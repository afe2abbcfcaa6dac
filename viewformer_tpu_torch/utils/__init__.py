"""The index-set DSL and the loaders' helpers (port of SplitIndices,
batch_len, batch_slice and unique in viewformer_tpu/utils/__init__.py)."""
from functools import partial


class SplitIndices:
    """Index-set DSL: "1:10:2,15" denotes {1, 3, 5, 7, 9, 15}; a part is an
    index or start:stop[:step] (an open stop runs on). Selects shards for
    `--shards` (dataset generate, generate-codes)."""

    def __init__(self, indices):
        if isinstance(indices, range):
            self._indices = f'{indices.start}:{indices.stop}:{indices.step}'
        elif isinstance(indices, (list, tuple)):
            self._indices = ','.join(str(x) for x in indices)
        elif isinstance(indices, SplitIndices):
            self._indices = indices._indices
        else:
            self._indices = str(indices)

    @classmethod
    def from_str(cls, str_val):
        return SplitIndices(str_val)

    def __repr__(self):
        return self._indices

    def __str__(self):
        return self._indices

    def restrict(self, b):
        """The indices of self that are in b, in self's order."""
        vals = []
        if not isinstance(b, SplitIndices):
            b = SplitIndices(b)
        limit = b.left_limit()
        for x in self._indices.split(','):
            xx = [int(a) if a else None for a in x.split(':')]
            if len(xx) == 1:
                if xx[0] in b:
                    vals.append(xx[0])
            elif len(xx) == 2:
                xx.append(None)
            if len(xx) == 3:
                cur = xx[0] if xx[0] is not None else 0
                while (xx[1] is None or cur < xx[1]) and cur < limit:
                    if cur in b:
                        vals.append(cur)
                    cur += 1 if xx[2] is None else xx[2]
        return SplitIndices(','.join(map(str, vals)))

    def __contains__(self, val):
        for x in self._indices.split(','):
            xx = [int(a) if a else None for a in x.split(':')]
            if len(xx) == 1:
                if val == xx[0]:
                    return True
                continue
            step = 1 if len(xx) == 2 else xx[-1]
            start, stop = xx[:2]
            if start is None:
                start = 0
            if (val - start) % step == 0 and (stop is None or val < stop) and val >= start:
                return True
        return False

    def left_limit(self):
        """An index bound for restrict(): one past the largest single index
        before the first range, or that range's stop (inf when open)."""
        max_v = -float('inf')
        for x in self._indices.split(','):
            xx = [int(a) if a else None for a in x.split(':')]
            if len(xx) == 1:
                max_v = max(max_v, xx[0] + 1)
                continue
            if xx[1] is None:
                return float('inf')
            return xx[1]
        return max_v

    def __iter__(self):
        if self._indices == '':
            return
        for x in self._indices.split(','):
            xx = [int(a) if a else None for a in x.split(':')]
            if len(xx) == 1:
                yield xx[0]
                continue
            if len(xx) == 2:
                xx.append(None)
            cur = xx[0] if xx[0] is not None else 0
            while xx[1] is None or cur < xx[1]:
                yield cur
                cur += 1 if xx[2] is None else xx[2]


def batch_slice(x, ind):
    """x (an array, or a tuple or dict of them, nested) indexed by `ind` along
    its first axis."""
    if isinstance(x, tuple):
        return tuple(map(partial(batch_slice, ind=ind), x))
    if isinstance(x, dict):
        return x.__class__([(k, batch_slice(v, ind)) for k, v in x.items()])
    return x[ind]


def batch_len(x):
    """The length of the first array in x (an array, tuple or dict)."""
    if isinstance(x, tuple):
        return batch_len(x[0])
    if isinstance(x, dict):
        return batch_len(next(iter(x.values())))
    return len(x)


def unique(iterable):
    """The items of iterable in order, each once."""
    seen = set()
    for x in iterable:
        if x not in seen:
            seen.add(x)
            yield x
