"""Batch helpers of the loaders (port of batch_len and batch_slice in
viewformer_tpu/utils/__init__.py)."""
from functools import partial


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
