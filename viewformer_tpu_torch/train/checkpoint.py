"""Checkpoints of a training job: a rolling last checkpoint and the best one
by validation loss, committed in the background (the port's counterpart of
viewformer_tpu/train/checkpoint.py, with torch.save files in place of orbax).

A job dir holds
  config.json                the model config
  last/<step>.pt             the newest committed save (one kept)
  best/<step>.pt, .json      the save with the lowest val_loss, and that loss
  aux-<step>.json            small side state of a save (the data cursor)
Each .pt file is one torch.save of the state tree handed to save() (dicts,
lists and tuples of CPU tensors and Python values), written under a .tmp
name and then renamed into place.

The commit-lag contract: save() snapshots the state and returns; one worker
thread copies the snapshot to the host and writes it, in order. Saves still
queued when a newer one arrives are cancelled and their snapshots freed at
once, so at most two snapshots are alive (the one being written and the
newest). An error of an earlier save is raised by the next save(), wait()
or close().
"""
import concurrent.futures
import json
import logging
import os
import re
import threading

import torch

from ..config import save_config

_log = logging.getLogger(__name__)


def _map_tensors(fn, tree):
    """tree with fn applied to each tensor; containers are new, other leaves
    shared."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: _map_tensors(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, value) for value in tree)
    return tree


def _tensors(tree):
    out = []
    _map_tensors(out.append, tree)
    return out


def _steps(directory, pattern):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in (re.fullmatch(pattern, f)
                                            for f in os.listdir(directory)) if m)


class CheckpointManager:
    """`last/` (rolling, every save) and `best/` (lowest val_loss) of a job
    dir."""

    def __init__(self, job_dir, config=None):
        """save() clones each tensor where it lives (on the card for a card
        run) and the worker copies the clones to the host: a snapshot costs
        one state of device memory, and at most two are alive. Single
        process only: with a torch.distributed world size above 1 it raises
        (DDP training is not ported)."""
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError('CheckpointManager runs in one process; '
                                      'multi-process (DDP) training is not ported')
        self.job_dir = os.path.abspath(job_dir)
        self._last_dir = os.path.join(self.job_dir, 'last')
        self._best_dir = os.path.join(self.job_dir, 'best')
        os.makedirs(self.job_dir, exist_ok=True)
        if config is not None:
            save_config(config, self.job_dir)
        # One worker: commits happen in the order of the saves.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='ckpt-commit')
        self._pending = []   # [(future, step)], never a cancelled one
        self._payloads = {}  # step -> (snapshot, event, val_loss)
        self.saves_coalesced = 0
        # Held by the worker while it writes or deletes files and by the
        # caller while it lists or reads them.
        self._lock = threading.Lock()
        self._committed_step = self._latest_step()
        self._best = self._read_best()

    def _read_best(self):
        """(val_loss, step) of the committed best checkpoint, or None."""
        best = None
        for step in _steps(self._best_dir, r'(\d+)\.json'):
            if not os.path.exists(os.path.join(self._best_dir, f'{step}.pt')):
                continue
            with open(os.path.join(self._best_dir, f'{step}.json')) as f:
                val_loss = json.load(f)['val_loss']
            if best is None or val_loss < best[0]:
                best = (val_loss, step)
        return best

    def save(self, step, state, val_loss=None, aux=None):
        """Snapshot `state` (a tree of tensors and Python values, e.g.
        {'model': model.state_dict(), 'optimizer': optimizer.state_dict(),
        'step': n}) and queue its commit as `step`; with val_loss, it also
        becomes `best/` when its loss is the lowest so far.

        aux: small JSON-serializable side state of this save (the data
        cursor), written at once and atomically as aux-<step>.json. Aux files
        are deleted only below the newest committed step, so the committed
        checkpoint's aux survives however far the commits lag; load_aux
        resolves against the committed step."""
        step = int(step)
        if aux is not None:
            name = f'aux-{step}.json'
            tmp = os.path.join(self.job_dir, name + '.tmp')
            with open(tmp, 'w') as f:
                json.dump({'step': step, **aux}, f)
            os.replace(tmp, os.path.join(self.job_dir, name))
            committed = self._committed_step
            for s in _steps(self.job_dir, r'aux-(\d+)\.json')[:-1]:
                if committed is not None and s < committed:
                    os.unlink(os.path.join(self.job_dir, f'aux-{s}.json'))
        snapshot, event = self._snapshot(state)
        val_loss = None if val_loss is None else float(val_loss)
        # Coalesce: cancel the queued saves (a rolling checkpoint needs only
        # the newest) and drop their snapshots now. The payloads live here,
        # not in the executor's work items, so a cancelled one frees its
        # memory at once. The running commit is never cancelled. Only the
        # earlier saves' errors are raised here: this save's own commit may
        # already have failed too, and the next call raises that.
        kept, done = [], []
        for future, s in self._pending:
            if future.cancel():
                self.saves_coalesced += 1
                self._payloads.pop(s, None)
            elif future.done():
                done.append(future)
            else:
                kept.append((future, s))
        self._pending = kept
        self._payloads[step] = (snapshot, event, val_loss)
        self._pending.append((self._pool.submit(self._commit, step), step))
        self._raise_first([f.exception() for f in done])

    def _snapshot(self, state):
        """(copy of state, CUDA event recorded after the copy or None)."""
        snapshot = _map_tensors(lambda t: t.detach().clone(), state)
        event = None
        if any(t.is_cuda for t in _tensors(snapshot)):
            # The clones are enqueued on the current stream before anything
            # the caller enqueues next (the next optimizer step updates the
            # parameters in place), so they hold this step's values. The
            # worker's copy to the host runs on a stream of its own, after
            # this event: it waits for the clones and for nothing later.
            event = torch.cuda.Event()
            event.record()
        return snapshot, event

    @staticmethod
    def _to_host(snapshot, event):
        if event is None:
            return snapshot
        device = next(t.device for t in _tensors(snapshot) if t.is_cuda)
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            host = _map_tensors(lambda t: t.to('cpu'), snapshot)
        stream.synchronize()
        return host

    def _commit(self, step):
        payload = self._payloads.pop(step, None)
        if payload is None:  # coalesced between submit and run
            return
        snapshot, event, val_loss = payload
        host = self._to_host(snapshot, event)
        del snapshot, payload  # free the device copy once it is on the host
        with self._lock:
            self._write(self._last_dir, step, host)
            if val_loss is not None and (self._best is None or val_loss < self._best[0]):
                self._write(self._best_dir, step, host, {'step': step, 'val_loss': val_loss})
                self._best = (val_loss, step)
        self._committed_step = step

    @staticmethod
    def _write(directory, step, host, metrics=None):
        """Write <step>.pt (and <step>.json), then delete the older ones."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f'{step}.pt')
        torch.save(host, path + '.tmp')
        os.replace(path + '.tmp', path)
        if metrics is not None:
            with open(path[:-3] + '.json.tmp', 'w') as f:
                json.dump(metrics, f)
            os.replace(path[:-3] + '.json.tmp', path[:-3] + '.json')
        for old in _steps(directory, r'(\d+)\.pt'):
            if old != step:
                for suffix in ('.json', '.pt'):
                    old_path = os.path.join(directory, f'{old}{suffix}')
                    if os.path.exists(old_path):
                        os.unlink(old_path)

    @staticmethod
    def _raise_first(exceptions):
        exceptions = [e for e in exceptions if e is not None]
        for extra in exceptions[1:]:
            _log.error('additional background checkpoint save failure: %r', extra)
        if exceptions:
            raise exceptions[0]

    def wait(self):
        """Wait for every queued commit; raise the first error among them."""
        pending, self._pending = self._pending, []
        self._raise_first([f.exception() for f, _ in pending])

    def latest_step(self):
        """The step of the committed last checkpoint, or None."""
        with self._lock:
            return self._latest_step()

    def _latest_step(self):
        steps = _steps(self._last_dir, r'(\d+)\.pt')
        return steps[-1] if steps else None

    def load_aux(self):
        """The aux dict of the newest committed checkpoint: aux-<latest
        step>.json first, then the newest aux at or below that step, then
        newer ones (a cursor ahead of the restored state is the last
        resort), or None."""
        step = self.latest_step()
        steps = _steps(self.job_dir, r'aux-(\d+)\.json')
        if step is not None:
            ordered = ([step] + [s for s in reversed(steps) if s <= step]
                       + [s for s in reversed(steps) if s > step])
        else:
            ordered = list(reversed(steps))
        for path in (os.path.join(self.job_dir, f'aux-{s}.json') for s in ordered):
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        return None

    @staticmethod
    def _load(directory, step):
        if step is None:
            return None, None
        return torch.load(os.path.join(directory, f'{step}.pt'), map_location='cpu',
                          weights_only=True), step

    def restore_last(self):
        """(state tree with CPU tensors, step) of the last checkpoint, or
        (None, None)."""
        with self._lock:
            return self._load(self._last_dir, self._latest_step())

    def restore_best(self):
        """(state tree, step) of the best checkpoint, or (None, None)."""
        with self._lock:
            return self._load(self._best_dir, None if self._best is None else self._best[1])

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def restore_checkpoint(job_dir, prefer='best'):
    """(state tree, step) from a job dir written by CheckpointManager: the
    best checkpoint if prefer='best' and there is one, else the last."""
    mgr = CheckpointManager(job_dir)
    try:
        if prefer == 'best':
            state, step = mgr.restore_best()
            if state is not None:
                return state, step
        return mgr.restore_last()
    finally:
        mgr.close()
