"""The port's CheckpointManager (viewformer_tpu_torch.train.checkpoint): the
counterparts of tests/test_checkpoint.py's six tests, then the snapshot
taken before an in-place optimizer step, best-by-val_loss, the coalescing
bound of two live snapshots, and errors raised by the next call, never by
the save whose commit failed."""
import gc
import json
import os
import threading
import weakref

import pytest
import torch

from viewformer_tpu_torch.config import MIGTConfig, load_config
from viewformer_tpu_torch.train import checkpoint as ckpt_mod
from viewformer_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint


def _equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def test_save_survives_in_place_updates(tmp_path):
    """save() snapshots and returns before the commit; updating and dropping
    the source tensors right after (what the next optimizer step does) must
    not change the checkpoint."""
    state = {'w': torch.arange(8.0), 'step': 3}
    expected = {'w': state['w'].clone(), 'step': 3}
    mgr = CheckpointManager(str(tmp_path / 'job'))
    mgr.save(0, state)
    state['w'].mul_(0).add_(7)
    del state
    mgr.wait()
    restored, step = mgr.restore_last()
    mgr.close()
    assert step == 0
    _equal(restored, expected)


def test_restore_gives_host_tensors_for_any_device(tmp_path):
    """A restored checkpoint holds plain CPU tensors (with the saved config
    beside it), which load into a model built anywhere."""
    config = MIGTConfig(n_embeddings=16, n_head=2, d_model=32, n_layer=1, token_image_size=2)
    model = torch.nn.Linear(4, 3)
    mgr = CheckpointManager(str(tmp_path / 'job'), config)
    mgr.save(0, {'model': model.state_dict()}, val_loss=1.0)
    mgr.close()
    assert load_config(str(tmp_path / 'job')).asdict() == config.asdict()
    restored, step = restore_checkpoint(str(tmp_path / 'job'), prefer='best')
    assert step == 0
    assert all(t.device.type == 'cpu' for t in restored['model'].values())
    other = torch.nn.Linear(4, 3)
    other.load_state_dict(restored['model'])
    _equal(other.state_dict(), model.state_dict())


def test_aux_state_roundtrip(tmp_path):
    """The data-iterator cursor rides next to the rolling last checkpoint."""
    mgr = CheckpointManager(str(tmp_path / 'job'))
    assert mgr.load_aux() is None
    state = {'w': torch.zeros(2)}
    mgr.save(0, state)  # no aux: nothing written
    assert mgr.load_aux() is None
    mgr.save(5, state, aux={'data_iterator': {'epoch': 1, 'batch': 7}})
    mgr.close()
    aux = CheckpointManager(str(tmp_path / 'job')).load_aux()
    assert aux == {'step': 5, 'data_iterator': {'epoch': 1, 'batch': 7}}


def test_aux_ahead_of_commit_is_not_preferred(tmp_path):
    """A crash can leave an aux file newer than the newest committed
    checkpoint. load_aux resolves the newest aux at or below the committed
    step; a newer one only when there is no other."""
    job = str(tmp_path / 'job')
    mgr = CheckpointManager(job)
    mgr.save(10, {'w': torch.zeros(2)}, aux={'data_iterator': {'epoch': 0, 'batch': 10}})
    mgr.close()
    with open(os.path.join(job, 'aux-20.json'), 'w') as f:
        json.dump({'step': 20, 'data_iterator': {'epoch': 0, 'batch': 20}}, f)
    assert CheckpointManager(job).load_aux()['step'] == 10
    os.unlink(os.path.join(job, 'aux-10.json'))
    assert CheckpointManager(job).load_aux()['step'] == 20


def _gate(monkeypatch):
    """Holds every commit until the returned event is set."""
    gate = threading.Event()
    commit = ckpt_mod.CheckpointManager._commit

    def slow_commit(self, step):
        gate.wait(timeout=60)
        return commit(self, step)

    monkeypatch.setattr(ckpt_mod.CheckpointManager, '_commit', slow_commit)
    return gate


def test_aux_cursor_survives_commit_lag(tmp_path, monkeypatch):
    """With commits lagging saves, the committed checkpoint's aux survives
    until a newer commit supersedes it, and queued saves coalesce."""
    gate = _gate(monkeypatch)
    job = str(tmp_path / 'job')
    mgr = CheckpointManager(job)
    state = {'w': torch.arange(4.0)}
    for s in (10, 20, 30):
        mgr.save(s, state, aux={'data_iterator': {'epoch': 0, 'batch': s}})
    assert {f for f in os.listdir(job) if f.startswith('aux-')} == \
        {'aux-10.json', 'aux-20.json', 'aux-30.json'}
    # 20 was queued behind the running 10 and coalesced away by 30, its
    # snapshot dropped at once
    assert mgr.saves_coalesced == 1
    assert set(mgr._payloads) <= {10, 30}
    gate.set()
    mgr.wait()
    assert mgr._payloads == {}
    assert os.listdir(os.path.join(job, 'last')) == ['30.pt']
    assert mgr.load_aux() == {'step': 30, 'data_iterator': {'epoch': 0, 'batch': 30}}
    mgr.save(40, state, aux={'data_iterator': {'epoch': 1, 'batch': 40}})
    mgr.wait()
    aux_files = {f for f in os.listdir(job) if f.startswith('aux-')}
    assert 'aux-10.json' not in aux_files and 'aux-20.json' not in aux_files
    mgr.close()
    assert CheckpointManager(job).load_aux()['step'] == 40


def test_snapshot_unchanged_by_the_next_optimizer_step(tmp_path):
    """The trainer's save: the model's state_dict and AdamW's, taken before
    the next in-place optimizer step, restore to those values exactly and
    continue the same trajectory."""
    torch.manual_seed(0)
    model = torch.nn.Linear(5, 4)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2)
    x = torch.randn(8, 5)

    def step():
        optimizer.zero_grad()
        model(x).square().mean().backward()
        optimizer.step()

    step()
    expected = {'model': {k: v.clone() for k, v in model.state_dict().items()}}
    mgr = CheckpointManager(str(tmp_path / 'job'))
    gate = threading.Event()
    mgr._pool.submit(gate.wait, 60)
    mgr.save(1, {'model': model.state_dict(), 'optimizer': optimizer.state_dict(), 'step': 1})
    step()  # in place, while the commit waits
    after = {k: v.clone() for k, v in model.state_dict().items()}
    gate.set()
    mgr.close()
    restored, saved_step = restore_checkpoint(str(tmp_path / 'job'), prefer='last')
    assert saved_step == 1 and restored['step'] == 1
    _equal(restored['model'], expected['model'])
    model.load_state_dict(restored['model'])
    optimizer.load_state_dict(restored['optimizer'])
    step()
    _equal(model.state_dict(), after)


def test_best_by_val_loss(tmp_path):
    """best/ keeps the save with the lowest val_loss; last/ the newest; a
    new manager reads the best loss back."""
    job = str(tmp_path / 'job')
    mgr = CheckpointManager(job)
    for s, loss in ((1, 3.0), (2, 1.0), (3, 2.0), (4, None)):
        mgr.save(s, {'w': torch.full((2,), float(s))}, val_loss=loss)
        mgr.wait()
    assert mgr.restore_best()[1] == 2 and mgr.restore_last()[1] == 4
    mgr.close()
    mgr = CheckpointManager(job)
    mgr.save(5, {'w': torch.zeros(2)}, val_loss=1.5)  # not better than 1.0
    mgr.close()
    state, step = restore_checkpoint(job, prefer='best')
    assert step == 2 and torch.equal(state['w'], torch.full((2,), 2.0))
    assert sorted(os.listdir(os.path.join(job, 'best'))) == ['2.json', '2.pt']
    assert restore_checkpoint(job, prefer='last')[1] == 5


def test_at_most_two_snapshots_alive(tmp_path, monkeypatch):
    """While the first commit runs, each new save cancels the queued one and
    frees its snapshot: two snapshots are alive, never more."""
    gate = _gate(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / 'job'))
    refs = []
    for s in range(6):
        mgr.save(s, {'w': torch.full((1000,), float(s))})
        refs.append(weakref.ref(mgr._payloads[s][0]['w']))
        gc.collect()
        assert len(mgr._payloads) <= 2
        assert sum(r() is not None for r in refs) <= 2
    assert mgr.saves_coalesced == 4
    gate.set()
    mgr.close()
    gc.collect()
    assert all(r() is None for r in refs)
    state, step = restore_checkpoint(str(tmp_path / 'job'), prefer='last')
    assert step == 5 and torch.equal(state['w'], torch.full((1000,), 5.0))


def test_errors_surface_in_the_next_call(tmp_path, monkeypatch):
    """A failed background commit raises in the next save(), or in wait()
    and close()."""
    def broken_save(obj, path):
        raise OSError('disk full')

    monkeypatch.setattr(ckpt_mod.torch, 'save', broken_save)
    mgr = CheckpointManager(str(tmp_path / 'job'))
    mgr.save(0, {'w': torch.zeros(1)})
    mgr._pending[0][0].exception()  # let the commit fail
    with pytest.raises(OSError, match='disk full'):
        mgr.save(1, {'w': torch.zeros(1)})
    with pytest.raises(OSError, match='disk full'):
        mgr.close()


def test_a_save_never_raises_its_own_error(tmp_path, monkeypatch):
    """Commits that fail before save() returns (here the worker runs each
    one at submit) are raised by the next call: save(0) returns, save(1)
    raises commit 0's error, close() commit 1's."""
    def broken_save(obj, path):
        raise OSError(f'disk full at {os.path.basename(path)}')

    monkeypatch.setattr(ckpt_mod.torch, 'save', broken_save)
    mgr = CheckpointManager(str(tmp_path / 'job'))
    submit = mgr._pool.submit

    def submit_and_finish(fn, *args):
        future = submit(fn, *args)
        future.exception()
        return future

    monkeypatch.setattr(mgr._pool, 'submit', submit_and_finish)
    mgr.save(0, {'w': torch.zeros(1)})
    with pytest.raises(OSError, match='0.pt'):
        mgr.save(1, {'w': torch.zeros(1)})
    with pytest.raises(OSError, match='1.pt'):
        mgr.close()
