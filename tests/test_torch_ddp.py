"""The port's data parallel (parallel/distributed.py) on the CPU: two gloo
processes (torch.multiprocessing, spawn, a file rendezvous) against one
process over the whole batch. One spawn runs every case, in order, and
saves each rank's results; the tests read them.

  step:       2 train steps at dropout 0 (random pose multiplier 2) on each
              rank's rows equal 2 one-process steps on the whole batch
  dropout:    at dropout 0.1, each rank's non-attention masks are rows of
              the one-process masks, the attention seed words differ by
              rank and from one process, and the replicas stay equal
  quantizer:  quantize_ema over both ranks' rows equals one process
  checkpoint: only rank 0 writes; both ranks restore rank 0's state
  loop:       train_transformer over a token dataset: the replicas end
              equal, only rank 0 writes the log and the checkpoints

JAX's one-device step equals the port's (tests/test_torch_train.py); this
file holds the port's ranks against the port's one process."""
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from viewformer_tpu_torch.config import MIGTConfig
from viewformer_tpu_torch.data import dataset as tds
from viewformer_tpu_torch.models import migt as tmigt
from viewformer_tpu_torch.ops import attention_cuda, quantizer
from viewformer_tpu_torch.ops.dropout import hash_uniform
from viewformer_tpu_torch.parallel import distributed
from viewformer_tpu_torch.train import checkpoint as tckpt
from viewformer_tpu_torch.train import transformer as ttt
from viewformer_tpu_torch.utils.schedules import Schedule

WORLD = 2
SPAWN_TIMEOUT = 60
CONFIG = MIGTConfig(n_embeddings=16, n_head=4, d_model=64, n_layer=2, dropout=0.0,
                    sequence_size=3, token_image_size=4, total_steps=100, n_loss_skip=1,
                    learning_rate=1e-3, weight_decay=0.01, batch_size=4,
                    random_pose_multiplier=2.0, localization_weight=Schedule.from_str('1'))
RATE = 0.1


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tensors here are tiny, and the CPU's thread
    pool only adds contention when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, B=4):
    rng = np.random.RandomState(seed)
    poses = rng.randn(B, CONFIG.sequence_size, 7).astype(np.float32)
    poses[..., 3:] /= np.linalg.norm(poses[..., 3:], axis=-1, keepdims=True)
    size = CONFIG.token_image_size
    return (torch.from_numpy(poses),
            torch.from_numpy(rng.randint(0, 16, (B, CONFIG.sequence_size, size, size))))


def _steps(config, batch, steps=2):
    """`steps` train steps in f32 on the CPU from generator seed 0, step i's
    seed words and pose multiplier from generator seed 7 + i: (metrics and
    averaged gradients of each step, the final state_dict)."""
    model, state = ttt.init_transformer_state(config, torch.Generator().manual_seed(0),
                                              torch.float32, 'cpu', warmup_steps=1)
    step = ttt.make_transformer_train_step(model, config)
    metrics, grads = [], []
    for i in range(steps):
        state, m = step(state, batch, torch.Generator().manual_seed(7 + i))
        metrics.append({key: value.clone() for key, value in m.items()})
        grads.append({name: p.grad.clone() for name, p in model.named_parameters()})
    return metrics, grads, model.state_dict()


def _record_dropout(monkeypatch, calls):
    """Record each non-attention dropout site (words, shape, hashed element
    indices) and the attention kernels' seed words of a forward, in call
    order."""
    hash_dropout = tmigt.hash_dropout

    def recorded(words, x, rate, index=None):
        if rate > 0:
            calls['sites'].append((tuple(words), tuple(x.shape), index))
        return hash_dropout(words, x, rate, index)

    monkeypatch.setattr(tmigt, 'hash_dropout', recorded)
    for name in ('block_causal_attention_dropout_fwd', 'branch_attention_dropout_fwd'):
        def wrapped(*args, _fn=getattr(attention_cuda, name), _name=name, **kwargs):
            calls['attention'].append((_name, tuple(int(w) for w in args[-2])))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(attention_cuda, name, wrapped)


def _dropout_run(shard_batch):
    """One train step at dropout 0.1 with the sites recorded, then a second
    step: (calls of the first step, final state_dict)."""
    config = dataclasses.replace(CONFIG, dropout=RATE)
    model, state = ttt.init_transformer_state(config, torch.Generator().manual_seed(0),
                                              torch.float32, 'cpu', warmup_steps=1)
    step = ttt.make_transformer_train_step(model, config)
    calls = {'sites': [], 'attention': []}
    with pytest.MonkeyPatch.context() as monkeypatch:
        _record_dropout(monkeypatch, calls)
        state, _ = step(state, shard_batch, torch.Generator().manual_seed(7))
    state, _ = step(state, shard_batch, torch.Generator().manual_seed(8))
    return calls, model.state_dict()


def _quantizer_inputs():
    return torch.from_numpy(np.random.RandomState(3).randn(8, 5, 4).astype(np.float32))


def _quantize(inputs, calls=2):
    state = types.SimpleNamespace(**quantizer.init_quantizer_state(
        4, 6, torch.Generator().manual_seed(1)))
    for _ in range(calls):
        quantizer.quantize_ema(state, inputs, training=True)
    return vars(state)


def _checkpoint_case(rank, job_dir):
    """Each rank saves a state of its own rank's value; returns what each
    rank restores and how many files it wrote."""
    writes = []
    write = tckpt.CheckpointManager._write

    def counted(*args, **kwargs):
        writes.append(args[0])
        return write(*args, **kwargs)

    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(tckpt.CheckpointManager, '_write', staticmethod(counted))
        mgr = tckpt.CheckpointManager(job_dir, CONFIG)
        mgr.save(1, {'w': torch.full((3,), float(rank))}, val_loss=1.0 + rank,
                 aux={'rank': rank})
        # the commit is synchronous: every rank sees it when save() returns
        restored, step = mgr.restore_last()
        mgr.close()
    return {'restored': restored['w'], 'step': step, 'writes': writes,
            'aux': mgr.load_aux()}


def _write_tokens(path):
    """A token dataset: 2 train shards and 1 test shard of 3 environments of
    6-8 frames of 4x4 codes (the port's writer)."""
    rng = np.random.RandomState(0)
    name = os.path.basename(path)
    os.makedirs(path)
    features = ['cameras', 'codes']
    for split, size in (('train', 2), ('test', 1)):
        tds.write_dataset_info(os.path.join(path, 'info.json'), {
            'name': name, 'features': features, 'token_image_size': 4, 'frame_size': 16,
            f'{split}_size': size, 'splits': [split]})
        for shard in range(1, size + 1):
            sequences = []
            for _ in range(3):
                count = rng.randint(6, 9)
                cameras = rng.randn(count, 7).astype(np.float32)
                cameras[:, 3:] /= np.linalg.norm(cameras[:, 3:], axis=-1, keepdims=True)
                sequences.append({'cameras': cameras, 'codes': rng.randint(0, 16, (count, 4, 4))})
            tds.write_shard(os.path.join(path, f'{name}-{split}-{shard:06d}-of-{size:06d}'),
                            sequences, features)


def _loop_case(job_dir, dataset):
    model, state = ttt.train_transformer(
        dataclasses.replace(CONFIG, dropout=RATE), dataset, job_dir, total_steps=4, epochs=2,
        use_bf16=False, progress=False, log_every=1, profile_batch=0, device='cpu')
    return {'params': model.state_dict(), 'step': state.step}


def _worker(rank, init_file, out_dir, dataset):
    torch.set_num_threads(1)
    sys.modules['torch.utils.tensorboard'] = None  # no TensorBoard sink: it imports TensorFlow
    dist.init_process_group('gloo', init_method=f'file://{init_file}', rank=rank,
                            world_size=WORLD)
    try:
        poses, tokens = _batch()
        shard = (distributed.shard_rows(poses), distributed.shard_rows(tokens))
        results = {'step': _steps(CONFIG, shard), 'dropout': _dropout_run(shard),
                   'quantizer': _quantize(distributed.shard_rows(_quantizer_inputs())),
                   'checkpoint': _checkpoint_case(rank, os.path.join(out_dir, 'ckpt')),
                   'loop': _loop_case(os.path.join(out_dir, 'loop'), dataset)}
        torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, dataset):
    context = torch.multiprocessing.start_processes(
        _worker, args=(os.path.join(out_dir, 'rendezvous'), out_dir, dataset), nprocs=WORLD,
        join=False, start_method='spawn')
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not context.join(timeout=1):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            pytest.fail(f'the {WORLD} ranks did not finish in {SPAWN_TIMEOUT} s')
    assert not any(process.is_alive() for process in context.processes)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Each rank's results, the job dirs' root and the one-process runs."""
    out_dir = str(tmp_path_factory.mktemp('ddp'))
    dataset = os.path.join(out_dir, 'tokens')
    _write_tokens(dataset)
    _spawn(out_dir, dataset)
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'), weights_only=False)
            for r in range(WORLD)], out_dir


def _close(a, b, tol, msg=''):
    torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=msg)


def test_two_rank_step_equals_one_process(ranks):
    """At dropout 0 each rank's step on its rows, with the gradients and
    metrics averaged over the ranks, is the one-process step over the whole
    batch (within f32 reassociation of the sums, 1e-6)."""
    results, _ = ranks
    metrics, grads, params = _steps(CONFIG, _batch())
    for rank_results in results:
        rank_metrics, rank_grads, rank_params = rank_results['step']
        for step_metrics, expected in zip(rank_metrics, metrics):
            assert step_metrics.keys() == expected.keys()
            for key in expected:
                _close(step_metrics[key], expected[key], 1e-6, key)
        for step_grads, expected in zip(rank_grads, grads):
            for name in expected:
                _close(step_grads[name], expected[name], 1e-6, name)
        d = CONFIG.d_model
        for name, value in rank_params.items():
            expected = params[name]
            if name.endswith('attn.c_attn.bias'):
                # the key third has a zero true gradient; Adam turns its
                # rounding noise (|g| < 1e-10) into updates of up to
                # lr * |g| / eps (test_torch_train.test_train_steps_match_jax)
                _close(value[2 * d:], expected[2 * d:], 5e-5, name)
                value, expected = value[:2 * d], expected[:2 * d]
            _close(value, expected, 1e-6, name)


def test_dropout_masks_and_seeds_by_rank(ranks):
    """At dropout 0.1: each rank's non-attention masks are its rows of the
    one-process masks (the global batch's element indices are hashed); the
    attention kernels' seed words differ between the ranks and from one
    process (the rank folded in); after 2 steps the replicas are equal."""
    results, _ = ranks
    expected_calls, _ = _dropout_run(_batch())
    rate = np.float32(RATE)
    per_rank = [r['dropout'][0] for r in results]
    for rank, calls in enumerate(per_rank):
        assert len(calls['sites']) == len(expected_calls['sites']) > 0
        for (words, shape, index), (gwords, gshape, gindex) in zip(calls['sites'],
                                                                    expected_calls['sites']):
            assert words == gwords
            assert torch.equal(gindex.flatten(), torch.arange(gindex.numel()))
            assert shape[0] * WORLD == gshape[0] and shape[1:] == gshape[1:]
            mask = hash_uniform(words, shape, index=index) >= rate
            global_mask = hash_uniform(gwords, gshape) >= rate
            rows = global_mask[rank * shape[0]:(rank + 1) * shape[0]]
            assert torch.equal(mask, rows)
    one = expected_calls['attention']
    zero, first = per_rank[0]['attention'], per_rank[1]['attention']
    # B5 and B7 a layer, in the forward and the remat recompute
    assert len(zero) == len(first) == len(one) == 4 * CONFIG.n_layer
    for (name0, s0), (name1, s1), (name, s) in zip(zero, first, one):
        assert name0 == name1 == name
        assert len({s0, s1, s}) == 3, (s0, s1, s)
    params0, params1 = (r['dropout'][1] for r in results)
    for name in params0:
        torch.testing.assert_close(params0[name], params1[name], rtol=0, atol=0, msg=name)


def test_quantize_ema_over_two_ranks_equals_one_process(ranks):
    """The EMA update sums its one-hot counts and inputs^T @ one-hot over the
    ranks: counts exact, the codebook within 1e-6 of one process over the
    concatenated inputs."""
    results, _ = ranks
    expected = _quantize(_quantizer_inputs())
    for rank_results in results:
        state = rank_results['quantizer']
        assert torch.equal(state['counter'], expected['counter'])
        assert torch.equal(state['ema_cluster_size_hidden'], expected['ema_cluster_size_hidden'])
        for key in ('ema_dw_hidden', 'embeddings'):
            _close(state[key], expected[key], 1e-6, key)


def test_checkpoint_written_by_rank_zero_only(ranks):
    results, out_dir = ranks
    zero, first = (r['checkpoint'] for r in results)
    assert zero['writes'] == [os.path.join(out_dir, 'ckpt', 'last'),
                              os.path.join(out_dir, 'ckpt', 'best')]
    assert first['writes'] == []
    for rank_results in (zero, first):
        assert rank_results['step'] == 1
        assert torch.equal(rank_results['restored'], torch.zeros(3))
        assert rank_results['aux'] == {'step': 1, 'rank': 0}
    with open(os.path.join(out_dir, 'ckpt', 'config.json')) as f:
        assert json.load(f)['d_model'] == CONFIG.d_model


def test_train_transformer_on_two_ranks(ranks):
    """train_transformer under 2 ranks (batches of 2 rows each, each rank its
    own train shard): the replicas end equal, rank 0 alone writes the metric
    log (train and validation records), and the checkpoint restores the
    final parameters."""
    results, out_dir = ranks
    zero, first = (r['loop'] for r in results)
    assert zero['step'] == first['step'] == 4
    for name, value in zero['params'].items():
        torch.testing.assert_close(value, first['params'][name], rtol=0, atol=0, msg=name)
    job = os.path.join(out_dir, 'loop')
    with open(os.path.join(job, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert [(r['step'], 'val/loss' in r) for r in records] == [
        (1, False), (2, False), (2, True), (3, False), (4, False), (4, True)]
    restored, step = tckpt.restore_checkpoint(job, prefer='last')
    assert step == 4
    for name, value in zero['params'].items():
        assert torch.equal(restored['model'][name], value), name


# tools/ddp_check.py's verdict on its multi-card training runs
# (steps_agree over a compare_steps record), with the readings of four
# H100s on the meshes 2x1x2 and 1x2x2 (bf16 against one card's bf16) and
# records that each fault one bound. Every faulty record but the replicas'
# passes the bounds set for f32 on the CPU against bf16 on the card
# (chip_smoke.TRAIN_LOSS_TOL, GRAD_COSINE, UPDATE_COSINE): those would pass
# a wrong mean over the ranks.
CARD_READINGS = {'replicas_equal': True, 'loss_rel_err': 6.6e-6, 'grad_cosine_min': 0.999983,
                 'grad_norm_ratio_err': 2.1e-4,
                 'update_cosine': {'wte.weight': 0.99356, 'h.0.attn.c_attn.weight': 0.99660}}
VERDICT_CASES = {
    'card_readings': ({}, True),
    'loss_off_by_1e-3': ({'loss_rel_err': 1e-3}, False),
    'gradient_norm_off_by_1e-2': ({'grad_norm_ratio_err': 1e-2}, False),
    'gradient_cosine_0.9995': ({'grad_cosine_min': 0.9995}, False),
    'update_cosine_0.98': ({'update_cosine': {'wte.weight': 0.98}}, False),
    'replicas_differ': ({'replicas_equal': False}, False),
}


@pytest.mark.parametrize('case', sorted(VERDICT_CASES))
def test_ddp_check_verdict(case):
    import chip_smoke as cs
    from viewformer_tpu_torch.tools import ddp_check

    changes, expected = VERDICT_CASES[case]
    record = dict(CARD_READINGS, **changes)
    assert ddp_check.steps_agree(record) is expected
    if not expected and record['replicas_equal']:
        assert (record['loss_rel_err'] <= cs.TRAIN_LOSS_TOL
                and record['grad_cosine_min'] >= cs.GRAD_COSINE
                and min(record['update_cosine'].values()) >= cs.UPDATE_COSINE)


def test_ddp_check_compare_steps_sees_a_gradient_scale(monkeypatch):
    """compare_steps' gradient norm ratio sees a gradient 1% too large,
    which leaves every cosine at 1: steps_agree fails it. (One process: no
    group to compare replicas over.)"""
    import chip_smoke as cs
    from viewformer_tpu_torch.tools import ddp_check

    monkeypatch.setattr(cs, 'replicas_equal', lambda tensors: True)
    gen = torch.Generator().manual_seed(0)
    names = cs.compared(2)
    params = {k: torch.randn(8, 4, generator=gen) for k in names}
    moved = {k: torch.randn(8, 4, generator=gen) for k in names}
    grads = [{k: torch.randn(8, 4, generator=gen) for k in names} for _ in range(2)]
    reference = ([2.0, 1.5], [0.1, 0.1], params, moved, grads)
    same = ddp_check.compare_steps(reference, reference, 2)
    assert same['loss_rel_err'] == 0 and same['grad_norm_ratio_err'] < 1e-12
    assert ddp_check.steps_agree(same)
    scaled = ([2.0, 1.5], [0.1, 0.1], params, moved,
              [{k: 1.01 * g for k, g in step.items()} for step in grads])
    record = ddp_check.compare_steps(scaled, reference, 2)
    assert record['grad_cosine_min'] > 1 - 1e-12
    assert abs(record['grad_norm_ratio_err'] - 0.01) < 1e-6  # 1.01 rounded to f32
    assert not ddp_check.steps_agree(record)
