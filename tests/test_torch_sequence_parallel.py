"""Context parallelism of the port (the mesh's `seq` axis, models/migt.py)
on the CPU: gloo processes on the meshes 1x2x1 and 1x2x2 (data x
seq x model), against the JAX package's step with sp_axis='seq' on the
same meshes of its CPU devices and against the port's one process (the
helpers of tests/test_torch_tensor_parallel.py).

  steps:    2 train steps at dropout 0 from JAX's initial weights: the bars
            of test_torch_tensor_parallel against JAX and one process
  dropout:  at dropout 0.1 the 1x2x1 steps equal one process within the
            same bars; each non-attention site's mask is the rank's frames
            of one process's; the attention kernels' seed words are one
            process's on 1x2x1 (no fold), and on 1x2x2 equal over `seq`
            and distinct over `model`
  loop:     train_transformer(seq_parallelism=2) on 1x2x1 against one
            process's run: the logged losses and the final parameters"""
import dataclasses
import json
import os
import sys

import pytest
import torch

from test_torch_tensor_parallel import (CONFIG, DROPOUT, LOOP, LOOP_KWARGS, LOSS_RTOL,
                                        NOISE_ATOL, RTOL, assert_steps_equal, jax_steps,
                                        join, port_steps, seed_words_by_shard, start)
from viewformer_tpu_torch.ops import dropout as tdropout
from viewformer_tpu_torch.ops.dropout import hash_uniform
from viewformer_tpu_torch.parallel import mesh as mesh_lib
from viewformer_tpu_torch.train import transformer as ttt

MESHES = ((1, 2, 1), (1, 2, 2))
# a training forward's dropout sites: 3 streams' embeddings, then per layer
# the attention's 2 and 2 a stream (models/migt.py)
SITES = 3 + DROPOUT.n_layer * (2 + 2 * 3)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dropout_run():
    """One step at dropout 0.1 with every non-attention site's (words, keep
    mask) and the attention seed words recorded, then a second step:
    (sites, seed words, the steps' port_steps results)."""
    sites, seeds = [], []
    hash_dropout = tdropout.hash_dropout

    def recorded(words, x, rate, index=None):
        if rate > 0 and len(sites) < SITES:
            keep = hash_uniform(words, tuple(x.shape), x.device, index) >= rate
            sites.append((tuple(words), keep))
        return hash_dropout(words, x, rate, index)

    with pytest.MonkeyPatch.context() as patch:
        # the plain twin, which viewformer::hash_dropout runs on the CPU
        patch.setattr(tdropout, 'hash_dropout', recorded)
        results = port_steps(DROPOUT, record=seeds)
    return sites, seeds, results


def loop_case(out_dir, dataset):
    model, state = ttt.train_transformer(LOOP, dataset, out_dir, seq_parallelism=2,
                                         **LOOP_KWARGS)
    return {'params': model.state_dict(), 'step': state.step}


def rank_cases(rank, shape, out_dir, initial, dataset):
    out = {'steps': port_steps(CONFIG, initial)}
    if shape == (1, 2, 1):
        out['dropout'] = dropout_run()
        out['loop'] = loop_case(os.path.join(out_dir, 'loop'), dataset)
    else:
        seeds = []
        port_steps(DROPOUT, steps=1, record=seeds)
        out['seeds'] = seeds
    return out


@pytest.fixture(scope='module')
def meshes(tmp_path_factory):
    from test_torch_ddp import _write_tokens

    root = str(tmp_path_factory.mktemp('sp'))
    dataset = os.path.join(root, 'tokens')
    _write_tokens(dataset)
    reference = jax_steps(MESHES[0])
    initial = reference[0]
    handles = {shape: start(shape, __name__, os.path.join(root, 'x'.join(map(str, shape))),
                            initial, dataset) for shape in MESHES}
    jax_runs = {MESHES[0]: reference, MESHES[1]: jax_steps(MESHES[1])}
    results = {shape: (join(handle), jax_runs[shape]) for shape, handle in handles.items()}
    return results, root, initial, dataset


@pytest.mark.parametrize('shape', MESHES, ids=lambda s: 'x'.join(map(str, s)))
def test_sequence_parallel_steps_match_jax(meshes, shape):
    results = meshes[0]
    ranks, (_, losses, grads, params) = results[shape]
    for rank in ranks:
        assert_steps_equal(rank['steps'], losses, grads, params)


@pytest.mark.parametrize('shape', MESHES, ids=lambda s: 'x'.join(map(str, s)))
def test_sequence_parallel_steps_match_one_process(meshes, shape):
    results, _, initial, _ = meshes
    metrics, grads, params = port_steps(CONFIG, initial)
    for rank in results[shape][0]:
        assert_steps_equal(rank['steps'], [m['loss'] for m in metrics], grads, params)


def test_dropout_steps_masks_and_seeds_match_one_process(meshes):
    """At dropout 0.1 on 1x2x1: the embedding sites' masks are one
    process's (dropout before the frames are cut), every block site's are
    the rank's frames of one process's, the attention seed words are one
    process's, and the 2 steps equal one process's."""
    results = meshes[0]
    one_sites, one_seeds, (metrics, grads, params) = dropout_run()
    frames = DROPOUT.sequence_size // 2
    for seq, rank in enumerate(results[(1, 2, 1)][0]):
        sites, seeds, steps = rank['dropout']
        assert len(sites) == len(one_sites) == SITES
        for i, ((words, keep), (one_words, one_keep)) in enumerate(zip(sites, one_sites)):
            assert words == one_words, i
            if i >= 3:  # after the 3 embedding sites, the blocks' frames
                one_keep = one_keep[:, seq * frames:(seq + 1) * frames]
            assert torch.equal(keep, one_keep), i
        assert seeds == one_seeds and len(seeds) == 4 * DROPOUT.n_layer
        assert_steps_equal(steps, [m['loss'] for m in metrics], grads, params)


def test_seed_words_equal_over_seq_distinct_over_model(meshes):
    results = meshes[0]
    shape = (1, 2, 2)
    by_shard = seed_words_by_shard([r['seeds'] for r in results[shape][0]], shape)
    assert len(by_shard) == 2
    first, second = ([w for _, w in calls] for calls in by_shard.values())
    assert len(first) == 4 * DROPOUT.n_layer
    assert all(a != b for a, b in zip(first, second))


def test_train_transformer_seq_parallelism_matches_one_process(meshes, tmp_path, monkeypatch):
    """train_transformer(seq_parallelism=2) on 2 ranks against one process's
    run: the logged losses within 1e-5 relative, the final parameters
    within 1e-4 relative / 5e-5 absolute (Adam's noise on gradients near 0,
    which this run does not record), the replicas bit-equal."""
    results, root, _, dataset = meshes
    zero, first = (r['loop'] for r in results[(1, 2, 1)][0])
    # no TensorBoard sink, as in the ranks: it imports TensorFlow
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    model, state = ttt.train_transformer(LOOP, dataset, str(tmp_path), **LOOP_KWARGS)
    assert zero['step'] == first['step'] == state.step == 4
    for name, value in model.state_dict().items():
        assert torch.equal(zero['params'][name], first['params'][name]), name
        torch.testing.assert_close(zero['params'][name], value, rtol=RTOL, atol=NOISE_ATOL,
                                   msg=name)

    def losses(job):
        with open(os.path.join(job, 'metrics.jsonl')) as f:
            records = [json.loads(line) for line in f]
        return [(r['step'], r.get('train/loss', r.get('val/loss'))) for r in records]

    ranks, one = losses(os.path.join(root, '1x2x1', 'loop')), losses(str(tmp_path))
    assert [s for s, _ in ranks] == [s for s, _ in one] and len(one) == 6
    for (_, a), (_, b) in zip(ranks, one):
        assert a == pytest.approx(b, rel=LOSS_RTOL)


def test_cli_seq_parallelism_reaches_the_loop(monkeypatch, tmp_path):
    """`train transformer --seq-parallelism N` hands N to train_transformer
    (the JAX package's flag); without it, 1."""
    from viewformer_tpu_torch import cli
    from viewformer_tpu_torch.config import VQGANConfig, save_config

    codebook = str(tmp_path / 'codebook')
    save_config(dataclasses.replace(VQGANConfig(), n_embed=16), codebook)
    calls = []
    monkeypatch.setattr(ttt, 'train_transformer', lambda *a, **kw: calls.append(kw))
    base = ['train', 'transformer', '--dataset', 'D', '--codebook-model', codebook,
            '--job-dir', str(tmp_path / 'job'), '--device', 'cpu']
    cli.main(base + ['--seq-parallelism', '2'])
    cli.main(base)
    assert [kw['seq_parallelism'] for kw in calls] == [2, 1]
    assert mesh_lib.current_mesh().shape == {'data': 1, 'seq': 1, 'model': 1}
