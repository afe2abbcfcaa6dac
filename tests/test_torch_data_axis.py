"""The data axis of inference (parallel/distributed.py's batch_rows,
gather_rows, map_rows and gather_tensor_rows) on the CPU: two gloo
processes (torch.multiprocessing, spawn, a file rendezvous) run
`generate-codes` and `evaluate transformer|transformer-multictx|codebook`
through the CLI at --fp32, each rank writing under its own directory,
against the same commands in one process. One spawn runs every command;
the tests read what it wrote.

  generate-codes: the shards, indexes and info.json byte-equal to one
                  process's (a padded tail batch), rank 1 writes nothing,
                  and a batch that 2 does not divide raises
  evaluate:       results.json within 1e-6 and the stored files equal (the
                  last batch of 1 sequence, or 3 frames, runs on rank 0
                  alone), rank 1 writes nothing
"""
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from viewformer_tpu_torch import cli
from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig
from viewformer_tpu_torch.data.dataset import generate_dataset_from_loader
from viewformer_tpu_torch.data.loaders import build
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.parallel import distributed
from viewformer_tpu_torch.train.checkpoint import CheckpointManager

WORLD = 2
SPAWN_TIMEOUT = 60
TOL = 1e-6
# 5 sequences of 3 frames: transformer batches of 2, 2 and 1 sequences,
# codebook batches of 4, 4, 4 and 3 frames
SEQUENCES, FRAMES, BATCH, CODEBOOK_BATCH = 5, 3, 2, 4
EVALUATE = ('transformer', 'transformer-multictx', 'codebook')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tensors here are tiny, and the CPU's thread
    pool only adds contention when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_inputs(root):
    """A colors image dataset at 16 px (train 3 sequences of 5 frames, test
    2) and random-weight job dirs of a tiny codebook and transformer."""
    for split, n in (('train', 3), ('test', 2)):
        loader = build('colors', split=split, num_sequences=n, sequence_size=5, image_size=16)
        generate_dataset_from_loader(loader, split, os.path.join(root, 'images', 'colors'),
                                     max_sequences_per_shard=2, progress=False)
    gen = torch.Generator().manual_seed(0)
    models = {
        'codebook': AutoModel.from_config(VQGANConfig(
            ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], z_channels=32,
            embed_dim=8, n_embed=16, image_size=16), device='cpu', generator=gen),
        'transformer': AutoModel.from_config(MIGTConfig(
            n_embeddings=16, n_head=2, d_model=32, n_layer=2, token_image_size=8,
            sequence_size=FRAMES), device='cpu', generator=gen)}
    for name, model in models.items():
        mgr = CheckpointManager(os.path.join(root, name), model.config)
        mgr.save(0, {'model': model.state_dict()})
        mgr.close()


def _commands(root, out, batch=CODEBOOK_BATCH):
    """The CLI commands of one run, writing under `out`."""
    common = ['--fp32', '--device', 'cpu']
    yield ['generate-codes', '--dataset', os.path.join(root, 'images'), '--output',
           os.path.join(out, 'codes'), '--model', os.path.join(root, 'codebook'),
           '--batch-size', str(batch), *common]
    loader = ['--loader', 'colors', '--loader-num-sequences', str(SEQUENCES),
              '--loader-sequence-size', str(FRAMES), '--codebook-model',
              os.path.join(root, 'codebook'), '--num-store-images', '100', *common]
    for kind in EVALUATE:
        argv = ['evaluate', kind, *loader, '--job-dir', os.path.join(out, kind)]
        if kind == 'codebook':
            argv += ['--batch-size', str(CODEBOOK_BATCH)]
        else:
            argv += ['--transformer-model', os.path.join(root, 'transformer'),
                     '--batch-size', str(BATCH), '--sequence-size', str(FRAMES)]
        yield argv


def _worker(rank, init_file, root):
    torch.set_num_threads(1)
    # torchrun's variables: cli joins the group already initialized here
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD))
    dist.init_process_group('gloo', init_method=f'file://{init_file}', rank=rank,
                            world_size=WORLD)
    try:
        mapped = distributed.map_rows(lambda x: x * 10, np.arange(5))
        as_dict = distributed.map_rows(lambda x, y: {'x': x, 'y': y, 'none': None},
                                       np.arange(4), -np.arange(4))
        record = {'rows': [str(distributed.batch_rows(n)) for n in (4, 3)],
                  'mapped': None if mapped is None else mapped.tolist(),
                  'mapped_dict': None if as_dict is None else {
                      k: None if v is None else v.tolist() for k, v in as_dict.items()},
                  'gathered': distributed.gather_tensor_rows(torch.full((2,), rank)).tolist()}
        for argv in _commands(root, os.path.join(root, f'rank{rank}')):
            cli.main(argv)
        try:
            cli.main(next(_commands(root, os.path.join(root, f'odd{rank}'), batch=3)))
        except ValueError as e:
            record['odd_batch_error'] = str(e)
        with open(os.path.join(root, f'record{rank}.json'), 'w') as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The root: each rank's record, the ranks' outputs (rank0, rank1) and
    one process's (one)."""
    root = str(tmp_path_factory.mktemp('data_axis'))
    _write_inputs(root)
    context = torch.multiprocessing.start_processes(
        _worker, args=(os.path.join(root, 'rendezvous'), root), nprocs=WORLD, join=False,
        start_method='spawn')
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not context.join(timeout=1):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            pytest.fail(f'the {WORLD} ranks did not finish in {SPAWN_TIMEOUT} s')
    assert not any(process.is_alive() for process in context.processes)
    for argv in _commands(root, os.path.join(root, 'one')):
        cli.main(argv)
    return root


def _files(path):
    """{relative path: bytes} of every file under path."""
    out = {}
    for d, _, names in os.walk(path):
        for name in names:
            with open(os.path.join(d, name), 'rb') as f:
                out[os.path.relpath(os.path.join(d, name), path)] = f.read()
    return out


def _record(root, rank):
    with open(os.path.join(root, f'record{rank}.json')) as f:
        return json.load(f)


def test_rows_of_each_rank(runs):
    """A divisible batch splits in rank order; an indivisible one runs on
    rank 0 alone; the gathers return every rank's rows in global order, the
    host rows (map_rows) on rank 0 only, the tensors on every rank."""
    for rank in range(WORLD):
        record = _record(runs, rank)
        assert record['rows'] == [str(slice(2 * rank, 2 * rank + 2)),
                                  str(slice(0, 3 if rank == 0 else 0))]
        assert record['mapped'] == ([0, 10, 20, 30, 40] if rank == 0 else None)
        assert record['mapped_dict'] == ({'x': [0, 1, 2, 3], 'y': [0, -1, -2, -3], 'none': None}
                                         if rank == 0 else None)
        assert record['gathered'] == [0, 0, 1, 1]
    assert distributed.batch_rows(3) == slice(0, 3)  # no process group: one process


def test_generate_codes_on_two_ranks_equals_one_process(runs):
    one = _files(os.path.join(runs, 'one', 'codes'))
    assert 'info.json' in one and sum(name.endswith('.tfrecord') for name in one) == 3
    assert _files(os.path.join(runs, 'rank0', 'codes')) == one
    assert not os.path.exists(os.path.join(runs, 'rank1'))


def test_generate_codes_refuses_an_indivisible_batch(runs):
    for rank in range(WORLD):
        assert _record(runs, rank)['odd_batch_error'] == 'batch 3 not divisible by data axis 2'
        assert not os.path.exists(os.path.join(runs, f'odd{rank}'))


@pytest.mark.parametrize('kind', EVALUATE)
def test_evaluate_on_two_ranks_equals_one_process(runs, kind):
    one = _files(os.path.join(runs, 'one', kind))
    ranks = _files(os.path.join(runs, 'rank0', kind))
    assert sorted(ranks) == sorted(one)
    stored = SEQUENCES * FRAMES if kind == 'codebook' else SEQUENCES
    assert sum(name.endswith('-gt.png') for name in one) == stored
    expected, got = json.loads(one.pop('results.json')), json.loads(ranks.pop('results.json'))

    def close(a, b, key=''):
        if isinstance(b, dict):
            assert list(a) == list(b), key
            for k in b:
                close(a[k], b[k], f'{key}/{k}')
        elif b is None:
            assert a is None, key
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=key)

    close(got, expected)
    for name, data in one.items():
        if name.endswith('.png'):
            assert ranks[name] == data, name
        else:  # cameras: the rows of another batch size, in f32
            np.testing.assert_allclose(np.load(os.path.join(runs, 'rank0', kind, name)),
                                       np.load(os.path.join(runs, 'one', kind, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
    assert not os.path.exists(os.path.join(runs, 'rank1'))
