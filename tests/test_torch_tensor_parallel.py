"""Tensor parallelism of the port (parallel/mesh.py, parallel/sharding.py,
the `model` axis) on the CPU: gloo processes (torch.multiprocessing, spawn,
a file rendezvous, one intra-op thread) on the meshes 1x1x2 and 2x1x2
(data x seq x model), against the JAX package's step on the same meshes of
its CPU devices (shard_transformer_state) and against the port's one
process. One spawn a world size runs every case of that mesh; both spawns
run while JAX compiles.

  steps:       2 train steps at dropout 0 from numpy-seeded weights
               (through state_dict_from_jax), each tensor's gradient
               clipped to a norm of 0.05 (a sharded tensor by its whole
               norm, summed over `model`): the loss within 1e-5
               relative, the gradients and the updated parameters within
               1e-4 relative / 1e-6 absolute of JAX's (tests/
               test_tensor_parallel.py's bars) and of the port's one
               process
  dropout:     at dropout 0.1 the attention kernels' seed words differ over
               the (data, model) shards; the replicas of a shard stay equal;
               on 1x1x2 the steps equal one process that draws each head
               group's mask with its shard's words
  checkpoint:  train_transformer on 1x1x2 writes the one-process layout,
               which load_model reads in one process, and a run killed
               after its step-2 save resumes bit-equal to the uninterrupted
               run

The helpers here (the spawn, the port's steps, the comparisons) also serve
tests/test_torch_sequence_parallel.py. JAX is imported only in the test
process, never in the ranks."""
import dataclasses
import importlib
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from viewformer_tpu_torch.config import MIGTConfig
from viewformer_tpu_torch.ops import attention_cuda
from viewformer_tpu_torch.parallel import distributed, sharding
from viewformer_tpu_torch.parallel import mesh as mesh_lib
from viewformer_tpu_torch.train import transformer as ttt
from viewformer_tpu_torch.utils.schedules import Schedule

SPAWN_TIMEOUT = 120
CONFIG = MIGTConfig(n_embeddings=16, n_head=4, d_model=64, n_layer=2, dropout=0.0,
                    sequence_size=4, token_image_size=2, total_steps=100, n_loss_skip=1,
                    learning_rate=1e-3, weight_decay=0.01, batch_size=4,
                    gradient_clip_val=0.05, localization_weight=Schedule.from_str('1'))
DROPOUT = dataclasses.replace(CONFIG, dropout=0.1, random_pose_multiplier=2.0)
STEPS = 2
# tests/test_tensor_parallel.py:95-102
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
# Adam turns a gradient within f32 noise of 0 into an update of up to lr,
# different for each order of the sums (tests/test_torch_codebook.py); the
# key third of c_attn's bias has a true gradient of 0 (tests/
# test_torch_train.py). Such elements (a gradient of exactly 0 moves only
# by the weight decay, and is not one) are held within lr * 5e-2 instead.
NOISE_GRAD, NOISE_ATOL = 1e-6, 5e-5


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch(B=4, config=CONFIG, seed=0):
    rng = np.random.RandomState(seed)
    poses = rng.randn(B, config.sequence_size, 7).astype(np.float32)
    poses[..., 3:] /= np.linalg.norm(poses[..., 3:], axis=-1, keepdims=True)
    size = config.token_image_size
    tokens = rng.randint(0, 16, (B, config.sequence_size, size, size)).astype(np.int32)
    return poses, tokens


def port_steps(config, initial=None, steps=STEPS, record=None):
    """`steps` port train steps in f32 on the CPU on this rank's rows of
    batch(), on the current mesh (its `model` axis sharding the state, its
    `seq` axis the frames), from `initial` (a one-process state_dict; else
    generator seed 0), step i's seeds from generator 7 + i: (metrics, the
    one-process layout of each step's averaged gradients before the clip,
    of the final parameters).
    record: a list that collects the attention kernels' seed words of the
    first step."""
    mesh = mesh_lib.current_mesh()
    model, state = ttt.init_transformer_state(
        config, torch.Generator().manual_seed(0), torch.float32, 'cpu', warmup_steps=2)
    if initial is not None:
        model.load_state_dict(initial)
    sharding.shard_transformer_state(model, state, mesh)
    poses, tokens = batch(config=config)
    poses = distributed.shard_rows(torch.from_numpy(poses))
    tokens = distributed.shard_rows(torch.from_numpy(tokens).long())
    step = ttt.make_transformer_train_step(model, config)
    metrics, grads = [], []
    clip = ttt.clip_per_tensor_norm
    assert config.gradient_clip_val > 0

    def record_then_clip(*args):
        # the averaged gradients, before the clip scales them
        grads.append(sharding.unshard_state_dict(
            {name: p.grad.clone() for name, p in model.named_parameters()}, mesh))
        return clip(*args)

    for i in range(steps):
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(ttt, 'clip_per_tensor_norm', record_then_clip)
            if record is not None and i == 0:
                record_attention_seeds(patch, record)
            state, m = step(state, (poses, tokens), torch.Generator().manual_seed(7 + i))
        metrics.append({key: float(value) for key, value in m.items()})
    return metrics, grads, sharding.unshard_state_dict(model.state_dict(), mesh)


def record_attention_seeds(patch, calls):
    for name in ('block_causal_attention_dropout_fwd', 'branch_attention_dropout_fwd'):
        def wrapped(*args, _fn=getattr(attention_cuda, name), _name=name, **kwargs):
            calls.append((_name, tuple(int(w) for w in args[-2])))
            return _fn(*args, **kwargs)
        patch.setattr(attention_cuda, name, wrapped)


def _worker(rank, world, shape, module, out_dir, args):
    torch.set_num_threads(1)
    sys.modules['torch.utils.tensorboard'] = None  # no TensorBoard sink: it imports TensorFlow
    dist.init_process_group('gloo', init_method=f'file://{out_dir}/rendezvous', rank=rank,
                            world_size=world)
    try:
        D, S, M = shape
        mesh_lib.create_mesh(D, M, seq_parallelism=S)
        results = importlib.import_module(module).rank_cases(rank, shape, out_dir, *args)
        torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def start(shape, module, out_dir, *args):
    """Spawn the ranks of a D x S x M mesh, each running
    module.rank_cases(rank, shape, out_dir, *args); returns a handle for
    join()."""
    world = int(np.prod(shape))
    os.makedirs(out_dir, exist_ok=True)
    return torch.multiprocessing.start_processes(
        _worker, args=(world, shape, module, out_dir, args), nprocs=world, join=False,
        start_method='spawn'), world, out_dir


def join(handle):
    """Each rank's results of a start()."""
    context, world, out_dir = handle
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not context.join(timeout=1):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            pytest.fail(f'the {world} ranks did not finish in {SPAWN_TIMEOUT} s')
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


def jax_steps(shape, config=CONFIG, steps=STEPS):
    """`steps` of the JAX package's train steps on a D x S x M mesh of its
    CPU devices (shard_transformer_state over `model`, sp_axis='seq' over
    `seq`) on batch(), from numpy-seeded weights: the initial parameters,
    each step's loss and gradients (value_and_grad on the mesh before the
    step) and the parameters after the last, as port state_dicts
    (state_dict_from_jax)."""
    import jax
    import jax.numpy as jnp

    from test_torch_config import to_port
    from viewformer_tpu.models.migt import MIGT as JaxMIGT
    from viewformer_tpu.parallel import mesh as jmesh
    from viewformer_tpu.parallel.sharding import shard_transformer_state
    from viewformer_tpu.train import transformer as jtt
    from viewformer_tpu_torch.models.migt import MIGT
    from viewformer_tpu_torch.utils.convert import state_dict_from_jax

    jconfig = jax_config(config)
    D, S, M = shape
    optimizer, _ = jtt.create_transformer_optimizer(jconfig, warmup_steps=2)
    model = JaxMIGT(jconfig, sp_axis='seq' if S > 1 else None)
    poses, tokens = batch(config=config)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), poses[:1], tokens[:1],
                                               compute_losses=True))['params']
    rng = np.random.RandomState(1)

    def leaf(path, spec):
        value = rng.standard_normal(spec.shape).astype(np.float32) * 0.02
        return jnp.asarray(value + (1.0 if path[-1].key == 'scale' else 0.0))

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    state = jtt.TransformerTrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
    train_step = jtt.make_transformer_train_step(model, jconfig, optimizer, donate=False)

    @jax.jit
    def grads_of(params, data):
        def loss_fn(p):
            out = model.apply({'params': p}, *data, compute_losses=True, deterministic=False,
                              step=jnp.zeros((), jnp.int32),
                              rngs={'dropout': jax.random.PRNGKey(1),
                                    'pose_noise': jax.random.PRNGKey(2)})
            return jnp.mean(out['loss'])
        return jax.value_and_grad(loss_fn)(params)

    port = MIGT(to_port(jconfig))

    def as_port(tree):
        return state_dict_from_jax(port, {'params': jax.device_get(tree)})

    initial = as_port(state.params)
    mesh = jmesh.create_mesh(D, M, jax.devices()[:D * S * M], seq_parallelism=S)
    losses, grads = [], []
    with mesh:
        data = jmesh.shard_batch(mesh, (poses, tokens))
        state = (shard_transformer_state(state, mesh) if M > 1
                 else jmesh.replicate(mesh, state))
        for _ in range(steps):
            loss, g = grads_of(state.params, data)
            state, metrics = train_step(state, data, jax.random.PRNGKey(0))
            losses.append(float(metrics['loss']))
            grads.append(as_port(g))
    return initial, losses, grads, as_port(state.params)


def jax_config(config):
    """The JAX package's MIGTConfig of the port's `config`."""
    from viewformer_tpu.config import MIGTConfig as JaxConfig

    return JaxConfig.from_dict(config.asdict())


def assert_close(value, expected, msg=''):
    torch.testing.assert_close(torch.as_tensor(value), torch.as_tensor(expected), rtol=RTOL,
                               atol=ATOL, msg=msg)


def assert_steps_equal(port, expected_losses, expected_grads, expected_params):
    """A run's losses, gradients and parameters (port_steps) against
    another's: the bars of the module docstring."""
    metrics, grads, params = port
    for step, (m, loss) in enumerate(zip(metrics, expected_losses)):
        assert m['loss'] == pytest.approx(loss, rel=LOSS_RTOL), step
    for step, (g, expected) in enumerate(zip(grads, expected_grads)):
        assert g.keys() == expected.keys()
        for name in expected:
            assert_close(g[name], expected[name], f'step {step}: {name}')
    noise = {}
    for name in expected_params:
        magnitude = torch.stack([g[name].abs() for g in expected_grads])
        noise[name] = (magnitude.amin(0) < NOISE_GRAD) & (magnitude.amax(0) > 0)
    d = CONFIG.d_model
    for name, expected in expected_params.items():
        value = params[name]
        quiet = noise[name]
        if name.endswith('attn.c_attn.bias'):
            quiet = quiet.clone()
            quiet[2 * d:] = True
        torch.testing.assert_close(value[quiet], expected[quiet], rtol=0, atol=NOISE_ATOL,
                                   msg=name)
        assert_close(value[~quiet], expected[~quiet], name)
        assert quiet.float().mean() < 0.05 or name.endswith('attn.c_attn.bias'), name


def seed_words_by_shard(results, shape):
    """{(data, model) shard: the attention seed words its ranks used} (one
    entry a shard: its `seq` ranks must agree)."""
    D, S, M = shape
    by_shard = {}
    for rank, calls in enumerate(results):
        shard = (rank // (S * M), rank % M)
        assert by_shard.setdefault(shard, calls) == calls, (rank, shard)
    return by_shard


# the ranks' side ------------------------------------------------------------

def rank_cases(rank, shape, out_dir, initial, dataset):
    """Every case of a mesh of this module, on one rank."""
    seeds = []
    out = {'steps': port_steps(CONFIG, initial),
           'dropout': port_steps(DROPOUT, record=seeds), 'seeds': seeds}
    if shape == (1, 1, 2):
        out['checkpoint'] = checkpoint_case(out_dir, dataset)
    return out


LOOP = dataclasses.replace(DROPOUT, token_image_size=4, random_pose_multiplier=1.0)
LOOP_KWARGS = dict(total_steps=4, epochs=2, log_every=1, use_bf16=False, progress=False,
                   profile_batch=0, device='cpu')


class Killed(Exception):
    pass


def checkpoint_case(out_dir, dataset):
    """train_transformer on the current mesh, uninterrupted, and killed at
    its third step then resumed: the final parameters of both (one-process
    layout) and the uninterrupted job dir."""
    mesh = mesh_lib.current_mesh()
    uninterrupted = os.path.join(out_dir, 'uninterrupted')
    model, state = ttt.train_transformer(LOOP, dataset, uninterrupted, mesh=mesh, **LOOP_KWARGS)
    final = sharding.unshard_state_dict(model.state_dict(), mesh)

    make = ttt.make_transformer_train_step

    def make_killable(model, config):
        step = make(model, config)

        def killable(state, batch, generator=None):
            if state.step == 2:
                raise Killed
            return step(state, batch, generator)
        return killable

    job = os.path.join(out_dir, 'killed')
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ttt, 'make_transformer_train_step', make_killable)
        with pytest.raises(Killed):
            ttt.train_transformer(LOOP, dataset, job, mesh=mesh, **LOOP_KWARGS)
    resumed, resumed_state = ttt.train_transformer(LOOP, dataset, job, mesh=mesh, **LOOP_KWARGS)
    return {'final': final, 'step': state.step, 'resumed_step': resumed_state.step,
            'resumed': sharding.unshard_state_dict(resumed.state_dict(), mesh),
            'local_shapes': {name: tuple(p.shape) for name, p in model.named_parameters()}}


# the test process' side -------------------------------------------------------

MESHES = ((1, 1, 2), (2, 1, 2))


@pytest.fixture(scope='module')
def meshes(tmp_path_factory):
    """{mesh: (each rank's results, JAX's steps on that mesh)}, the job
    dirs' root and the one-process port steps."""
    from test_torch_ddp import _write_tokens

    root = str(tmp_path_factory.mktemp('tp'))
    dataset = os.path.join(root, 'tokens')
    _write_tokens(dataset)
    reference = jax_steps(MESHES[0])
    initial = reference[0]
    handles = {shape: start(shape, __name__, os.path.join(root, 'x'.join(map(str, shape))),
                            initial, dataset) for shape in MESHES}
    jax_runs = {MESHES[0]: reference, MESHES[1]: jax_steps(MESHES[1])}
    results = {shape: (join(handle), jax_runs[shape]) for shape, handle in handles.items()}
    one = port_steps(CONFIG, initial)
    return results, root, one, dataset


@pytest.mark.parametrize('shape', MESHES, ids=lambda s: 'x'.join(map(str, s)))
def test_tensor_parallel_steps_match_jax(meshes, shape):
    """Each rank's 2 steps on the mesh equal JAX's 2 steps on its mesh of
    the same shape."""
    results, _, _, _ = meshes
    ranks, (_, losses, grads, params) = results[shape]
    for rank in ranks:
        assert_steps_equal(rank['steps'], losses, grads, params)


@pytest.mark.parametrize('shape', MESHES, ids=lambda s: 'x'.join(map(str, s)))
def test_tensor_parallel_steps_match_one_process(meshes, shape):
    """The same steps equal the port's one process over the whole batch."""
    results, _, one, _ = meshes
    metrics, grads, params = one
    for rank in results[shape][0]:
        assert_steps_equal(rank['steps'], [m['loss'] for m in metrics], grads, params)


def test_dropout_seed_words_differ_by_shard(meshes):
    """At dropout 0.1 each (data, model) shard folds its index r * M + m
    into the attention kernels' seed words: B5 and B7 a layer, forward and
    remat recompute, with words of its own; the replicas end equal."""
    results, _, _, _ = meshes
    for shape in MESHES:
        ranks = results[shape][0]
        by_shard = seed_words_by_shard([r['seeds'] for r in ranks], shape)
        assert len(by_shard) == shape[0] * shape[2]
        words = [tuple(w for _, w in calls) for calls in by_shard.values()]
        assert all(len(w) == 4 * CONFIG.n_layer for w in words)
        for position in range(len(words[0])):
            assert len({w[position] for w in words}) == len(words), position
        for rank in ranks[1:]:
            for name, value in rank['dropout'][2].items():
                assert torch.equal(value, ranks[0]['dropout'][2][name]), name


def test_dropout_steps_match_one_process_with_shard_seeds(meshes):
    """At dropout 0.1 the 1x1x2 steps equal one process whose attention
    draws each head group's mask with that shard's seed words
    (chip_smoke.shard_seeded_attention, the reference of its phase 14),
    within the bars of the dropout-0 steps."""
    from chip_smoke import shard_seeded_attention

    results = meshes[0]
    with shard_seeded_attention(2):
        metrics, grads, params = port_steps(DROPOUT)
    for rank in results[(1, 1, 2)][0]:
        assert_steps_equal(rank['dropout'], [m['loss'] for m in metrics], grads, params)


def test_checkpoint_is_one_process_layout_and_resumes(meshes):
    """train_transformer on 1x1x2: each rank holds half of every sharded
    tensor; the job dir holds the one-process layout (its last checkpoint
    equals the final parameters, and load_model reads its best in one
    process); killed
    after the step-2 save and resumed, the run ends bit-equal."""
    from viewformer_tpu_torch.models import load_model
    from viewformer_tpu_torch.models.migt import MIGT
    from viewformer_tpu_torch.train.checkpoint import restore_checkpoint

    results, root, _, _ = meshes
    ranks = [r['checkpoint'] for r in results[(1, 1, 2)][0]]
    full = MIGT(LOOP)
    full_shapes = {name: tuple(p.shape) for name, p in full.named_parameters()}
    for case in ranks:
        assert case['step'] == case['resumed_step'] == 4
        for name, shape in case['local_shapes'].items():
            layout = sharding.param_layout(name)
            if layout == 'replicated':
                assert shape == full_shapes[name], name
            else:
                axis = -1 if layout == 'row' else 0
                assert shape[axis] * 2 == full_shapes[name][axis], name
        for name, value in case['final'].items():
            assert torch.equal(case['resumed'][name], value), name
            assert torch.equal(ranks[0]['final'][name], value), name
    job = os.path.join(root, '1x1x2', 'uninterrupted')
    restored, step = restore_checkpoint(job, prefer='last')
    assert step == 4
    saved = restored['model']
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        k: tuple(v.shape) for k, v in full.state_dict().items()}
    for name, value in ranks[0]['final'].items():
        assert torch.equal(saved[name], value), name
    moments = restored['optimizer']['state']
    names = [name for group in restored['optimizer']['param_groups'] for name in group['params']]
    assert len(moments) == len(names) == len(full_shapes)
    best, _ = restore_checkpoint(job)
    loaded = load_model(job, torch.float32, 'cpu').state_dict()
    assert loaded.keys() == best['model'].keys()
    for name, value in best['model'].items():
        assert torch.equal(loaded[name], value), name


def test_param_layouts_match_jax():
    """param_layout of each port parameter is the spec migt_param_shardings
    gives its JAX path on a model-2 mesh: column for P(None, 'model') kernels
    and P('model') biases, row for P('model', None), else replicated."""
    import jax
    from jax.sharding import PartitionSpec as P

    from test_torch_config import to_port
    from viewformer_tpu.parallel import mesh as jmesh
    from viewformer_tpu.parallel.sharding import migt_param_shardings
    from viewformer_tpu_torch.models.migt import MIGT
    from viewformer_tpu_torch.utils.convert import jax_leaves

    config = jax_config(CONFIG)
    model = MIGT(to_port(config))
    tree = {}
    for _, path, convert, tensor in jax_leaves(model):
        node = tree
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        shape = tuple(tensor.shape)
        node[path[-1]] = jax.ShapeDtypeStruct(shape[::-1] if convert else shape, 'float32')
    mesh = jmesh.create_mesh(1, 2, jax.devices()[:2])
    specs = migt_param_shardings(tree, mesh)
    expected = {P(None, 'model'): 'column', P('model'): 'column', P('model', None): 'row',
                P(): 'replicated'}
    seen = set()
    for name, path, _, _ in jax_leaves(model):
        spec = specs
        for key in path[1:]:
            spec = spec[key]
        assert sharding.param_layout(name) == expected[spec.spec], name
        seen.add(sharding.param_layout(name))
    assert seen == {'column', 'row', 'replicated'}


@pytest.mark.parametrize('size', [2, 4])
def test_c_attn_shard_holds_heads(size):
    """Rank m's rows of c_attn are rows m*d/M.. of each of the (v, q, k)
    chunks: heads m*H/M onward; unshard_state_dict on a 1x1x1 mesh and
    shard_state_dict with M = 1 leave the tensors as they are."""
    from viewformer_tpu_torch.models.migt import MIGT

    model = MIGT(CONFIG, generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    d, H = CONFIG.d_model, CONFIG.n_head
    dh = d // H
    weight, bias = state['h.0.attn.c_attn.weight'], state['h.0.attn.c_attn.bias']
    for m in range(size):
        shard = sharding.shard_state_dict(state, m, size)
        heads = slice(m * H // size, (m + 1) * H // size)
        expected = weight.reshape(3, H, dh, d)[:, heads].reshape(-1, d)
        assert torch.equal(shard['h.0.attn.c_attn.weight'], expected)
        assert torch.equal(shard['h.0.attn.c_attn.bias'],
                           bias.reshape(3, H, dh)[:, heads].reshape(-1))
        assert torch.equal(shard['h.0.attn.c_proj.weight'],
                           state['h.0.attn.c_proj.weight'][:, m * d // size:(m + 1) * d // size])
        assert torch.equal(shard['h.1.mlp.c_fc.weight'],
                           state['h.1.mlp.c_fc.weight'].chunk(size, 0)[m])
        assert torch.equal(shard['h.1.mlp.c_proj.bias'], state['h.1.mlp.c_proj.bias'])
        assert torch.equal(shard['pose_criterion.pose_classifier.c_fc.weight'],
                           state['pose_criterion.pose_classifier.c_fc.weight'])
    one = mesh_lib.current_mesh()
    assert one.shape == {'data': 1, 'seq': 1, 'model': 1}
    unsharded = sharding.unshard_state_dict(sharding.shard_state_dict(state, 0, 1), one)
    assert all(unsharded[k] is v for k, v in state.items())


def test_mesh_refusals(monkeypatch):
    """create_mesh raises JAX's assertion text when the axes do not multiply
    to the world; a model axis that does not divide the heads, and a seq
    axis that does not divide the frames, raise a ValueError."""
    from viewformer_tpu_torch.models.migt import MIGT

    with pytest.raises(ValueError, match=r'^0x1x2 != 1 devices$'):
        mesh_lib.create_mesh(model_parallelism=2)
    with pytest.raises(ValueError, match=r'^2x1x1 != 1 devices$'):
        mesh_lib.create_mesh(2)
    three = mesh_lib.Mesh({'data': 1, 'seq': 1, 'model': 3}, 0, {}, None)
    model, state = ttt.init_transformer_state(CONFIG, device='cpu', dtype=torch.float32)
    with pytest.raises(ValueError, match='does not divide n_head 4'):
        sharding.shard_transformer_state(model, state, three)
    seq = mesh_lib.Mesh({'data': 1, 'seq': 3, 'model': 1}, 0, {}, None)
    monkeypatch.setattr(mesh_lib, '_current', seq)
    assert mesh_lib.current_mesh() is seq
    poses, tokens = (torch.from_numpy(x) for x in batch())
    with pytest.raises(ValueError, match='seq axis of 3 ranks does not divide the 4 frames'):
        MIGT(CONFIG)(poses, tokens, compute_losses=True)
