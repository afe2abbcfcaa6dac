"""The port's incremental MIGT path (prefill / generate / localize /
reduce_cameras) against the JAX package, with weights through the bridge,
and against the port's own one-shot forward."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_migt_incremental import TINY
from test_torch_config import to_port
from viewformer_tpu.evaluate import transformer as jev
from viewformer_tpu.models import migt_incremental as jinc
from viewformer_tpu.models.migt import MIGT
from viewformer_tpu.utils.schedules import Schedule
from viewformer_tpu_torch.evaluate import transformer as tev
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.models import migt_incremental as tinc
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

CONFIG = dataclasses.replace(TINY, localization_weight=Schedule.from_str('1'))


@pytest.fixture(scope='module')
def setup():
    jmodel = MIGT(CONFIG)
    rng = np.random.RandomState(0)
    poses = rng.randn(2, 5, 7).astype(np.float32)
    poses[..., 3:] /= np.linalg.norm(poses[..., 3:], axis=-1, keepdims=True)
    tokens = rng.randint(0, 16, (2, 5, 2, 2))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(poses),
                                           jnp.asarray(tokens), compute_losses=True))
    port = AutoModel.from_config(to_port(CONFIG), device='cpu',
                                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax(port, variables))
    return jmodel, variables['params'], port, poses, tokens


@pytest.mark.parametrize('pad', [False, True])
def test_prefill_kv_matches_jax(setup, pad):
    """With pad, the last frame is an inert pad frame (valid_frames=T-1)."""
    jmodel, params, port, poses, tokens = setup
    T = 5 if pad else 4
    valid = 4 if pad else None
    jcache = jinc.prefill_cache(jmodel, params, jnp.asarray(tokens[:, :T]),
                                jnp.asarray(poses[:, :T]), valid_frames=valid)
    with torch.no_grad():
        cache = tinc.prefill_cache(port, torch.from_numpy(tokens[:, :T]),
                                   torch.from_numpy(poses[:, :T]), valid_frames=valid)
    assert cache.n == int(jcache['n']) == 4 and cache.grid == jcache.grid
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache['k']), atol=1e-4)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache['v']), atol=1e-4)


def test_generate_and_localize_match_jax(setup):
    """The port prefills the 4 context frames directly; JAX prefills them
    with an inert pad frame, as its serving path does."""
    jmodel, params, port, poses, tokens = setup
    jcache = jinc.prefill_cache(jmodel, params, jnp.asarray(tokens), jnp.asarray(poses),
                                valid_frames=4)
    expected_logits = np.asarray(jinc.generate_frame(jmodel, params, jcache,
                                                     jnp.asarray(poses[:, -1])))
    expected_pred = jinc.localize_frame(jmodel, params, jcache, jnp.asarray(tokens[:, -1]))
    expected_cams = np.asarray(jmodel.apply({'params': params}, expected_pred[:, None],
                                            method=MIGT.reduce_cameras))
    with torch.no_grad():
        cache = tinc.prefill_cache(port, torch.from_numpy(tokens[:, :4]),
                                   torch.from_numpy(poses[:, :4]))
        logits = tinc.generate_frame(port, cache, torch.from_numpy(poses[:, -1]))
        pred = tinc.localize_frame(port, cache, torch.from_numpy(tokens[:, -1]))
        cams = port.reduce_cameras(pred[:, None])
    assert logits.shape == expected_logits.shape == (2, 2, 2, 16)
    np.testing.assert_allclose(logits.numpy(), expected_logits, atol=2e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(expected_pred), atol=1e-4)
    np.testing.assert_allclose(cams.numpy(), expected_cams, atol=1e-4)


@pytest.mark.parametrize('n,pad', [(1, False), (2, False), (3, False), (3, True)])
def test_incremental_matches_port_one_shot(setup, n, pad):
    """The port's incremental path against its own one-shot forward, for
    every context size n: prefill n frames (with pad, plus an inert trailing
    frame, valid_frames=n), generate the query frame; the one-shot forward
    sees the n frames and a mask-token frame with the query pose."""
    _, _, port, poses, tokens = setup
    query = np.full_like(tokens[:, :1], port.mask_token)
    one_shot_poses = np.concatenate([poses[:, :n], poses[:, -1:]], 1)
    context = n + 1 if pad else n
    with torch.no_grad():
        expected = port(torch.from_numpy(one_shot_poses),
                        torch.from_numpy(np.concatenate([tokens[:, :n], query], 1)))
        cache = tinc.prefill_cache(port, torch.from_numpy(tokens[:, :context]),
                                   torch.from_numpy(poses[:, :context]), valid_frames=n)
        logits = tinc.generate_frame(port, cache, torch.from_numpy(poses[:, -1]))
    assert cache.n == n
    np.testing.assert_allclose(logits.numpy(), expected['logits'][:, -1].numpy(), atol=2e-4)


def test_localize_matches_port_one_shot_eval(setup):
    """localize_frame against the port's one-shot eval forward, where the
    query frame rides stream 0 with the localization token as its pose."""
    _, _, port, poses, tokens = setup
    with torch.no_grad():
        expected = port(torch.from_numpy(poses[:, :3]), torch.from_numpy(tokens[:, :4]))
        cache = tinc.prefill_cache(port, torch.from_numpy(tokens[:, :3]),
                                   torch.from_numpy(poses[:, :3]))
        pred = tinc.localize_frame(port, cache, torch.from_numpy(tokens[:, 3]))
    np.testing.assert_allclose(pred.numpy(), expected['pose_prediction'][:, -1].numpy(),
                               atol=2e-4)


@pytest.mark.parametrize('options', [
    dict(),                                   # TINY: localization off, no pose head
    dict(localization_weight=Schedule.from_str('1')),
    dict(use_dynamic_pose_loss=True),
])
def test_parameter_tree_matches_jax(options):
    """The port holds exactly the JAX parameters of each config variant, in
    the same shapes once converted."""
    config = dataclasses.replace(TINY, **options)
    variables = jax.device_get(MIGT(config).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 7)), jnp.zeros((1, 4, 2, 2), jnp.int32),
        compute_losses=True))
    port = AutoModel.from_config(to_port(config), device='cpu')
    state = state_dict_from_jax(port, variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert hasattr(port, 'pose_criterion') == port.use_localization
    np.testing.assert_array_equal(state['h.1.attn.c_attn.weight'].numpy(),
                                  variables['params']['h_1']['attn']['c_attn']['kernel'].T)


def test_init_cache_matches_jax():
    jcache = jinc.init_cache(TINY, 3, 6)
    cache = tinc.init_cache(to_port(TINY), 3, 6, device='cpu')
    assert tuple(cache.k.shape) == jcache['k'].shape == tuple(cache.v.shape)
    assert cache.n == 0 and cache.grid == jcache.grid
    assert not cache.k.any() and not cache.v.any()


def test_camera_helpers_match_jax():
    rng = np.random.RandomState(4)
    cameras = rng.randn(3, 5, 7).astype(np.float32)
    relative, transform = tev.to_relative_cameras(torch.from_numpy(cameras))
    jrelative, jtransform = jev.to_relative_cameras(jnp.asarray(cameras))
    np.testing.assert_allclose(relative.numpy(), np.asarray(jrelative), atol=1e-5)
    np.testing.assert_allclose(transform.numpy(), np.asarray(jtransform), atol=1e-6)
    np.testing.assert_allclose(tev.normalize_cameras(relative).numpy(),
                               np.asarray(jev.normalize_cameras(jrelative)), atol=1e-6)
    back = tev.from_relative_cameras(relative, transform)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        jev.from_relative_cameras(jrelative, jtransform)), atol=1e-5)
