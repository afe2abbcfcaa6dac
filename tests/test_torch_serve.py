"""The port's serving session (viewformer_tpu_torch.serve), its cache
capacity and extend_cache, and its JSONL protocol against the JAX package's
ServingSession and extend_cache, on the CPU with the same weights (f32).

Tolerances: logits within 1e-4 of their largest magnitude, codes equal,
uint8 pixels within 1 level (a code's decode may round the other way),
cameras within 1e-4."""
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_serve import CCONFIG, TCONFIG, one_shot_predict
from test_torch_config import to_port
from viewformer_tpu.models import migt_incremental as jinc
from viewformer_tpu.models.migt import MIGT
from viewformer_tpu.models.vqgan import VQGAN
from viewformer_tpu.serve import ServingSession as JaxSession
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.models import migt_incremental as tinc
from viewformer_tpu_torch.serve import ServingSession
from viewformer_tpu_torch.utils.convert import state_dict_from_jax


def port_model(config, variables):
    """The port's model of a JAX config with the JAX variables, f32, CPU."""
    model = AutoModel.from_config(to_port(config), device='cpu',
                                  generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(model, jax.device_get(variables)))
    return model


def save_port_job(path, model):
    """`model` saved as a job dir of the port (models.load_model reads it)."""
    from viewformer_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(path), model.config)
    mgr.save(0, {'model': model.state_dict()})
    mgr.close()
    return str(path)


def assert_logits_close(actual, expected):
    scale = np.abs(expected).max()
    assert np.abs(actual - expected).max() <= 1e-4 * scale


def assert_pixels_close(actual, expected):
    assert actual.shape == expected.shape and actual.dtype == np.uint8
    assert np.abs(actual.astype(int) - expected.astype(int)).max() <= 1


def jax_variables():
    """test_serve's models and their variables (initialised under jit, as
    eager flax init takes twice as long; the values are the same)."""
    cmodel, tmodel = VQGAN(CCONFIG), MIGT(TCONFIG)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    cvars = jax.jit(lambda a, b: cmodel.init({'params': a, 'quantizer': b},
                                             jnp.zeros((1, 32, 32, 3), jnp.float32),
                                             training=False))(k1, k2)
    tvars = jax.jit(lambda k: tmodel.init(k, jnp.zeros((1, 5, 7), jnp.float32),
                                          jnp.zeros((1, 5, 16, 16), jnp.int32),
                                          compute_losses=False))(k3)
    return cmodel, cvars, tmodel, tvars


@pytest.fixture(scope='module')
def setup():
    cmodel, cvars, tmodel, tvars = jax_variables()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8)
    cameras = rng.randn(2, 4, 7).astype(np.float32)
    cameras[..., 3:] /= np.linalg.norm(cameras[..., 3:], axis=-1, keepdims=True)
    port = (port_model(TCONFIG, tvars), port_model(CCONFIG, cvars))
    return (cmodel, cvars, tmodel, tvars), port, images, cameras


@pytest.fixture(scope='module')
def one_shot(setup):
    """(logits, codes, images) of JAX's one-shot path for the query frame 3
    over context frames 0-2."""
    jax_models, _, images, cameras = setup
    return one_shot_predict(*jax_models, images, cameras)


@pytest.fixture(scope='module')
def jax_session(setup):
    """One JAX session for the tests (each starts it anew), so its programs
    compile once."""
    cmodel, cvars, tmodel, tvars = setup[0]
    return JaxSession(tmodel, tvars, cmodel, cvars, batch_size=2, max_frames=8)


def _session(setup, max_frames=8):
    _, (transformer, codebook), _, _ = setup
    return ServingSession(transformer, codebook, batch_size=2, max_frames=max_frames)


def test_session_render_matches_jax_and_one_shot(setup, one_shot, jax_session):
    _, _, images, cameras = setup
    jsession, session = jax_session, _session(setup)
    for s in (jsession, session):
        s.start(images[:, :3], cameras[:, :3])
    assert session.context_frames == 3
    expected_logits, expected_codes, expected_images = one_shot
    logits = session.render_logits(cameras[:, 3:4])
    assert logits.shape == (2, 1, 16, 16, 16)
    assert_logits_close(logits, jsession.render_logits(cameras[:, 3:4]))
    assert_logits_close(logits[:, 0], expected_logits)
    rendered, codes = session.render(cameras[:, 3], return_tokens=True)
    np.testing.assert_array_equal(codes, expected_codes)
    assert_pixels_close(rendered, expected_images)


def test_observe_extends_context(setup, one_shot, jax_session):
    """start(2 frames) + observe(1) equals the one-shot pass over 3 context
    frames: the transform stays anchored at frame 0."""
    _, _, images, cameras = setup
    jsession, session = jax_session, _session(setup)
    for s in (jsession, session):
        s.start(images[:, :2], cameras[:, :2])
        s.observe(images[:, 2], cameras[:, 2])
    assert session.context_frames == 3
    expected_logits = one_shot[0]
    logits = session.render_logits(cameras[:, 3:4])
    assert_logits_close(logits, jsession.render_logits(cameras[:, 3:4]))
    assert_logits_close(logits[:, 0], expected_logits)


def test_localize_matches_jax(setup, jax_session):
    _, _, images, cameras = setup
    jsession, session = jax_session, _session(setup)
    for s in (jsession, session):
        s.start(images[:, :3], cameras[:, :3])
    assert session.can_localize
    predicted = session.localize(images[:, 3])
    assert predicted.shape == (2, 7)
    np.testing.assert_allclose(predicted, jsession.localize(images[:, 3]), atol=1e-4)


@pytest.mark.parametrize('n_views', [2, 3])
def test_render_many_views(setup, jax_session, n_views):
    """[B, N, 7] queries in one pass (B2's query rows N-major over the B
    scenes' caches) equal the one-view renders and JAX's vmap: a query
    paired with the other scene's cache would differ."""
    _, _, images, cameras = setup
    jsession, session = jax_session, _session(setup)
    for s in (jsession, session):
        s.start(images[:, :3], cameras[:, :3])
    queries = np.stack([cameras[:, 3], cameras[:, 0], cameras[:, 1]][:n_views], 1)
    batch, codes = session.render(queries, return_tokens=True)
    assert batch.shape == (2, n_views, 32, 32, 3)
    for n in range(n_views):
        single, single_codes = session.render(queries[:, n], return_tokens=True)
        np.testing.assert_array_equal(codes[:, n], single_codes)
        assert_pixels_close(batch[:, n], single)  # the decoder's convs at another batch
    _, jax_codes = jsession.render(queries, return_tokens=True)
    np.testing.assert_array_equal(codes, jax_codes)


def test_session_errors(setup):
    _, _, images, cameras = setup
    session = _session(setup, max_frames=3)
    with pytest.raises(RuntimeError, match='start'):
        session.render(cameras[:, 0])
    with pytest.raises(RuntimeError, match='start'):
        session.observe(images[:, 0], cameras[:, 0])
    with pytest.raises(RuntimeError, match='start'):
        session.localize(images[:, 0])
    session.start(images[:, :3], cameras[:, :3])
    with pytest.raises(RuntimeError, match='context full'):
        session.observe(images[:, 3], cameras[:, 3])
    with pytest.raises(ValueError, match='images'):
        session.start(images[:, :3, 0], cameras[:, :3])  # no frame axis
    with pytest.raises(ValueError, match='cameras'):
        session.render(cameras[:1, 0])  # one scene of two
    small = _session(setup, max_frames=2)
    with pytest.raises(ValueError, match='context size'):
        small.start(images[:, :3], cameras[:, :3])


def test_context_beyond_trained_length(setup, jax_session):
    """max_frames may exceed the trained context (sequence_size - 1 = 4)."""
    _, _, images, cameras = setup
    jsession, session = jax_session, _session(setup)
    for s in (jsession, session):
        s.start(images[:, :4], cameras[:, :4])
        for t in (0, 1):  # observe frames again: 6 > 4 context frames
            s.observe(images[:, t], cameras[:, t])
    assert session.context_frames == 6
    logits = session.render_logits(cameras[:, 3:4])
    assert np.isfinite(logits).all()
    assert_logits_close(logits, jsession.render_logits(cameras[:, 3:4]))
    assert session.render(cameras[:, 3]).shape == (2, 32, 32, 3)


def test_extend_cache_matches_prefill_and_jax(setup):
    """prefill(T, max_frames > T) then extend_cache(frame T) equals
    prefill(T + 1), and JAX's prefill(max_frames) then extend_cache."""
    (_, _, tmodel, tvars), (transformer, _), _, _ = setup
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, 16, (2, 4, 16, 16))
    poses = rng.randn(2, 4, 7).astype(np.float32)
    with torch.inference_mode():
        full = tinc.prefill_cache(transformer, torch.from_numpy(tokens), torch.from_numpy(poses))
        cache = tinc.prefill_cache(transformer, torch.from_numpy(tokens[:, :3]),
                                   torch.from_numpy(poses[:, :3]), max_frames=6)
        assert cache.k.shape[3] == 6 and cache.n == 3
        cache = tinc.extend_cache(transformer, cache, torch.from_numpy(tokens[:, 3]),
                                  torch.from_numpy(poses[:, 3]))
    assert cache.n == 4
    np.testing.assert_allclose(cache.k[:, :, :, :4].numpy(), full.k.numpy(), atol=1e-5)
    np.testing.assert_allclose(cache.v[:, :, :, :4].numpy(), full.v.numpy(), atol=1e-5)
    assert not cache.k[:, :, :, 4:].any()

    params = tvars['params']
    jcache = jinc.prefill_cache(tmodel, params, jnp.asarray(tokens[:, :3]),
                                jnp.asarray(poses[:, :3]), max_frames=6)
    jcache = jinc.extend_cache(tmodel, params, jcache, jnp.asarray(tokens[:, 3]),
                               jnp.asarray(poses[:, 3]))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache['k']), atol=1e-4)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache['v']), atol=1e-4)


def test_serve_loop_protocol(setup, tmp_path):
    """The JSONL protocol over port job dirs and PNG files: the ready
    banner, start, observe, render to a file, localize, an error, stop; the
    rendered file and camera against JAX's session on the same frames."""
    from PIL import Image

    from viewformer_tpu_torch.commands.serve import serve_loop

    (cmodel, cvars, tmodel, tvars), (transformer, codebook), _, _ = setup
    tjob = save_port_job(tmp_path / 'transformer', transformer)
    cjob = save_port_job(tmp_path / 'codebook', codebook)
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    cameras = rng.randn(4, 7).astype(np.float32)
    cameras[:, 3:] /= np.linalg.norm(cameras[:, 3:], axis=-1, keepdims=True)
    paths = []
    for i, frame in enumerate(frames):
        paths.append(str(tmp_path / f'ctx{i}.png'))
        Image.fromarray(frame).save(paths[-1])
    out_png = str(tmp_path / 'render.png')
    requests = [
        {'op': 'status'},
        {'op': 'start', 'images': paths[:2], 'cameras': cameras[:2].tolist()},
        {'op': 'observe', 'image': paths[2], 'camera': cameras[2].tolist()},
        {'op': 'render', 'camera': cameras[3].tolist(), 'output': out_png},
        {'op': 'localize', 'image': paths[3]},
        {'op': 'bogus'},
        {'op': 'stop'},
    ]
    stdout = io.StringIO()
    serve_loop(tjob, cjob, use_bfloat16=False, device='cpu',
               input_stream=io.StringIO(''.join(json.dumps(r) + '\n' for r in requests)),
               output_stream=stdout)

    responses = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert responses[0] == {'ok': True, 'op': 'ready', 'max_frames': 4, 'image_size': 32,
                            'localize': True}
    assert responses[1]['ok'] and not responses[1]['started'] and responses[1]['localize']
    assert responses[2]['ok'] and responses[2]['context_frames'] == 2
    assert responses[3]['ok'] and responses[3]['context_frames'] == 3
    assert responses[4]['ok'] and responses[4]['outputs'] == [out_png]
    assert responses[5]['ok'] and len(responses[5]['camera']) == 7
    assert not responses[6]['ok'] and 'bogus' in responses[6]['error']
    assert responses[7] == {'ok': True, 'op': 'stop'}

    jsession = JaxSession(tmodel, tvars, cmodel, cvars, batch_size=1, max_frames=4)
    jsession.start(frames[None, :2], cameras[None, :2])
    jsession.observe(frames[None, 2], cameras[None, 2])
    assert_pixels_close(np.asarray(Image.open(out_png)), jsession.render(cameras[None, 3])[0])
    np.testing.assert_allclose(responses[5]['camera'], jsession.localize(frames[None, 3])[0],
                               atol=1e-4)


def test_cli_serve(setup, tmp_path, monkeypatch, capsys):
    """`python -m viewformer_tpu_torch serve --max-frames 6 --pose-multiplier
    2 --fp32 --device cpu` reads requests from stdin."""
    from viewformer_tpu_torch import cli

    _, (transformer, codebook), _, _ = setup
    tjob = save_port_job(tmp_path / 'transformer', transformer)
    cjob = save_port_job(tmp_path / 'codebook', codebook)
    monkeypatch.setattr('sys.stdin', io.StringIO('{"op": "status"}\n{"op": "stop"}\n'))
    cli.main(['serve', '--transformer-model', tjob, '--codebook-model', cjob, '--max-frames', '6',
              '--pose-multiplier', '2', '--fp32', '--device', 'cpu'])
    responses = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert responses[0] == {'ok': True, 'op': 'ready', 'max_frames': 6, 'image_size': 32,
                            'localize': True}
    assert responses[1]['ok'] and responses[1]['max_frames'] == 6 and not responses[1]['started']
    assert responses[2] == {'ok': True, 'op': 'stop'}


def test_load_model_config_overrides(setup, tmp_path):
    """load_model sets config overrides before building the model (the pose
    head's multiplier is read at construction); bf16 keeps the f32 islands."""
    from viewformer_tpu_torch.models import load_model

    _, (transformer, _), _, _ = setup
    tjob = save_port_job(tmp_path / 'transformer', transformer)
    model = load_model(tjob, torch.bfloat16, 'cpu', pose_multiplier=2.0)
    assert model.config.pose_multiplier == 2.0
    assert model.pose_criterion.position_multiplier == 2.0
    assert model.wte.weight.dtype == torch.bfloat16
    assert model.pose_criterion.pose_classifier.c_fc.weight.dtype == torch.float32
    assert model.pose_embedding.c_fc.weight.dtype == torch.float32
    with pytest.raises(ValueError, match='no field'):
        load_model(tjob, device='cpu', bogus=1)
