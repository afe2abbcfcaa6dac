"""The port's copy of jax.random and flax's initial draw
(viewformer_tpu_torch/utils/jax_random.py, utils/convert.jax_initial_state)
against jax and flax themselves on the CPU: keys and 32-bit words bit for
bit; uniform draws bit for bit; truncated normal and lecun_normal draws
within ERFINV_ULPS f32 ULPs of each value (the port takes erfinv in f64 and
rounds it once, XLA approximates it in f32); the VQ-GAN's and the MIGT's
whole initial states against the JAX package's init_codebook_state and
init_transformer_state; and, at VQGANConfig()'s full width from JAX's seed
1337, the first training encode with its EMA update, the step at which
the codebook's live codes are decided."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from flax.core import scope as flax_scope
from flax.linen import initializers

from test_torch_config import to_port
from test_train_transformer import TINY as TINY_MIGT_BASE
from viewformer_tpu.config import VQGANConfig
from viewformer_tpu.models.vqgan import VQGAN as JaxVQGAN
from viewformer_tpu.train import codebook as jcb
from viewformer_tpu.train import transformer as jtt
from viewformer_tpu_torch.data.loaders.colors import ColorsLoader
from viewformer_tpu_torch.models.migt import MIGT
from viewformer_tpu_torch.models.vqgan import VQGAN, GroupNorm32
from viewformer_tpu_torch.ops.image import normalize_images
from viewformer_tpu_torch.train import codebook as tcb
from viewformer_tpu_torch.train import transformer as ttt
from viewformer_tpu_torch.utils import jax_random as jr
from viewformer_tpu_torch.utils.convert import jax_initial_state, jax_leaves, state_dict_from_jax

import chip_smoke

SEEDS = [0, 42, 1337, 2 ** 31 - 1]
SHAPES = [(), (7,), (3, 5, 2)]
ERFINV_ULPS = 8
# two resolutions, an attention resolution and two res blocks
TINY = VQGANConfig(ch=32, ch_mult=(1, 2), num_res_blocks=2, attn_resolutions=(8,),
                   z_channels=16, embed_dim=8, n_embed=64, image_size=16)
# TINY's draw at seed 0, as jax 0.9.0 and flax 0.12.3 make it: the first four
# words of the codebook's bits and of encoder.conv_in's kernel (HWIO)
SEED0_CODEBOOK_BITS = (0x618BE600, 0x547B252E, 0x98A2526F, 0x2C1D390D)
SEED0_CONV_IN = (-0.10036773979663849, 0.16849425435066223, 0.3643440306186676,
                 -0.14749866724014282)
# every leaf of the MIGT: localization on (the pose criterion), the dynamic
# pose loss on (pos_ori_weights)
TINY_MIGT = dataclasses.replace(TINY_MIGT_BASE, use_dynamic_pose_loss=True)
# the first training encode at full width: codes may flip only at
# Voronoi boundaries, where f32 convolutions of XLA and oneDNN round apart
CODE_AGREEMENT = 0.99
# ... and the updated codebook (means of latents) and EMA sums, within the
# rounding of two f32 encoders 24 convolutions deep (|latent| <= 4.2 here)
LATENT_ATOL = 1e-3
# GroupNorm32 on the CPU against f64 (its statistics over NCHW)
GROUP_NORM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key_data(key):
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key)


def _assert_within_ulps(port, expected, what):
    port, expected = np.asarray(port, np.float32), np.asarray(expected, np.float32)
    bound = ERFINV_ULPS * np.spacing(np.abs(expected))
    excess = np.abs(port - expected) - bound
    assert (excess <= 0).all(), (what, float(np.abs(port - expected).max()))


@pytest.mark.parametrize('seed', SEEDS)
def test_keys_and_bits(seed):
    key = jax.random.PRNGKey(seed)
    port = jr.prng_key(seed)
    np.testing.assert_array_equal(port, _key_data(key))
    for num in (2, 5):
        np.testing.assert_array_equal(jr.split(port, num), _key_data(jax.random.split(key, num)))
    for data in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        np.testing.assert_array_equal(jr.fold_in(port, data),
                                      _key_data(jax.random.fold_in(key, data)))
    for shape in SHAPES:
        np.testing.assert_array_equal(jr.random_bits(port, shape),
                                      np.asarray(jax.random.bits(key, shape, jnp.uint32)))


@pytest.mark.parametrize('seed', SEEDS)
def test_uniform_bit_for_bit(seed):
    key, port = jax.random.PRNGKey(seed), jr.prng_key(seed)
    limit = np.sqrt(np.float32(3.0))
    for shape, low, high in [(s, 0.0, 1.0) for s in SHAPES] + \
            [((8, 64), -limit, limit), ((3, 1000), -2.5, 0.75)]:
        expected = np.asarray(jax.random.uniform(key, shape, jnp.float32, low, high))
        np.testing.assert_array_equal(jr.uniform(port, shape, low, high).view(np.uint32),
                                      expected.view(np.uint32), err_msg=str(shape))


@pytest.mark.parametrize('seed', SEEDS)
def test_truncated_normal_and_lecun_normal(seed):
    key, port = jax.random.PRNGKey(seed), jr.prng_key(seed)
    for shape in SHAPES[1:] + [(3, 3, 64, 96)]:
        _assert_within_ulps(jr.truncated_normal(port, -2.0, 2.0, shape),
                            jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32),
                            ('truncated_normal', shape))
    for shape in [(5, 7), (1, 1, 16, 8), (3, 3, 64, 96)]:
        _assert_within_ulps(jr.lecun_normal(port, shape),
                            initializers.lecun_normal()(key, shape, jnp.float32),
                            ('lecun_normal', shape))


def test_variable_key_is_flax_make_rng():
    """Scope paths hashed with the stream's counter, as flax folds them."""
    key = jax.random.PRNGKey(3)
    for path, count in [((), 1), (('encoder', 'conv_in'), 1), (('encoder', 'conv_in'), 2),
                        (('decoder', 'up_1_block_2', 'norm1', 'GroupNorm_0'), 300)]:
        expected = flax_scope.LazyRng.create(key, *path, count).as_jax_rng()
        np.testing.assert_array_equal(jr.variable_key(jr.prng_key(3), path, count),
                                      _key_data(expected), err_msg=str(path))


@pytest.fixture(scope='module')
def jax_tiny_states():
    """The JAX package's init_codebook_state of TINY (remat, as its
    train_codebook builds it) at seeds 0, 42 and 1337, carried into the
    port's names. It runs under one jit, compiled once for the three seeds:
    jit draws the same numbers as the eager call, which dispatches op by op
    and takes longer."""
    model = VQGAN(to_port(TINY))
    init = jax.jit(lambda rng: jcb.init_codebook_state(TINY, rng, optax.adam(1e-3),
                                                       remat=True)[1])
    states, raw = {}, {}
    for seed in (0, 42, 1337):
        state = init(jax.random.PRNGKey(seed))
        variables = jax.device_get({'params': state.params, 'quantizer': state.quantizer})
        states[seed] = state_dict_from_jax(model, variables)
        raw[seed] = variables
    return model, states, raw


@pytest.mark.parametrize('seed', [42, 1337])
def test_tiny_initial_state_is_jax(seed, jax_tiny_states):
    """Every tensor of jax_initial_state against JAX's draw: the codebook
    bit for bit, zeros and ones exact, the kernels within ERFINV_ULPS (a
    wrong scope path or counter would give O(1) differences)."""
    model, states, _ = jax_tiny_states
    expected = states[seed]
    port = jax_initial_state(model, seed, device='cpu')
    assert sorted(port) == sorted(expected)
    kernels = 0
    for key, value in expected.items():
        assert port[key].shape == value.shape and port[key].dtype == value.dtype, key
        if key.endswith('.weight') and value.ndim == 4:
            _assert_within_ulps(port[key].numpy(), value.numpy(), key)
            kernels += 1
        else:
            assert torch.equal(port[key], value), key
    assert kernels == sum(1 for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    # init_codebook_state(jax_seed=) lands the same state in the model
    built, _ = tcb.init_codebook_state(to_port(TINY), dtype=torch.float32, device='cpu',
                                       jax_seed=seed)
    for key, value in built.state_dict().items():
        assert torch.equal(value, port[key]), key
    # a caller asking for torch's draw too is refused, not given JAX's
    with pytest.raises(ValueError, match='not both'):
        tcb.init_codebook_state(to_port(TINY), generator=torch.Generator(), device='cpu',
                                jax_seed=seed)


def test_pinned_seed0_draw(jax_tiny_states):
    """The constants chip_smoke.py asserts on the card's machine are jax's."""
    _, _, raw = jax_tiny_states
    _, quantizer_rng = jax.random.split(jax.random.PRNGKey(0))
    bits = np.asarray(jax.random.bits(flax_scope.LazyRng.create(quantizer_rng, 1).as_jax_rng(),
                                      (TINY.embed_dim, TINY.n_embed), jnp.uint32))
    assert tuple(int(b) for b in bits.reshape(-1)[:4]) == SEED0_CODEBOOK_BITS
    conv_in = np.asarray(raw[0]['params']['encoder']['conv_in']['kernel']).reshape(-1)[:4]
    assert tuple(float(v) for v in conv_in) == SEED0_CONV_IN
    assert chip_smoke.JAX_DRAW_CODEBOOK_BITS == SEED0_CODEBOOK_BITS
    assert chip_smoke.JAX_DRAW_CONV_IN == SEED0_CONV_IN
    assert chip_smoke.JAX_DRAW_ULPS == ERFINV_ULPS
    for name, value in chip_smoke.JAX_DRAW_CONFIG.items():
        assert np.array_equal(getattr(TINY, name), value), name
    drawn = chip_smoke.check_jax_draw()
    assert drawn['codebook_bits'] == [hex(b) for b in SEED0_CODEBOOK_BITS]


@pytest.fixture(scope='module')
def jax_migt_states():
    """The JAX package's init_transformer_state of TINY_MIGT (remat, as its
    train_transformer builds it) at seeds 0, 42 and 1337 under one jit,
    carried into the port's names."""
    with torch.device('meta'):
        model = MIGT(to_port(TINY_MIGT), param_dtype=torch.float32)
    init = jax.jit(lambda rng: jtt.init_transformer_state(TINY_MIGT, rng, optax.adam(1e-3))[1])
    states, raw = {}, {}
    for seed in (0, 42, 1337):
        variables = {'params': jax.device_get(init(jax.random.PRNGKey(seed)).params)}
        states[seed] = state_dict_from_jax(model, variables)
        raw[seed] = variables
    return model, states, raw


@pytest.mark.parametrize('seed', [0, 42, 1337])
def test_migt_initial_state_is_jax(seed, jax_migt_states):
    """Every tensor of the MIGT's jax_initial_state against JAX's draw: Dense
    kernels, wte and wpe within ERFINV_ULPS, zeros, ones and pos_ori_weights
    exact; init_transformer_state(jax_seed=) lands it in the model, and
    refuses a generator beside it."""
    model, states, _ = jax_migt_states
    expected = states[seed]
    port = jax_initial_state(model, seed, device='cpu')
    assert sorted(port) == sorted(expected)
    drawn = 0
    for key, value in expected.items():
        assert port[key].shape == value.shape and port[key].dtype == value.dtype, key
        if key.endswith('.weight') and value.ndim == 2 or key == 'wpe':
            _assert_within_ulps(port[key].numpy(), value.numpy(), key)
            drawn += 1
        else:
            assert torch.equal(port[key], value), key
    linears = sum(1 for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert drawn == linears + 2  # and wte, wpe
    assert torch.equal(port['pos_ori_weights'], torch.tensor([0.0, -3.0]))
    built, _ = ttt.init_transformer_state(to_port(TINY_MIGT), dtype=torch.float32,
                                          device='cpu', jax_seed=seed)
    for key, value in built.state_dict().items():
        assert torch.equal(value, port[key]), key
    with pytest.raises(ValueError, match='not both'):
        ttt.init_transformer_state(to_port(TINY_MIGT), generator=torch.Generator(),
                                   device='cpu', jax_seed=seed)


def test_pinned_migt_seed0_draw(jax_migt_states):
    """The MIGT constants chip_smoke.py asserts on the card's machine are
    jax's: seed 0's first c_attn kernel values, and what JAX's train step 0
    of `train transformer --seed 0` draws from PRNGKey(1): the first dropout
    sites' seed words and the pose noise."""
    _, _, raw = jax_migt_states
    c_attn = np.asarray(raw[0]['params']['h_0']['attn']['c_attn']['kernel']).reshape(-1)[:4]
    assert tuple(float(v) for v in c_attn) == chip_smoke.JAX_DRAW_MIGT_C_ATTN
    dropout_rng, pose_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    embedding = flax_scope.LazyRng.create(dropout_rng, 1).as_jax_rng()
    attention = jax.random.split(
        flax_scope.LazyRng.create(dropout_rng, 'h_0', 'attn', 1).as_jax_rng())
    words = [tuple(int(w) for w in _key_data(k)) for k in (embedding, *attention)]
    assert tuple(words) == chip_smoke.JAX_DRAW_MIGT_WORDS
    u = jax.random.uniform(flax_scope.LazyRng.create(pose_rng, 1).as_jax_rng(),
                           (len(chip_smoke.JAX_DRAW_POSE_NOISE),), jnp.float32, -1.0, 1.0)
    assert tuple(float(v) for v in u) == chip_smoke.JAX_DRAW_POSE_NOISE
    multiplier = jnp.float32(chip_smoke.JAX_DRAW_POSE_BASE) ** u
    assert tuple(float(v) for v in multiplier) == chip_smoke.JAX_DRAW_POSE_MULTIPLIER
    for name, value in chip_smoke.JAX_DRAW_MIGT_CONFIG.items():
        assert getattr(TINY_MIGT, name) == value, name
    drawn = chip_smoke.check_jax_draw()
    assert drawn['migt_words'] == [list(w) for w in words]


def test_group_norm_channels_last_cpu_precision():
    """GroupNorm32 in training mode on a channels_last f32 CPU tensor whose
    groups' mean is 10 standard deviations: within GROUP_NORM_ATOL of f64
    and still channels_last, where torch's channels_last CPU kernel alone
    is not (the full-width step below then takes another code at its
    narrowest boundary)."""
    torch.manual_seed(0)
    x = (torch.randn(2, 64, 16, 16) * 0.1 + 1.0).contiguous(memory_format=torch.channels_last)
    norm = GroupNorm32(64)
    with torch.no_grad():
        out = norm(x)
        kernel = torch.nn.functional.group_norm(x, 32, norm.weight, norm.bias, 1e-6)
    expected = torch.nn.functional.group_norm(x.double(), 32, eps=1e-6)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert (out.double() - expected).abs().max().item() <= GROUP_NORM_ATOL
    assert (kernel.double() - expected).abs().max().item() > GROUP_NORM_ATOL


def _colors_frames(n, size):
    """Frame 0 of n colors sequences, uint8 [n, size, size, 3]."""
    loader = ColorsLoader('train', num_sequences=n, sequence_size=1, image_size=size)
    return np.stack([loader[i]['frames'][0] for i in range(n)])


def test_full_width_first_update_from_jax_seed_1337():
    """VQGANConfig() at JAX's seed 1337, one training encode (EMA update) of
    8 colors frames at 128 px in f32 in both packages. JAX inits only what
    encode reads (the encoder, quant_conv and the codebook: the decoder's
    draw is left out, it plays no part in this step), so its init and the
    step compile as one function: every leaf it draws is checked against
    the port's full-depth draw, then the codes, the set of codes alive
    after the update, and the updated codebook and EMA state."""
    config = VQGANConfig()
    seed = 1337
    frames = _colors_frames(8, config.image_size)
    x = normalize_images(torch.from_numpy(frames)).float()
    jax_model = JaxVQGAN(config, dtype=jnp.float32)

    @jax.jit
    def jax_step(rng, images):
        params_rng, quantizer_rng = jax.random.split(rng)
        variables = jax_model.init({'params': params_rng, 'quantizer': quantizer_rng},
                                   images[:1], training=False, method=JaxVQGAN.encode)
        (_, _, codes), mutated = jax_model.apply(variables, images, training=True,
                                                 method=JaxVQGAN.encode, mutable=['quantizer'])
        return variables, codes, mutated['quantizer']

    variables, jax_codes, jax_quantizer = jax.device_get(
        jax_step(jax.random.PRNGKey(seed), jnp.asarray(x.numpy())))

    model, _ = tcb.init_codebook_state(to_port(config), dtype=torch.float32, device='cpu',
                                       jax_seed=seed)
    drawn = {tuple(path): np.asarray(v) for path, v in traverse_util.flatten_dict(
        {'params': variables['params'], 'quantizer': variables['quantizer']}).items()}
    checked = 0
    for key, path, convert, tensor in jax_leaves(model):
        if path not in drawn:
            assert path[1] == 'decoder' or path[1] == 'post_quant_conv', path
            continue
        value = drawn.pop(path)
        value = convert(value) if convert is not None else value
        if tensor.ndim == 4:
            _assert_within_ulps(tensor.detach().numpy(), value, key)
        else:
            np.testing.assert_array_equal(tensor.detach().numpy(), value, err_msg=key)
        checked += 1
    assert not drawn and checked > 60

    with torch.no_grad():
        _, codes = model.encode(x, training=True)
    codes, jax_codes = codes.numpy(), np.asarray(jax_codes)
    assert codes.shape == jax_codes.shape == (8, 8, 8)
    agreement = (codes == jax_codes).mean()
    assert agreement >= CODE_AGREEMENT, agreement
    assert set(codes.reshape(-1)) == set(jax_codes.reshape(-1))
    q = model.quantizer
    assert q.counter.item() == int(jax_quantizer['counter']) == 1
    np.testing.assert_allclose(q.ema_cluster_size_hidden.numpy(),
                               jax_quantizer['ema_cluster_size_hidden'], atol=0)
    np.testing.assert_allclose(q.embeddings.numpy(), jax_quantizer['embeddings'],
                               rtol=0, atol=LATENT_ATOL)
    np.testing.assert_allclose(q.ema_dw_hidden.numpy(), jax_quantizer['ema_dw_hidden'],
                               rtol=0, atol=LATENT_ATOL)
