"""The port's VQ-GAN, codebook ops, image ops and weight bridge against the
JAX package, at the tiny codebook config of test_serve."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_serve import CCONFIG
from test_torch_config import to_port
from viewformer_tpu.models.vqgan import VQGAN
from viewformer_tpu.ops import image as jimage
from viewformer_tpu.ops import quantizer as jq
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.ops import image as timage
from viewformer_tpu_torch.ops import quantizer as tq
from viewformer_tpu_torch.utils.convert import state_dict_from_jax


@pytest.fixture(scope='module')
def models():
    jmodel = VQGAN(CCONFIG)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.device_get(jmodel.init({'params': k1, 'quantizer': k2},
                                           jnp.zeros((1, 32, 32, 3)), training=False))
    port = AutoModel.from_config(to_port(CCONFIG), device='cpu',
                                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax(port, variables))
    images = np.random.RandomState(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    return jmodel, variables, port, images


def test_nearest_codes_equal():
    rng = np.random.RandomState(1)
    embeddings = rng.uniform(-1.7, 1.7, (8, 64)).astype(np.float32)
    latents = rng.randn(5, 4, 4, 8).astype(np.float32)
    expected = np.asarray(jq.nearest_codes(jnp.asarray(embeddings), jnp.asarray(latents)))
    codes = tq.nearest_codes(torch.from_numpy(embeddings), torch.from_numpy(latents))
    np.testing.assert_array_equal(codes.numpy(), expected)
    np.testing.assert_array_equal(
        tq.embed_code(torch.from_numpy(embeddings), codes).numpy(),
        np.asarray(jq.embed_code(jnp.asarray(embeddings), jnp.asarray(expected))))


def test_encode_matches_jax(models):
    jmodel, variables, port, images = models
    cv = {'params': variables['params'], 'quantizer': variables['quantizer']}
    h = np.asarray(jmodel.apply(cv, jnp.asarray(images),
                                method=lambda m, x: m.quant_conv(m.encoder(x))))
    _quant, _loss, jcodes = jmodel.apply(cv, jnp.asarray(images), training=False,
                                         method=VQGAN.encode)
    with torch.no_grad():
        th = port.quant_conv(port.encoder(torch.from_numpy(images).permute(0, 3, 1, 2)))
        quant, codes = port.encode(torch.from_numpy(images))
    np.testing.assert_allclose(th.permute(0, 2, 3, 1).numpy(), h, atol=1e-4)

    # codes must agree wherever the JAX top-2 margin leaves room for f32 noise
    emb = variables['quantizer']['embeddings']
    scores = 2.0 * h.reshape(-1, emb.shape[0]) @ emb - (emb ** 2).sum(0)
    top2 = np.sort(scores, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(codes.numpy().reshape(-1)[clear],
                                  np.asarray(jcodes).reshape(-1)[clear])
    np.testing.assert_array_equal(quant.numpy(), emb.T[codes.numpy()])


def test_decode_code_matches_jax(models):
    jmodel, variables, port, _ = models
    codes = np.random.RandomState(2).randint(0, CCONFIG.n_embed, (2, 16, 16))
    expected = np.asarray(jmodel.apply({'params': variables['params'],
                                        'quantizer': variables['quantizer']},
                                       jnp.asarray(codes), method=VQGAN.decode_code))
    with torch.no_grad():
        pixels = port.decode_code(torch.from_numpy(codes))
    assert pixels.dtype == torch.float32 and pixels.shape == expected.shape
    np.testing.assert_allclose(pixels.numpy(), expected, atol=1e-4)


@pytest.mark.parametrize('size', [16, 48])
def test_resize_and_normalize_match_jax(size):
    images = np.random.RandomState(3).randint(0, 256, (2, 3, 32, 32, 3)).astype(np.uint8)
    expected = jimage.resize(images, size)
    port = timage.resize(torch.from_numpy(images), size)
    np.testing.assert_array_equal(port.numpy(), expected)
    np.testing.assert_allclose(timage.normalize_images(port).numpy(),
                               np.asarray(jimage.normalize_images(jnp.asarray(expected))),
                               atol=1e-7)


def test_bridge_is_strict(models):
    _jmodel, variables, port, _ = models
    missing = jax.tree.map(lambda x: x, variables)
    del missing['params']['decoder']['conv_out']['bias']
    with pytest.raises(KeyError, match='decoder.conv_out.bias'):
        state_dict_from_jax(port, missing)
    extra = jax.tree.map(lambda x: x, variables)
    extra['params']['encoder']['unused'] = {'kernel': np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match='params/encoder/unused/kernel'):
        state_dict_from_jax(port, extra)
    # the unmodified tree fills every port entry
    assert set(state_dict_from_jax(port, variables)) == set(port.state_dict())
