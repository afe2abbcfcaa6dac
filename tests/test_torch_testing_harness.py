"""The port's parity harness (viewformer_tpu_torch/utils/testing.py): the
cases of tests/test_testing_harness.py with a torch candidate where the JAX
package's harness takes a JAX function, and the same pairs giving the JAX
package's harness's verdicts."""
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from viewformer_tpu.utils import testing as jtesting
from viewformer_tpu_torch.utils.testing import assert_gradients_same, assert_outputs_same


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _linear_pair():
    """A torch MLP, and the same function as a torch and as a JAX callable
    from its weights."""
    torch.manual_seed(0)
    module = tnn.Sequential(tnn.Linear(8, 16), tnn.Tanh(), tnn.Linear(16, 4))
    w = [(module[0].weight.detach().clone(), module[0].bias.detach().clone()),
         (module[2].weight.detach().clone(), module[2].bias.detach().clone())]

    def port_apply(x):
        return torch.tanh(x @ w[0][0].T + w[0][1]) @ w[1][0].T + w[1][1]

    def jax_apply(x):
        h = jnp.tanh(jnp.asarray(x) @ w[0][0].numpy().T + w[0][1].numpy())
        return h @ w[1][0].numpy().T + w[1][1].numpy()

    return module, port_apply, jax_apply


def _conv_pair():
    """A torch conv, and the same conv on NHWC input as a torch and as a
    JAX callable."""
    torch.manual_seed(1)
    conv = tnn.Conv2d(3, 8, 3, padding=1)
    w, b = conv.weight.detach().clone(), conv.bias.detach().clone()

    def port_apply(x_nhwc):
        return F.conv2d(x_nhwc.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)

    def jax_apply(x_nhwc):
        return jax.lax.conv_general_dilated(
            jnp.asarray(x_nhwc), jnp.asarray(w.numpy().transpose(2, 3, 1, 0)), (1, 1),
            ((1, 1), (1, 1)), dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            precision=jax.lax.Precision.HIGHEST) + b.numpy()

    return conv, port_apply, jax_apply


def _verdict(check, *args, **kwargs):
    try:
        return check(*args, **kwargs)
    except AssertionError:
        return False


def test_outputs_same_passes_for_equivalent():
    module, port_apply, _ = _linear_pair()
    assert assert_outputs_same(module, port_apply, (3, 8), channels_last=False)


def test_outputs_same_detects_mismatch():
    module, port_apply, _ = _linear_pair()
    with pytest.raises(AssertionError):
        assert_outputs_same(module, lambda x: port_apply(x) + 0.01, (3, 8), channels_last=False)


def test_gradients_same():
    module, port_apply, _ = _linear_pair()
    assert assert_gradients_same(module, port_apply, (3, 8), channels_last=False)


def test_gradients_detect_mismatch():
    module, port_apply, _ = _linear_pair()
    with pytest.raises(AssertionError):
        assert_gradients_same(module, lambda x: port_apply(x * 1.01), (3, 8),
                              channels_last=False)


def test_nchw_nhwc_handling():
    conv, port_apply, _ = _conv_pair()
    assert assert_outputs_same(conv, port_apply, (2, 3, 8, 8))
    assert assert_gradients_same(conv, port_apply, (2, 3, 8, 8))


def test_tuple_and_dict_outputs():
    """A dict's outputs are taken in sorted key order, a tuple's in its."""
    module, port_apply, _ = _linear_pair()
    named = lambda x: {'b': module(x) * 2, 'a': -module(x)}  # noqa: E731
    ordered = lambda x: (-port_apply(x), port_apply(x) * 2)  # noqa: E731
    assert assert_outputs_same(named, ordered, (3, 8), channels_last=False)
    assert assert_gradients_same(named, ordered, (3, 8), channels_last=False)
    with pytest.raises(AssertionError):
        assert_outputs_same(named, lambda x: ordered(x)[::-1], (3, 8), channels_last=False)
    with pytest.raises(AssertionError, match='arity'):
        assert_outputs_same(named, port_apply, (3, 8), channels_last=False)


@pytest.mark.parametrize('case', ['equivalent', 'output-shift', 'input-scale'])
@pytest.mark.parametrize('pair', ['linear', 'conv'])
def test_verdicts_match_jax_harness(pair, case):
    """The same reference and candidate function (torch for the port, JAX
    for the JAX package) get the same verdict from both harnesses, for
    outputs and for gradients."""
    module, port_apply, jax_apply = (_linear_pair if pair == 'linear' else _conv_pair)()
    shape, channels_last = ((3, 8), False) if pair == 'linear' else ((2, 3, 8, 8), True)
    if case == 'output-shift':
        port_fn, jax_fn = (lambda x: port_apply(x) + 0.01), (lambda x: jax_apply(x) + 0.01)
    elif case == 'input-scale':
        port_fn, jax_fn = (lambda x: port_apply(x * 1.01)), (lambda x: jax_apply(x * 1.01))
    else:
        port_fn, jax_fn = port_apply, jax_apply
    for port_check, jax_check in ((assert_outputs_same, jtesting.assert_outputs_same),
                                  (assert_gradients_same, jtesting.assert_gradients_same)):
        port = _verdict(port_check, module, port_fn, shape, channels_last=channels_last)
        expected = _verdict(jax_check, module, jax_fn, shape, channels_last_jax=channels_last)
        assert port == expected == (case == 'equivalent' or (
            port_check is assert_gradients_same and case == 'output-shift'))
