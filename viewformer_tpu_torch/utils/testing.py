"""Parity harness: a reference torch module against the port's module or
function (the port's own copy of viewformer_tpu/utils/testing.py, whose
other side was a JAX apply function; here both sides are torch callables).

The reference takes its input in torch's layout (NCHW for a 4-d input).
With channels_last the candidate takes and returns 4-d tensors in NHWC, as
the port's image models do, and the harness transposes on the way in and
out. Outputs may be one tensor, a tuple or list, or a dict (compared by
sorted key). Used to check an imported checkpoint, or a port of a module,
against its original.
"""
import numpy as np
import torch


def _to_nhwc(x):
    return np.transpose(x, (0, 2, 3, 1)) if x.ndim == 4 else x


def _to_nchw(x):
    return np.transpose(x, (0, 3, 1, 2)) if x.ndim == 4 else x


def _unpack(out):
    if isinstance(out, (tuple, list)):
        return list(out)
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [out]


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_outputs_same(reference, candidate, input_shape, *, seed=0, atol=1e-4,
                        channels_last=True):
    """Assert reference(x) == candidate(x) within atol on a seeded random
    f32 input x of input_shape (the reference's layout). Returns True."""
    x = np.random.RandomState(seed).randn(*input_shape).astype(np.float32)
    with torch.no_grad():
        expected = _unpack(reference(torch.from_numpy(x)))
        got = _unpack(candidate(torch.from_numpy(
            np.ascontiguousarray(_to_nhwc(x) if channels_last else x))))
    assert len(expected) == len(got), \
        f'output arity mismatch: {len(expected)} vs {len(got)}'
    for i, (a, b) in enumerate(zip(expected, got)):
        a = _numpy(a)
        if channels_last:
            a = _to_nhwc(a)
        np.testing.assert_allclose(_numpy(b), a, atol=atol, err_msg=f'output {i} differs')
    return True


def assert_gradients_same(reference, candidate, input_shape, *, seed=0, atol=1e-4,
                          channels_last=True):
    """Assert that the gradients with respect to the input of one seeded
    random-weighted sum of the outputs agree within atol, on a seeded random
    input (the reference's own strongest check). Returns True."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*input_shape).astype(np.float32)

    x_ref = torch.from_numpy(x).requires_grad_(True)
    outs = _unpack(reference(x_ref))
    weights = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)).backward()

    x_cand = torch.from_numpy(np.ascontiguousarray(_to_nhwc(x) if channels_last else x))
    x_cand.requires_grad_(True)
    outs = _unpack(candidate(x_cand))
    if channels_last:
        weights = [np.ascontiguousarray(_to_nhwc(w)) for w in weights]
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)).backward()
    grad = x_cand.grad.numpy()
    if channels_last:
        grad = _to_nchw(grad)
    np.testing.assert_allclose(grad, x_ref.grad.numpy(), atol=atol,
                               err_msg='input gradients differ')
    return True
