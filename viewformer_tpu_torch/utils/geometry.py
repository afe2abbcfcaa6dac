"""Quaternion helpers on tensors (port of the camera math in
viewformer_tpu/utils/geometry.py). Quaternions are (w, x, y, z); cameras are
7-vectors (x, y, z, qw, qx, qy, qz)."""
import torch


def quaternion_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    x = x1 * w2 + y1 * z2 - z1 * y2 + w1 * x2
    y = -x1 * z2 + y1 * w2 + z1 * x2 + w1 * y2
    z = x1 * y2 - y1 * x2 + z1 * w2 + w1 * z2
    w = -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2
    return torch.stack((w, x, y, z), -1)


def quaternion_normalize(x, epsilon=1e-12):
    return x / torch.sqrt(torch.clamp((x ** 2).sum(-1, keepdim=True), min=epsilon))


def quaternion_remove_sign(x):
    """Flip each quaternion to a non-negative w."""
    sign = 2 * (x[..., :1] >= 0).to(x.dtype) - 1
    return x * sign


def quaternion_conjugate(q):
    return torch.cat((q[..., :1], -q[..., 1:]), -1)


def quaternion_rotate(point, quaternion):
    point = torch.cat([torch.zeros_like(point[..., :1]), point], -1)
    point = quaternion_multiply(quaternion, point)
    point = quaternion_multiply(point, quaternion_conjugate(quaternion))
    return point[..., 1:]


def make_quaternion(axis, angle):
    """Rotation by angle [...] about the unit axis [3] -> [..., 4]."""
    return torch.cat([torch.cos(angle / 2)[..., None], torch.sin(angle / 2)[..., None] * axis], -1)


def make_quaternion_x(angle):
    return make_quaternion(torch.tensor([1.0, 0.0, 0.0], dtype=angle.dtype), angle)


def make_quaternion_y(angle):
    return make_quaternion(torch.tensor([0.0, 1.0, 0.0], dtype=angle.dtype), angle)
