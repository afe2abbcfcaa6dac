"""Quaternion and camera helpers on tensors (port of
viewformer_tpu/utils/geometry.py). Quaternions are (w, x, y, z); cameras are
7-vectors (x, y, z, qw, qx, qy, qz)."""
import math

import torch

_F32_EPS = torch.finfo(torch.float32).eps


def safe_unsigned_div(a, b, eps=None):
    if eps is None:
        eps = 10.0 * torch.finfo(b.dtype).tiny
    return a / (b + eps)


def rotation_matrix_to_quaternion(rotation_matrix):
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w, x, y, z), by the
    reference's four cases chosen without branches."""
    e = [[rotation_matrix[..., i, j] for j in range(3)] for i in range(3)]
    trace = e[0][0] + e[1][1] + e[2][2]
    eps_addition = 2.0 * _F32_EPS

    sq0 = torch.sqrt(torch.clamp(trace + 1.0, min=eps_addition)) * 2.0
    tr_positive = torch.stack((0.25 * sq0,
                               safe_unsigned_div(e[2][1] - e[1][2], sq0),
                               safe_unsigned_div(e[0][2] - e[2][0], sq0),
                               safe_unsigned_div(e[1][0] - e[0][1], sq0)), -1)
    sq1 = torch.sqrt(torch.clamp(1.0 + e[0][0] - e[1][1] - e[2][2], min=0.0) + eps_addition) * 2.0
    cond_1 = torch.stack((safe_unsigned_div(e[2][1] - e[1][2], sq1),
                          0.25 * sq1,
                          safe_unsigned_div(e[0][1] + e[1][0], sq1),
                          safe_unsigned_div(e[0][2] + e[2][0], sq1)), -1)
    sq2 = torch.sqrt(torch.clamp(1.0 + e[1][1] - e[0][0] - e[2][2], min=0.0) + eps_addition) * 2.0
    cond_2 = torch.stack((safe_unsigned_div(e[0][2] - e[2][0], sq2),
                          safe_unsigned_div(e[0][1] + e[1][0], sq2),
                          0.25 * sq2,
                          safe_unsigned_div(e[1][2] + e[2][1], sq2)), -1)
    sq3 = torch.sqrt(torch.clamp(1.0 + e[2][2] - e[0][0] - e[1][1], min=0.0) + eps_addition) * 2.0
    cond_3 = torch.stack((safe_unsigned_div(e[1][0] - e[0][1], sq3),
                          safe_unsigned_div(e[0][2] + e[2][0], sq3),
                          safe_unsigned_div(e[1][2] + e[2][1], sq3),
                          0.25 * sq3), -1)
    where_2 = torch.where((e[1][1] > e[2][2])[..., None], cond_2, cond_3)
    where_1 = torch.where(((e[0][0] > e[1][1]) & (e[0][0] > e[2][2]))[..., None], cond_1, where_2)
    return torch.where((trace > 0)[..., None], tr_positive, where_1)


def quaternion_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    x = x1 * w2 + y1 * z2 - z1 * y2 + w1 * x2
    y = -x1 * z2 + y1 * w2 + z1 * x2 + w1 * y2
    z = x1 * y2 - y1 * x2 + z1 * w2 + w1 * z2
    w = -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2
    return torch.stack((w, x, y, z), -1)


def l2_normalize(x, axis=-1, epsilon=1e-12):
    return x / torch.sqrt(torch.clamp((x ** 2).sum(axis, keepdim=True), min=epsilon))


def quaternion_normalize(x, epsilon=1e-12):
    return l2_normalize(x, -1, epsilon)


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


def quaternion_to_euler(quaternion):
    """-> (pitch, yaw, roll) [..., 3]."""
    w, x, y, z = quaternion.unbind(-1)
    roll = torch.atan2(2 * (w * z + x * y), 1 - 2 * (z * z + x * x))
    sinp = 2 * (w * x - y * z)
    pitch = torch.where(sinp.abs() >= 1, math.pi / 2 * torch.sign(sinp),
                        torch.asin(sinp.clamp(-1, 1)))
    yaw = torch.atan2(2 * (w * y + z * x), 1 - 2 * (x * x + y * y))
    return torch.stack([pitch, yaw, roll], -1)


def quaternion_to_rotation_matrix(quaternion):
    w, x, y, z = quaternion.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    m = torch.stack((1.0 - (tyy + tzz), txy - twz, txz + twy,
                     txy + twz, 1.0 - (txx + tzz), tyz - twx,
                     txz - twy, tyz + twx, 1.0 - (txx + tyy)), -1)
    return m.reshape(quaternion.shape[:-1] + (3, 3))


def look_at_to_cameras(camera_position, look_at, up_vector):
    """A look-at camera -> its 7-vector; z faces away from the camera, y
    down, x right."""
    z_axis = l2_normalize(look_at - camera_position)
    x_axis = l2_normalize(torch.linalg.cross(z_axis, up_vector.expand_as(z_axis)))
    y_axis = torch.linalg.cross(z_axis, x_axis)
    R = torch.stack([y_axis, -x_axis, z_axis], -1)
    quaternion = quaternion_normalize(rotation_matrix_to_quaternion(R))
    return torch.cat((camera_position, quaternion), -1)


def cameras_to_pose_euler(pose):
    return torch.cat((pose[..., :3], quaternion_to_euler(pose[..., 3:])), -1)


def quaternion_average(quaternion, axis=-2):
    """The eigenvector mean of quaternions along `axis` (the principal
    eigenvector of the mean outer product, by eigh)."""
    quaternion = quaternion_remove_sign(quaternion)
    M = (quaternion[..., None, :] * quaternion[..., :, None]).mean(axis - 1 if axis < 0 else axis)
    return torch.linalg.eigh(M)[1][..., :, -1]
