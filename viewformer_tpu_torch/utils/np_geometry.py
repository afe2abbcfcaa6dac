"""Camera helpers on numpy arrays, for the loaders and the 7-Scenes
evaluators, which do their geometry on the host (port of the numpy forms of
viewformer_tpu/utils/geometry.py). utils/geometry.py has the same functions
on tensors. These keep numpy's own operations, so the cameras they give are
the reference's to the bit: LAPACK's eigh in torch and in numpy may return
the principal eigenvector of quaternion_average with the other sign.

Quaternions are (w, x, y, z); cameras are 7-vectors (x, y, z, qw, qx, qy,
qz). The dtype of the input is kept."""
import numpy as np


def safe_unsigned_div(a, b, eps=None):
    if eps is None:
        eps = 10.0 * float(np.finfo(np.asarray(b).dtype).tiny)
    return a / (b + eps)


def rotation_matrix_to_quaternion(rotation_matrix):
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4], by the
    reference's four cases chosen without branches."""
    rotation_matrix = np.asarray(rotation_matrix)
    trace = np.trace(rotation_matrix, axis1=-2, axis2=-1)
    eps_addition = 2.0 * float(np.finfo(np.float32).eps)
    e = [[rotation_matrix[..., i, j] for j in range(3)] for i in range(3)]

    sq0 = np.sqrt(np.maximum(trace + 1.0, eps_addition)) * 2.0
    tr_positive = np.stack((0.25 * sq0,
                            safe_unsigned_div(e[2][1] - e[1][2], sq0),
                            safe_unsigned_div(e[0][2] - e[2][0], sq0),
                            safe_unsigned_div(e[1][0] - e[0][1], sq0)), -1)
    sq1 = np.sqrt(np.maximum(1.0 + e[0][0] - e[1][1] - e[2][2], 0.0) + eps_addition) * 2.0
    cond_1 = np.stack((safe_unsigned_div(e[2][1] - e[1][2], sq1),
                       0.25 * sq1,
                       safe_unsigned_div(e[0][1] + e[1][0], sq1),
                       safe_unsigned_div(e[0][2] + e[2][0], sq1)), -1)
    sq2 = np.sqrt(np.maximum(1.0 + e[1][1] - e[0][0] - e[2][2], 0.0) + eps_addition) * 2.0
    cond_2 = np.stack((safe_unsigned_div(e[0][2] - e[2][0], sq2),
                       safe_unsigned_div(e[0][1] + e[1][0], sq2),
                       0.25 * sq2,
                       safe_unsigned_div(e[1][2] + e[2][1], sq2)), -1)
    sq3 = np.sqrt(np.maximum(1.0 + e[2][2] - e[0][0] - e[1][1], 0.0) + eps_addition) * 2.0
    cond_3 = np.stack((safe_unsigned_div(e[1][0] - e[0][1], sq3),
                       safe_unsigned_div(e[0][2] + e[2][0], sq3),
                       safe_unsigned_div(e[1][2] + e[2][1], sq3),
                       0.25 * sq3), -1)
    where_2 = np.where((e[1][1] > e[2][2])[..., None], cond_2, cond_3)
    where_1 = np.where(((e[0][0] > e[1][1]) & (e[0][0] > e[2][2]))[..., None], cond_1, where_2)
    return np.where((trace > 0)[..., None], tr_positive, where_1)


def quaternion_multiply(q1, q2):
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    x = x1 * w2 + y1 * z2 - z1 * y2 + w1 * x2
    y = -x1 * z2 + y1 * w2 + z1 * x2 + w1 * y2
    z = x1 * y2 - y1 * x2 + z1 * w2 + w1 * z2
    w = -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2
    return np.stack((w, x, y, z), -1)


def l2_normalize(x, axis=-1, epsilon=1e-12):
    return x / np.sqrt(np.maximum((x ** 2).sum(axis=axis, keepdims=True), epsilon))


def quaternion_normalize(x, epsilon=1e-12):
    return l2_normalize(x, axis=-1, epsilon=epsilon)


def quaternion_remove_sign(x):
    """Flip each quaternion to a non-negative w."""
    return x * (2 * (x[..., :1] >= 0).astype(x.dtype) - 1)


def quaternion_conjugate(q):
    return np.concatenate((q[..., :1], -q[..., 1:]), axis=-1)


def look_at_to_cameras(camera_position, look_at, up_vector):
    """A look-at camera -> its 7-vector; z faces away from the camera, y
    down, x right."""
    z_axis = l2_normalize(look_at - camera_position)
    x_axis = l2_normalize(np.cross(z_axis, up_vector))
    y_axis = np.cross(z_axis, x_axis)
    R = np.stack([y_axis, -x_axis, z_axis], -1)
    quaternion = quaternion_normalize(rotation_matrix_to_quaternion(R))
    return np.concatenate((camera_position, quaternion), -1)


def quaternion_average(quaternion, axis=-2):
    """The eigenvector mean of quaternions along `axis`: the principal
    eigenvector of their mean outer product (numpy's eigh)."""
    quaternion = quaternion_remove_sign(quaternion)
    M = (quaternion[..., None, :] * quaternion[..., :, None]).mean(axis - 1 if axis < 0 else axis)
    return np.linalg.eigh(M)[1][..., :, -1]
