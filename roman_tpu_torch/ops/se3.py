"""Batched SO(3)/SE(3) operations on tensors (port of roman_tpu/ops/se3.py).

Everything broadcasts over leading batch dimensions and has no
data-dependent control flow. Quaternions are xyzw (scalar last), the g2o
order. The small-angle branches are roman_tpu's, value for value; the
pose-graph solver differentiates se3_log through them
(``rpgo.solver._edge_jacobians``).
"""

from __future__ import annotations

import torch

from roman_tpu_torch import tracing

_EPS = 1e-12


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion(s) (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> xyzw quaternion (..., 4), w >= 0.

    Shepperd's method evaluated on all four candidates, the one with the
    largest dominant term kept (first maximum on a tie)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cand, wxyz)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    q = torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    tracing.count_sync(top.device)  # the bottom row's copy from the host
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def xyz_quat_to_T(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return make_T(quat_to_rot(q), t)


def T_to_xyz_quat(T: torch.Tensor):
    """(..., 4, 4) -> ((..., 3), (..., 4) xyzw)."""
    return T[..., :3, 3], rot_to_quat(T[..., :3, :3])


def inv_T(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def apply_T(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., n, 3)."""
    return (torch.einsum("...ij,...nj->...ni", T[..., :3, :3], points)
            + T[..., None, :3, 3])


def yaw_of_rot(R: torch.Tensor) -> torch.Tensor:
    """Z angle of the ZYX euler decomposition, atan2(R10, R00)
    (roman_tpu/ops/se3.py:117-120)."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """Rotations about z by yaw (...,) -> (..., 3, 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o],
                       dim=-1).reshape(yaw.shape + (3, 3))


def rotation_rm_roll_pitch(R: torch.Tensor) -> torch.Tensor:
    """The yaw-only part of a rotation (reference roman/utils.py:125-127)."""
    return rot_z(yaw_of_rot(R))


def transform_rm_roll_pitch(T: torch.Tensor) -> torch.Tensor:
    """The yaw-only part of an SE(3), translation kept (reference
    roman/utils.py:128-130); returns a new matrix."""
    return make_T(rotation_rm_roll_pitch(T[..., :3, :3]), T[..., :3, 3])


def rotation_magnitude(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of rotation matrices (scipy Rotation.magnitude)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.acos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def T_to_xyzrpy(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [x y z roll pitch yaw], 'ZYX' intrinsic
    euler (roman_tpu/ops/se3.py:143-154)."""
    R = T[..., :3, :3]
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.cat(
        [T[..., :3, 3], torch.stack([roll, pitch, yaw], dim=-1)], dim=-1)


# ---------------------------------------------------------------------------
# so(3)/se(3) exp and log (the pose-graph solver's residuals)
# ---------------------------------------------------------------------------

def skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z],
                       dim=-1).reshape(w.shape[:-1] + (3, 3))


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm over the last dim (kept) whose derivative is finite at 0."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True),
                                  min=_EPS))


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues with a Taylor branch below 1e-2 rad. The exact branch
    divides by a guarded theta so that derivatives through the branch not
    taken stay finite (roman_tpu/ops/se3.py:182-196)."""
    theta = _safe_norm(w)[..., None]  # (..., 1, 1)
    K = skew(w)
    K2 = K @ K
    small = theta < 1e-2
    theta_s = torch.where(small, 1.0, theta)
    a = torch.where(small, 1.0 - theta**2 / 6.0, torch.sin(theta_s) / theta_s)
    b = torch.where(small, 0.5 - theta**2 / 24.0,
                    (1.0 - torch.cos(theta_s)) / theta_s**2)
    return _eye(K) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues, accurate away from pi (roman_tpu/ops/se3.py:
    199-211)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.acos(cos_t)[..., None, None]
    W = 0.5 * (R - R.transpose(-1, -2))
    small = theta < 1e-2
    theta_s = torch.where(small, 1.0, theta)
    scale = torch.where(small, 1.0 + theta**2 / 6.0, theta_s / torch.sin(theta_s))
    V = scale * W
    return torch.stack([V[..., 2, 1], V[..., 0, 2], V[..., 1, 0]], dim=-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi (..., 6) = [rho(3), w(3)] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta = _safe_norm(w)[..., None]
    K = skew(w)
    K2 = K @ K
    small = theta < 1e-2
    theta_s = torch.where(small, 1.0, theta)
    b = torch.where(small, 0.5 - theta**2 / 24.0,
                    (1.0 - torch.cos(theta_s)) / theta_s**2)
    c = torch.where(small, 1.0 / 6.0 - theta**2 / 120.0,
                    (theta_s - torch.sin(theta_s)) / theta_s**3)
    V = _eye(K) + b * K + c * K2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_T(so3_exp(w), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, w]."""
    w = so3_log(T[..., :3, :3])
    theta = _safe_norm(w)[..., None]
    K = skew(w)
    K2 = K @ K
    small = theta < 1e-2
    theta_s = torch.where(small, 1.0, theta)
    # V^-1 = I - K/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) K^2
    coef = torch.where(
        small, 1.0 / 12.0 + theta**2 / 720.0,
        (1.0 - theta_s * torch.sin(theta_s) / (2.0 * (1.0 - torch.cos(theta_s))))
        / theta_s**2)
    Vinv = _eye(K) - 0.5 * K + coef * K2
    rho = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([rho, w], dim=-1)


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of xyzw quaternions, branch-free."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    den = torch.clamp(sin_theta, min=_EPS)
    a = torch.where(use_lerp, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / den)
    b = torch.where(use_lerp, alpha, torch.sin(alpha * theta) / den)
    q = a * q0 + b * q1
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def interp_T(T0: torch.Tensor, T1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Pose interpolation: lerp of the translation, slerp of the rotation."""
    q = slerp(rot_to_quat(T0[..., :3, :3]), rot_to_quat(T1[..., :3, :3]),
              alpha[..., None])
    t = ((1.0 - alpha[..., None]) * T0[..., :3, 3]
         + alpha[..., None] * T1[..., :3, 3])
    return make_T(quat_to_rot(q), t)
