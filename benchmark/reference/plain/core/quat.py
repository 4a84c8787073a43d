"""Batched quaternion math, xyzw convention (counterpart of agility_tpu/core/quat.py).

All functions take tensors whose last axis is the component axis and
broadcast over leading batch axes.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (xyzw)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T v."""
    return quat_rotate(quat_conjugate(q), v)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate unit quaternions by world-frame angular velocity over dt with
    the exponential map (exact for constant omega)."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.clamp(angle, min=_EPS)
    half = 0.5 * angle * dt
    dq = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
    return normalize(quat_mul(dq, q))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3), angle (...) -> quat (..., 4)."""
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic x-y-z Euler angles -> quat."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy,
                        cr * cp * cy + sr * sp * sy], dim=-1)


def euler_from_quat(q: torch.Tensor):
    """quat -> (roll, pitch, yaw)."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    return torch.remainder(angle + torch.pi, 2 * torch.pi) - torch.pi


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the rotated x-axis."""
    ref = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ref[..., 0] = 1.0
    d = quat_rotate(q, ref)
    return torch.atan2(d[..., 1], d[..., 0])


def _yaw_quat(h: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(h)
    return torch.stack([z, z, torch.sin(h * 0.5), torch.cos(h * 0.5)], dim=-1)


def heading_quat(q: torch.Tensor) -> torch.Tensor:
    """Pure-yaw quaternion with the heading of q."""
    return _yaw_quat(calc_heading(q))


def heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse heading rotation."""
    return _yaw_quat(-calc_heading(q))


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q."""
    return quat_rotate(heading_quat(q), v)


def quat_to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """6-d tangent/normal rotation encoding: R(q) e_x, R(q) e_z."""
    e = torch.zeros(q.shape[:-1] + (2, 3), dtype=q.dtype, device=q.device)
    e[..., 0, 0] = 1.0
    e[..., 1, 2] = 1.0
    return quat_rotate(q[..., None, :], e).flatten(-2)


def quat_standardize(q: torch.Tensor) -> torch.Tensor:
    """Nonnegative-w hemisphere."""
    return torch.where(q[..., 3:4] < 0, -q, q)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Batched spherical interpolation; t is (..., 1) against (..., 4)."""
    cos_half = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(cos_half < 0, -q1, q1)
    cos_half = torch.abs(cos_half)
    half = torch.acos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    small = sin_half < 1e-5
    den = torch.clamp(sin_half, min=_EPS)
    r0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * half) / den)
    r1 = torch.where(small, t, torch.sin(t * half) / den)
    return normalize(r0 * q0 + r1 * q1)
