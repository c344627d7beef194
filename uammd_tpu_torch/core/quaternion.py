"""Quaternion algebra for rigid-body orientations.

Port of ``uammd_tpu/core/quaternion.py`` (reference:
src/utils/quaternion.cuh:15, the ``dir`` particle property of the BDHI
integrators). Quaternions are [..., 4] tensors laid out (w, x, y, z), w the
scalar part, batched over particles; every function is elementwise.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def identity(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[n, 4] identity quaternions on ``device`` (default the GPU)."""
    q = torch.zeros((n, 4), dtype=dtype, device=resolve_device(device))
    q[:, 0] = 1.0
    return q


def multiply(q, p):
    """Hamilton product q p, [..., 4] (quaternion.cuh operator*)."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack([
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
    ], dim=-1)


def from_rotation_vector(v):
    """exp(v / 2): the unit quaternion rotating by |v| about v / |v|
    (quaternion.cuh rotVec2Quaternion). Below |v| = 1e-6, sin(|v|/2) / |v|
    is its Taylor form 1/2 - |v|^2 / 48."""
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    small = theta < 1e-6
    sinc_half = torch.where(small, 0.5 - theta * theta / 48.0,
                            torch.sin(0.5 * theta) / torch.where(small, 1.0, theta))
    return torch.cat([torch.cos(0.5 * theta), v * sinc_half], dim=-1)


def rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def apply_rotation(q, omega_dt):
    """Advance orientations by a rotation-vector increment (BDHI_FCM.cuh:
    dir = rotVec2Quaternion(w dt) * dir)."""
    return normalize(multiply(from_rotation_vector(omega_dt), q))


def basis(q):
    """The rotated frame, [..., 3, 3]: basis(q)[..., i, :] is the image of
    e_i (quaternion.cuh getVx / getVy / getVz)."""
    e = torch.eye(3, dtype=q.dtype, device=q.device)
    return torch.stack([rotate(q, e[i]) for i in range(3)], dim=-2)
