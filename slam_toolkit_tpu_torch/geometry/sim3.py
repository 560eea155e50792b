"""Batched Sim(3) operations on torch tensors.

Counterpart of slam_toolkit_tpu/geometry/sim3.py, same conventions:
(..., 4, 4) matrices [[s*R, t], [0, 1]]; tangent vectors (..., 7) laid
out [rho(3), phi(3), sigma] (translation, rotation, log-scale); updates
multiply on the left, S_new = exp(xi) @ S_old. With sigma = 0 every
function reduces to its SE(3) counterpart.
"""

from __future__ import annotations

import torch

from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.se3 import hat, so3_exp, so3_log

_EPS = 1e-8


def make(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3), (...,) -> (..., 4, 4) with block s*R."""
    return se3.make(R * s[..., None, None], t)


def scale_of(S: torch.Tensor) -> torch.Tensor:
    """s from the [[s*R, t], [0, 1]] block: the mean of the row norms."""
    return torch.mean(torch.linalg.vector_norm(S[..., :3, :3], dim=-1),
                      dim=-1)


def rotation_of(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, :3] / scale_of(S)[..., None, None]


def inv(S: torch.Tensor) -> torch.Tensor:
    """(R, t, s)^-1 = (R^T, -(1/s) R^T t, 1/s)."""
    s = scale_of(S)
    Rt = (S[..., :3, :3] / s[..., None, None]).transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ S[..., :3, 3:4])[..., 0]
    return make(Rt, t_inv, s_inv)


def _calc_W(theta2: torch.Tensor, sigma: torch.Tensor, W_phi: torch.Tensor):
    """W = C I + A hat(phi) + B hat(phi)^2, the Sim(3) translation mixer
    (closed forms and series fallbacks as in the JAX package)."""
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    s = torch.exp(sigma)
    small_t = theta2 < 1e-8
    small_s = torch.abs(sigma) < 1e-5
    sigma_safe = torch.where(small_s, one, sigma)
    theta_safe = torch.where(small_t, one, theta)
    t2_safe = torch.where(small_t, one, theta2)
    c = theta2 + sigma * sigma
    c_safe = torch.where(c < _EPS, one, c)

    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sigma_safe)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    A_gen = (a * sigma + (1.0 - b) * theta) / (theta_safe * c_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / t2_safe
    s2 = sigma_safe * sigma_safe
    A_t0 = (s * (sigma - 1.0) + 1.0) / s2
    B_t0 = (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0) \
        / (2.0 * s2 * sigma_safe)
    A_s0 = torch.where(small_t, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / t2_safe)
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / (t2_safe * theta_safe))
    A = torch.where(small_s, A_s0, torch.where(small_t, A_t0, A_gen))
    B = torch.where(small_s, B_s0, torch.where(small_t, B_t0, B_gen))
    eye = torch.eye(3, dtype=W_phi.dtype, device=W_phi.device)
    return (C[..., None, None] * eye + A[..., None, None] * W_phi
            + B[..., None, None] * (W_phi @ W_phi))


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) [rho, phi, sigma] -> (..., 4, 4) similarity."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    theta2 = torch.sum(phi * phi, dim=-1)
    W = _calc_W(theta2, sigma, hat(phi))
    return make(so3_exp(phi), (W @ rho[..., None])[..., 0], torch.exp(sigma))


def log(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 7) [rho, phi, sigma]. rho is a batched LU
    solve, as in the JAX package: a closed-form adjugate inverse in
    float32 moved the pose-graph optimum there. solve_ex leaves the LU's
    error check on the device (a CUDA graph holds it)."""
    s = scale_of(S)
    sigma = torch.log(s)
    phi = so3_log(S[..., :3, :3] / s[..., None, None])
    W = _calc_W(torch.sum(phi * phi, dim=-1), sigma, hat(phi))
    rho = torch.linalg.solve_ex(W, S[..., :3, 3:4],
                                check_errors=False)[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def adjoint(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 7, 7) in [rho, phi, sigma] layout:
    [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    Ad = torch.zeros(S.shape[:-2] + (7, 7), dtype=S.dtype, device=S.device)
    Ad[..., :3, :3] = s[..., None, None] * R
    Ad[..., :3, 3:6] = hat(t) @ R
    Ad[..., :3, 6] = -t
    Ad[..., 3:6, 3:6] = R
    Ad[..., 6, 6].fill_(1.0)
    return Ad


def transform(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return se3.transform(S, X)


def normalize(S: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation factor, preserving scale."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    Rn = se3.normalize(se3.make(R, torch.zeros_like(S[..., :3, 3])))
    return make(Rn[..., :3, :3], S[..., :3, 3], s)


def from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    """Lift an SE(3) pose (optionally with a scale) to Sim(3)."""
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device).expand(
        T.shape[:-2])
    return make(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """[R, t/s]: the corrected similarity as a metric pose."""
    s = scale_of(S)
    return se3.make(rotation_of(S), S[..., :3, 3] / s[..., None])
