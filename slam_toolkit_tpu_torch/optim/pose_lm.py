"""Motion-only pose estimation: Levenberg-Marquardt on SE(3).

Counterpart of slam_toolkit_tpu/optim/pose_lm.py. Residuals are
whitened normalized reprojection errors under a Huber kernel; 10 damped
Gauss-Newton steps
with accept/reject, as in ref src/posetracker.cpp:53-99. The 2-row path
is also the plain version the pose-LM kernel (ops/pose_lm_kernel.py) is
held against; the loop closer adds the optional stereo right-x row
(ref EdgeStereoSE3ProjectXYZ, src/method.cpp:43-57).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_toolkit_tpu_torch.config import TrackerConfig
from slam_toolkit_tpu_torch.geometry import camera as cam_mod
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.optim import robust


class PoseLMResult(NamedTuple):
    T_cw: torch.Tensor        # (4, 4) optimized pose
    cost: torch.Tensor        # () final robust cost
    inlier_r2: torch.Tensor   # (N,) squared whitened residual norms


def _residuals(T_cw, Xw, z_norm, inv_sigma, stereo=None):
    """Whitened residuals (N, 2), camera-frame points, in-front mask.
    stereo: optional (z_right_norm (N,), stereo_mask (N,), baseline)
    adds a third row ((x - b)/z - ur_n)/sigma, zeroed without stereo."""
    Xc = se3.transform(T_cw, Xw)
    z = Xc[..., 2]
    good = z > 1e-3
    zsafe = torch.where(good, z, torch.ones_like(z))
    pred = torch.stack([Xc[..., 0] / zsafe, Xc[..., 1] / zsafe], dim=-1)
    r = (pred - z_norm) * inv_sigma[:, None]
    if stereo is not None:
        z_right, s_mask, b = stereo
        r3 = ((Xc[..., 0] - b) / zsafe - z_right) * inv_sigma * s_mask
        r = torch.cat([r, r3[:, None]], dim=-1)
    return r, Xc, good


def _jacobian(Xc, inv_sigma, stereo=None):
    """(N, 2, 6) d(whitened residual)/d(xi) for T <- exp(xi) T; (N, 3, 6)
    with the stereo row."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(z > 1e-3, z, torch.ones_like(z))
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    ju = torch.stack([iz, zero, -x * iz2,
                      -x * y * iz2, 1.0 + x * x * iz2, -y * iz], dim=-1)
    jv = torch.stack([zero, iz, -y * iz2,
                      -(1.0 + y * y * iz2), x * y * iz2, x * iz], dim=-1)
    rows = [ju, jv]
    if stereo is not None:
        _, s_mask, b = stereo
        xb = x - b
        rows.append(torch.stack([iz, zero, -xb * iz2, -xb * y * iz2,
                                 1.0 + x * xb * iz2, -y * iz], dim=-1)
                    * s_mask[:, None])
    return torch.stack(rows, dim=-2) * inv_sigma[:, None, None]


def reprojection_inliers(cam_left, T_cw, Xw, xy_obs, ok, px_thresh: float):
    """In front of the camera and reprojecting within px_thresh pixels
    (ref ReprojectionFilter, src/posetracker.cpp:106-137).
    Returns (inlier_mask, depths); with a leading lane axis on T_cw,
    Xw, xy_obs and ok, each lane's as its own call's (se3.per_lane)."""
    Xc = se3.transform(T_cw, Xw) if T_cw.dim() == 2 else \
        se3.per_lane(se3.transform, T_cw, Xw)
    uv = cam_mod.project(cam_left, Xc)
    err_px = torch.linalg.vector_norm(uv - xy_obs, dim=-1)
    inlier = ok & (Xc[..., 2] > 0.0) & (err_px <= px_thresh)
    return inlier, Xc[..., 2]


def behind_cost(delta: float) -> float:
    """The cost of a point pushed behind the camera: the Huber cost of a
    residual of 1e3, more than any plausible reprojection error, so
    such a point cannot drop out of the cost."""
    return 0.5 * 1e3 * 1e3 if 1e3 <= delta else delta * (1e3 - 0.5 * delta)


def optimize_pose(T_init, Xw, z_norm, sigma2, weight_mask,
                  cfg: TrackerConfig, stereo=None) -> PoseLMResult:
    """LM over cfg.num_iterations with accept/reject damping. Xw (N, 3)
    fixed landmarks, z_norm (N, 2) normalized observations, sigma2 (N,)
    variances, weight_mask (N,) validity, stereo the optional right-x
    row (see _residuals). No host synchronisation."""
    inv_sigma = torch.rsqrt(torch.clamp(sigma2, min=1e-12))
    w_valid = weight_mask.float()
    behind = behind_cost(cfg.huber_delta)
    eye6 = torch.eye(6, dtype=torch.float32, device=Xw.device)

    def cost_at(T):
        r, _, good = _residuals(T, Xw, z_norm, inv_sigma, stereo)
        rn = torch.linalg.vector_norm(r, dim=-1)
        return torch.sum(robust.huber_cost(rn, cfg.huber_delta)
                         * w_valid * good) + \
            behind * torch.sum(w_valid * (~good).float())

    T = T_init
    lam = torch.full((), cfg.lm_lambda0, dtype=torch.float32,
                     device=Xw.device)
    cost = cost_at(T)
    for _ in range(cfg.num_iterations):
        r, Xc, good = _residuals(T, Xw, z_norm, inv_sigma, stereo)
        w = w_valid * good
        rn = torch.linalg.vector_norm(r, dim=-1)
        w_rob = w * robust.huber_weight(rn, cfg.huber_delta)
        J = _jacobian(Xc, inv_sigma, stereo)
        H = torch.einsum('nri,n,nrj->ij', J, w_rob, J)
        b = -torch.einsum('nri,n,nr->i', J, w_rob, r)
        H_damped = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
        xi = torch.linalg.solve_ex(H_damped, b)[0]
        T_try = se3.normalize(se3.compose(se3.exp(xi), T))
        cost_try = cost_at(T_try)
        accept = cost_try < cost
        T = torch.where(accept, T_try, T)
        lam = torch.where(accept, lam * cfg.lm_lambda_down,
                          lam * cfg.lm_lambda_up)
        cost = torch.where(accept, cost_try, cost)
    r_fin, _, good = _residuals(T, Xw, z_norm, inv_sigma, stereo)
    r2 = torch.sum(r_fin * r_fin, dim=-1)
    r2 = torch.where(w_valid * good > 0, r2, torch.full_like(r2, float("inf")))
    return PoseLMResult(T_cw=T, cost=cost, inlier_r2=r2)
