"""Batched PnP-RANSAC, rigid alignment and Euclidean clustering.

Counterpart of slam_toolkit_tpu/cluster/ransac.py, the stand-in for
the reference's per-cluster cv::solvePnPRansac loops and FLANN
Euclidean clustering (ref examples/epip_cluster/src/tracker.cpp:202-392,
:518-693). Every hypothesis of every problem is solved and scored at
once: the hypothesis solves and the refinements are
optim/pose_lm.optimize_pose under torch.func.vmap (the plain LM, as the
JAX package vmaps its XLA LM), and the samples are jax.random's draws
bit for bit (utils/threefry).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch.func import vmap

from slam_toolkit_tpu_torch.config import TrackerConfig
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.optim import pose_lm
from slam_toolkit_tpu_torch.utils import threefry


def kabsch_se3(P: torch.Tensor, Q: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment Q ~= R P + t, batched over leading axes.
    P, Q: (..., N, 3); w: (..., N). Returns (..., 4, 4)."""
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-9
    mp = torch.sum(P * w[..., None], dim=-2) / wsum
    mq = torch.sum(Q * w[..., None], dim=-2) / wsum
    Pc = P - mp[..., None, :]
    Qc = Q - mq[..., None, :]
    H = torch.einsum('...ni,...n,...nj->...ij', Pc, w, Qc)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    S = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ S @ Ut
    t = mq - (R @ mp[..., None])[..., 0]
    return se3.make(R, t)


class RansacResult(NamedTuple):
    T_cw: torch.Tensor       # (..., 4, 4) best model, refined
    inliers: torch.Tensor    # (..., N) bool
    n_inliers: torch.Tensor  # (...,)
    ok: torch.Tensor         # (...,)


def _project_err(T: torch.Tensor, Xw: torch.Tensor, uv: torch.Tensor):
    """Normalised reprojection error of points Xw (B, N, 3) under poses
    T (B, K, 4, 4) against uv (B, N, 2): (err (B, K, N), in front)."""
    Xc = torch.einsum('bkij,bnj->bkni', T[..., :3, :3], Xw) \
        + T[..., None, :3, 3]
    good = Xc[..., 2] > 1e-3
    z = torch.where(good, Xc[..., 2], torch.ones_like(Xc[..., 2]))
    err = torch.linalg.vector_norm(Xc[..., :2] / z[..., None]
                                   - uv[:, None], dim=-1)
    return err, good


def pnp_ransac_rows(Xw: torch.Tensor, uv_norm: torch.Tensor,
                    valid: torch.Tensor, keys: Sequence,
                    n_hypotheses: int = 64, sample_size: int = 4,
                    inlier_norm: float = 0.01, min_inliers: int = 20,
                    refine_iters: int = 5, u=None) -> RansacResult:
    """pnp_ransac for each of B problems at once (jax.vmap of the JAX
    pnp_ransac over its inputs and keys): Xw (B, N, 3), uv_norm (B, N,
    2), valid (B, N), one threefry key a problem, or instead `u` (B,
    n_hypotheses * sample_size), the keys' uniforms on the device
    (threefry.uniform_rows), which makes the call upload nothing."""
    B, n = valid.shape
    probs = valid.float()
    probs = probs / torch.clamp(probs.sum(dim=1, keepdim=True), min=1.0)
    idx = threefry.choice_p_rows(keys, probs, (n_hypotheses, sample_size),
                                 u=u)                           # (B, H, S)
    rows = torch.arange(B, device=Xw.device)[:, None, None]
    Xs, zs = Xw[rows, idx], uv_norm[rows, idx]                 # (B, H, S, .)

    cfg_s = TrackerConfig(num_iterations=3, huber_delta=1e9)
    eye = torch.eye(4, dtype=torch.float32, device=Xw.device)
    ones = torch.ones(sample_size, dtype=torch.float32, device=Xw.device)

    def solve_one(X, z):
        return pose_lm.optimize_pose(eye, X, z, ones, ones, cfg_s).T_cw

    Ts = vmap(vmap(solve_one))(Xs, zs)                          # (B, H, 4, 4)
    err, good = _project_err(Ts, Xw, uv_norm)
    inl = good & (err < inlier_norm) & valid[:, None]
    best = torch.argmax(torch.sum(inl, dim=-1), dim=1)          # first max
    bi = torch.arange(B, device=Xw.device)
    T_best, inliers = Ts[bi, best], inl[bi, best]

    cfg_r = TrackerConfig(num_iterations=refine_iters)
    sig2 = torch.full((n,), (1.0 / 500.0) ** 2, dtype=torch.float32,
                      device=Xw.device)

    def refine_one(T0, X, z, m):
        return pose_lm.optimize_pose(T0, X, z, sig2, m, cfg_r).T_cw

    T_ref = vmap(refine_one)(T_best, Xw, uv_norm, inliers)
    err, good = _project_err(T_ref[:, None], Xw, uv_norm)
    inliers = valid & good[:, 0] & (err[:, 0] < inlier_norm)
    n_in = torch.sum(inliers, dim=-1)
    return RansacResult(T_cw=T_ref, inliers=inliers, n_inliers=n_in,
                        ok=n_in >= min_inliers)


def pnp_ransac(Xw: torch.Tensor, uv_norm: torch.Tensor,
               valid: torch.Tensor, key, n_hypotheses: int = 64,
               sample_size: int = 4, inlier_norm: float = 0.01,
               min_inliers: int = 20, refine_iters: int = 5, u=None
               ) -> RansacResult:
    """3D->2D pose RANSAC over one problem, all hypotheses batched: each
    hypothesis runs 3 Gauss-Newton steps from identity on sample_size
    points drawn by `valid` (a threefry key, or `u`, its uniforms on the
    device), scored by normalised reprojection error; the best is
    refined on its inliers by a 5-step LM. Xw (N, 3), uv_norm (N, 2),
    valid (N,)."""
    r = pnp_ransac_rows(Xw[None], uv_norm[None], valid[None], [key],
                        n_hypotheses, sample_size, inlier_norm,
                        min_inliers, refine_iters,
                        None if u is None else u.reshape(1, -1))
    return RansacResult(*(v[0] for v in r))


def euclidean_cluster(X: torch.Tensor, valid: torch.Tensor, radius: float,
                      iters: int = 32, min_size: int = 50
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Connected components over the radius graph by min-label
    propagation with pointer jumping. X: (N, D). Returns (labels (N,)
    int32: the component's lowest point index, -1 for invalid points and
    components below min_size; sizes (N,) per point)."""
    n = X.shape[0]
    d2 = torch.sum((X[:, None, :] - X[None, :, :]) ** 2, dim=-1)
    adj = (d2 <= radius * radius) & valid[:, None] & valid[None, :]
    labels = torch.where(valid, torch.arange(n, dtype=torch.int32,
                                             device=X.device), n)
    sentinel = torch.full_like(labels, n)
    for _ in range(iters):
        neigh = torch.where(adj, labels[None, :], n)
        labels = torch.minimum(labels, torch.amin(neigh, dim=1))
        jump = labels[torch.clamp(labels, 0, n - 1).long()]
        labels = torch.minimum(labels, torch.where(labels < n, jump,
                                                   sentinel))
    sizes = torch.bincount(labels.long(), minlength=n + 1)[labels.long()]
    keep = valid & (sizes >= min_size)
    return (torch.where(keep, labels, -1).int(),
            torch.where(keep, sizes, 0).int())
