"""One frame of indirect tracking against a landmark snapshot, plain
PyTorch.

extract -> undistorted normalized coords -> projection match (top-2
Hamming under the r and 2r pixel gates, the ratio test, the doubled
radius when fewer than 8 pass, one match a keypoint) -> motion-only LM
(Huber, 10 damped steps with accept/reject) -> the reprojection filter
-> the grid-occupancy keyframe rule. The pose starts from the
constant-velocity prediction velocity @ T_prev. Settings come from the
configuration file's sections. Frozen copy of the port's plain path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import extractor as ext
from benchmark.reference import geometry as geo

BIG = 1e9


class Tracked(NamedTuple):
    T_cw: torch.Tensor        # (4, 4) the tracked pose (the prediction
    #                           where tracking failed)
    n_inliers: int
    ok: bool
    needs_keyframe: bool


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return 2.0 * bits.reshape(desc.shape[:-1] + (256,)).float() - 1.0


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 8) x (N, 8) packed descriptors -> (M, N) Hamming distances
    (the +-1 product sums integers below 2**24: exact in float32)."""
    return 0.5 * (256.0 - unpack_pm1(a) @ unpack_pm1(b).transpose(-1, -2))


def topk2(a_desc, b_desc, a_uv, b_xy, radius: float) -> torch.Tensor:
    """(M, 6): best, second best and best index under the r gate, then
    the same under the 2r gate."""
    dist = distance_matrix(a_desc, b_desc)
    du = a_uv[:, None, 0] - b_xy[None, :, 0]
    dv = a_uv[:, None, 1] - b_xy[None, :, 1]
    d2 = du * du + dv * dv
    rows = torch.arange(a_desc.shape[0], device=a_desc.device)
    big = torch.full_like(dist, BIG)
    cols = []
    for rsq in (float(np.float32(radius * radius)),
                float(np.float32(4.0 * radius * radius))):
        md = torch.where(d2 <= rsq, dist, big)
        idx = torch.argmin(md, dim=1)
        best = md[rows, idx]
        sec = md.index_put((rows, idx), torch.full_like(best, BIG)).min(dim=1)
        cols += [best, sec.values, idx.float()]
    return torch.stack(cols, dim=1)


def keep_best_per_target(idx, ok, dist_best, num_targets: int):
    """One source a target: the smallest distance, ties to the lowest
    source."""
    m = idx.shape[-1]
    src = torch.arange(m, dtype=torch.float32, device=idx.device)
    packed = torch.where(ok, dist_best * 4096.0 + src,
                         torch.full_like(src, BIG))
    per_target = torch.full((num_targets,), BIG, dtype=torch.float32,
                            device=idx.device)
    per_target = per_target.scatter_reduce(-1, idx.long(), packed,
                                           reduce="amin", include_self=True)
    return ok & (packed <= torch.gather(per_target, -1, idx.long()))


def projection_match(Xw, lm_desc, lm_valid, feats: ext.Features, T_cw, cam,
                     matcher: dict):
    """(keypoint index (L,), ok (L,)) of each landmark."""
    radius = float(matcher["projection_radius"])
    Xc = geo.transform(T_cw, Xw)
    uv = geo.project(cam, Xc)
    visible = lm_valid & (Xc[:, 2] > 0.05) & geo.in_image(cam, uv)
    a_uv = torch.where(visible[:, None], uv, torch.full_like(uv, 1e7))
    b_xy = torch.where(feats.valid[:, None], feats.xy,
                       torch.full_like(feats.xy, -1e7))
    t2 = topk2(lm_desc, feats.desc, a_uv, b_xy, radius)
    max_h, ratio = matcher["max_hamming"], matcher["track_ratio"]
    ok1 = (t2[:, 0] <= max_h) & (t2[:, 0] < ratio * t2[:, 1])
    ok2 = (t2[:, 3] <= max_h) & (t2[:, 3] < ratio * t2[:, 4])
    wide = torch.sum(ok1) < 8
    idx = torch.where(wide, t2[:, 5], t2[:, 2]).int()
    ok = torch.where(wide, ok2, ok1)
    best = torch.where(wide, t2[:, 3], t2[:, 0])
    return idx, keep_best_per_target(idx, ok, best, feats.desc.shape[0])


def _huber_weight(r, delta):
    return torch.clamp(delta / torch.clamp(r, min=1e-12), max=1.0)


def _huber_cost(r, delta):
    return torch.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta))


def _residuals(T, Xw, z_norm, inv_sigma):
    Xc = geo.transform(T, Xw)
    z = Xc[:, 2]
    good = z > 1e-3
    zs = torch.where(good, z, torch.ones_like(z))
    pred = torch.stack([Xc[:, 0] / zs, Xc[:, 1] / zs], dim=-1)
    return (pred - z_norm) * inv_sigma[:, None], Xc, good


def _jacobian(Xc, inv_sigma):
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zs = torch.where(z > 1e-3, z, torch.ones_like(z))
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    ju = torch.stack([iz, zero, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2,
                      -y * iz], dim=-1)
    jv = torch.stack([zero, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2,
                      x * iz], dim=-1)
    return torch.stack([ju, jv], dim=-2) * inv_sigma[:, None, None]


def optimize_pose(T_init, Xw, z_norm, sigma2, mask, tr: dict):
    """Motion-only LM from T_init over tr["num_iterations"] damped steps."""
    delta = float(tr["huber_delta"])
    inv_sigma = torch.rsqrt(torch.clamp(sigma2, min=1e-12))
    w_valid = mask.float()
    behind = 0.5 * 1e6 if 1e3 <= delta else delta * (1e3 - 0.5 * delta)
    eye6 = torch.eye(6, dtype=torch.float32, device=Xw.device)

    def cost_at(T):
        r, _, good = _residuals(T, Xw, z_norm, inv_sigma)
        rn = torch.linalg.vector_norm(r, dim=-1)
        return torch.sum(_huber_cost(rn, delta) * w_valid * good) + \
            behind * torch.sum(w_valid * (~good).float())

    T = T_init
    lam = torch.full((), tr["lm_lambda0"], dtype=torch.float32,
                     device=Xw.device)
    cost = cost_at(T)
    for _ in range(int(tr["num_iterations"])):
        r, Xc, good = _residuals(T, Xw, z_norm, inv_sigma)
        rn = torch.linalg.vector_norm(r, dim=-1)
        w_rob = w_valid * good * _huber_weight(rn, delta)
        J = _jacobian(Xc, inv_sigma)
        H = torch.einsum('nri,n,nrj->ij', J, w_rob, J)
        b = -torch.einsum('nri,n,nr->i', J, w_rob, r)
        H_damped = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
        xi = torch.linalg.solve_ex(H_damped, b)[0]
        T_try = geo.normalize(geo.compose(geo.exp(xi), T))
        cost_try = cost_at(T_try)
        accept = cost_try < cost
        T = torch.where(accept, T_try, T)
        lam = torch.where(accept, lam * tr["lm_lambda_down"],
                          lam * tr["lm_lambda_up"])
        cost = torch.where(accept, cost_try, cost)
    return T


def needs_keyframe(kpt_xy, inlier, width: int, height: int,
                   kf: dict) -> torch.Tensor:
    cols, rows = int(kf["grid_cols"]), int(kf["grid_rows"])
    cx = torch.clamp((kpt_xy[:, 0] * cols / width).int(), 0, cols - 1)
    cy = torch.clamp((kpt_xy[:, 1] * rows / height).int(), 0, rows - 1)
    cell = cy * cols + cx
    cells = torch.arange(cols * rows, device=kpt_xy.device)[:, None]
    counts = torch.sum((cell[None, :] == cells) & inlier[None, :], dim=-1)
    return (torch.sum(counts) < kf["min_total"]) | \
        torch.any(counts < kf["min_per_cell"])


def track_frame(left: torch.Tensor, state: dict, cam: geo.Camera,
                cfg: dict) -> Tracked:
    """Track one left image against `state` (T_cw and velocity of the
    frame before, the landmark snapshot lm_Xw, lm_desc, lm_valid, and
    inlier_peak), as the frame after a chunk boundary is tracked."""
    feats = ext.extract(left, cfg["extractor"])
    norm = geo.pixel_to_normalized(cam, feats.xy)
    norm = torch.where(feats.valid[:, None], norm, torch.zeros_like(norm))
    T_pred = geo.compose(state["velocity"], state["T_cw"])
    Xw = state["lm_Xw"]
    kpt, ok = projection_match(Xw, state["lm_desc"], state["lm_valid"],
                               feats, T_pred, cam, cfg["matcher"])
    k = kpt.long()
    tr = cfg["tracker"]
    T = optimize_pose(T_pred, Xw, norm[k], feats.sigma2[k] / (cam.fx * cam.fx),
                      ok, tr)
    xy_kpt = feats.xy[k]
    Xc = geo.transform(T, Xw)
    err = torch.linalg.vector_norm(geo.project(cam, Xc) - xy_kpt, dim=-1)
    inlier = ok & (Xc[:, 2] > 0.0) & (err <= tr["reprojection_px"])
    final = inlier if int(torch.sum(inlier)) >= tr["min_matches"] else ok
    n_inl = int(torch.sum(final))
    good = n_inl >= tr["min_matches"]
    kf = cfg["keyframe"]
    needs = bool(needs_keyframe(xy_kpt, final, cam.width, cam.height, kf)) \
        or not good or n_inl < kf["decay_ratio"] * float(state["inlier_peak"])
    return Tracked(T_cw=T if good else T_pred, n_inliers=n_inl, ok=good,
                   needs_keyframe=needs)
