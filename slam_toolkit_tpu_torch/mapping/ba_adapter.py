"""MapState <-> BAProblem adapter: the local-mapping step.

Counterpart of slam_toolkit_tpu/mapping/ba_adapter.py (ref
StandardLocalMapper, src/localmapper.cpp:39-162): select the window of
the W most recent keyframes (the oldest fixed as gauge), gather up to P
landmarks they observe (multi-view ones first), build the fixed-shape
BA problem, solve it through ops/ba_kernel.solve_ba (the CUDA kernel on
a CUDA map, the plain solver on a CPU map), and write the poses and the
landmarks' inverse depths along their anchor rays back into the map.

The map is updated in place, like the rest of mapping/map_state. No
value is read back to the host: the non-finite guard is a torch.where.
Seam BA (select_seam_window, seam_ba_step) is the same pass over a
window straddling a just-closed loop, every pose held fixed.

The problem is built and written back over a leading lane axis (B
lanes, the JAX package's vmapped local-mapping step); one map is the
batch of one lane (utils/lanes.with_lane). The integer selection runs
once over the lanes, the landmark positions and pose algebra lane by
lane, the non-finite guard per lane. One map is solved by the kernel's
single entry; a batched map by one launch of its batched entry
(ops/ba_kernel.solve_ba_batched) with a (B,) lane mask, and only the
lanes the mask keeps are written back. Each kept lane's map is the
single step's bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.mapping.map_state import (MapState, _top_slots,
                                                      covisibility_counts,
                                                      lane_index,
                                                      mappoint_positions_at,
                                                      scatter_drop_lanes,
                                                      unique_prioritized,
                                                      write_rows_lanes)
from slam_toolkit_tpu_torch.ops import ba_kernel
from slam_toolkit_tpu_torch.optim.local_ba import BAProblem, BAResult
from slam_toolkit_tpu_torch.utils.lanes import lane, with_lane


def _lanes_of(*xs):
    """Each optional per-window tensor as a batch of one lane."""
    return tuple(None if x is None else x[None] for x in xs)


def select_window(m: MapState, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots (W,) int32, valid (W,)): the W most recent keyframes, newest
    first; empty slots (frame id -1) in index order, as lax.top_k. A
    batched map gives (B, W) for each lane's own."""
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, -1))
    vals, slots = _top_slots(fid, W)
    return slots.int(), vals >= 0


def select_points(m: MapState, window: torch.Tensor, P: int):
    """Up to P distinct mappoints observed by the window keyframes,
    landmarks observed at least twice in the window first. A batched map
    takes (B, W) windows."""
    if m.kf_valid.dim() == 1:
        return lane(select_points(with_lane(m), window[None], P), 0)
    B = window.shape[0]
    ids = m.kf_obs[lane_index(B, window.device), window.long()]
    uniq = unique_prioritized(ids.reshape(B, -1), P, m)
    ok = uniq < m.mp_valid.shape[-1]
    safe = torch.where(ok, uniq, torch.zeros_like(uniq))
    return safe, ok & torch.gather(m.mp_valid, 1, safe.long())


def select_seam_window(m: MapState, cur, cand, W: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both-sides window around a just-closed seam: the current and the
    candidate keyframe (host ints or 0-dim tensors on the map's device)
    forced in, then the keyframes most covisible with either (ties in
    index order, as lax.top_k)."""
    score = torch.maximum(covisibility_counts(m, cur),
                          covisibility_counts(m, cand)).float()
    score = torch.where(m.kf_valid, score, torch.full_like(score, -1.0))
    for slot, v in ((cur, 1e9), (cand, 1e9 - 1.0)):
        idx = slot.reshape(1).long() if torch.is_tensor(slot) else \
            torch.full((1,), int(slot), dtype=torch.int64,
                       device=score.device)
        score.index_fill_(0, idx, v)
    vals, slots = _top_slots(score, W)
    return slots.int(), (vals > 0) & m.kf_valid[slots]


def _kpt_at(obs_ids: torch.Tensor, pt_ids: torch.Tensor,
            pt_valid: torch.Tensor, M: int) -> torch.Tensor:
    """(B, W, P) int32: the keypoint of point p in window keyframe w, -1
    if unobserved (the largest such keypoint, as JAX's compare-reduce),
    through a scatter-amax over each (lane, keyframe)'s mappoint table:
    order-free, and no (B, W, K, P) compare."""
    B, W, K = obs_ids.shape
    dev = obs_ids.device
    rows = torch.arange(B * W, device=dev).reshape(B, W, 1) * (M + 1)
    idx = torch.where(obs_ids >= 0, obs_ids.long(),
                      torch.full_like(obs_ids, M, dtype=torch.int64)) + rows
    k_iota = torch.arange(K, device=dev).expand(B, W, K)
    table = torch.full((B * W * (M + 1),), -1, dtype=torch.int64, device=dev)
    table.scatter_reduce_(0, idx.reshape(-1), k_iota.reshape(-1), "amax")
    kpt = torch.gather(table.reshape(B, W, M + 1), 2,
                       pt_ids.long()[:, None, :].expand(B, W, -1))
    return torch.where(pt_valid[:, None, :], kpt,
                       torch.full_like(kpt, -1)).int()


def build_problem(m: MapState, cam: StereoCamera, cfg: SlamConfig,
                  window=None, win_valid=None, fixed_mask=None
                  ) -> Tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """The BA problem of the window (the current one, or the given one
    with the caller's gauge fixed_mask), its slots and its point ids. A
    batched map gives every lane's problem, with a leading lane axis on
    every field but the baseline (and window, win_valid, fixed_mask, when
    given, take one too)."""
    if m.kf_valid.dim() == 1:
        prob, window, pt_ids = build_problem(
            with_lane(m), cam, cfg, *_lanes_of(window, win_valid, fixed_mask))
        return lane(prob, 0), window[0], pt_ids[0]
    W = cfg.local_ba.window_keyframes
    P = cfg.local_ba.max_points
    B = m.kf_obs.shape[0]
    bi = lane_index(B, m.kf_obs.device)
    if window is None:
        window, win_valid = select_window(m, W)
    wl = window.long()
    pt_ids, pt_valid = select_points(m, window, P)

    kpt_at = _kpt_at(m.kf_obs[bi, wl], pt_ids, pt_valid,
                     m.mp_valid.shape[-1])                   # (B, W, P)
    obs_mask = kpt_at >= 0
    safe_kpt = torch.clamp(kpt_at, min=0).long()
    sigma2_n = m.kf_sigma2[bi, wl] / (cam.left.fx * cam.left.fx)
    packed = torch.cat([
        m.kf_norm[bi, wl], m.kf_right_x_norm[bi, wl][..., None],
        torch.rsqrt(torch.clamp(sigma2_n, min=1e-12))[..., None],
        m.kf_has_stereo[bi, wl].float()[..., None],
    ], dim=-1)                                               # (B, W, K, 5)
    got = torch.gather(packed, 2, safe_kpt[..., None].expand(-1, -1, -1, 5))
    z = torch.where(obs_mask[..., None], got[..., :3],
                    torch.zeros_like(got[..., :3]))
    inv_sigma = torch.where(obs_mask, got[..., 3],
                            torch.ones_like(got[..., 3]))
    stereo_mask = obs_mask & (got[..., 4] > 0.5)

    Xw = mappoint_positions_at(m, pt_ids)
    if fixed_mask is None:
        # gauge: the OLDEST valid keyframe of the window is fixed
        fid = m.kf_frame_id[bi, wl]
        fid = torch.where(win_valid, fid,
                          torch.full_like(fid, torch.iinfo(torch.int32).max))
        pose_fixed = torch.zeros_like(win_valid)
        pose_fixed.scatter_(1, torch.argmin(fid, dim=-1)[:, None], True)
    else:
        pose_fixed = fixed_mask          # the caller's gauge (seam BA)

    # a point anchored outside the window stays fixed: the window leans
    # on old structure without dragging it off its other observations
    anchors = torch.gather(m.mp_ref_kf, 1, pt_ids.long())
    anchor_in_win = torch.any((anchors[:, :, None] == window[:, None, :]) &
                              win_valid[:, None, :], dim=-1)
    prob = BAProblem(
        T_cw=m.kf_T_cw[bi, wl], pose_fixed=pose_fixed | ~win_valid,
        pose_valid=win_valid, Xw=Xw, point_valid=pt_valid, z=z,
        inv_sigma=inv_sigma, obs_mask=obs_mask, stereo_mask=stereo_mask,
        baseline=cam.baseline, point_free=anchor_in_win)
    return prob, window, pt_ids


def write_back(m: MapState, res: BAResult, window: torch.Tensor,
               win_valid: torch.Tensor, pose_fixed: torch.Tensor,
               pt_ids: torch.Tensor, pt_valid: torch.Tensor,
               lanes=None) -> MapState:
    """Poses of the free window slots, and inverse depths along each
    point's anchor ray (RetriveStructure, ref src/method.cpp:118-126); a
    point optimized behind its anchor is invalidated. In place. A
    batched map is written in the lanes the (B,) mask `lanes` keeps
    (None: every lane); the others keep every value."""
    if m.kf_valid.dim() == 1:
        write_back(with_lane(m), with_lane(res),
                   *_lanes_of(window, win_valid, pose_fixed, pt_ids,
                              pt_valid))
        return m
    B = m.kf_obs.shape[0]
    M = m.mp_valid.shape[-1]
    bi = lane_index(B, window.device)
    keep = torch.ones((B,), dtype=torch.bool, device=window.device) \
        if lanes is None else lanes.bool()
    wl = window.long()
    upd = win_valid & ~pose_fixed
    new_T = torch.where(upd[..., None, None], res.T_cw, m.kf_T_cw[bi, wl])
    write_rows_lanes(m.kf_T_cw, wl, new_T, keep)  # window slots distinct

    ref = torch.gather(m.mp_ref_kf, 1, pt_ids.long()).long()
    z_ref = se3.per_lane(se3.transform, m.kf_T_cw[bi, ref], res.Xw)[..., 2]
    invd_new = 1.0 / torch.clamp(z_ref, min=1e-3)
    behind = pt_valid & (z_ref <= 1e-3)
    sentinel = torch.full_like(pt_ids, M)
    kept = keep[:, None]
    mp_invd = scatter_drop_lanes(m.mp_invd, torch.where(
        pt_valid & kept, pt_ids, sentinel), invd_new)
    mp_valid = scatter_drop_lanes(m.mp_valid, torch.where(
        behind & kept, pt_ids, sentinel), False)
    m.mp_invd.copy_(mp_invd)
    m.mp_valid.copy_(mp_valid)
    return m


def local_ba_step(m: MapState, cam: StereoCamera, cfg: SlamConfig,
                  window=None, win_valid=None, fixed_mask=None,
                  lanes=None) -> MapState:
    """One local-BA pass over the current window, or the given one (ref
    src/pipeline.cpp:137-138). Updates `m` in place and returns it. One
    map: the kernel's single entry. A batched map: every lane's window in
    one launch of the batched entry, solving and writing back the lanes
    the (B,) mask `lanes` keeps (None: every lane)."""
    one = m.kf_valid.dim() == 1
    mb = with_lane(m) if one else m
    if one:
        window, win_valid, fixed_mask = _lanes_of(window, win_valid,
                                                  fixed_mask)
    prob, window, pt_ids = build_problem(mb, cam, cfg, window, win_valid,
                                         fixed_mask)
    lb = cfg.local_ba
    kw = dict(iters=lb.num_iterations, huber_delta=lb.huber_delta,
              lambda0=lb.lm_lambda0, lambda_up=lb.lm_lambda_up,
              lambda_down=lb.lm_lambda_down, trim_sigma=lb.trim_sigma)
    if one:
        res = with_lane(ba_kernel.solve_ba(lane(prob, 0), **kw))
    else:
        if lanes is None:
            lanes = torch.ones((mb.kf_obs.shape[0],), dtype=torch.bool,
                               device=window.device)
        res = ba_kernel.solve_ba_batched(prob, lanes, **kw)
    # a lane's solver result with ANY non-finite value is discarded
    # wholesale (its pre-BA map is kept); a device-side select
    ok = torch.isfinite(res.T_cw).flatten(1).all(dim=1) & \
        torch.isfinite(res.Xw).flatten(1).all(dim=1)
    res = res._replace(T_cw=torch.where(ok[:, None, None, None], res.T_cw,
                                        prob.T_cw),
                       Xw=torch.where(ok[:, None, None], res.Xw, prob.Xw))
    write_back(mb, res, window, prob.pose_valid, prob.pose_fixed, pt_ids,
               prob.point_valid, lanes)
    return m


def seam_ba_step(m: MapState, cur, cand, cam: StereoCamera,
                 cfg: SlamConfig) -> MapState:
    """Post-closure seam BA: one structure-only local-BA pass (every pose
    of the window fixed) over select_seam_window's both-sides window."""
    window, win_valid = select_seam_window(m, cur, cand,
                                           cfg.local_ba.window_keyframes)
    return local_ba_step(m, cam, cfg, window, win_valid,
                         fixed_mask=torch.ones_like(win_valid))
