"""Loop closing: relative pose, pose-graph correction, mappoint merge.

Counterpart of slam_toolkit_tpu/loop/closer.py (ref src/loopcloser.cpp):

- relative_pose (GetRelativePose, :51-100): the current keyframe
  re-tracked against the landmarks of the candidate and its covisible
  neighbours, the candidate's pose as prediction; putative matches by
  projection (the top-2 matcher at the projection radius) and, as a
  fallback, by a global mutual Hamming match; a RANSAC of 64 four-point
  Gauss-Newton hypotheses picks the consensus before the stereo LM. The
  hypotheses are one batched plain-torch LM (the JAX package runs them
  as a vmap outside any Pallas kernel), drawn from the same threefry
  keys as the JAX package (utils/threefry). With loop.relpose_stereo_aug
  the candidate keyframe's stereo keypoints join the landmarks, as in
  the JAX package, double vote included (_candidate_group_landmarks);
- close_loop (CloseLoop, :104-220): the SE(3) or Sim(3) pose graph over
  the keyframes in age order, compacted to a tier of slots, after a
  rigid pre-correction of the recent segment;
- merge_mappoints (CombineNeighborMappoints, :223-299): candidate-side
  landmarks matched into the current keyframe at the loop radius win
  over the current side's duplicates;
- relocalize_frame: a lost frame re-tracked against one keyframe's
  landmarks (no reference counterpart).

Functions return a new MapState; the fields they replace are new
tensors, the rest are shared with the input. Scatters with repeated
indices resolve as XLA's in-order scatter does (the last writer wins),
through a max-reduction of the writer's index, so the result is the
same on every run and device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig, TrackerConfig
from slam_toolkit_tpu_torch.frontend.matching import projection_match
from slam_toolkit_tpu_torch.geometry import se3, sim3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.loop.detector import insertion_rank
from slam_toolkit_tpu_torch.mapping.map_state import (MapState, _top_slots,
                                                      at,
                                                      covisibility_counts,
                                                      mappoint_positions_at,
                                                      row,
                                                      unique_prioritized)
from slam_toolkit_tpu_torch.ops import hamming
from slam_toolkit_tpu_torch.ops.extractor import FrameFeatures
from slam_toolkit_tpu_torch.optim import pose_lm, robust
from slam_toolkit_tpu_torch.optim.pose_graph import (PoseGraphProblem,
                                                     solve_pose_graph,
                                                     solve_pose_graph_sim3)
from slam_toolkit_tpu_torch.utils import threefry
from slam_toolkit_tpu_torch.utils.device import constant

N_HYPOTHESES = 64
SAMPLE_SIZE = 4


class RelPoseResult(NamedTuple):
    T_cw: torch.Tensor        # corrected pose of the current keyframe
    n_inliers: torch.Tensor
    ok: torch.Tensor
    scale: torch.Tensor       # current/candidate map scale (sim3 only; 1)
    n_near: torch.Tensor      # final inliers nearer than the depth gate


def _kf_features(m: MapState, slot) -> FrameFeatures:
    """A FrameFeatures view of a stored keyframe row (slot a host int or a
    0-dim tensor on the map's device)."""
    k = m.kf_xy.shape[1]
    dev = m.kf_xy.device
    zeros = torch.zeros((k,), dtype=torch.float32, device=dev)
    return FrameFeatures(
        xy=at(m.kf_xy, slot), response=zeros,
        octave=torch.zeros((k,), dtype=torch.int32, device=dev),
        angle=zeros, sigma2=at(m.kf_sigma2, slot),
        desc=at(m.kf_desc, slot).reshape(-1, 8),
        valid=at(m.kf_kpt_valid, slot))


def _slot(s, device) -> torch.Tensor:
    """A keyframe slot as a 0-dim int64 tensor on `device` (a host int is
    filled in, not uploaded)."""
    if torch.is_tensor(s):
        return s.reshape(()).long()
    return torch.full((), int(s), dtype=torch.int64, device=device)


def _candidate_group_landmarks(m: MapState, cur_slot, cand_slot,
                               cfg: SlamConfig):
    """Landmarks of the candidate and its top covisible neighbours at
    least min_kf_gap insertions older than the current keyframe,
    deduplicated: (Xw (L, 3), desc (L, 8), valid (L,)).

    With loop.relpose_stereo_aug (off by default, as in the JAX package)
    the candidate keyframe's own stereo keypoints follow as K more rows,
    triangulated from their stored disparity (depth between 0.5 m and
    2 * relpose_depth_baselines baselines), so L + K rows reach the
    top-2 matcher. Ported as the JAX package has it: a keypoint that
    also anchors one of the L landmarks is a second row at the same
    place with the same descriptor, so one correspondence can be counted
    twice (ADVICE.md); changing that would change the reference's
    behaviour."""
    F = m.kf_valid.shape[0]
    K = m.kf_obs.shape[1]
    nb = cfg.loop.relpose_neighbor_kfs
    ids = at(m.kf_obs, cand_slot)
    if nb > 0:
        cov = covisibility_counts(m, cand_slot)
        rank = insertion_rank(m)
        slots = torch.arange(F, device=cov.device)
        ok_nb = m.kf_valid & (slots != cand_slot) & \
            (rank <= at(rank, cur_slot) - cfg.loop.min_kf_gap)
        cov = torch.where(ok_nb, cov, torch.zeros_like(cov))
        cov_top, nbs = _top_slots(cov, nb)
        ids_n = m.kf_obs[nbs].reshape(-1)
        ids_n = torch.where(torch.repeat_interleave(cov_top > 0, K), ids_n,
                            torch.full_like(ids_n, -1))
        ids = torch.cat([ids, ids_n])
    uniq = unique_prioritized(ids, cfg.loop.relpose_landmarks, m)
    ok = uniq < m.mp_valid.shape[0]
    safe = torch.where(ok, uniq, torch.zeros_like(uniq)).long()
    Xw, desc = mappoint_positions_at(m, safe), m.mp_desc[safe]
    valid = ok & m.mp_valid[safe]
    if not cfg.loop.relpose_stereo_aug:
        return Xw, desc, valid
    norm_c = at(m.kf_norm, cand_slot)                      # (K, 2)
    disp_n = norm_c[:, 0] - at(m.kf_right_x_norm, cand_slot)
    baseline = cfg.camera.baseline
    z_c = baseline / torch.clamp(disp_n, min=1e-6)
    aug_ok = (at(m.kf_kpt_valid, cand_slot) & at(m.kf_has_stereo, cand_slot)
              & (disp_n > 1e-6) & (z_c > 0.5)
              & (z_c < 2.0 * cfg.loop.relpose_depth_baselines * baseline))
    ray = torch.cat([norm_c, torch.ones_like(z_c)[:, None]], dim=-1)
    Xw_aug = se3.transform(se3.inv(at(m.kf_T_cw, cand_slot)),
                           ray * z_c[:, None])
    return (torch.cat([Xw, Xw_aug]),
            torch.cat([desc, at(m.kf_desc, cand_slot).reshape(-1, 8)]),
            torch.cat([valid, aug_ok]))


def _camera_points(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(H, 4, 4) poses applied to (H, S, 3) or (S, 3) points."""
    if X.dim() == 2:
        return torch.einsum('hij,sj->hsi', T[:, :3, :3], X) + T[:, None, :3, 3]
    return torch.einsum('hij,hsj->hsi', T[:, :3, :3], X) + T[:, None, :3, 3]


def _hypotheses_lm(T0: torch.Tensor, Xw: torch.Tensor, z: torch.Tensor,
                   cfg: TrackerConfig) -> torch.Tensor:
    """pose_lm.optimize_pose from T0 for each of H point samples at once
    (Xw (H, S, 3), z (H, S, 2), unit variances and weights): (H, 4, 4)."""
    H = Xw.shape[0]
    behind = pose_lm.behind_cost(cfg.huber_delta)
    eye6 = torch.eye(6, dtype=torch.float32, device=Xw.device)

    def residuals(T):
        Xc = _camera_points(T, Xw)
        good = Xc[..., 2] > 1e-3
        zs = torch.where(good, Xc[..., 2], torch.ones_like(Xc[..., 2]))
        return Xc[..., :2] / zs[..., None] - z, Xc, good

    def cost_at(T):
        r, _, good = residuals(T)
        rn = torch.linalg.vector_norm(r, dim=-1)
        return torch.sum(robust.huber_cost(rn, cfg.huber_delta) * good,
                         dim=1) + behind * torch.sum((~good).float(), dim=1)

    T = T0.expand(H, 4, 4)
    lam = torch.full((H,), cfg.lm_lambda0, dtype=torch.float32,
                     device=Xw.device)
    cost = cost_at(T)
    for _ in range(cfg.num_iterations):
        r, Xc, good = residuals(T)
        w_rob = good * robust.huber_weight(
            torch.linalg.vector_norm(r, dim=-1), cfg.huber_delta)
        J = pose_lm._jacobian(Xc.reshape(-1, 3),
                              torch.ones_like(w_rob).reshape(-1)) \
            .reshape(H, -1, 2, 6)
        Hm = torch.einsum('hsri,hs,hsrj->hij', J, w_rob, J)
        b = -torch.einsum('hsri,hs,hsr->hi', J, w_rob, r)
        Hd = Hm + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(Hm, dim1=-2, dim2=-1)) + 1e-9 * eye6
        xi = torch.linalg.solve_ex(Hd, b)[0]
        T_try = se3.normalize(se3.exp(xi) @ T)
        cost_try = cost_at(T_try)
        accept = cost_try < cost
        T = torch.where(accept[:, None, None], T_try, T)
        lam = torch.where(accept, lam * cfg.lm_lambda_down,
                          lam * cfg.lm_lambda_up)
        cost = torch.where(accept, cost_try, cost)
    return T


def _ransac_consensus(T_pred: torch.Tensor, Xw: torch.Tensor,
                      z_norm: torch.Tensor, ok: torch.Tensor,
                      inlier_norm: float, key,
                      n_hypotheses: int = N_HYPOTHESES,
                      sample_size: int = SAMPLE_SIZE) -> torch.Tensor:
    """Consensus mask over putative loop matches: n_hypotheses samples
    of sample_size matches (weighted by `ok`, with replacement), each
    solved by 3 Gauss-Newton steps from the prediction and scored by
    normalized reprojection over every putative match; the mask of the
    best one (the first on ties)."""
    probs = ok.float()
    probs = probs / torch.clamp(probs.sum(), min=1.0)
    idx = threefry.choice_p(key, probs, (n_hypotheses, sample_size))
    cfg_h = TrackerConfig(num_iterations=3, huber_delta=1e9)
    Ts = _hypotheses_lm(T_pred, Xw[idx], z_norm[idx], cfg_h)
    Xc = _camera_points(Ts, Xw)                             # (H, L, 3)
    good = Xc[..., 2] > 1e-3
    zs = torch.where(good, Xc[..., 2], torch.ones_like(Xc[..., 2]))
    err = torch.linalg.vector_norm(Xc[..., :2] / zs[..., None]
                                   - z_norm[None], dim=-1)
    inl = good & (err < inlier_norm) & ok[None]
    return row(inl, torch.argmax(torch.sum(inl, dim=-1)))


def _decoupled_rt_refine(T0, Xw, z_norm, inv_sig, use, near, stereo,
                         huber_delta: float, rounds: int) -> torch.Tensor:
    """Alternating rotation-only (far-rich set, t frozen) and
    translation-only (near set, R frozen, with the stereo rows)
    Gauss-Newton polish of a loop relative pose."""
    far = use & ~near
    rot_sel = torch.where(torch.sum(far) >= 20, far, use).float()
    t_sel = torch.where(torch.sum(use & near) >= 6, use & near, use).float()
    z_r_norm, s_mask, baseline = stereo
    eye3 = torch.eye(3, dtype=torch.float32, device=Xw.device)

    def gn_step(T, sel, rot: bool):
        R, t = T[:3, :3], T[:3, 3]
        Xc = Xw @ R.T + t
        good = Xc[:, 2] > 1e-3
        z = torch.where(good, Xc[:, 2], torch.ones_like(Xc[:, 2]))
        r = (Xc[:, :2] / z[:, None] - z_norm) * inv_sig[:, None]
        w = sel * good * robust.huber_weight(
            torch.linalg.vector_norm(r, dim=-1), huber_delta)
        iz = inv_sig / z
        x, y = Xc[:, 0], Xc[:, 1]
        zero = torch.zeros_like(iz)
        Ju = torch.stack([torch.stack([iz, zero, -x * iz / z], -1),
                          torch.stack([zero, iz, -y * iz / z], -1)], dim=-2)
        J = -torch.einsum('nij,njk->nik', Ju, se3.hat(Xc - t)) if rot else Ju
        Hm = torch.einsum('n,nij,nik->jk', w, J, J)
        g = torch.einsum('n,nij,ni->j', w, J, r)
        if not rot:
            rs = ((x - baseline) / z - z_r_norm) * inv_sig
            ws = sel * good * s_mask * robust.huber_weight(torch.abs(rs),
                                                            huber_delta)
            Js = torch.stack([iz, zero, -(x - baseline) * iz / z], -1)
            Hm = Hm + torch.einsum('n,nj,nk->jk', ws, Js, Js)
            g = g + torch.einsum('n,nj,n->j', ws, Js, rs)
        delta = torch.linalg.solve_ex(Hm + 1e-8 * eye3, -g)[0]
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        T = T.clone()
        if rot:
            T[:3, :3] = se3.so3_exp(delta) @ R
        else:
            T[:3, 3] = t + delta
        return se3.normalize(T)

    T = T0
    for _ in range(rounds):
        T = gn_step(T, rot_sel, rot=True)
        T = gn_step(T, t_sel, rot=False)
    return T


def _loop_scale(m: MapState, cur_slot, kpt, inlier, d_cand,
                cfg: SlamConfig) -> torch.Tensor:
    """Current/candidate map scale: the masked median of matched depth
    ratios, clamped to 1 +- max_scale_drift; 1 with fewer than
    min_scale_pairs pairs, and always 1 under the SE(3) graph."""
    one = torch.ones((), dtype=torch.float32, device=inlier.device)
    if cfg.loop.pose_graph_group != "sim3":
        return one
    ids_cur = at(m.kf_obs, cur_slot)[kpt.long()]
    safe_cur = torch.where(ids_cur >= 0, ids_cur,
                           torch.zeros_like(ids_cur)).long()
    pair_ok = inlier & (ids_cur >= 0) & m.mp_valid[safe_cur]
    d_cur = se3.transform(at(m.kf_T_cw, cur_slot),
                          mappoint_positions_at(m, safe_cur))[..., 2]
    pair_ok = pair_ok & (d_cur > 1e-3) & (d_cand > 1e-3)
    ratio = d_cur / torch.clamp(d_cand, min=1e-3)
    n_pairs = torch.sum(pair_ok)
    r_sorted = torch.sort(torch.where(pair_ok, ratio,
                                      torch.full_like(ratio, float("inf")))
                          ).values
    med = row(r_sorted, torch.clamp(n_pairs - 1, min=0) // 2)
    c = cfg.loop.max_scale_drift
    med = torch.clamp(med, 1.0 / (1.0 + c), 1.0 + c)
    return torch.where(n_pairs >= cfg.loop.min_scale_pairs, med, one)


def relative_pose(m: MapState, cur_slot, cand_slot,
                  cam: StereoCamera, cfg: SlamConfig) -> RelPoseResult:
    """Track the current keyframe against the candidate group's landmarks
    (ref src/loopcloser.cpp:51-100, prediction = the candidate's pose).
    The slots are host ints or 0-dim tensors on the map's device; either
    way they are read on the device (rows gathered with index_select, the
    RANSAC key hashed there), so the function reads nothing back and a
    CUDA graph can hold it."""
    dev = m.kf_valid.device
    cur_slot, cand_slot = _slot(cur_slot, dev), _slot(cand_slot, dev)
    Xw, desc, valid = _candidate_group_landmarks(m, cur_slot, cand_slot, cfg)
    feats = _kf_features(m, cur_slot)
    T_pred = row(m.kf_T_cw, cand_slot)
    F = m.kf_valid.shape[0]
    key = threefry.fold_in(threefry.prng_key(7), cur_slot * F + cand_slot)
    fx = cam.left.fx
    depth_gate = cfg.loop.relpose_depth_baselines * cam.baseline

    def solve(kpt, ok, salt: int, T_seed):
        kl = kpt.long()
        z_norm = row(m.kf_norm, cur_slot)[kl]
        sigma2 = row(m.kf_sigma2, cur_slot)[kl] / (fx * fx)
        consensus = _ransac_consensus(
            T_seed, Xw, z_norm, ok, cfg.tracker.reprojection_px / fx,
            threefry.fold_in(key, salt))
        use_c = torch.where(torch.sum(consensus) >= 6, consensus, ok)
        near = se3.transform(T_seed, Xw)[:, 2] < depth_gate
        use_near = use_c & near
        use = torch.where(torch.sum(use_near) >= cfg.loop.relpose_near_min,
                          use_near, use_c)
        stereo = (row(m.kf_right_x_norm, cur_slot)[kl],
                  row(m.kf_has_stereo, cur_slot)[kl].float(), cam.baseline)
        T_est = pose_lm.optimize_pose(T_seed, Xw, z_norm, sigma2, use,
                                      cfg.tracker, stereo=stereo).T_cw
        if cfg.loop.relpose_rt_rounds > 0:
            T_est = _decoupled_rt_refine(
                T_est, Xw, z_norm, torch.rsqrt(torch.clamp(sigma2,
                                                           min=1e-12)),
                use_c, near, stereo, cfg.tracker.huber_delta,
                cfg.loop.relpose_rt_rounds)
        inlier, depth = pose_lm.reprojection_inliers(
            cam.left, T_est, Xw, row(m.kf_xy, cur_slot)[kl], use,
            cfg.tracker.reprojection_px)
        return (T_est, torch.sum(inlier),
                _loop_scale(m, cur_slot, kpt, inlier, depth, cfg),
                torch.sum(inlier & near))

    match = projection_match(Xw, desc, valid, feats, T_pred, cam,
                             cfg.matcher, 1.0 * cfg.matcher.projection_radius)
    T_proj, n_proj, s_proj, nn_proj = solve(match.kpt_idx, match.ok, 0,
                                            T_pred)

    # the global fallback: the full masked Hamming match with a mutual
    # check, which needs no pose prior (ref SearchByBoW)
    gmask = valid[:, None] & feats.valid[None, :]
    dist = hamming.masked_distance(desc, feats.desc, gmask)
    gidx, gok = hamming.ratio_test_match(dist, cfg.matcher.ratio,
                                         cfg.matcher.max_hamming)
    rows = torch.arange(gidx.shape[0], device=gidx.device)
    back = torch.argmin(dist, dim=0)
    gok = gok & (back[gidx.long()] == rows)
    gok = hamming.keep_best_per_target(gidx, gok, dist[rows, gidx.long()],
                                       feats.desc.shape[0])
    T_glob, n_glob, s_glob, nn_glob = solve(gidx, gok, 1, T_pred)

    use_glob = (n_proj < cfg.loop.min_matches) & (n_glob > n_proj)
    T = torch.where(use_glob, T_glob, T_proj)
    n = torch.where(use_glob, n_glob, n_proj)
    s = torch.where(use_glob, s_glob, s_proj)
    nn = torch.where(use_glob, nn_glob, nn_proj)

    # re-match from the solved pose, only for solves already accepted
    accepted0 = n >= cfg.loop.min_matches
    for r in range(cfg.loop.relpose_refine_rounds):
        radius = cfg.loop.relpose_refine_radius * \
            cfg.matcher.projection_radius
        m2 = projection_match(Xw, desc, valid, feats, T, cam, cfg.matcher,
                              radius)
        T2, n2, s2, nn2 = solve(m2.kpt_idx, m2.ok, 2 + r, T)
        apply = accepted0 & (n2 >= cfg.loop.min_matches)
        T = torch.where(apply, T2, T)
        n = torch.where(apply, n2, n)
        s = torch.where(apply, s2, s)
        nn = torch.where(apply, nn2, nn)
    return RelPoseResult(T_cw=T, n_inliers=n, ok=n >= cfg.loop.min_matches,
                         scale=s, n_near=nn)


def relocalize_frame(m: MapState, frame_feats: FrameFeatures,
                     frame_norm: torch.Tensor, cand_slot,
                     cam: StereoCamera, cfg: SlamConfig) -> RelPoseResult:
    """Re-track a lost frame against one keyframe's landmarks, matched at
    twice the projection radius; accepted at reloc_min_matches. The slot
    is a host int or a 0-dim tensor on the map's device (nothing is read
    back)."""
    ids = at(m.kf_obs, cand_slot)
    safe = torch.where(ids >= 0, ids, torch.zeros_like(ids)).long()
    valid = (ids >= 0) & m.mp_valid[safe]
    Xw = mappoint_positions_at(m, safe)
    T_pred = at(m.kf_T_cw, cand_slot)
    match = projection_match(Xw, m.mp_desc[safe], valid, frame_feats, T_pred,
                             cam, cfg.matcher,
                             2.0 * cfg.matcher.projection_radius)
    kpt = match.kpt_idx.long()
    fx = cam.left.fx
    res = pose_lm.optimize_pose(T_pred, Xw, frame_norm[kpt],
                                frame_feats.sigma2[kpt] / (fx * fx),
                                match.ok, cfg.tracker)
    inlier, _ = pose_lm.reprojection_inliers(
        cam.left, res.T_cw, Xw, frame_feats.xy[kpt], match.ok,
        cfg.tracker.reprojection_px)
    n = torch.sum(inlier)
    one = torch.ones((), dtype=torch.float32, device=n.device)
    return RelPoseResult(T_cw=res.T_cw, n_inliers=n,
                         ok=n >= cfg.loop.reloc_min_matches, scale=one,
                         n_near=torch.zeros_like(n))


def _scalar(x, device) -> torch.Tensor:
    """A float32 scalar on `device`: a tensor converted there, a host
    number filled in (no upload)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def loop_edge_measurement(m: MapState, cand_slot, T_cur_loop: torch.Tensor,
                          scale, cfg: SlamConfig) -> torch.Tensor:
    """The loop edge: the re-tracked current pose relative to the
    candidate; under "sim3" a similarity carrying the detected scale.
    cand_slot: a host int or a 0-dim tensor on the map's device."""
    rel = se3.compose(T_cur_loop, se3.inv(at(m.kf_T_cw, cand_slot)))
    if cfg.loop.pose_graph_group != "sim3":
        return rel
    s = _scalar(scale, rel.device).reshape(
        torch.Size(rel.shape[:-2])).to(rel.dtype)
    return sim3.make(rel[..., :3, :3], s[..., None] * rel[..., :3, 3], s)


def close_loop(m: MapState, cur_slot, cand_slot,
               T_cur_loop: torch.Tensor, prev_loops_i: torch.Tensor,
               prev_loops_j: torch.Tensor, prev_loops_T: torch.Tensor,
               prev_loops_valid: torch.Tensor, cfg: SlamConfig,
               tier: int = 0, loop_scale=1.0, loop_weight=1.0,
               prev_loops_w=None) -> MapState:
    """Pose-graph correction over all keyframes (ref :104-220): valid
    keyframes gathered oldest first into a (tier,) problem (tier <= 0 or
    > F: the whole ring), chain edges between consecutive ones weighted
    by tracking quality, the new loop edge and the remembered ones (the
    replayed ones boosted), the recent segment rigidly pre-corrected,
    the oldest keyframe fixed. Under "sim3" anchored inverse depths
    rescale with their anchor keyframes. cur_slot and cand_slot: host
    ints or 0-dim tensors on the map's device; nothing is read back, and
    every shape is fixed by the tier (the pose graph's assembly by its
    tier - 1 chain edges and 1 + len(prev_loops_i) loop edges), so a
    CUDA graph a tier holds the whole close."""
    F = m.kf_valid.shape[0]
    dev = m.kf_valid.device
    if tier <= 0 or tier > F:
        tier = F
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id,
                                      torch.iinfo(torch.int32).max))
    order = torch.sort(fid, stable=True).indices
    n_valid = torch.sum(m.kf_valid)
    rank = torch.empty((F,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(F, device=dev)

    sel = order[:tier]
    ar = torch.arange(tier, device=dev)
    valid_c = ar < n_valid
    T_ring = m.kf_T_cw
    Tc_pre = T_ring[sel]
    ei, ej = ar[:-1], ar[1:]
    chain_valid = ei < (n_valid - 1)
    T_meas_chain = se3.compose(Tc_pre[ej], se3.inv(Tc_pre[ei]))

    sim3_mode = cfg.loop.pose_graph_group == "sim3"
    loop_T_new = loop_edge_measurement(m, cand_slot, T_cur_loop, loop_scale,
                                       cfg)
    # rigid pre-correction of the recent segment (ORB-SLAM CorrectLoop)
    dT = se3.compose(T_cur_loop, se3.inv(at(T_ring, cur_slot)))
    seg = m.kf_valid & (rank > at(rank, cur_slot) -
                        cfg.loop.correction_window)
    T_init = torch.where(seg[:, None, None],
                         se3.normalize(se3.compose(dT[None], T_ring)), T_ring)
    m = m._replace(kf_T_cw=T_init)

    li = torch.cat([_slot(cand_slot, dev).reshape(1), prev_loops_i.long()])
    lj = torch.cat([_slot(cur_slot, dev).reshape(1), prev_loops_j.long()])
    lv = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                    prev_loops_valid])
    lv = lv & (rank[li] < tier) & (rank[lj] < tier)
    edge_i = torch.cat([ei, torch.clamp(rank[li], max=tier - 1)])
    edge_j = torch.cat([ej, torch.clamp(rank[lj], max=tier - 1)])
    edge_T = torch.cat([T_meas_chain, loop_T_new[None], prev_loops_T])
    edge_valid = torch.cat([chain_valid, lv])

    info = [cfg.loop.info_translation] * 3 + \
        [cfg.loop.info_rotation, cfg.loop.info_yaw_damp,
         cfg.loop.info_rotation]
    if sim3_mode:
        info.append(cfg.loop.info_scale)
    edge_info = constant(tuple(info), str(dev)).expand(edge_i.shape[0], -1)
    qc = m.kf_quality[sel]
    q = torch.minimum(qc[ei], qc[ej])
    chain_scale = torch.clamp(q / (2.0 * cfg.tracker.min_matches),
                              cfg.loop.chain_quality_floor, 1.0)
    if prev_loops_w is None:
        prev_loops_w = torch.ones((prev_loops_i.shape[0],), device=dev)
    loop_w = torch.cat([_scalar(loop_weight, dev).reshape(1),
                        prev_loops_w * cfg.loop.replay_edge_boost])
    edge_info = edge_info * torch.cat([chain_scale, loop_w])[:, None]

    prob = PoseGraphProblem(
        T_cw=m.kf_T_cw[sel], pose_valid=valid_c,
        pose_fixed=(ar == 0) | ~valid_c, edge_i=edge_i, edge_j=edge_j,
        edge_T_ji=edge_T, edge_info=edge_info, edge_valid=edge_valid)
    if sim3_mode:
        S_opt = solve_pose_graph_sim3(prob,
                                      iters=cfg.loop.posegraph_iterations,
                                      chain_edges=tier - 1)
        T_opt = sim3.to_se3(S_opt)
        s_c = torch.where(valid_c, sim3.scale_of(S_opt),
                          torch.ones_like(valid_c, dtype=torch.float32))
        s_ring = torch.ones((F,), dtype=torch.float32, device=dev)
        s_ring[sel] = s_c
        m = m._replace(mp_invd=torch.where(
            m.mp_valid, m.mp_invd * s_ring[m.mp_ref_kf.long()], m.mp_invd))
    else:
        T_opt = solve_pose_graph(prob, iters=cfg.loop.posegraph_iterations,
                                 chain_edges=tier - 1)
    new_T = m.kf_T_cw.clone()
    new_T[sel] = torch.where(valid_c[:, None, None], T_opt, m.kf_T_cw[sel])
    return m._replace(kf_T_cw=new_T)


def _last_writer(targets: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) index of the last position writing each target, -1 if none:
    XLA's in-order scatter resolution of repeated indices."""
    pos = torch.arange(targets.shape[0], device=targets.device)
    return torch.full((n,), -1, dtype=torch.int64,
                      device=targets.device).scatter_reduce(
        0, targets.long(), pos, reduce="amax", include_self=True)


def merge_mappoints(m: MapState, cur_slot, cand_slot,
                    cam: StereoCamera, cfg: SlamConfig) -> MapState:
    """Merge duplicate landmarks after a closure (ref :223-299): the
    candidate side's landmarks, matched into the current keyframe at the
    loop radius, win over the landmark the matched keypoint observes;
    every observation of a loser is redirected to its winner, and a
    matched keypoint that observes nothing adopts the winner. Slots are
    host ints or 0-dim tensors on the map's device."""
    ids_cand = at(m.kf_obs, cand_slot)
    safe = torch.where(ids_cand >= 0, ids_cand, torch.zeros_like(ids_cand))
    valid = (ids_cand >= 0) & m.mp_valid[safe.long()]
    Xw = mappoint_positions_at(m, safe.long())
    feats = _kf_features(m, cur_slot)
    match = projection_match(Xw, m.mp_desc[safe.long()], valid, feats,
                             at(m.kf_T_cw, cur_slot), cam, cfg.matcher,
                             cfg.matcher.loop_radius)
    kpt = match.kpt_idx.long()
    dev = safe.device
    cur = _slot(cur_slot, dev)
    existing = row(m.kf_obs, cur)[kpt]
    winner, loser = safe, existing
    do_merge = match.ok & (existing >= 0) & (existing != winner)

    M = m.mp_valid.shape[0]
    K = m.kf_obs.shape[1]
    # a winner that is itself a loser this pass is left for a later pass
    loser_flag = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
    loser_flag.index_fill_(0, torch.where(do_merge, loser,
                                          torch.full_like(loser, M)).long(),
                           True)
    do_merge = do_merge & ~loser_flag[winner.long()]

    dump = torch.where(do_merge, loser, torch.full_like(loser, M)).long()
    w_of = _last_writer(dump, M + 1)[:M]
    remap = torch.where(w_of >= 0, winner[torch.clamp(w_of, min=0)],
                        torch.arange(M, dtype=torch.int32, device=dev))
    remap = torch.cat([remap.int(), torch.full((1,), -1, dtype=torch.int32,
                                               device=dev)])
    kf_obs = remap[torch.where(m.kf_obs >= 0, m.kf_obs,
                               torch.full_like(m.kf_obs, M)).long()]
    mp_valid = torch.cat([m.mp_valid, m.mp_valid.new_zeros(1)])
    mp_valid.index_fill_(0, dump, False)
    mp_valid = mp_valid[:M]

    adopt = match.ok & (existing < 0)
    a_of = _last_writer(torch.where(adopt, kpt, torch.full_like(kpt, K)),
                        K + 1)[:K]
    obs_row = torch.where(a_of >= 0, winner[torch.clamp(a_of, min=0)].int(),
                          row(kf_obs, cur))
    kf_obs.index_copy_(0, cur.reshape(1), obs_row[None])

    # observation counts follow the redirects (integer adds: order-free)
    cnt = torch.cat([m.mp_obs_count, m.mp_obs_count.new_zeros(1)])
    w_dump = torch.where(do_merge, winner, torch.full_like(winner, M)).long()
    gained = torch.where(do_merge, cnt[dump], torch.zeros_like(cnt[dump]))
    cnt = cnt.index_add(0, w_dump, gained)
    cnt.index_fill_(0, dump, 0)
    cnt = cnt.index_add(0, torch.where(adopt, winner,
                                       torch.full_like(winner, M)).long(),
                        torch.ones_like(winner, dtype=cnt.dtype))
    return m._replace(kf_obs=kf_obs, mp_valid=mp_valid,
                      mp_obs_count=cnt[:M])
