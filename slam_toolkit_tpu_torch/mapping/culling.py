"""Keyframe and weak-mappoint culling (counterpart of
slam_toolkit_tpu/mapping/culling.py).

A fixed-capacity keyframe ring needs redundancy culling: a keyframe whose
landmarks are seen by enough other keyframes can go. Landmarks are
anchored (inverse depth along the anchor keyframe's ray), so culling
keyframe f re-anchors every landmark whose mp_ref_kf == f to another
keyframe that observes it, and invalidates those with no other observer.

Like the port's map_state, these update the map's tensors in place and
return the same MapState. Scatters with repeated indices are order-free:
the alternative-observer search is a scatter-amax, the observation-count
decrement an integer index_add.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.mapping.map_state import (MapState, lane_index,
                                                      mappoint_positions)
from slam_toolkit_tpu_torch.utils.lanes import with_lane


def redundancy_scores(m: MapState, protect_recent: int = 8) -> torch.Tensor:
    """(F,) fraction of a keyframe's landmarks seen by >= 3 other
    keyframes; -1 for invalid keyframes and the `protect_recent` newest,
    so argmax picks the best candidate."""
    M = m.mp_valid.shape[0]
    counts = torch.cat([m.mp_obs_count, m.mp_obs_count.new_zeros(1)])
    ids = torch.where(m.kf_obs >= 0, m.kf_obs,
                      torch.full_like(m.kf_obs, M)).long()
    observed = ids < M
    redundant = (counts[ids] >= 4) & observed            # self + 3 others
    frac = torch.sum(redundant, dim=1) / torch.clamp(
        torch.sum(observed, dim=1), min=1)
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, -1))
    rank = torch.sum(fid[None, :] < fid[:, None], dim=1)
    newest_rank = torch.max(torch.where(m.kf_valid, rank,
                                        torch.full_like(rank, -1)))
    protected = rank > newest_rank - protect_recent
    return torch.where(m.kf_valid & ~protected, frac,
                       torch.full_like(frac, -1.0))


def cull_keyframe(m: MapState, slot, do=None) -> MapState:
    """Remove keyframe `slot` (int or 0-dim tensor): re-anchor its
    landmarks on the last other keyframe that observes them, or
    invalidate them. Updates `m` in place and returns it. `do`, a 0-dim
    bool tensor, makes the cull conditional on the device (lax.cond's
    counterpart): where it is False every field keeps its values."""
    F, K = m.kf_obs.shape
    M = m.mp_valid.shape[0]
    dev = m.kf_obs.device
    slot = slot.reshape(()).long() if torch.is_tensor(slot) else \
        torch.full((), int(slot), dtype=torch.int64, device=dev)
    if do is None:
        do = torch.ones((), dtype=torch.bool, device=dev)
    Xw = mappoint_positions(m)                  # before the anchors move

    # the alternative observer of every landmark: scatter-max of the
    # encoded (kf, kpt) over all observations from other keyframes
    f_idx = torch.arange(F, device=dev)[:, None].expand(F, K)
    k_idx = torch.arange(K, device=dev)[None, :].expand(F, K)
    usable = (m.kf_obs >= 0) & m.kf_valid[:, None] & (f_idx != slot)
    code = torch.where(usable, f_idx * K + k_idx + 1,
                       torch.zeros_like(f_idx))          # 0 = none
    target = torch.where(usable, m.kf_obs.long(),
                         torch.full_like(f_idx, M))
    alt = torch.zeros((M + 1,), dtype=torch.int64, device=dev).scatter_reduce(
        0, target.reshape(-1), code.reshape(-1), "amax")[:M]

    anchored = do & m.mp_valid & (m.mp_ref_kf == slot)
    moved = anchored & (alt > 0)
    orphan = anchored & (alt == 0)
    new_ref = torch.where(moved, (alt - 1) // K, m.mp_ref_kf.long())
    new_kpt = torch.where(moved, (alt - 1) % K, m.mp_kpt.long())
    # inverse depth along the new anchor ray; a landmark that lands
    # behind its new anchor is dropped, not clamped to 1 mm
    z_new = se3.transform(m.kf_T_cw[new_ref], Xw)[..., 2]
    new_invd = torch.where(moved, 1.0 / torch.clamp(z_new, min=1e-3),
                           m.mp_invd)
    behind = moved & (z_new <= 1e-3)

    # one observation fewer for everything this keyframe saw
    row = m.kf_obs.index_select(0, slot.reshape(1))[0]
    seen = torch.where(row >= 0, row, torch.full_like(row, M)).long()
    obs_count = torch.cat([m.mp_obs_count, m.mp_obs_count.new_zeros(1)])
    obs_count = obs_count.index_add(0, seen, torch.full_like(row, -1))[:M]
    obs_count = torch.where(do, torch.clamp(obs_count, min=0),
                            m.mp_obs_count)

    s = slot.reshape(1)
    for field, gone in ((m.kf_valid, False), (m.kf_frame_id, -1),
                        (m.kf_obs, -1)):
        old = field.index_select(0, s)
        field.index_copy_(0, s, torch.where(do, torch.full_like(old, gone),
                                            old))
    m.mp_ref_kf.copy_(new_ref)
    m.mp_kpt.copy_(new_kpt)
    m.mp_invd.copy_(new_invd)
    m.mp_valid.logical_and_(~orphan & ~behind)
    m.mp_obs_count.copy_(obs_count)
    return m


def cull_most_redundant(m: MapState, min_fraction: float = 0.8,
                        protect_recent: int = 8
                        ) -> Tuple[MapState, torch.Tensor]:
    """Cull the most redundant unprotected keyframe (the first of equal
    scores, as argmax) if its score reaches `min_fraction`, the choice
    made on the device (the JAX package's lax.cond): every write selects
    between the culled and the unchanged map. Returns (map, the culled
    slot or -1 as a 0-dim int64 tensor); the caller reads it back."""
    scores = redundancy_scores(m, protect_recent)
    slot = torch.argmax(scores)
    do = scores.index_select(0, slot.reshape(1))[0] >= min_fraction
    m = cull_keyframe(m, slot, do)
    return m, torch.where(do, slot, torch.full_like(slot, -1))


def cull_weak_mappoints(m: MapState, cur_frame_id: int,
                        grace_frames: int = 12, min_obs: int = 2,
                        lanes=None) -> MapState:
    """Free landmarks not re-observed by >= min_obs keyframes within
    grace_frames frames of their anchor, once >= min_obs newer keyframes
    exist. Clears each freed landmark's anchor cell in kf_obs (for every
    valid landmark, kf_obs[mp_ref_kf, mp_kpt] is that landmark). Updates
    `m` in place and returns it. A batched map (B lanes) is culled in one
    pass, only in the lanes the (B,) mask `lanes` keeps (None: every
    lane); each kept lane as by the single call, one map as one lane."""
    if m.kf_obs.dim() == 2:
        cull_weak_mappoints(with_lane(m), cur_frame_id, grace_frames,
                            min_obs)
        return m
    B, F, K = m.kf_obs.shape
    newer = torch.sum(m.kf_valid[:, None, :] &
                      (m.kf_frame_id[:, None, :] >
                       m.kf_frame_id[:, :, None]), dim=-1)
    kf_elig = ((cur_frame_id - m.kf_frame_id > grace_frames) &
               (newer >= min_obs))
    weak = m.mp_valid & (m.mp_obs_count < min_obs) & \
        torch.gather(kf_elig, 1, m.mp_ref_kf.long())
    if lanes is not None:
        weak = weak & lanes.bool()[:, None]
    n = B * F * K
    flat_idx = (m.mp_ref_kf.long() + lane_index(B, weak.device) * F) * K + \
        m.mp_kpt.long()
    # mark the cells to clear; every write is True, so repeats agree
    clear = torch.zeros((n + 1,), dtype=torch.bool, device=weak.device)
    clear.index_fill_(0, torch.where(weak, flat_idx,
                                     torch.full_like(flat_idx, n)).reshape(-1),
                      True)
    m.kf_obs.masked_fill_(clear[:-1].reshape(m.kf_obs.shape), -1)
    m.mp_valid.logical_and_(~weak)
    m.mp_obs_count.masked_fill_(weak, 0)
    return m
