"""The map as one fixed-capacity struct of tensors.

Counterpart of slam_toolkit_tpu/mapping/map_state.py: keyframes in F
slots of K keypoints, mappoints in M slots with the anchored
inverse-depth parametrization (ref src/mappoint.cpp:128-138), "deleted"
as a valid mask. Where the JAX package returns a new MapState, this port
writes the keyframe row and the mappoint table IN PLACE and returns the
same object: the engine holds the only reference, and a functional copy
of the (F, K, ...) tables per keyframe would move ~100 MB at the
default capacities.

Scatters with repeated indices are made deterministic: they either
write one value to every repeated index, or go through a dump slot
appended past the end (the JAX package's mode="drop" sentinel), or use
scatter_reduce with an order-free reduction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.frame import FrameState
from slam_toolkit_tpu_torch.geometry import se3


class MapState(NamedTuple):
    kf_T_cw: torch.Tensor          # (F, 4, 4)
    kf_valid: torch.Tensor         # (F,) bool
    kf_frame_id: torch.Tensor      # (F,) int32, -1 empty
    kf_xy: torch.Tensor            # (F, K, 2)
    kf_norm: torch.Tensor          # (F, K, 2)
    kf_desc: torch.Tensor          # (F, K*8) int32 (uint32 words in JAX)
    kf_sigma2: torch.Tensor        # (F, K)
    kf_kpt_valid: torch.Tensor     # (F, K) bool
    kf_right_x_norm: torch.Tensor  # (F, K)
    kf_has_stereo: torch.Tensor    # (F, K) bool
    kf_obs: torch.Tensor           # (F, K) int32 mappoint id, -1 none
    kf_quality: torch.Tensor       # (F,) float32
    mp_ref_kf: torch.Tensor        # (M,) int32 anchor keyframe slot
    mp_kpt: torch.Tensor           # (M,) int32 anchor keypoint index
    mp_invd: torch.Tensor          # (M,) float32 inverse depth
    mp_desc: torch.Tensor          # (M, 8) int32
    mp_valid: torch.Tensor         # (M,) bool
    mp_obs_count: torch.Tensor     # (M,) int32


def empty_map(cfg: SlamConfig, device) -> MapState:
    f = cfg.map.max_keyframes
    k = cfg.extractor.max_keypoints
    m = cfg.map.max_mappoints

    def z(*shape, dtype=torch.float32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return MapState(
        kf_T_cw=torch.eye(4, device=device).repeat(f, 1, 1),
        kf_valid=z(f, dtype=torch.bool),
        kf_frame_id=z(f, dtype=torch.int32, fill=-1),
        kf_xy=z(f, k, 2),
        kf_norm=z(f, k, 2),
        kf_desc=z(f, k * 8, dtype=torch.int32),
        kf_sigma2=z(f, k, fill=1.0),
        kf_kpt_valid=z(f, k, dtype=torch.bool),
        kf_right_x_norm=z(f, k),
        kf_has_stereo=z(f, k, dtype=torch.bool),
        kf_obs=z(f, k, dtype=torch.int32, fill=-1),
        kf_quality=z(f),
        mp_ref_kf=z(m, dtype=torch.int32),
        mp_kpt=z(m, dtype=torch.int32),
        mp_invd=z(m, fill=1e-3),
        mp_desc=z(m, 8, dtype=torch.int32),
        mp_valid=z(m, dtype=torch.bool),
        mp_obs_count=z(m, dtype=torch.int32),
    )


def _scatter_drop(arr: torch.Tensor, idx: torch.Tensor,
                  values) -> torch.Tensor:
    """arr[idx] = values where idx < len(arr); idx == len(arr) entries
    are dropped through a dump slot (their writes race only with each
    other). `values` is a tensor or a Python scalar (written with
    index_fill_, which needs no upload). Returns a new tensor."""
    tmp = torch.cat([arr, arr[:1]], dim=0)
    if torch.is_tensor(values):
        tmp.index_put_((idx.long(),), values)
    else:
        tmp.index_fill_(0, idx.long(), values)
    return tmp[:-1]


def mappoint_positions_at(m: MapState, ids: torch.Tensor) -> torch.Tensor:
    """World positions of mappoints `ids`: Xw = T_wc_ref . (ray / invd)."""
    ids = ids.long()
    ref = m.mp_ref_kf[ids].long()
    norm = m.kf_norm[ref, m.mp_kpt[ids].long()]
    invd = torch.clamp(m.mp_invd[ids], min=1e-3)
    ray = torch.cat([norm, torch.ones_like(invd)[:, None]], dim=-1)
    return se3.transform(se3.inv(m.kf_T_cw[ref]), ray / invd[:, None])


def mappoint_positions(m: MapState) -> torch.Tensor:
    """(M, 3) world positions of every mappoint slot; invalid ones at the
    origin."""
    ids = torch.arange(m.mp_valid.shape[0], device=m.mp_valid.device)
    Xw = mappoint_positions_at(m, ids)
    return torch.where(m.mp_valid[:, None], Xw, torch.zeros_like(Xw))


def allocate_slots(free: torch.Tensor, want: torch.Tensor,
                   num: int) -> torch.Tensor:
    """First-free allocation: the i-th real request gets the i-th free
    slot; masked or overflow requests get the sentinel N = len(free).
    The slot of rank r is the first index whose free-count reaches r + 1
    (a searchsorted on the running count of free slots)."""
    n = free.shape[0]
    csum = torch.cumsum(free.int(), dim=0)
    rank = torch.cumsum(want.int(), dim=0) - 1
    slots = torch.searchsorted(csum, rank + 1, side="left")
    real = want & (rank < csum[-1])
    return torch.where(real, slots, torch.full_like(slots, n)).int()


def claimed_keypoints(frame: FrameState, T_cw: torch.Tensor, cfg: SlamConfig,
                      points_w: torch.Tensor,
                      points_valid: torch.Tensor) -> torch.Tensor:
    """(K,) bool: keypoints whose image cell (or a neighbour) holds the
    projection of a live landmark of the snapshot; those spawn no new
    landmark (claim_cell_px grid, dilated 3x3)."""
    cell = cfg.map.claim_cell_px
    K = frame.feats.xy.shape[0]
    dev = frame.feats.xy.device
    if cell <= 0:
        return torch.zeros((K,), dtype=torch.bool, device=dev)
    Xc = se3.transform(T_cw, points_w)
    z = torch.clamp(Xc[:, 2], min=0.05)
    u = cfg.camera.fx * Xc[:, 0] / z + cfg.camera.cx
    v = cfg.camera.fy * Xc[:, 1] / z + cfg.camera.cy
    gw = int(cfg.camera.width / cell) + 3
    gh = int(cfg.camera.height / cell) + 3
    cu = torch.floor(u / cell).int() + 1
    cv = torch.floor(v / cell).int() + 1
    inb = (points_valid & (Xc[:, 2] > 0.05) &
           (cu >= 0) & (cu < gw) & (cv >= 0) & (cv < gh))
    flat = torch.where(inb, cv * gw + cu, torch.full_like(cu, gh * gw))
    grid = torch.zeros((gh * gw + 1,), dtype=torch.bool, device=dev)
    grid.index_fill_(0, flat.long(), True)        # one value: deterministic
    grid = grid[:-1].reshape(gh, gw)
    dil = grid
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                dil = dil | torch.roll(grid, shifts=(dy, dx), dims=(0, 1))
    ku = torch.clamp(torch.floor(frame.feats.xy[:, 0] / cell).long() + 1,
                     0, gw - 1)
    kv = torch.clamp(torch.floor(frame.feats.xy[:, 1] / cell).long() + 1,
                     0, gh - 1)
    return dil[kv, ku]


def row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-dim index tensor i on t's device. t[i] itself reads i
    back to the host (a synchronisation, and no CUDA graph captures it);
    this gathers the row on the device."""
    return t.index_select(0, i.reshape(1))[0]


def insert_keyframe(m: MapState, frame: FrameState, T_cw: torch.Tensor,
                    frame_id, mp_ids: torch.Tensor,
                    mp_kpt: torch.Tensor, mp_tracked: torch.Tensor,
                    cfg: SlamConfig, lm_snapshot, quality=None
                    ) -> Tuple[MapState, torch.Tensor]:
    """Insert `frame` as a keyframe and supply new mappoints at stereo
    keypoints that are neither matched nor claimed (ref
    src/frame.cpp:444-463, :235-255; src/pipeline_map.cpp:131-149).

    mp_ids / mp_kpt / mp_tracked: landmark id, matched keypoint and
    inlier mask of the tracking result. lm_snapshot: (Xw, valid) of the
    tracker's landmark snapshot, rasterized for the claim test.
    frame_id: a host int or a 0-dim int tensor on the map's device.
    Updates `m` in place; returns (m, slot) with slot a 0-dim tensor."""
    K = frame.feats.xy.shape[0]
    M = m.mp_valid.shape[0]
    dev = frame.feats.xy.device
    slot = torch.argmin(m.kf_valid.int())             # first free KF slot

    # kpt k of this keyframe observes landmark mp_ids[i]; tracked
    # landmarks hit distinct keypoints (keep_best_per_target), untracked
    # ones all write -1 into the dump slot K
    scatter_kpt = torch.where(mp_tracked, mp_kpt, torch.full_like(mp_kpt, K))
    obs_row = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    obs_row[scatter_kpt.long()] = torch.where(
        mp_tracked, mp_ids, torch.full_like(mp_ids, -1)).int()
    obs_row = obs_row[:K]

    has_mp = obs_row >= 0
    claimed = claimed_keypoints(frame, T_cw, cfg, *lm_snapshot)
    new_mask = frame.feats.valid & frame.has_stereo & ~has_mp & ~claimed
    new_slots = allocate_slots(~m.mp_valid, new_mask, K)
    allocated = new_slots < M
    kpt_idx = torch.arange(K, dtype=torch.int32, device=dev)
    invd_new = 1.0 / torch.clamp(frame.depth, min=1e-3)

    mp_ref_kf = _scatter_drop(m.mp_ref_kf, new_slots,
                              slot.int().expand(K))
    mp_kpt_arr = _scatter_drop(m.mp_kpt, new_slots, kpt_idx)
    mp_invd = _scatter_drop(m.mp_invd, new_slots, invd_new)
    mp_desc = _scatter_drop(m.mp_desc, new_slots, frame.feats.desc)
    mp_valid = _scatter_drop(m.mp_valid, new_slots, True)
    obs_row = torch.where(allocated, new_slots, obs_row)

    # observation counts: tracked landmarks +1 (integer adds: order-free),
    # new landmarks = 1
    tracked_ids = torch.where(mp_tracked, mp_ids, torch.full_like(mp_ids, M))
    obs_count = torch.cat([m.mp_obs_count,
                           m.mp_obs_count.new_zeros(1)])
    obs_count = obs_count.index_add(
        0, tracked_ids.long(),
        torch.ones_like(tracked_ids, dtype=torch.int32))[:-1]
    obs_count = _scatter_drop(obs_count, new_slots, 1)

    if quality is None:
        quality = torch.sum(mp_tracked.float())
    elif not torch.is_tensor(quality):
        quality = torch.full((), quality, dtype=torch.float32, device=dev)
    s = slot.reshape(1)
    m.kf_T_cw.index_copy_(0, s, T_cw[None].to(m.kf_T_cw.dtype))
    m.kf_valid.index_fill_(0, s, True)
    if torch.is_tensor(frame_id):     # index_fill_ would read it back
        m.kf_frame_id.index_copy_(0, s, frame_id.reshape(1).to(
            m.kf_frame_id.dtype))
    else:
        m.kf_frame_id.index_fill_(0, s, int(frame_id))
    m.kf_xy.index_copy_(0, s, frame.feats.xy[None])
    m.kf_norm.index_copy_(0, s, frame.norm_xy[None])
    m.kf_desc.index_copy_(0, s, frame.feats.desc.reshape(1, -1))
    m.kf_sigma2.index_copy_(0, s, frame.feats.sigma2[None])
    m.kf_kpt_valid.index_copy_(0, s, frame.feats.valid[None])
    m.kf_right_x_norm.index_copy_(0, s, frame.right_x_norm[None])
    m.kf_has_stereo.index_copy_(0, s, frame.has_stereo[None])
    m.kf_obs.index_copy_(0, s, obs_row[None].int())
    m.kf_quality.index_copy_(0, s, quality.reshape(1).to(torch.float32))
    for name, new in (("mp_ref_kf", mp_ref_kf), ("mp_kpt", mp_kpt_arr),
                      ("mp_invd", mp_invd), ("mp_desc", mp_desc),
                      ("mp_valid", mp_valid), ("mp_obs_count", obs_count)):
        getattr(m, name).copy_(new)
    return m, slot


def unique_prioritized(ids: torch.Tensor, num_out: int,
                       m: MapState) -> torch.Tensor:
    """Up to `num_out` distinct landmark ids (negative entries ignored),
    landmarks that appear at least twice in `ids` first, then by id;
    sentinel M fills the rest. Two sorts of packed integer keys."""
    M = m.mp_valid.shape[0]
    n = ids.shape[0]
    ids = ids.long()
    pos = torch.arange(n, dtype=torch.int64, device=ids.device)
    key = torch.where(ids >= 0, ids * n + pos, torch.full_like(ids, M * n))
    skey = torch.sort(key).values
    sid = torch.clamp(skey // n, max=M)
    diff = sid[1:] != sid[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                       diff]) & (sid < M)
    est = first & torch.cat([~diff, torch.zeros(1, dtype=torch.bool,
                                                device=ids.device)])
    pack2 = torch.where(first,
                        torch.where(est, torch.zeros_like(sid),
                                    torch.full_like(sid, M + 1)) + sid,
                        torch.full_like(sid, 2 * (M + 1) + M))
    return (torch.sort(pack2).values[:num_out] % (M + 1)).int()


def covisibility_counts(m: MapState, kf_slot) -> torch.Tensor:
    """(F,) int32 number of mappoints keyframe `kf_slot` shares with each
    keyframe: the query's observed ids marked in an (M,) mask (one value
    written per index), gathered at every keyframe's observation row."""
    M = m.mp_valid.shape[0]
    q = m.kf_obs[kf_slot].long()
    member = torch.zeros((M + 1,), dtype=torch.bool, device=q.device)
    member[torch.where(q >= 0, q, torch.full_like(q, M))] = True
    obs = m.kf_obs.long()
    hit = (obs >= 0) & member[:M][torch.clamp(obs, min=0)]
    return torch.sum(hit, dim=1).int()


def camera_frustum(cam_cfg, margin: float = 1.25):
    """Normalized-plane half-extents (nx_max, ny_max), widened by margin."""
    nx = margin * max(cam_cfg.cx, cam_cfg.width - cam_cfg.cx) / cam_cfg.fx
    ny = margin * max(cam_cfg.cy, cam_cfg.height - cam_cfg.cy) / cam_cfg.fy
    return (float(nx), float(ny))


def _top_slots(values: torch.Tensor, k: int):
    """lax.top_k: the k largest, ties in index order (stable sort)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def gather_local_landmarks(m: MapState, num_out: int, recent: int = 10,
                           covis_kfs: int = 0, covis_min: int = 5,
                           frustum=None):
    """The tracker's local map: mappoints observed by the `recent` newest
    keyframes plus, with covis_kfs > 0, those of the latest keyframe's
    top covisible neighbours that lie in its view (ref
    src/pipeline.cpp:167-177). Returns (Xw (L, 3), desc (L, 8),
    ids (L,), valid (L,)) with L = num_out."""
    F = m.kf_valid.shape[0]
    dev = m.kf_valid.device
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, -1))
    _, recent_slots = _top_slots(fid, recent)
    ids = m.kf_obs[recent_slots].reshape(-1)
    if covis_kfs > 0:
        K = m.kf_obs.shape[1]
        latest = torch.argmax(fid)
        # anchor-ownership covisibility with the latest keyframe
        q = row(m.kf_obs, latest).long()
        anc = torch.where(q >= 0, m.mp_ref_kf[torch.clamp(q, min=0)].long(),
                          torch.full_like(q, -1))
        cov = torch.sum(anc[:, None] == torch.arange(F, device=dev)[None, :],
                        dim=0)
        in_recent = torch.zeros((F,), dtype=torch.bool, device=dev)
        in_recent.index_fill_(0, recent_slots, True)
        cov = torch.where(m.kf_valid & ~in_recent, cov, torch.zeros_like(cov))
        cov_top, cov_slots = _top_slots(cov, covis_kfs)
        cids = m.kf_obs[cov_slots].reshape(-1)
        keep = torch.repeat_interleave(cov_top >= covis_min, K) & (cids >= 0)
        if frustum is not None:
            safe = torch.where(keep, cids, torch.zeros_like(cids))
            Xc = se3.transform(row(m.kf_T_cw, latest),
                               mappoint_positions_at(m, safe))
            z = Xc[..., 2]
            zs = torch.clamp(z, min=1e-6)
            keep = keep & (z > 0.05) & \
                (torch.abs(Xc[..., 0] / zs) <= frustum[0]) & \
                (torch.abs(Xc[..., 1] / zs) <= frustum[1])
        cids = torch.where(keep, cids, torch.full_like(cids, -1))
        ids = torch.cat([ids, cids])
    uniq = unique_prioritized(ids, num_out, m)
    ok = uniq < m.mp_valid.shape[0]
    safe = torch.where(ok, uniq, torch.zeros_like(uniq))
    Xw = mappoint_positions_at(m, safe)
    valid = ok & m.mp_valid[safe.long()]
    return Xw, m.mp_desc[safe.long()], safe, valid
