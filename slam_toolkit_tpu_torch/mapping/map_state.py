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

A batched map (B lanes, every field with a leading lane axis) is what
insert_keyframe, claimed_keypoints, gather_local_landmarks and
mappoint_positions_at compute on (the JAX package's vmapped calls); one
map is the batch of one lane (utils/lanes.with_lane). The integer and
elementwise work runs once over the lanes, the pose algebra lane by lane
(se3.per_lane), so each lane's result is its single call's bit for bit.
insert_keyframe takes a lane mask: a lane the mask leaves out keeps
every field (its mappoint writes go to the dump slot, its keyframe row
is written back with the values it held).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.frame import FrameState
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.utils.lanes import lane, with_lane


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

    @property
    def capacity(self) -> Tuple[int, int]:
        """(keyframe slots F, mappoint slots M); a batched map's per
        lane."""
        return self.kf_valid.shape[-1], self.mp_valid.shape[-1]


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
    """World positions of mappoints `ids`: Xw = T_wc_ref . (ray / invd).
    A batched map takes (B, N) ids, each lane's from its own map."""
    if m.mp_valid.dim() == 1:
        return mappoint_positions_at(with_lane(m), ids[None])[0]
    ids = ids.long()
    bi = lane_index(ids.shape[0], ids.device)
    ref = torch.gather(m.mp_ref_kf, 1, ids).long()
    norm = m.kf_norm[bi, ref, torch.gather(m.mp_kpt, 1, ids).long()]
    invd = torch.clamp(torch.gather(m.mp_invd, 1, ids), min=1e-3)
    ray = torch.cat([norm, torch.ones_like(invd)[..., None]], dim=-1)
    return se3.per_lane(lambda T, X: se3.transform(se3.inv(T), X),
                        m.kf_T_cw[bi, ref], ray / invd[..., None])


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
    (a searchsorted on the running count of free slots). Leading lane
    axes allocate each lane in its own row."""
    n = free.shape[-1]
    csum = torch.cumsum(free.int(), dim=-1)
    rank = torch.cumsum(want.int(), dim=-1) - 1
    slots = torch.searchsorted(csum, rank + 1, side="left")
    real = want & (rank < csum[..., -1:])
    return torch.where(real, slots, torch.full_like(slots, n)).int()


def claimed_keypoints(frame: FrameState, T_cw: torch.Tensor, cfg: SlamConfig,
                      points_w: torch.Tensor,
                      points_valid: torch.Tensor) -> torch.Tensor:
    """(K,) bool: keypoints whose image cell (or a neighbour) holds the
    projection of a live landmark of the snapshot; those spawn no new
    landmark (claim_cell_px grid, dilated 3x3). (B, K) for B lanes."""
    if frame.feats.xy.dim() == 2:
        return claimed_keypoints(with_lane(frame), T_cw[None], cfg,
                                 points_w[None], points_valid[None])[0]
    cell = cfg.map.claim_cell_px
    B, K = frame.feats.xy.shape[:2]
    dev = frame.feats.xy.device
    if cell <= 0:
        return torch.zeros((B, K), dtype=torch.bool, device=dev)
    Xc = se3.per_lane(se3.transform, T_cw, points_w)
    z = torch.clamp(Xc[..., 2], min=0.05)
    u = cfg.camera.fx * Xc[..., 0] / z + cfg.camera.cx
    v = cfg.camera.fy * Xc[..., 1] / z + cfg.camera.cy
    gw = int(cfg.camera.width / cell) + 3
    gh = int(cfg.camera.height / cell) + 3
    cu = torch.floor(u / cell).int() + 1
    cv = torch.floor(v / cell).int() + 1
    inb = (points_valid & (Xc[..., 2] > 0.05) &
           (cu >= 0) & (cu < gw) & (cv >= 0) & (cv < gh))
    flat = torch.where(inb, cv * gw + cu, torch.full_like(cu, gh * gw))
    grid = torch.zeros((B, gh * gw + 1), dtype=torch.bool, device=dev)
    grid.scatter_(1, flat.long(), True)           # one value: deterministic
    grid = grid[:, :-1].reshape(B, gh, gw)
    dil = grid
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                dil = dil | torch.roll(grid, shifts=(dy, dx), dims=(1, 2))
    ku = torch.clamp(torch.floor(frame.feats.xy[..., 0] / cell).long() + 1,
                     0, gw - 1)
    kv = torch.clamp(torch.floor(frame.feats.xy[..., 1] / cell).long() + 1,
                     0, gh - 1)
    return dil[lane_index(B, dev), kv, ku]


def row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-dim index tensor i on t's device. t[i] itself reads i
    back to the host (a synchronisation, and no CUDA graph captures it);
    this gathers the row on the device."""
    return t.index_select(0, i.reshape(1))[0]


def at(t: torch.Tensor, i) -> torch.Tensor:
    """t[i] for a host int or a 0-dim index tensor (row)."""
    return row(t, i) if torch.is_tensor(i) else t[int(i)]


def insert_keyframe(m: MapState, frame: FrameState, T_cw: torch.Tensor,
                    frame_id, mp_ids: torch.Tensor,
                    mp_kpt: torch.Tensor, mp_tracked: torch.Tensor,
                    cfg: SlamConfig, lm_snapshot, quality=None, lanes=None
                    ) -> Tuple[MapState, torch.Tensor]:
    """Insert `frame` as a keyframe and supply new mappoints at stereo
    keypoints that are neither matched nor claimed (ref
    src/frame.cpp:444-463, :235-255; src/pipeline_map.cpp:131-149).

    mp_ids / mp_kpt / mp_tracked: landmark id, matched keypoint and
    inlier mask of the tracking result. lm_snapshot: (Xw, valid) of the
    tracker's landmark snapshot, rasterized for the claim test.
    frame_id: a host int or a 0-dim int tensor on the map's device.
    Updates `m` in place; returns (m, slot) with slot a 0-dim tensor.

    A batched map (B lanes) takes the frame, pose, tracking result and
    snapshot with the same leading lane axis, and `lanes`, a (B,) mask on
    the map's device (None: every lane): each lane the mask keeps gets
    the single call's insertion, one the mask leaves out keeps every
    field; slot is (B,) (the slot the lane's keyframe went to, or would
    have)."""
    if m.kf_valid.dim() == 1:
        if torch.is_tensor(quality):
            quality = quality.reshape(1)
        _, slot = insert_keyframe(
            with_lane(m), with_lane(frame), T_cw[None], frame_id,
            mp_ids[None], mp_kpt[None], mp_tracked[None], cfg,
            with_lane(tuple(lm_snapshot)), quality)
        return m, slot[0]
    B, K = frame.feats.xy.shape[:2]
    M = m.mp_valid.shape[-1]
    dev = frame.feats.xy.device
    keep = torch.ones((B,), dtype=torch.bool, device=dev) if lanes is None \
        else lanes.bool()
    slot = torch.argmin(m.kf_valid.int(), dim=-1)     # first free KF slot

    # kpt k of this keyframe observes landmark mp_ids[i]; tracked
    # landmarks hit distinct keypoints (keep_best_per_target), untracked
    # ones all write -1 into the dump slot K
    scatter_kpt = torch.where(mp_tracked, mp_kpt, torch.full_like(mp_kpt, K))
    obs_row = torch.full((B, K + 1), -1, dtype=torch.int32, device=dev)
    obs_row.scatter_(1, scatter_kpt.long(), torch.where(
        mp_tracked, mp_ids, torch.full_like(mp_ids, -1)).int())
    obs_row = obs_row[:, :K]

    has_mp = obs_row >= 0
    claimed = claimed_keypoints(frame, T_cw, cfg, *lm_snapshot)
    new_mask = frame.feats.valid & frame.has_stereo & ~has_mp & ~claimed & \
        keep[:, None]
    new_slots = allocate_slots(~m.mp_valid, new_mask, K)
    allocated = new_slots < M
    kpt_idx = torch.arange(K, dtype=torch.int32, device=dev).expand(B, K)
    invd_new = 1.0 / torch.clamp(frame.depth, min=1e-3)

    mp_ref_kf = scatter_drop_lanes(m.mp_ref_kf, new_slots,
                                   slot.int()[:, None].expand(B, K))
    mp_kpt_arr = scatter_drop_lanes(m.mp_kpt, new_slots, kpt_idx)
    mp_invd = scatter_drop_lanes(m.mp_invd, new_slots, invd_new)
    mp_desc = scatter_drop_lanes(m.mp_desc, new_slots, frame.feats.desc)
    mp_valid = scatter_drop_lanes(m.mp_valid, new_slots, True)
    obs_row = torch.where(allocated, new_slots, obs_row)

    # observation counts: tracked landmarks +1 (integer adds: order-free),
    # new landmarks = 1
    tracked_ids = torch.where(mp_tracked & keep[:, None], mp_ids,
                              torch.full_like(mp_ids, M))
    base = lane_index(B, dev) * M
    flat = torch.where(tracked_ids < M, tracked_ids.long() + base,
                       torch.full_like(base, B * M)).reshape(-1)
    obs_count = torch.cat([m.mp_obs_count.reshape(-1),
                           m.mp_obs_count.new_zeros(1)])
    obs_count = obs_count.index_add(
        0, flat, torch.ones_like(flat, dtype=torch.int32))[:-1]
    obs_count = scatter_drop_lanes(obs_count.reshape(B, M), new_slots, 1)

    if quality is None:
        quality = torch.sum(mp_tracked.float(), dim=-1)
    elif not torch.is_tensor(quality):
        quality = torch.full((B,), quality, dtype=torch.float32, device=dev)
    if torch.is_tensor(frame_id):     # a fill would read it back
        fid = frame_id.reshape(1).expand(B)
    else:
        fid = torch.full((B,), int(frame_id), dtype=torch.int32, device=dev)
    for field, new in ((m.kf_T_cw, T_cw),
                       (m.kf_valid, torch.ones_like(keep)),
                       (m.kf_frame_id, fid),
                       (m.kf_xy, frame.feats.xy), (m.kf_norm, frame.norm_xy),
                       (m.kf_desc, frame.feats.desc),
                       (m.kf_sigma2, frame.feats.sigma2),
                       (m.kf_kpt_valid, frame.feats.valid),
                       (m.kf_right_x_norm, frame.right_x_norm),
                       (m.kf_has_stereo, frame.has_stereo),
                       (m.kf_obs, obs_row), (m.kf_quality, quality)):
        write_rows_lanes(field, slot, new, keep)
    for name, new in (("mp_ref_kf", mp_ref_kf), ("mp_kpt", mp_kpt_arr),
                      ("mp_invd", mp_invd), ("mp_desc", mp_desc),
                      ("mp_valid", mp_valid), ("mp_obs_count", obs_count)):
        getattr(m, name).copy_(new)
    return m, slot


def unique_prioritized(ids: torch.Tensor, num_out: int,
                       m: MapState) -> torch.Tensor:
    """Up to `num_out` distinct landmark ids (negative entries ignored),
    landmarks that appear at least twice in `ids` first, then by id;
    sentinel M fills the rest. Two sorts of packed integer keys. Leading
    lane axes on `ids` (and the map) give each lane's row."""
    M = m.mp_valid.shape[-1]
    n = ids.shape[-1]
    ids = ids.long()
    pos = torch.arange(n, dtype=torch.int64, device=ids.device)
    key = torch.where(ids >= 0, ids * n + pos, torch.full_like(ids, M * n))
    skey = torch.sort(key).values
    sid = torch.clamp(skey // n, max=M)
    diff = sid[..., 1:] != sid[..., :-1]
    one = torch.ones(sid.shape[:-1] + (1,), dtype=torch.bool,
                     device=ids.device)
    first = torch.cat([one, diff], dim=-1) & (sid < M)
    est = first & torch.cat([~diff, ~one], dim=-1)
    pack2 = torch.where(first,
                        torch.where(est, torch.zeros_like(sid),
                                    torch.full_like(sid, M + 1)) + sid,
                        torch.full_like(sid, 2 * (M + 1) + M))
    return (torch.sort(pack2).values[..., :num_out] % (M + 1)).int()


def covisibility_counts(m: MapState, kf_slot) -> torch.Tensor:
    """(F,) int32 number of mappoints keyframe `kf_slot` (a host int or a
    0-dim tensor on the map's device) shares with each keyframe: the
    query's observed ids marked in an (M,) mask (one value written per
    index), gathered at every keyframe's observation row: one pass over
    kf_obs."""
    M = m.mp_valid.shape[0]
    q = at(m.kf_obs, kf_slot).long()
    member = torch.zeros((M + 1,), dtype=torch.bool, device=q.device)
    member.index_fill_(0, torch.where(q >= 0, q, torch.full_like(q, M)),
                       True)
    obs = m.kf_obs.long()
    hit = (obs >= 0) & member[:M][torch.clamp(obs, min=0)]
    return torch.sum(hit, dim=1).int()


def covisibility_rows(m: MapState, slots: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """(R, F) int32 covisibility rows of the (R,) device slots, a pass over
    kf_obs each; a row `valid` leaves out is zero (its slot is not
    read)."""
    safe = torch.where(valid, slots, torch.zeros_like(slots))
    rows = torch.stack([covisibility_counts(m, safe[r])
                        for r in range(safe.shape[0])])
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


def camera_frustum(cam_cfg, margin: float = 1.25):
    """Normalized-plane half-extents (nx_max, ny_max), widened by margin."""
    nx = margin * max(cam_cfg.cx, cam_cfg.width - cam_cfg.cx) / cam_cfg.fx
    ny = margin * max(cam_cfg.cy, cam_cfg.height - cam_cfg.cy) / cam_cfg.fy
    return (float(nx), float(ny))


def _top_slots(values: torch.Tensor, k: int):
    """lax.top_k: the k largest, ties in index order (stable sort)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_local_landmarks(m: MapState, num_out: int, recent: int = 10,
                           covis_kfs: int = 0, covis_min: int = 5,
                           frustum=None):
    """The tracker's local map: mappoints observed by the `recent` newest
    keyframes plus, with covis_kfs > 0, those of the latest keyframe's
    top covisible neighbours that lie in its view (ref
    src/pipeline.cpp:167-177). Returns (Xw (L, 3), desc (L, 8),
    ids (L,), valid (L,)) with L = num_out; for a batched map each with a
    leading lane axis, every lane's the single call's."""
    if m.kf_valid.dim() == 1:
        return lane(gather_local_landmarks(with_lane(m), num_out, recent,
                                           covis_kfs, covis_min, frustum), 0)
    B, F = m.kf_valid.shape
    K = m.kf_obs.shape[-1]
    dev = m.kf_valid.device
    bi = lane_index(B, dev)
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, -1))
    _, recent_slots = _top_slots(fid, recent)
    ids = m.kf_obs[bi, recent_slots].reshape(B, -1)
    if covis_kfs > 0:
        latest = torch.argmax(fid, dim=-1)
        # anchor-ownership covisibility with the latest keyframe
        q = m.kf_obs[bi[:, 0], latest].long()
        anc = torch.where(q >= 0, torch.gather(m.mp_ref_kf, 1,
                                               torch.clamp(q, min=0)).long(),
                          torch.full_like(q, -1))
        cov = torch.sum(anc[:, :, None] ==
                        torch.arange(F, device=dev)[None, None, :], dim=1)
        in_recent = torch.zeros((B, F), dtype=torch.bool, device=dev)
        in_recent.scatter_(1, recent_slots, True)
        cov = torch.where(m.kf_valid & ~in_recent, cov, torch.zeros_like(cov))
        cov_top, cov_slots = _top_slots(cov, covis_kfs)
        cids = m.kf_obs[bi, cov_slots].reshape(B, -1)
        keep = torch.repeat_interleave(cov_top >= covis_min, K, dim=1) & \
            (cids >= 0)
        if frustum is not None:
            safe = torch.where(keep, cids, torch.zeros_like(cids))
            Xc = se3.per_lane(se3.transform, m.kf_T_cw[bi[:, 0], latest],
                              mappoint_positions_at(m, safe))
            z = Xc[..., 2]
            zs = torch.clamp(z, min=1e-6)
            keep = keep & (z > 0.05) & \
                (torch.abs(Xc[..., 0] / zs) <= frustum[0]) & \
                (torch.abs(Xc[..., 1] / zs) <= frustum[1])
        cids = torch.where(keep, cids, torch.full_like(cids, -1))
        ids = torch.cat([ids, cids], dim=1)
    uniq = unique_prioritized(ids, num_out, m)
    ok = uniq < m.mp_valid.shape[-1]
    safe = torch.where(ok, uniq, torch.zeros_like(uniq)).long()
    Xw = mappoint_positions_at(m, safe)
    valid = ok & torch.gather(m.mp_valid, 1, safe)
    return Xw, m.mp_desc[bi, safe], safe.int(), valid


# ---- lanes: a batched map, every field with a leading lane axis B ------
def lane_index(n: int, device) -> torch.Tensor:
    """(n, 1) int64 lane numbers, to index a batched field next to a
    (n, k) index tensor."""
    return torch.arange(n, device=device)[:, None]


def scatter_drop_lanes(arr: torch.Tensor, idx: torch.Tensor,
                       values) -> torch.Tensor:
    """_scatter_drop in every lane: arr (B, N, ...), idx (B, K) with N
    the dropped entries, values a tensor (B, K, ...) or a Python scalar.
    The lanes are one flat table of B * N rows with one shared dump slot,
    so the scatter is _scatter_drop's own. Returns a new tensor."""
    B, N = arr.shape[:2]
    base = lane_index(B, idx.device) * N
    flat = torch.where(idx < N, idx.long() + base,
                       torch.full_like(base, B * N))
    if torch.is_tensor(values):
        values = values.reshape((-1,) + values.shape[2:])
    out = _scatter_drop(arr.reshape((B * N,) + arr.shape[2:]),
                        flat.reshape(-1), values)
    return out.reshape(arr.shape)


def write_rows_lanes(field: torch.Tensor, rows: torch.Tensor,
                     new: torch.Tensor, lanes: torch.Tensor) -> None:
    """field[b, rows[b]] = new[b] in place for the lanes the mask keeps;
    a lane it leaves out gets its row's own values back, so nothing of it
    changes. field (B, F, ...), rows (B,) or (B, k) distinct per lane,
    new (B, ...) or (B, k, ...)."""
    B, F = field.shape[:2]
    rows = rows.reshape(B, -1).long()
    flat = (rows + lane_index(B, rows.device) * F).reshape(-1)
    view = field.view((B * F,) + field.shape[2:])
    old = view.index_select(0, flat)
    new = new.reshape(old.shape).to(field.dtype)
    keep = lanes.bool().repeat_interleave(rows.shape[1]).reshape(
        (-1,) + (1,) * (old.dim() - 1))
    view.index_copy_(0, flat, torch.where(keep, new, old))
