"""Chunked SLAM engine: the per-frame step and its host loop.

Counterpart of slam_toolkit_tpu/pipeline/scan_engine.py without a
vocabulary: every frame extracts and tracks (tracker.method "indirect":
projection matching and the motion-only pose LM; "direct": photometric
alignment against the latest keyframe image, then keypoint binding;
"hybrid": indirect, then a short photometric polish), and applies the
keyframe rule; on a keyframe it also runs SAD stereo, inserts the
keyframe, culls weak mappoints, runs local BA over the keyframe window
and refreshes the tracker's landmark snapshot. The bootstrap keyframe
runs no BA, as in the JAX package. Between chunks, a keyframe ring near
capacity is culled (mapping/culling) and the trajectory re-anchored, as
the JAX engine's _ensure_headroom does.

The JAX package runs a chunk as one jitted lax.scan with the keyframe
branch under lax.cond (make_chunk_fn). Here the step is split at the
keyframe flag into two halves, tracking and the keyframe event.
make_chunk_fn runs them on a static carry, captured once on a CUDA
device as one CUDA graph a chunk: a WHILE node over the frames (the
frame index, the chunk's images and its packed rows on the device,
utils/cuda_graphs.run_while) whose body tracks, then runs the keyframe
event under an IF node on the device flag (run_if); one graph launch a
chunk, no host read inside it (eagerly on the CPU, the flags read on
the host). make_frame_body runs the halves eagerly on a carry rebuilt
every frame, the branch a host `if` on the flag. A chunk's frames go up
through pinned memory without waiting, and its packed result rows are
read back once, when the chunk is folded.

ChunkedSlamEngine keeps up to queue_depth chunks run and not yet folded
(the JAX engine's in-flight queue, SLAM_QUEUE_DEPTH; 0 by default here):
process_chunk returns the rows of the chunks it folds, and flush() the
rest. With a vocabulary, loop closing and relocalization run at each
fold (the JAX engine's mapping-thread phases, through
pipeline/engine.py's SlamEngine): each chunk's keyframes are
BoW-registered and scored on the device as soon as the chunk has run;
its fold then (1) relocalizes on a lost streak, from the newest image
run, and folds the chunks in flight at once, (2) closes the
measurements one fold old (pose graph, merge), re-seeding the tracking
head through the latest keyframe, (3) consumes the detections stashed
two folds earlier (accScore groups, consistency) and measures the
accepted candidates' relative poses, and (4) stashes this chunk's
detections with their covisibility rows. A pending measurement is
consumed once it is a fold old and, under the mapping worker, its result
has landed (an event recorded after it has completed), or at 4 folds;
inline, and on the CPU, the ages alone decide. Phases (2)-(4) run inline
by default, or with loop_thread (SLAM_LOOP_THREAD) as jobs on a mapping
thread with a CUDA stream of its own (_MappingWorker), beside the next
chunk's replays; a closure it decides lands at the next chunk boundary.
Inline, the closure count is deterministic; under the thread it depends
on timing, as under the JAX engine's.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
import weakref
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.direct_tracker import \
    track_direct_bound
from slam_toolkit_tpu_torch.frontend.frame import (FrameState, add_stereo,
                                                   build_frame)
from slam_toolkit_tpu_torch.frontend.tracker import TrackResult, track_pose
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.loop.vocab import db_set as vocab_db_set
from slam_toolkit_tpu_torch.mapping import keyframe as kf_rule
from slam_toolkit_tpu_torch.mapping.ba_adapter import local_ba_step
from slam_toolkit_tpu_torch.mapping.culling import cull_weak_mappoints
from slam_toolkit_tpu_torch.mapping.map_state import (MapState,
                                                      camera_frustum,
                                                      empty_map,
                                                      gather_local_landmarks,
                                                      insert_keyframe, row)
from slam_toolkit_tpu_torch.optim import direct_lm
from slam_toolkit_tpu_torch.optim.direct_lm import DirectState
from slam_toolkit_tpu_torch.pipeline.engine import (BOW_ROWS, SlamEngine,
                                                    full_float32, store_map)
from slam_toolkit_tpu_torch.utils.cuda_graphs import (StepGraphs, run_if,
                                                      run_while)
from slam_toolkit_tpu_torch.utils import timing
from slam_toolkit_tpu_torch.utils.device import upload
from slam_toolkit_tpu_torch.utils.lanes import lane

PACK_WIDTH = 16 + 16 + 4  # T, T_rel, [slot, ok, kf, n_inliers]
# a traced chunk's device stamps (_StaticChunk with a tracer), a row a
# frame, in the order a frame writes them: its start (before the fetch),
# after extraction (build_frame), after tracking (the tracker, keyframe
# rule, carry writes and pack), then inside the keyframe IF body (its
# start, after stereo, after insert and weak-mappoint cull, after local
# BA, its end), and after the row store; the keyframe slots stay 0 on a
# frame with no keyframe event
FRAME_STAMPS = ("start", "extracted", "tracked", "kf_start", "kf_stereo",
                "kf_inserted", "kf_ba", "kf_end", "stored")
_SLOT = {name: k for k, name in enumerate(FRAME_STAMPS)}
_NO_SPAN = contextlib.nullcontext()


class ChunkCarry(NamedTuple):
    m: MapState
    T_cw: torch.Tensor         # (4, 4)
    velocity: torch.Tensor     # (4, 4)
    lm_Xw: torch.Tensor        # (L, 3) landmark snapshot
    lm_desc: torch.Tensor      # (L, 8) int32
    lm_ids: torch.Tensor       # (L,) int32
    lm_valid: torch.Tensor     # (L,) bool
    latest_slot: torch.Tensor  # () int slot of the latest keyframe
    latest_T: torch.Tensor     # (4, 4) pose of the latest keyframe
    # global frame index: a host int, or (the static carry of
    # make_chunk_fn) a 0-dim int32 on the device that the step advances
    frame_id: int
    inlier_peak: torch.Tensor  # () float32 max inliers since the last KF
    # the photometric anchor ("direct" and "hybrid" only; None otherwise)
    kf_img: Optional[torch.Tensor] = None     # (H, W) latest keyframe image
    kf_ab: Optional[torch.Tensor] = None      # (2,) brightness (a, b)
    # "hybrid" only: the anchor's pattern intensities per landmark (L, 8),
    # computed at the keyframe so the per-frame polish skips that pass
    kf_refvals: Optional[torch.Tensor] = None


def _snapshot(m: MapState, cfg: SlamConfig):
    return gather_local_landmarks(
        m, cfg.map.track_landmarks, cfg.map.track_recent_kfs,
        cfg.map.track_covis_kfs, cfg.map.track_covis_min,
        camera_frustum(cfg.camera))


def _camera_center(T: torch.Tensor) -> torch.Tensor:
    return -(T[:3, :3].T @ T[:3, 3])


def keyframe_event(carry: ChunkCarry, frame, left, right, T_new,
                   res: TrackResult, cam: StereoCamera, cfg: SlamConfig,
                   lanes=None, stamp=None):
    """The keyframe branch (JAX scan_engine kf_branch): SAD stereo, insert,
    weak-mappoint cull, local BA and the landmark snapshot. Returns (map,
    slot, snapshot, the keyframe's pose after BA).

    B lanes (a batched carry, frame, tracking result and images, and
    `lanes` the (B,) mask of the flagged lanes on the device): the event
    runs once over all lanes, the JAX package's vmapped kf_branch with
    the keyframe select as a mask. Stereo (the SAD curves of every lane
    in one batched launch), insert, cull and local BA (one batched
    launch) touch only the flagged lanes' maps, in place; slot, snapshot
    and pose come back for every lane and hold for the flagged ones
    (_batched_keyframe keeps the others'). Each flagged lane's result is
    its single event's bit for bit. Descriptor stereo and the BRIEF gate
    also run once over the lanes (frontend/frame.add_stereo).

    stamp: None, or stamp(name) to stamp the device clock after stereo
    ("kf_stereo"), after insert and cull ("kf_inserted") and after local
    BA ("kf_ba") (a traced chunk's FRAME_STAMPS)."""
    kw = {} if lanes is None else {"lanes": lanes}
    fr2 = add_stereo(frame, left, right, cam, cfg, **kw)
    if stamp is not None:
        stamp("kf_stereo")
    m, slot = insert_keyframe(
        carry.m, fr2, T_new, carry.frame_id, carry.lm_ids, res.mp_kpt,
        res.mp_inlier, cfg, lm_snapshot=(carry.lm_Xw, carry.lm_valid), **kw)
    m = cull_weak_mappoints(m, carry.frame_id, cfg.map.mp_cull_grace_frames,
                            cfg.map.mp_cull_min_obs, **kw)
    if stamp is not None:
        stamp("kf_inserted")
    m = local_ba_step(m, cam, cfg, **kw)
    if stamp is not None:
        stamp("kf_ba")
    if m.kf_valid.dim() == 2:
        latest_T = m.kf_T_cw[torch.arange(slot.shape[0],
                                          device=slot.device), slot]
    else:
        latest_T = row(m.kf_T_cw, slot)
    return m, slot, _snapshot(m, cfg), latest_T


def write_lane(batched: MapState, b: int, m: MapState) -> None:
    """Store lane b's map `m` into the batched map (its views of the
    batch are already there)."""
    store_map(lane(batched, b), m)


class Tracked(NamedTuple):
    """The tracking half of a frame step, everything before the keyframe
    flag (a leading lane axis when B lanes are tracked)."""
    frame: FrameState
    res: TrackResult
    needs: torch.Tensor        # () bool: the frame becomes a keyframe
    T_new: torch.Tensor        # (4, 4) tracked pose, or the prediction
    velocity: torch.Tensor     # (4, 4)
    inlier_peak: torch.Tensor  # ()
    ab: Optional[torch.Tensor] = None  # (2,) the frame's (a, b), photometric


def _keyframe_rule(res: TrackResult, peak: torch.Tensor, cfg: SlamConfig):
    """(needs, the new inlier peak): the keyframe rule, tracking lost, or
    inliers decayed below decay_ratio of their peak since the last
    keyframe."""
    n_inl = res.n_inliers.float()
    needs = (kf_rule.needs_keyframe(
        res.mp_xy, res.mp_inlier, cfg.camera.width, cfg.camera.height,
        cfg.keyframe) | ~res.ok | (n_inl < cfg.keyframe.decay_ratio * peak))
    return needs, torch.where(needs, torch.zeros_like(n_inl),
                              torch.maximum(peak, n_inl))


def _pack(T_out, T_rel, slot, res: TrackResult, needs) -> torch.Tensor:
    """The packed row (36,), or rows (B, 36): T, T_rel, slot, ok, kf,
    n_inliers."""
    return torch.cat([T_out.flatten(-2), T_rel.flatten(-2), torch.stack(
        [slot.float(), res.ok.float(), needs.float(),
         res.n_inliers.float()], dim=-1)], dim=-1)


def require_anchor(cfg: SlamConfig, carry: ChunkCarry) -> None:
    """Raise ValueError when a photometric tracker ("direct", "hybrid") is
    handed a carry without its anchor: kf_img and kf_ab, and for "hybrid"
    kf_refvals. mesh.batched_bootstrap, as the JAX package's, builds no
    anchor; the caller adds one (the keyframe's left image, (a, b) = (0,
    0), and for "hybrid" direct_lm.reference_values at latest_T)."""
    need = {"direct": ("kf_img", "kf_ab"),
            "hybrid": ("kf_img", "kf_ab", "kf_refvals")}.get(
                cfg.tracker.method, ())
    missing = [f for f in need if getattr(carry, f) is None]
    if missing:
        raise ValueError(f"tracker.method={cfg.tracker.method!r} needs the "
                         f"carry's photometric anchor; missing: "
                         f"{', '.join(missing)}")


def _batched_tracker(cfg: SlamConfig, cam: StereoCamera):
    """track(carry, lefts (B, H, W)) -> Tracked: the tracking half of
    make_batched_frame_body, once over the lane axis, for every
    tracker.method (_frame_tracker's over lanes)."""
    method = cfg.tracker.method
    if method not in ("indirect", "direct", "hybrid"):
        raise NotImplementedError(f"tracker.method={method!r}")

    def hybrid_polish(carry: ChunkCarry, lefts, res0: TrackResult):
        """_frame_tracker's polish over lanes: the photometric LM of every
        lane at once, its shift gate per lane."""
        st0 = DirectState(T_cw=res0.T_cw, a=carry.kf_ab[:, 0],
                          b=carry.kf_ab[:, 1])
        dres = direct_lm.optimize_direct(
            st0, lefts, cam.left, carry.lm_Xw, carry.kf_refvals,
            carry.lm_valid, 1.0, iters=cfg.tracker.hybrid_iters)
        T_dir = se3.per_lane(se3.normalize, dres.state.T_cw)
        shift = se3.per_lane(
            lambda a, b: torch.linalg.vector_norm(_camera_center(a) -
                                                  _camera_center(b)),
            T_dir, res0.T_cw)
        okp = res0.ok & (shift < cfg.tracker.hybrid_max_shift_m)
        ab = torch.where(okp[:, None], torch.stack(
            [dres.state.a, dres.state.b], dim=-1), carry.kf_ab)
        return res0._replace(T_cw=torch.where(okp[:, None, None], T_dir,
                                              res0.T_cw)), ab

    def track(carry: ChunkCarry, lefts: torch.Tensor,
              stamp=None) -> Tracked:
        frame = build_frame(lefts, cam, cfg)
        if stamp is not None:
            stamp("extracted")
        T_pred = se3.per_lane(se3.compose, carry.velocity, carry.T_cw)
        ab_new = None
        if method == "direct":
            res, ab_new = track_direct_bound(
                frame, lefts, T_pred, carry.kf_img, carry.latest_T,
                carry.kf_ab, carry.lm_Xw, carry.lm_desc, carry.lm_valid, cam,
                cfg)
        else:
            res = track_pose(frame, carry.lm_Xw, carry.lm_desc,
                             carry.lm_valid, T_pred, cam, cfg)
            if method == "hybrid":
                res, ab_new = hybrid_polish(carry, lefts, res)
        needs, peak = _keyframe_rule(res, carry.inlier_peak, cfg)
        T_new = torch.where(res.ok[:, None, None], res.T_cw, T_pred)
        return Tracked(frame, res, needs, T_new,
                       se3.per_lane(_velocity, T_new, carry.T_cw), peak,
                       ab_new)

    return track


def _batched_keyframe(cfg: SlamConfig, cam: StereoCamera):
    """keyframe(carry, tracked, lefts, rights) -> the flagged lanes' new
    (snapshot, slot, pose, anchor image, "hybrid"'s anchor pattern
    intensities), every other lane's as the carry holds them: the
    keyframe half of make_batched_frame_body, once over all lanes with
    tracked.needs as the lane mask (keyframe_event over lanes). The maps
    are updated in place."""
    method = cfg.tracker.method

    def keyframe(carry: ChunkCarry, t: Tracked, lefts, rights):
        mask = t.needs
        _, slot, lm, latest_T = keyframe_event(
            carry, t.frame, lefts, rights, t.T_new, t.res, cam, cfg,
            lanes=mask)

        def pick(new, old):
            return torch.where(mask.reshape((-1,) + (1,) * (old.dim() - 1)),
                               new.to(old.dtype), old)
        lm = tuple(pick(n, o) for n, o in zip(lm, (
            carry.lm_Xw, carry.lm_desc, carry.lm_ids, carry.lm_valid)))
        slot = pick(slot, carry.latest_slot)
        latest_T = pick(latest_T, carry.latest_T)
        kf_img = refvals = None
        if method != "indirect":
            # the flagged lanes' keyframes become their anchors
            kf_img = pick(lefts, carry.kf_img)
        if method == "hybrid":
            refvals = pick(direct_lm.reference_values(
                DirectState(T_cw=latest_T, a=t.ab[:, 0], b=t.ab[:, 1]),
                lefts, cam.left, lm[0], lm[3], 1.0), carry.kf_refvals)
        return lm, slot, latest_T, kf_img, refvals

    return keyframe


def make_batched_frame_body(cfg: SlamConfig, cam: StereoCamera):
    """(carry, lefts (B, H, W), rights (B, H, W)) -> (carry, packed (B,
    36)): make_frame_body over B lanes, the JAX package's vmapped frame
    body (parallel/mesh._vmapped_frame_body), for every tracker.method.
    Everything before the keyframe flag runs once over the lane axis
    (extraction, frame build, the tracker, keyframe rule, velocity and
    peak): one op, or one kernel launch, for B lanes. The B flags are
    read back together; when any is set the keyframe event runs once
    over all lanes with the flags as its lane mask (stereo, insert, cull,
    local BA, snapshot and the new anchor of the flagged lanes; one
    launch each of the batched SAD and local-BA kernels). The 4x4 pose
    algebra, the landmark transforms, the photometric LM's sums and solve
    run lane by lane (se3.per_lane): a batched matrix product or
    reduction rounds otherwise, and tracking grows a last bit into
    centimetres. So each lane's row is the one make_frame_body gives it,
    bit for bit. A photometric tracker needs the carry's anchor
    (require_anchor). The eager step: parallel/mesh.multi_sequence_chunk
    runs the same halves on a static carry (_StaticBatchedChunk)."""
    track = _batched_tracker(cfg, cam)
    keyframe = _batched_keyframe(cfg, cam)

    def frame_body(carry: ChunkCarry, lefts: torch.Tensor,
                   rights: torch.Tensor):
        require_anchor(cfg, carry)
        t = track(carry, lefts)
        slot, latest_T = carry.latest_slot, carry.latest_T
        lm = (carry.lm_Xw, carry.lm_desc, carry.lm_ids, carry.lm_valid)
        kf_img, refvals = carry.kf_img, carry.kf_refvals
        T_out = t.T_new
        if bool(t.needs.any()):                       # one readback
            lm, slot, latest_T, kf_img, refvals = keyframe(carry, t, lefts,
                                                           rights)
            T_out = torch.where(t.needs[:, None, None], latest_T, t.T_new)
        packed = _pack(T_out, se3.per_lane(_relative, T_out, latest_T),
                       slot, t.res, t.needs)
        new_carry = carry._replace(
            T_cw=T_out, velocity=t.velocity, lm_Xw=lm[0], lm_desc=lm[1],
            lm_ids=lm[2], lm_valid=lm[3], latest_slot=slot,
            latest_T=latest_T, frame_id=carry.frame_id + 1,
            inlier_peak=t.inlier_peak, kf_img=kf_img, kf_ab=t.ab,
            kf_refvals=refvals)
        return new_carry, packed

    return frame_body


def _velocity(T_new: torch.Tensor, T_prev: torch.Tensor) -> torch.Tensor:
    return se3.normalize(se3.compose(T_new, se3.inv(T_prev)))


def _relative(T: torch.Tensor, T_ref: torch.Tensor) -> torch.Tensor:
    return se3.compose(T, se3.inv(T_ref))


def _frame_tracker(cfg: SlamConfig, cam: StereoCamera):
    """(track, keyframe), the two halves of make_frame_body's step:
    track(carry, left) -> Tracked; keyframe(carry, tracked, left, right)
    -> (map, slot, snapshot, the keyframe's pose, "hybrid"'s anchor
    pattern intensities or None). Either takes an optional `stamp` (a
    traced chunk's, keyframe_event's)."""
    method = cfg.tracker.method
    if method not in ("indirect", "direct", "hybrid"):
        raise NotImplementedError(f"tracker.method={method!r}")

    def hybrid_polish(carry: ChunkCarry, left, res0: TrackResult):
        """The indirect pose polished by a few full-resolution photometric
        LM steps against the anchor; a polish that moves the camera
        centre by hybrid_max_shift_m or more is rejected."""
        st0 = DirectState(T_cw=res0.T_cw, a=carry.kf_ab[0], b=carry.kf_ab[1])
        dres = direct_lm.optimize_direct(
            st0, left, cam.left, carry.lm_Xw, carry.kf_refvals,
            carry.lm_valid, 1.0, iters=cfg.tracker.hybrid_iters)
        T_dir = se3.normalize(dres.state.T_cw)
        shift = torch.linalg.vector_norm(_camera_center(T_dir) -
                                         _camera_center(res0.T_cw))
        okp = res0.ok & (shift < cfg.tracker.hybrid_max_shift_m)
        ab = torch.where(okp, torch.stack([dres.state.a, dres.state.b]),
                         carry.kf_ab)
        return res0._replace(T_cw=torch.where(okp, T_dir, res0.T_cw)), ab

    def track(carry: ChunkCarry, left: torch.Tensor,
              stamp=None) -> Tracked:
        frame = build_frame(left, cam, cfg)
        if stamp is not None:
            stamp("extracted")
        T_pred = se3.compose(carry.velocity, carry.T_cw)
        ab_new = None
        if method == "direct":
            res, ab_new = track_direct_bound(
                frame, left, T_pred, carry.kf_img, carry.latest_T,
                carry.kf_ab, carry.lm_Xw, carry.lm_desc, carry.lm_valid, cam,
                cfg)
        else:
            res = track_pose(frame, carry.lm_Xw, carry.lm_desc,
                             carry.lm_valid, T_pred, cam, cfg)
            if method == "hybrid":
                res, ab_new = hybrid_polish(carry, left, res)
        needs, peak = _keyframe_rule(res, carry.inlier_peak, cfg)
        T_new = torch.where(res.ok, res.T_cw, T_pred)
        return Tracked(frame, res, needs, T_new,
                       _velocity(T_new, carry.T_cw), peak, ab_new)

    def keyframe(carry: ChunkCarry, t: Tracked, left, right, stamp=None):
        m, slot, lm, latest_T = keyframe_event(
            carry, t.frame, left, right, t.T_new, t.res, cam, cfg,
            stamp=stamp)
        refvals = direct_lm.reference_values(
            DirectState(T_cw=latest_T, a=t.ab[0], b=t.ab[1]), left,
            cam.left, lm[0], lm[3], 1.0) if method == "hybrid" else None
        return m, slot, lm, latest_T, refvals

    return track, keyframe


def make_frame_body(cfg: SlamConfig, cam: StereoCamera):
    """(carry, left, right) -> (carry, packed (36,)), the per-frame step
    of slam_toolkit_tpu.pipeline.scan_engine.make_frame_body, eager: the
    keyframe branch is a host `if` on the flag, and the carry is rebuilt
    every frame. make_chunk_fn runs the same two halves on a static
    carry."""
    track, keyframe = _frame_tracker(cfg, cam)
    photometric = cfg.tracker.method != "indirect"

    def frame_body(carry: ChunkCarry, left: torch.Tensor,
                   right: torch.Tensor):
        t = track(carry, left)
        if bool(t.needs):        # the frame's one host synchronisation
            m, slot, lm, latest_T, refvals = keyframe(carry, t, left, right)
            T_out = latest_T
            # this keyframe becomes the photometric anchor, its image
            # paired with the BA-refined pose
            kf_img = left if photometric else None
        else:
            m, slot, latest_T, T_out = carry.m, carry.latest_slot, \
                carry.latest_T, t.T_new
            lm = (carry.lm_Xw, carry.lm_desc, carry.lm_ids, carry.lm_valid)
            kf_img, refvals = carry.kf_img, carry.kf_refvals
        packed = _pack(T_out, _relative(T_out, latest_T), slot, t.res,
                       t.needs)
        new_carry = ChunkCarry(
            m=m, T_cw=T_out, velocity=t.velocity,
            lm_Xw=lm[0], lm_desc=lm[1], lm_ids=lm[2], lm_valid=lm[3],
            latest_slot=slot, latest_T=latest_T,
            frame_id=carry.frame_id + 1, inlier_peak=t.inlier_peak,
            # (a, b) carries forward every frame: the anchor's brightness
            # is the latest tracked estimate
            kf_img=kf_img, kf_ab=t.ab, kf_refvals=refvals)
        return new_carry, packed

    return frame_body


# ---- the static carry: make_chunk_fn and the batched chunk ---------------
def static_copy(carry: ChunkCarry) -> ChunkCarry:
    """`carry` in contiguous buffers of its own, frame_id a 0-dim int32 on
    the carry's device: the static carry a graphed step works in."""
    def own(t):
        return t if t is None else t.clone(
            memory_format=torch.contiguous_format)
    fid = carry.frame_id
    fid = fid.to(torch.int32).clone() if torch.is_tensor(fid) else \
        torch.full((), fid, dtype=torch.int32, device=carry.T_cw.device)
    return ChunkCarry(*(MapState(*(own(f) for f in carry.m)) if n == "m"
                        else fid if n == "frame_id" else own(v)
                        for n, v in zip(ChunkCarry._fields, carry)))


def load_carry(static: ChunkCarry, carry: ChunkCarry) -> None:
    """Copy `carry`, which the host built or changed between chunks
    (bootstrap, keyframe cull, closure, relocalization), into the static
    buffers. Fields that are the buffers themselves are skipped; a source
    that views a static buffer is cloned before any buffer is written."""
    dsts = list(static.m) + [getattr(static, f) for f in ChunkCarry._fields
                             if f != "m"]
    srcs = list(carry.m) + [getattr(carry, f) for f in ChunkCarry._fields
                            if f != "m"]
    held = {t.untyped_storage().data_ptr() for t in dsts if t is not None}
    pairs = []
    for name, dst, src in zip(list(MapState._fields) + [
            f for f in ChunkCarry._fields if f != "m"], dsts, srcs):
        if (dst is None) != (src is None):
            raise ValueError(f"carry field {name}: the static carry holds "
                             f"{type(dst).__name__}, got "
                             f"{type(src).__name__}")
        if dst is None or src is dst:
            continue
        if not torch.is_tensor(src):
            dst.fill_(src)                   # a host frame id
            continue
        if src.untyped_storage().data_ptr() in held:
            src = src.clone()
        pairs.append((dst, src))
    for dst, src in pairs:
        dst.copy_(src)


class _StaticChunk:
    """make_chunk_fn's chunk: lax.scan of the frame step on a static carry.

    The carry lives in buffers bound on the first call (static_copy) and
    written in place, with `copy_`, by every step. So do the chunk's
    inputs and outputs: a (capacity, 2, H, W) images buffer ((capacity,
    2, B, H, W) for lanes), a (capacity, 36) rows buffer ((capacity, B,
    36)), and 0-dim device tensors for the frame index `i`, the chunk's
    length `n` and the loop's flag `go`. A frame (_scan_step) takes frame
    i's pair into the (H, W) buffers `left` and `right`, runs
    make_frame_body's two halves, each followed by the writes into the
    static carry:

    - tracking: extraction, the configured tracker, the keyframe rule,
      velocity, peak and (a, b); the frame id advanced on the device; the
      packed row as a frame that is no keyframe;
    - the keyframe event, under run_if on the device flag (the JAX
      body's lax.cond(needs, kf_branch, no_branch)): keyframe_event, the
      new anchor (its image copied in, and "hybrid"'s pattern
      intensities), the snapshot, the slot and pose, and the packed row
      again;

    then stores the row at i, advances i and sets go to i < n. The chunk
    (_chunk_program) sets i to 0 and go to 0 < n and runs the frames
    under run_while on go (the JAX chunk's lax.scan).

    On a CUDA device the chunk is captured once, at the first call
    (after a warm-up on a throwaway copy of the carry that runs one
    frame, its keyframe event too), as one graph "chunk" whose frames
    are a WHILE node and whose keyframe event is an IF node inside it,
    and launched once a chunk: no host read between a chunk's first and
    last frame. On the CPU the same program runs eagerly, as the graph's
    plain version (the flags read on the host). Either way every row
    equals make_frame_body's bit for bit. A chunk holds at most
    `capacity` frames; with capacity None the buffers grow to the
    longest chunk yet (on a card the graph is then captured again). The
    carry returned is the static one; the caller may change it or hand
    another, which the next call copies in (load_carry). The rows
    returned are the caller's.

    With a tracer (utils/timing.StreamStages) the chunk also stamps the
    device clock (timing.stamp) into `stamp_buf`, a flat int64 buffer of
    (capacity, len(FRAME_STAMPS)) frame rows, indexed by the device frame
    index as the rows are, and the chunk graph's start and end after
    them: cleared at the chunk's start, each frame's FRAME_STAMPS, and
    the two chunk-level stamps before and after the WHILE node; on a
    card each stamp is a kernel node of the graph. The
    capture is a span ("capture") of the tracer. Without one no stamp is
    made: the graph, its launches and the rows are the untraced ones."""

    def __init__(self, cfg: SlamConfig, cam: StereoCamera,
                 capacity: Optional[int] = None,
                 tracer: Optional[timing.StreamStages] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"chunk capacity {capacity} < 1")
        self.cfg, self.cam = cfg, cam
        self.capacity, self.grows = capacity or 0, capacity is None
        self.track, self.keyframe = self._halves(cfg, cam)
        self.photometric = cfg.tracker.method != "indirect"
        self.static: Optional[ChunkCarry] = None
        self.graphs: Optional[StepGraphs] = None
        self.tracer = tracer
        self.stamp_buf: Optional[torch.Tensor] = None

    @staticmethod
    def _halves(cfg: SlamConfig, cam: StereoCamera):
        return _frame_tracker(cfg, cam)

    def _bind(self, carry: ChunkCarry, images: torch.Tensor) -> None:
        """Static buffers for `carry`, and for chunks shaped as `images`
        ((C, 2, H, W), or (C, B, 2, H, W) for lanes) of at most
        `capacity` frames."""
        self.static = static_copy(carry)
        pair = (2,) + tuple(images.shape[1:-3]) + tuple(images.shape[-2:])
        # frame i's pair: index_select writes the left and right buffers
        self.pair = images.new_empty((1,) + pair, dtype=torch.float32)
        self.left, self.right = self.pair[0, 0], self.pair[0, 1]
        self.row = self.left.new_empty(pair[1:-2] + (PACK_WIDTH,))
        self._chunk_buffers(images.shape[0] if self.grows
                            else self.capacity)
        dev = images.device
        self.fid = torch.empty((), dtype=torch.int32, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.n = torch.zeros((), dtype=torch.int64, device=dev)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)

    def _chunk_buffers(self, capacity: int) -> None:
        """The images and rows buffers for chunks of `capacity` frames; a
        graph captured on the old ones is dropped."""
        self.capacity, self.graphs = capacity, None
        self.images = self.pair.new_empty((capacity,) + self.pair.shape[1:])
        self.rows = self.row.new_empty((capacity,) + self.row.shape)
        if self.tracer is not None:
            self.stamp_buf = torch.zeros(
                capacity * len(FRAME_STAMPS) + 2, dtype=torch.int64,
                device=self.images.device)

    @property
    def _stamp(self):
        """The halves' stamp hook: None untraced, so nothing stamps."""
        return None if self.tracer is None else self._frame_stamp

    def _frame_stamp(self, name: str) -> None:
        """Stamp frame i's slot `name`."""
        timing.stamp(self.stamp_buf, _SLOT[name], self.i, len(FRAME_STAMPS))

    def _flag(self, t: Tracked) -> torch.Tensor:
        """The keyframe event's flag, on the device."""
        return t.needs

    def _track_step(self, S: ChunkCarry) -> Tracked:
        t = self.track(S, self.left, self._stamp)
        self.fid.copy_(S.frame_id)           # the frame a keyframe inserts
        S.frame_id.add_(1)
        S.T_cw.copy_(t.T_new)
        S.velocity.copy_(t.velocity)
        S.inlier_peak.copy_(t.inlier_peak)
        if t.ab is not None:
            S.kf_ab.copy_(t.ab)
        self.row.copy_(_pack(t.T_new, _relative(t.T_new, S.latest_T),
                             S.latest_slot, t.res, t.needs))
        if self._stamp is not None:
            self._stamp("tracked")
        return t

    def _keyframe_step(self, S: ChunkCarry, t: Tracked) -> None:
        if self._stamp is not None:
            self._stamp("kf_start")
        m, slot, lm, latest_T, refvals = self.keyframe(
            S._replace(frame_id=self.fid), t, self.left, self.right,
            self._stamp)
        store_map(S.m, m)
        for dst, src in zip((S.lm_Xw, S.lm_desc, S.lm_ids, S.lm_valid), lm):
            dst.copy_(src)
        S.latest_slot.copy_(slot)
        S.latest_T.copy_(latest_T)
        S.T_cw.copy_(latest_T)
        if self.photometric:                 # a copy: `left` is reused
            S.kf_img.copy_(self.left)
        if refvals is not None:
            S.kf_refvals.copy_(refvals)
        self.row.copy_(_pack(latest_T, _relative(latest_T, latest_T), slot,
                             t.res, t.needs))
        if self._stamp is not None:
            self._stamp("kf_end")

    def _frame_step(self, S: ChunkCarry) -> None:
        """One frame: tracking, then the keyframe event where flagged."""
        t = self._track_step(S)
        run_if(self._flag(t), self._keyframe_step, S, t, name="keyframe")

    def _scan_step(self, S: ChunkCarry) -> None:
        """The WHILE body: frame i of the images buffer, its row stored at
        i, then i advanced and go = i < n, all on the device."""
        if self._stamp is not None:
            self._stamp("start")
        torch.index_select(self.images, 0, self.i, out=self.pair)
        self._frame_step(S)
        self.rows.index_copy_(0, self.i, self.row[None])
        if self._stamp is not None:
            self._stamp("stored")
        self.i.add_(1)
        torch.lt(self.i, self.n, out=self.go)

    def _chunk_program(self, S: ChunkCarry) -> None:
        """The chunk: frames 0 to n - 1 (the JAX chunk's lax.scan); traced,
        the stamps cleared and the chunk-level stamps around the frames."""
        traced = self.stamp_buf is not None
        if traced:
            self.stamp_buf.zero_()
            timing.stamp(self.stamp_buf, self.stamp_buf.numel() - 2)
        self.i.zero_()
        torch.gt(self.n, 0, out=self.go)
        run_while(self.go, self._scan_step, S, name="frame")
        if traced:
            timing.stamp(self.stamp_buf, self.stamp_buf.numel() - 1)

    def _capture(self) -> None:
        g = StepGraphs(self.left.device)
        g.warm_up(self._chunk_program, static_copy(self.static))
        g.capture("chunk", self._chunk_program, self.static)
        self.graphs = g

    def graph_stats(self) -> Optional[dict]:
        """Captures, capture seconds, pool bytes, set-up launches, graph
        launches and the WHILE and IF bodies' runs; None where nothing
        was captured (the CPU)."""
        return None if self.graphs is None else self.graphs.stats()

    @full_float32()
    def __call__(self, carry: ChunkCarry, images: torch.Tensor):
        """images (C, 2, H, W), or (C, B, 2, H, W) for lanes, C at most
        the capacity -> (the static carry, packed (C, 36) or (C, B, 36))."""
        if self.static is None:
            self._bind(carry, images)
        elif carry is not self.static:
            load_carry(self.static, carry)
        C = images.shape[0]
        if C > self.capacity and self.grows:
            self._chunk_buffers(C)
        elif C > self.capacity:
            raise ValueError(f"a chunk of {C} frames; this chunk function "
                             f"holds at most {self.capacity}")
        self.images[:C].copy_(images.movedim(-3, 1))
        self.n.fill_(C)
        if images.is_cuda and self.graphs is None:
            with _NO_SPAN if self.tracer is None else \
                    self.tracer.stage("capture"):
                self._capture()
        if self.graphs is None:
            self._chunk_program(self.static)
        else:
            self.graphs.replay("chunk")
        return self.static, self.rows[:C].clone()


def make_chunk_fn(cfg: SlamConfig, cam: StereoCamera, graphs: bool = True,
                  capacity: Optional[int] = None,
                  tracer: Optional[timing.StreamStages] = None):
    """chunk(carry, images (C, 2, H, W)) -> (carry, packed (C, 36)), the
    JAX make_chunk_fn (a jitted lax.scan of make_frame_body with a donated
    carry). graphs=True: the scan on a static carry (_StaticChunk), one
    CUDA graph launch a chunk on a CUDA device, for chunks of at most
    `capacity` frames (None: as many as the longest chunk yet, captured
    again when a longer one comes); the carry handed
    in is copied into the static buffers unless it is the one the last
    call returned, and that one is overwritten by the next call, as JAX's
    donated carry is. graphs=False: make_frame_body frame by frame,
    eagerly (the JAX engine under jax.disable_jit()), for comparisons,
    any length. tracer: the static chunk's device stamps (_StaticChunk);
    the eager chunk has none."""
    if graphs:
        return _StaticChunk(cfg, cam, capacity, tracer)
    return _eager_chunk(make_frame_body(cfg, cam))


def _eager_chunk(body):
    @full_float32()
    def chunk(carry: ChunkCarry, images: torch.Tensor):
        rows = []
        for i in range(images.shape[0]):
            carry, packed = body(carry, images[i].select(-3, 0),
                                 images[i].select(-3, 1))
            rows.append(packed)
        return carry, torch.stack(rows)

    return chunk


class _StaticBatchedChunk(_StaticChunk):
    """mesh.multi_sequence_chunk's chunk: make_batched_frame_body's halves
    on a static batched carry, scanned as _StaticChunk's. Tracking runs
    over all B lanes (images through static (B, H, W) buffers) with the
    configured tracker and packs every lane's row as a frame that is no
    keyframe; where any of the B flags is set (computed on the device:
    the IF node's flag), the keyframe event runs once over all lanes with
    the flags as its lane mask (the flagged lanes' maps, snapshots,
    slots, poses, anchors and rows). One graph for any B, captured once
    and launched once a chunk. Traced, it stamps the frame-level slots
    (start, extracted, tracked, stored) and the chunk's; the keyframe
    slots stay 0."""

    @staticmethod
    def _halves(cfg: SlamConfig, cam: StereoCamera):
        return _batched_tracker(cfg, cam), _batched_keyframe(cfg, cam)

    def _flag(self, t: Tracked) -> torch.Tensor:
        """Any lane flagged, on the device."""
        return t.needs.any()

    def _track_step(self, S: ChunkCarry) -> Tracked:
        t = self.track(S, self.left, self._stamp)
        self.fid.copy_(S.frame_id)
        S.frame_id.add_(1)
        S.T_cw.copy_(t.T_new)
        S.velocity.copy_(t.velocity)
        S.inlier_peak.copy_(t.inlier_peak)
        if t.ab is not None:
            S.kf_ab.copy_(t.ab)
        self.row.copy_(_pack(t.T_new, se3.per_lane(_relative, t.T_new,
                                                   S.latest_T),
                             S.latest_slot, t.res, t.needs))
        if self._stamp is not None:
            self._stamp("tracked")
        return t

    def _keyframe_step(self, S: ChunkCarry, t: Tracked) -> None:
        lm, slot, latest_T, kf_img, refvals = self.keyframe(
            S._replace(frame_id=self.fid), t, self.left, self.right)
        for dst, src in zip((S.lm_Xw, S.lm_desc, S.lm_ids, S.lm_valid), lm):
            dst.copy_(src)
        S.latest_slot.copy_(slot)
        S.latest_T.copy_(latest_T)
        S.T_cw.copy_(torch.where(t.needs[:, None, None], latest_T,
                                 t.T_new))
        if kf_img is not None:
            S.kf_img.copy_(kf_img)
        if refvals is not None:
            S.kf_refvals.copy_(refvals)
        self.row.copy_(_pack(S.T_cw, se3.per_lane(_relative, S.T_cw,
                                                  latest_T),
                             slot, t.res, t.needs))

    def __call__(self, carry: ChunkCarry, images: torch.Tensor):
        require_anchor(self.cfg, carry)
        return super().__call__(carry, images)


def _worker_main(ref, w: "_MappingWorker") -> None:
    """The mapping thread's loop: run each job on the engine `ref` names
    (a weak reference, so that a dropped engine ends the thread); an
    exception is kept for the next flush, and later jobs still run."""
    while True:
        job = w.jobs.get()
        eng = None if job is None else ref()
        if eng is None:
            return
        try:
            eng._run_job(*job)
        except Exception as e:             # raised by the next flush
            if w.error is None:
                w.error = e
        finally:
            # the job's arguments (a chunk's scores among them) go here,
            # on this thread, after its reads of them have completed
            del eng, job
            with w.cv:
                w.outstanding -= 1
                w.cv.notify_all()


class _MappingWorker:
    """The JAX engine's mapping thread (_loop_worker_main, its job queue
    and _loop_lock), with what the port's static carry asks on top.

    A chunk here runs synchronously on the host and writes the map in
    place (the static carry), so a worker reading the live map while the
    next chunk's graphs write it would race, and a lock around the chunk
    would leave nothing to overlap. Instead:

    - at each chunk boundary the main thread copies the map into one of
      two published buffers (device to device, on the main stream) and
      records an event (publish); a job reads the newest published map
      on the worker's own CUDA stream, after that event (reading). The
      buffer a job holds is never the one written next, and the main
      stream waits for the job's reads before it writes a buffer again;
    - a job changes no map: a closure it decides is handed to the main
      thread (request_close), which runs it on the live carry at the next
      chunk boundary (serve) and publishes the corrected map; the job
      waits for that and reads on from the new copy. Relocalization and
      the keyframe culls stay on the main thread, as do all host
      counters (the JAX single-writer rule); the job owns the detection
      stash, the pending measurements and the consistency groups.

    Every hand-off between the two threads and their streams, and what
    orders it (tests/test_torch_worker_handoff.py holds each on the CPU):

    - the published map: ready[i] (main stream, after the copy) before a
      job reads buffer i; done[i] (worker stream, after its reads) before
      the main stream writes buffer i again; the lock picks a buffer no
      job holds (publish, _acquire, _release);
    - a chunk's scores (`sc`, cloned on the main stream at dispatch): the
      job's stream waits for a ready event recorded after that clone, and
      reads them with .cpu(), which returns once the copy is done; so
      when the job drops them (on this thread, _worker_main), no read is
      queued and the block may go back to the main stream's pool;
    - the BoW database (registered by the main thread at dispatch, by a
      job beyond BOW_ROWS keyframe rows, read by a relocalization): one
      buffer written in place, never replaced, so no tensor of it is
      freed while a stream reads it; bow_lock and bow_event order its
      users (_bow_guard);
    - a relative pose measured by a job (`rel`, `pk`, cloned on the worker
      stream): the job reads `pk` with .cpu(); a closure hands `rel` to
      the main thread, whose stream waits for the worker's (serve) and
      marks `rel` as used by it (record_stream, _apply_close), so its
      blocks outlive the close's reads wherever the job drops them;
    - the host mirrors (frame ids, keyframe counts): written by the main
      thread at each fold; a job reads only the copy taken when it was
      submitted (`seen`, _loop_fold), as the JAX engine's single-writer
      rule asks, and writes none;
    - a closure: decided by a job, run by the main thread while the job
      waits in request_close (or at a flush, the worker idle), after
      serve's wait for the worker's stream; a close captured then (its
      tier's first) is captured in thread_local mode, and the capture's
      synchronise finds the worker's stream drained;
    - the CUDA graphs: every capture (the chunk's, with its WHILE and IF
      bodies' pools and execution counts, and the loop programs') is made
      on the main thread, the chunk's and the loop programs' before the
      first job (_submit refuses one earlier); a job only replays loop
      programs, which have no conditional bodies, so it never reaches
      the bodies' pools, their counts or cuda_lib.settle;
    - the thread's end: when the engine goes, or at the interpreter's
      exit, stop() ends the thread and joins it.
    """

    def __init__(self, eng: "ChunkedSlamEngine"):
        self.device = eng.device
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.jobs: queue.Queue = queue.Queue()
        self.cv = threading.Condition()
        self.outstanding = 0          # jobs submitted and not finished
        self.requests: List[dict] = []  # closures for the main thread
        self.error: Optional[Exception] = None
        self.bow_lock = threading.Lock()
        self.bow_event = None
        self.lock = threading.Lock()  # the published buffers' indices
        self.bufs: List[Optional[MapState]] = [None, None]
        self.ready = [None, None]     # main-stream events: buffer written
        self.done = [None, None]      # worker-stream events: reads queued
        self.newest: Optional[int] = None
        self.held: Optional[int] = None
        self.map: Optional[MapState] = None   # what the running job reads
        self.thread = threading.Thread(
            target=_worker_main, args=(weakref.ref(eng), self), daemon=True,
            name="slam-mapping")
        self.thread.start()
        self.stopped = False
        # when the engine goes, and at the interpreter's exit if it is
        # still alive then (finalize's atexit), before finalization
        weakref.finalize(eng, self.stop)

    def on_thread(self) -> bool:
        return threading.current_thread() is self.thread

    def stop(self) -> None:
        """The engine is gone or the interpreter exits: end the thread and,
        unless this is that thread, wait for it. A thread that ran torch
        work and is still alive when the interpreter finalizes aborts the
        process (std::terminate), so it is joined first: the jobs queued
        are dropped, a closure the running job asks for is refused (the
        job then raises, and nobody reads it), and the running job
        ends."""
        with self.cv:
            self.stopped = True
            reqs = self.requests[:]
            self.requests.clear()
        for req in reqs:
            req["done"].set()              # "ran" stays False
        while True:
            try:
                self.jobs.get_nowait()
            except queue.Empty:
                break
            with self.cv:
                self.outstanding -= 1
        self.jobs.put(None)
        if not self.on_thread():
            self.thread.join()

    def submit(self, kind: str, args: tuple) -> None:
        with self.cv:
            self.outstanding += 1
        self.jobs.put((kind, args))

    def allocate(self, m: MapState) -> List[MapState]:
        """Main thread: both published buffers, made once as copies of `m`
        (the loop graphs that jobs replay are captured on them, so they
        exist and hold a valid map before the first job)."""
        if self.bufs[0] is None:
            self.bufs = [MapState(*(t.clone() for t in m)) for _ in range(2)]
        return list(self.bufs)

    def publish(self, m: MapState) -> None:
        """Main thread: copy the live map into the buffer no job holds."""
        self.allocate(m)
        with self.lock:
            if self.held is not None:
                j = 1 - self.held
            else:
                j = 0 if self.newest is None else 1 - self.newest
            if self.done[j] is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    self.done[j])
            for dst, src in zip(self.bufs[j], m):
                dst.copy_(src)
            if self.cuda:
                self.ready[j] = torch.cuda.Event()
                self.ready[j].record(torch.cuda.current_stream(self.device))
            self.newest = j

    def _acquire(self) -> None:
        with self.lock:
            i = self.held = self.newest
        if self.cuda:
            self.stream.wait_event(self.ready[i])
        self.map = self.bufs[i]

    def _release(self) -> None:
        with self.lock:
            if self.cuda:
                self.done[self.held] = torch.cuda.Event()
                self.done[self.held].record(self.stream)
            self.held, self.map = None, None

    def reacquire(self) -> None:
        """Read on from the newest published map (after a closure)."""
        self._release()
        self._acquire()

    @contextlib.contextmanager
    def reading(self):
        """Worker thread: a job's block, on the worker's stream, reading
        the newest published map (self.map)."""
        self._acquire()
        try:
            if self.cuda:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self.stream):
                    yield
            else:
                yield
        finally:
            self._release()

    def request_close(self, fn) -> None:
        """Worker thread: have the main thread run fn at its next chunk
        boundary, and wait until it has."""
        req = {"fn": fn, "done": threading.Event(), "ran": False}
        with self.cv:
            if self.stopped:
                raise RuntimeError("the mapping worker is stopping")
            self.requests.append(req)
            self.cv.notify_all()
        req["done"].wait()
        if not req["ran"]:
            raise RuntimeError("a closure decided on the mapping worker "
                               "failed or was refused on the main thread")

    def serve(self) -> None:
        """Main thread, at a chunk boundary: run the closures the worker
        handed over, after everything the worker's stream has queued."""
        with self.cv:
            reqs = self.requests[:]
            self.requests.clear()
        if reqs and self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        for req in reqs:
            try:
                req["fn"]()
                req["ran"] = True
            finally:
                req["done"].set()

    def drain(self) -> None:
        """Main thread: serve closures until every job has finished, order
        the main stream after the worker's, and raise the first exception
        a job raised since the last drain."""
        while True:
            with self.cv:
                while not self.requests and self.outstanding:
                    self.cv.wait()
                idle = not self.requests and not self.outstanding
            if idle:
                break
            self.serve()
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def _rows(rows: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(rows, axis=0) if rows else \
        np.zeros((0, PACK_WIDTH), np.float32)


def _knob(value, env: str, default: str) -> str:
    return os.environ.get(env, default) if value is None else str(int(value))


class ChunkedSlamEngine:
    """Host loop over chunks of stereo frames on one device.

    The JAX package's ChunkedSlamEngine interface: process_chunk(images
    (C, 2, H, W)), flush(), run(frames), warmup(), trajectory_refined(),
    map, loop_events, frame_stats, n_replays. `cam` (a StereoCamera
    already on `device`) defaults to the one cfg.camera describes;
    `vocab` (a loop.vocab.Vocabulary) turns on loop closing and
    relocalization. Chunks run through make_chunk_fn: with graphs=True
    (the default) the scan on a static carry, one CUDA graph launch a
    chunk on a CUDA device (captured at the first chunk and never
    again), and the loop programs on static buffers
    (pipeline/engine._LoopPrograms), replayed as CUDA graphs captured
    right after the first chunk, before any mapping job: for the static
    carry's map and, with the mapping worker, its two published copies.
    Every change the host makes to the carry (a cull, a closure, a
    relocalization) is copied into the static carry, so those maps keep
    their addresses. A chunk then has at most chunk_size frames (the
    bootstrap frame aside; more raise ValueError). graphs=False runs make_frame_body and the
    loop programs eagerly (the same rows, events and map bit for bit),
    for comparisons.

    The schedule, under the JAX package's two knobs (None reads the
    environment variable of the same name):

    - queue_depth (SLAM_QUEUE_DEPTH): chunks run but not yet folded.
      process_chunk returns the rows of the chunks it folds, none while
      the queue fills; flush() folds the rest and returns their rows.
      The host mirrors (frame ids, keyframe counts, the loop phases) lag
      the device by the chunks in flight, as the JAX engine's do.
    - loop_thread (SLAM_LOOP_THREAD, "1" on): with a vocabulary, the
      loop phases of each fold run on a mapping thread (_MappingWorker)
      on a CUDA stream of its own, beside the next chunk's graph
      replays; a closure it decides lands on the main thread at the next
      chunk boundary. The JAX engine's worker closes inside its job, so
      its correction reaches the next chunk dispatched; here the job runs
      while that chunk is replayed, so a closure can reach the chunk
      after it: up to chunk_size frames more than JAX's one fold of lag.
      Which fold a closure lands in depends on timing, as under the JAX
      engine's thread. Start and stop torch.profiler's CUDA activity
      with the worker idle (_worker.drain(), or after flush()): its
      stop, racing a CUDA-graph launch on the worker's thread,
      deadlocked the process on an H100 (torch 2.11, CUDA 12.8).

    The defaults differ from the JAX engine's (2 and "1"): 0 and "0", the
    JAX engine's deterministic schedule, in which each chunk is folded
    as soon as it ran and the loop phases run inline.

    trace=True keeps the engine's spans and the chunk graph's device
    stamps in `tracer` (a utils.timing.StreamStages, on one clock; None
    untraced, and then a span costs one None check and no stamp is
    captured). Each process_chunk is a span "chunk" whose children are
    "upload", "bootstrap" (the first call), "headroom" (a "cull" each
    keyframe cull, its readbacks inside), "dispatch" ("launch" inside:
    load_carry, the images' copy, the replay's enqueue, and at the first
    chunk "capture", the warm-up and capture) and "fold"
    ("readback_wait", "rows", and with a vocabulary the loop's stages,
    SlamEngine.stages, on the same tracer; a mapping worker's job is a
    span "job p1" or "job p2" caused by its fold). A chunk's stamps
    (FRAME_STAMPS, and its graph's start and end) come back with its
    rows, beside them in pinned memory under the same event, and are
    kept at its fold (StreamStages.add_stamps) under its "dispatch"
    span. The clock's offset is measured again at each flush.
    """

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 cam: Optional[StereoCamera] = None, vocab=None,
                 chunk_size: int = 8, device="cuda", graphs: bool = True,
                 queue_depth: Optional[int] = None,
                 loop_thread: Optional[bool] = None, trace: bool = False):
        self.cfg = cfg or SlamConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.cam = cam if cam is not None else \
            StereoCamera.from_config(self.cfg.camera, self.device)
        self.vocab = vocab
        self.chunk_size = chunk_size
        self.queue_depth = int(_knob(queue_depth, "SLAM_QUEUE_DEPTH", "0"))
        if self.queue_depth < 0:
            raise ValueError(f"queue_depth {self.queue_depth} < 0")
        self.loop_thread = vocab is not None and \
            _knob(loop_thread, "SLAM_LOOP_THREAD", "0") == "1"
        self.tracer = timing.StreamStages(self.device) if trace else None
        self._chunk = make_chunk_fn(self.cfg, self.cam, graphs,
                                    capacity=chunk_size, tracer=self.tracer)
        self.carry: Optional[ChunkCarry] = None
        self.n_keyframes = 0          # keyframes inserted, culled ones too
        self.n_culls = 0
        self._n_kf_valid = 0          # keyframes in the ring
        self.trajectory: List[np.ndarray] = []
        self._traj_anchor: List[tuple] = []
        self.frame_stats: List[dict] = []
        self.n_replays = 0            # closures that re-seeded the head
        # frames dispatched before each closure landed (the first frame
        # that tracked against the corrected map)
        self.closures_landed: List[int] = []
        self._n_dispatched = 0
        # chunks run and not folded, oldest first: packed rows and scores
        # on the device, the chunk's last image for a relocalization
        self._pending: List[dict] = []
        # rows folded inside a call that returns none (a flush before a
        # cull, a relocalization's drain), owed to the next return
        self._owed_rows: List[np.ndarray] = []
        # the loop machinery (None without a vocabulary)
        self._host: Optional[SlamEngine] = None
        self._worker: Optional[_MappingWorker] = None
        if vocab is not None:
            self._host = SlamEngine(self.cfg, self.cam, vocab, self.device,
                                    own_map=False, graphs=graphs)
            self._host.stages = self.tracer
        # the host engine whose keyframe programs cull the carry's map (the
        # loop host, or one of its own without a vocabulary)
        self._mapper = self._host if vocab is not None else SlamEngine(
            self.cfg, self.cam, None, self.device, own_map=False,
            graphs=graphs)
        if vocab is not None:
            self._host._loop.rows_capacity = max(chunk_size, BOW_ROWS)
            self._loop_stash: List[dict] = []     # detections awaiting age 2
            self._closure_pend: List[dict] = []   # measurements awaiting age 1
            # keyframe frame ids by slot, from the folded rows
            self._kf_fid_host = np.full((self.cfg.map.max_keyframes,), -1,
                                        np.int64)
            self._lost_streak = 0
            self._reloc_block_fid = -1
            if self.loop_thread:
                self._worker = _MappingWorker(self)

    @property
    def loop_events(self) -> List[dict]:
        """Closure events (frame, kf_slot, cand, inliers, fid_cand, n_near,
        scale, T_meas, T_cand_pre) and relocalizations (frame, reloc_to,
        inliers), as the JAX engine logs them."""
        return [] if self._host is None else self._host.loop_events

    def _span(self, name: str, cause: Optional[int] = None):
        """A span of the tracer around a block (a shared null context
        untraced)."""
        return _NO_SPAN if self.tracer is None else \
            self.tracer.stage(name, cause=cause)

    def warmup(self) -> None:
        """Nothing to compile ahead: the kernels build at first use, and
        the CUDA graphs (the chunk's, then the loop programs') are
        captured in the first chunk (they need its carry and images)."""

    # ---- bootstrap: the JAX host engine's first-frame keyframe --------
    def _bootstrap(self, left: torch.Tensor, right: torch.Tensor,
                   t0: float) -> None:
        """First frame: identity pose, stereo, keyframe insert with no
        tracked landmarks (quality = 2 * min_matches), weak-mappoint
        cull and landmark snapshot, no BA; the photometric anchor is this
        image with (a, b) = (0, 0) (JAX engine.process :507-515 and
        _make_keyframe :586-645)."""
        cfg, dev = self.cfg, self.device
        frame = add_stereo(build_frame(left, self.cam, cfg), left, right,
                           self.cam, cfg)
        m = empty_map(cfg, dev)
        L = cfg.map.track_landmarks
        zi = torch.zeros((L,), dtype=torch.int32, device=dev)
        snap = _snapshot(m, cfg)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        m, slot = insert_keyframe(
            m, frame, eye, 0, zi, zi, torch.zeros((L,), dtype=torch.bool,
                                                  device=dev), cfg,
            lm_snapshot=(snap[0], snap[3]),
            quality=float(2 * cfg.tracker.min_matches))
        m = cull_weak_mappoints(m, 0, cfg.map.mp_cull_grace_frames,
                                cfg.map.mp_cull_min_obs)
        photometric = cfg.tracker.method != "indirect"
        self.carry = self._with_snapshot(ChunkCarry(
            m=m, T_cw=eye, velocity=eye.clone(), lm_Xw=snap[0],
            lm_desc=snap[1], lm_ids=snap[2], lm_valid=snap[3],
            latest_slot=slot, latest_T=m.kf_T_cw[slot], frame_id=1,
            inlier_peak=torch.zeros((), dtype=torch.float32, device=dev),
            kf_img=left if photometric else None,
            kf_ab=torch.zeros((2,), dtype=torch.float32, device=dev)
            if photometric else None), slot)
        self.n_keyframes = self._n_kf_valid = 1
        if self._host is not None:
            # the first keyframe's BoW row (JAX engine._loop_step)
            h = self._host
            h.bow_db = vocab_db_set(h.bow_db, slot,
                                    h._bow(frame.feats.desc,
                                           frame.feats.valid))
            self._kf_fid_host[int(slot)] = 0
        self.trajectory.append(np.eye(4, dtype=np.float32))
        self._traj_anchor.append((int(slot), np.eye(4, dtype=np.float32)))
        self.frame_stats.append({"frame": 0, "inliers": 0, "kf": True,
                                 "elapsed_ms": round(
                                     1000.0 * (time.perf_counter() - t0), 2)})

    def _with_snapshot(self, carry: ChunkCarry, slot) -> ChunkCarry:
        """The carry as the JAX engine rebuilds it after the host changed
        the map (bootstrap, cull): the landmark snapshot of carry.m, the
        keyframe `slot` as the latest, inlier_peak reset to 0 and, for
        "hybrid", the anchor's pattern intensities for that snapshot."""
        m = carry.m
        lm = _snapshot(m, self.cfg)
        latest_T = m.kf_T_cw[slot]
        refvals = None
        if self.cfg.tracker.method == "hybrid":
            refvals = direct_lm.reference_values(
                DirectState(T_cw=latest_T, a=carry.kf_ab[0],
                            b=carry.kf_ab[1]),
                carry.kf_img, self.cam.left, lm[0], lm[3], 1.0)
        return carry._replace(
            lm_Xw=lm[0], lm_desc=lm[1], lm_ids=lm[2], lm_valid=lm[3],
            latest_slot=slot, latest_T=latest_T,
            inlier_peak=torch.zeros_like(carry.inlier_peak),
            kf_refvals=refvals)

    def _ensure_headroom(self, n_next: int) -> None:
        """Cull keyframes until the ring has room for n_next more (every
        frame of the next chunk may become one) plus 2: the most redundant
        unprotected keyframe at a 0.8 bar, else the most redundant one
        at any score (forced eviction; the newest window_keyframes are
        never culled). Every frame in flight counts as a keyframe in the
        estimate; a cull first flushes (its rows are owed to the caller).
        Trajectory rows anchored on a culled slot move to the latest
        keyframe. JAX scan_engine._ensure_headroom with its host engine's
        _cull, _cull_any and _refresh_kf_mirrors: the culls are the host's
        cull programs on the carry's map (graphed with the static step),
        each decided on the device and its slot read back here."""
        cap = self.cfg.map.max_keyframes
        in_flight = sum(p["n"] for p in self._pending)
        if self._n_kf_valid + in_flight < cap - n_next - 2:
            return
        rows = self.flush()           # the JAX engine drains before a cull
        if len(rows):
            self._owed_rows.append(rows)
        m = self.carry.m
        latest = None
        while self._n_kf_valid >= cap - n_next - 2:
            with self._span("cull"):
                kf_T_pre = m.kf_T_cw.cpu().numpy().copy()
                s = self._mapper._cull_slot(m, "cull")
                if s < 0:
                    s = self._mapper._cull_slot(m, "cull_any")
                if s < 0:
                    raise RuntimeError(
                        f"keyframe capacity {cap} exhausted (all protected)")
                self.n_culls += 1
                fid = torch.where(m.kf_valid, m.kf_frame_id,
                                  torch.full_like(m.kf_frame_id, -1))
                latest = torch.argmax(fid)
                slot_np, self._n_kf_valid = (int(v) for v in torch.stack(
                    [latest, torch.sum(m.kf_valid)]).cpu())
            T_new_inv = np.linalg.inv(kf_T_pre[slot_np])
            for i, (sl, rel) in enumerate(self._traj_anchor):
                if sl == s:
                    self._traj_anchor[i] = (
                        slot_np, (rel @ kf_T_pre[s]) @ T_new_inv)
        if latest is not None:        # the frames in flight made no room
            self.carry = self._with_snapshot(self.carry._replace(m=m),
                                             latest)
            self._settle()

    def _fold_down_to(self, depth: int) -> List[np.ndarray]:
        """Fold the oldest chunks until `depth` are in flight; their rows
        in frame order, a relocalization's drained chunks included."""
        rows = []
        while len(self._pending) > depth:
            rows.append(self._fold_one())
            rows += self._owed_rows
            self._owed_rows = []
        return rows

    @full_float32()
    def process_chunk(self, images) -> np.ndarray:
        """images: (C, 2, H, W) stereo pairs (numpy or tensor, any real
        dtype). Runs the chunk, then folds every chunk beyond queue_depth
        and returns their packed rows, (n, 36) [T(16), T_rel(16), slot,
        ok, kf, n_inliers] in frame order (none while the queue fills;
        flush() returns the rest; the bootstrap frame has no row). The
        engine's work runs in full float32; the caller's TF32 flags are
        restored on return. Traced, a span "chunk" (see the class)."""
        with self._span("chunk"):
            return self._process_chunk(images)

    def _process_chunk(self, images) -> np.ndarray:
        t0 = time.perf_counter()
        # host frames go up through pinned memory, without waiting
        with self._span("upload"):
            imgs = images.to(self.device, torch.float32) if \
                torch.is_tensor(images) and \
                images.device.type == self.device.type else \
                upload(np.asarray(images, np.float32), self.device)
        if self.carry is None:
            with self._span("bootstrap"):
                self._bootstrap(imgs[0, 0], imgs[0, 1], t0)
            self._n_dispatched = 1
            imgs = imgs[1:]
        if len(imgs) == 0:
            return np.zeros((0, PACK_WIDTH), np.float32)
        if self._worker is not None:
            self._worker.serve()      # closures the worker decided land here
        with self._span("headroom"):
            self._ensure_headroom(len(imgs))
        with self._span("dispatch"):
            self._dispatch(imgs, t0)
        owed, self._owed_rows = self._owed_rows, []
        return _rows(owed + self._fold_down_to(self.queue_depth))

    def _dispatch(self, imgs: torch.Tensor, t0: float) -> None:
        """Run one chunk; register and score its keyframes' BoW rows on
        the device right after it (JAX _loop_dispatch), publish the map
        for the mapping worker, and queue the chunk for its fold."""
        with self._span("launch"):
            self.carry, packed = self._chunk(self.carry, imgs)
        self._n_dispatched += len(imgs)
        sc = None
        if self._host is not None:
            h = self._host
            self._prepare_loop_graphs()
            with self._bow_guard():
                # the database is written in place (no assignment back)
                _, sc = h._bow_register(self.carry.m, h.bow_db, packed)
        if self._worker is not None:
            self._worker.publish(self.carry.m)
        # a traced static chunk's stamps, read back beside the rows
        stamps = getattr(self._chunk, "stamp_buf", None)
        ready = None
        if packed.is_cuda:
            # the rows to pinned memory without a wait, and an event the
            # fold waits for: a later chunk queued meanwhile stays in flight
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            if stamps is not None:
                st = torch.empty(stamps.shape, dtype=stamps.dtype,
                                 pin_memory=True)
                stamps = st.copy_(stamps, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            packed = host
        elif stamps is not None:
            stamps = stamps.clone()
        self._pending.append({"packed": packed, "ready": ready, "t0": t0,
                              "n": len(imgs), "sc": sc,
                              # the caller's image: the chunk's static
                              # images buffer is the next chunk's
                              "last_img": imgs[-1], "stamps": stamps,
                              "span": None if self.tracer is None
                              else self.tracer.current()})

    def _prepare_loop_graphs(self) -> None:
        """Once, on the main thread, before any mapping job: the loop
        programs for the static carry's map (all of them), the published
        copies (those a job runs) and the keyframe programs the main thread
        runs on the static carry's map between chunks (the culls and the
        closure's snapshot), captured as CUDA graphs on a card; then no
        capture is allowed (_LoopPrograms.frozen) but a close's, at its
        tier's first closure. No job runs a keyframe program, so none is
        captured for the published copies."""
        h = self._host
        if not h.graphs or h._loop.frozen or \
                not isinstance(self._chunk, _StaticChunk):
            return
        h._kf.prepare([self.carry.m], ("cull", "cull_any", "snapshot"))
        h._loop.prepare([self.carry.m])
        if self._worker is not None:
            h._loop.prepare(self._worker.allocate(self.carry.m),
                            ("register", "covis", "relpose"))
        h._loop.frozen = h._kf.frozen = True

    def _settle(self) -> None:
        """Hold the static carry: a carry the host rebuilt is copied into
        its buffers (load_carry), so the map keeps the addresses the loop
        graphs read. Nothing to do before the first chunk or without the
        static step."""
        ch = self._chunk
        if isinstance(ch, _StaticChunk) and ch.static is not None and \
                self.carry is not ch.static:
            load_carry(ch.static, self.carry)
            self.carry = ch.static

    def _fold_one(self) -> np.ndarray:
        """Fold the oldest chunk in flight: its one readback of packed
        rows (on a card a wait for their copy to pinned memory alone, not
        for the chunks queued after it), the host rows and mirrors, and
        with a vocabulary the loop work of the fold (JAX _fold_one);
        traced, the chunk's stamps kept by the tracer."""
        with self._span("fold"):
            p = self._pending.pop(0)
            with self._span("readback_wait"):
                if p["ready"] is not None:
                    p["ready"].synchronize()             # one readback
            packed_np = p["packed"].numpy()
            if p["stamps"] is not None:
                st = p["stamps"].numpy()
                k = len(FRAME_STAMPS)
                self.tracer.add_stamps(p["span"], FRAME_STAMPS, st[-2:],
                                       st[:p["n"] * k].reshape(p["n"], k))
            with self._span("rows"):
                self._fold(packed_np, p["t0"])
            if self._host is not None:
                self._loop_fold(packed_np, p)
            return packed_np

    def _fold(self, packed_np: np.ndarray, t0: float) -> None:
        base = len(self.trajectory)
        dt_ms = 1000.0 * (time.perf_counter() - t0) / len(packed_np)
        n_kf = int(np.sum(packed_np[:, 34] > 0.5))
        self.n_keyframes += n_kf
        self._n_kf_valid += n_kf
        for i, row in enumerate(packed_np):
            self.trajectory.append(row[:16].reshape(4, 4))
            self._traj_anchor.append((int(row[32]), row[16:32].reshape(4, 4)))
            self.frame_stats.append({"frame": base + i,
                                     "inliers": int(row[35]),
                                     "kf": bool(row[34] > 0.5),
                                     "ok": bool(row[33] > 0.5),
                                     "elapsed_ms": round(dt_ms, 2)})

    @full_float32()
    def flush(self) -> np.ndarray:
        """Fold every chunk in flight and return their rows (and any owed).
        With a vocabulary, wait for the mapping worker (raising the first
        exception a job raised), then consume the stashed detections and
        close the measurements they start (the JAX engine's flush).
        Traced, the device clock's offset is measured again."""
        owed, self._owed_rows = self._owed_rows, []
        rows = _rows(owed + self._fold_down_to(0))
        if self._host is not None and self.carry is not None:
            if self._worker is not None:
                self._worker.drain()
            self._host.map = self.carry.m
            seen = self._mirrors()
            if self._loop_stash:
                self._loop_phase2(True, seen)
            self._finish_pending_closures(False, seen)
        if self.tracer is not None:
            self.tracer.sync_clock()
        return rows

    # ---- loop closing and relocalization between chunks ---------------
    @contextlib.contextmanager
    def _bow_guard(self):
        """A read or write of the BoW database (one buffer that the register
        programs write in place and nothing replaces, so no tensor of it
        is freed while a stream reads it): with the mapping worker, under
        its lock, the current stream ordered after the last one that used
        the database (bow_event), and this use recorded for the next."""
        w = self._worker
        if w is None:
            yield
            return
        with w.bow_lock:
            cur = None
            if w.cuda:
                cur = torch.cuda.current_stream(self.device)
                if w.bow_event is not None:
                    cur.wait_event(w.bow_event)
            yield
            if w.cuda:
                w.bow_event = torch.cuda.Event()
                w.bow_event.record(cur)

    def _read_map(self) -> MapState:
        """The map the loop phases read: on the mapping worker the
        published copy its job holds, else the live one."""
        w = self._worker
        return w.map if w is not None and w.on_thread() else self.carry.m

    def _run_job(self, kind: str, args: tuple) -> None:
        """A mapping-worker job (JAX _loop_worker_main): phase 2 of a fold,
        or phase 1 of a folded chunk, on the worker's stream; traced, a
        span caused by the fold that submitted it (its `seen`, the last
        argument)."""
        with full_float32(), self._worker.reading(), \
                self._span("job " + kind, cause=args[-1]["cause"]):
            if kind == "p1":
                self._loop_phase1(*args)
            else:
                self._loop_phase2(*args)

    def _rebuild_carry(self, **changes) -> None:
        """The carry as the JAX engine rebuilds it after the host moved
        the head or the map (relocalization, closure): inlier_peak reset,
        and for "hybrid" the anchor's pattern intensities recomputed."""
        c = self.carry._replace(
            inlier_peak=torch.zeros_like(self.carry.inlier_peak), **changes)
        if self.cfg.tracker.method == "hybrid":
            c = c._replace(kf_refvals=direct_lm.reference_values(
                DirectState(T_cw=c.latest_T, a=c.kf_ab[0], b=c.kf_ab[1]),
                c.kf_img, self.cam.left, c.lm_Xw, c.lm_valid, 1.0))
        self.carry = c
        self._settle()

    def _loop_fold(self, packed_np: np.ndarray, p: dict) -> None:
        """The fold's loop work (JAX _fold_one with a vocabulary): host
        mirrors, relocalization on a lost streak, then phase 2 (the
        detections two folds old) and phase 1 (this chunk's), inline or
        as jobs for the mapping worker."""
        h = self._host
        h.map = self.carry.m
        h.frame_id = len(self.trajectory)
        h.n_keyframes = self.n_keyframes
        h._n_kf_valid_host = self._n_kf_valid
        h._latest_slot_host = int(packed_np[-1, 32])
        # this chunk's first frame, taken before a relocalization below
        # folds the chunks behind it and advances the mirrors
        base_fid = h.frame_id - len(packed_np)
        for i in np.flatnonzero(packed_np[:, 34] > 0.5):
            self._kf_fid_host[int(packed_np[i, 32])] = base_fid + i
        # any run of reloc_lost_streak lost rows fires, even if later
        # rows recovered (a re-lock onto a garbage-pose keyframe)
        streak, fire = self._lost_streak, False
        for okf in packed_np[:, 33] > 0.5:
            streak = 0 if okf else streak + 1
            fire = fire or streak >= self.cfg.loop.reloc_lost_streak
        self._lost_streak = streak
        if fire and h.frame_id >= self._reloc_block_fid \
                and h.n_keyframes >= 2:
            # the newest image run: the recovered pose re-seeds the head,
            # which is the chunks in flight ahead of this fold
            head = self._pending[-1] if self._pending else p
            self._try_chunked_reloc(head["last_img"])
        seen = self._mirrors()
        if self._worker is not None:
            self._submit("p2", (False, seen))
            self._submit("p1", (p["sc"], packed_np, base_fid, seen))
        else:
            self._loop_phase2(False, seen)
            self._loop_phase1(p["sc"], packed_np, base_fid, seen)

    def _mirrors(self) -> dict:
        """The host mirrors the loop phases read (keyframe count, keyframe
        frame ids), copied as of this fold: the main thread writes them at
        every fold, and a job of the mapping worker reads only the copy
        taken when it was submitted (the JAX engine's single-writer
        rule); traced, the span that took them ("cause")."""
        return {"n_keyframes": self._host.n_keyframes,
                "kf_fid": self._kf_fid_host.copy(),
                "cause": None if self.tracer is None
                else self.tracer.current()}

    def _submit(self, kind: str, args: tuple) -> None:
        """Queue a job for the mapping worker. The CUDA graphs (the
        chunk's and the loop programs') are captured in the first chunk,
        before any job: a capture (global mode) fails if another thread
        touches the card meanwhile."""
        if self.device.type == "cuda" and isinstance(
                self._chunk, _StaticChunk) and (
                    self._chunk.graphs is None or
                    (self._host.graphs and not self._host._loop.frozen)):
            raise RuntimeError("a mapping job before the chunk's and the "
                               "loop programs' CUDA graphs were captured")
        self._worker.submit(kind, args)

    def _try_chunked_reloc(self, last_img) -> None:
        """BoW relocalization of `last_img` (the newest image run); on
        success the next chunk starts from the recovered pose at zero
        velocity, re-attempts wait until a chunk has run from it, and the
        chunks in flight (tracked from the lost pose) are folded now,
        their rows owed to the caller."""
        h = self._host
        frame = h._build(last_img[0])
        with self._bow_guard():
            reloc_T = h._try_relocalize(frame)
        if reloc_T is None:
            return
        self._rebuild_carry(T_cw=reloc_T, velocity=torch.eye(
            4, dtype=torch.float32, device=self.device))
        self._lost_streak = 0
        self._reloc_block_fid = h.frame_id + sum(
            q["n"] for q in self._pending) + self.chunk_size
        while self._pending:
            self._owed_rows.append(self._fold_one())

    def _loop_phase1(self, sc, packed_np: np.ndarray, base_fid: int,
                     seen: dict) -> None:
        """Read this chunk's scores, register and score its keyframe rows
        beyond BOW_ROWS, take the candidates' covisibility rows, measure
        each keyframe's top candidate speculatively when a consistency
        group is one step from acceptance, and stash the detection.
        `seen`: the fold's copy of the host mirrors (_mirrors)."""
        h = self._host
        n_kf = seen["n_keyframes"]
        kf_rows = np.flatnonzero(packed_np[:, 34] > 0.5)
        if len(kf_rows) == 0:
            return
        m = self._read_map()
        n_cap = min(len(kf_rows), BOW_ROWS)
        with h._stage("scores readback"):
            cand_np = sc.candidates[:n_cap].cpu().numpy()
            scores_np = sc.scores[:n_cap].cpu().numpy()
        if len(kf_rows) > BOW_ROWS:
            extra = packed_np[kf_rows[BOW_ROWS:], 32].astype(np.int64)
            ex_c, ex_s = [cand_np], [scores_np]
            for j in range(0, len(extra), BOW_ROWS):
                batch = extra[j:j + BOW_ROWS]
                pad = np.zeros(BOW_ROWS, np.int64)
                pad[:len(batch)] = batch
                vmask = np.arange(BOW_ROWS) < len(batch)
                with self._bow_guard():     # the database in place
                    _, sc2 = h._bow_register_only(m, h.bow_db, pad, vmask)
                with h._stage("scores readback"):
                    ex_c.append(sc2.candidates[:len(batch)].cpu().numpy())
                    ex_s.append(sc2.scores[:len(batch)].cpu().numpy())
            cand_np = np.concatenate(ex_c, axis=0)
            scores_np = np.concatenate(ex_s, axis=0)
        slots = packed_np[kf_rows, 32].astype(np.int64)
        covis_rows, cand_all, spec = None, None, {}
        if n_kf >= 3:
            cand_all = np.unique(np.concatenate(
                [np.flatnonzero(cand_np[i]) for i in range(len(kf_rows))]))
            if len(cand_all):
                covis_rows = h._covis(m, cand_all).cpu().numpy()
            hot = any(n >= h.consistency.threshold - 1
                      for _, n in h.consistency.groups)
            for i, s in enumerate(slots) if hot else ():
                mask = cand_np[i]
                if not mask.any():
                    continue
                top = int(np.argmax(np.where(mask, scores_np[i], -1.0)))
                spec[int(s)] = (top, self._measure(m, int(s), top))
        self._loop_stash.append({
            "kf_rows": kf_rows, "slots": slots, "cand_np": cand_np,
            "scores_np": scores_np, "covis_rows": covis_rows,
            "cand_all": cand_all, "spec": spec, "base_fid": base_fid,
            "age": 0})

    def _measure(self, m: MapState, cur: int, cand: int):
        """The closer's relative pose of keyframe cur against cand on `m`
        (the top-2 kernel), and an event that its packed row is done, on
        the stream it ran on (None on the CPU, where it always is)."""
        rel, pk = self._host._relpose(m, cur, cand)
        ev = None
        if pk.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        return rel, pk, ev

    def _loop_phase2(self, force: bool, seen: dict) -> None:
        """Close the measurements pending from the last fold, age the
        stash, and consume the detections two folds old (all of them
        with force): detection and consistency per keyframe, then the
        accepted candidates' relative poses (the speculative one first
        when it is the top candidate, else up to three measured now),
        pending one fold; a speculative hit closes in this fold. `seen`:
        the fold's copy of the host mirrors (_mirrors)."""
        h = self._host
        n_kf = seen["n_keyframes"]
        self._finish_pending_closures(False, seen)
        for st in self._loop_stash:
            st["age"] += 1
        while self._loop_stash and (force or self._loop_stash[0]["age"] >= 2):
            st = self._loop_stash.pop(0)
            m = self._read_map()
            covis_of = None
            if st["covis_rows"] is not None:
                covis_of = {int(s): st["covis_rows"][i]
                            for i, s in enumerate(st["cand_all"])}
            for i, (r, s) in enumerate(zip(st["kf_rows"], st["slots"])):
                fid = st["base_fid"] + int(r)
                cands = h._detect_accept(int(s), st["cand_np"][i],
                                         st["scores_np"][i], covis_of, fid,
                                         n_kf, m)
                if not cands:
                    continue
                spec = st["spec"].get(int(s))
                hit = spec is not None and spec[0] == cands[0]
                rels = [spec] if hit else []
                for cand in cands[1 if hit else 0:4]:
                    rels.append((int(cand), self._measure(m, int(s),
                                                          int(cand))))
                self._closure_pend.append({"slot": int(s), "fid": fid,
                                           "rels": rels, "ready": hit})
        self._finish_pending_closures(True, seen)

    def _finish_pending_closures(self, ready_only: bool,
                                 seen: dict) -> None:
        """Close the pending measurements (with ready_only, only those a
        fold old whose results have landed, or 4 folds old; speculative
        hits are born a fold old): past the cooldown, the first candidate
        that measured ok and is no duplicate closes (_land_closure); the
        stashed covisibility rows are then re-read on the corrected map.
        Under the mapping worker a result "has landed" when the event
        recorded after its packed row has completed (the JAX engine's
        is_ready). Inline the ages alone decide, as on the CPU (where
        every result has landed): the fold reads a result back once it
        is a fold old, whatever the device's progress, so that the
        inline schedule depends on no timing (a replayed graph returns
        before its work is done, an eager program after most of it).
        `seen`: the fold's copy of the host mirrors (_mirrors)."""
        h = self._host
        n_kf, kf_fid = seen["n_keyframes"], seen["kf_fid"]
        remaining = []
        while self._closure_pend:
            pc = self._closure_pend.pop(0)
            if ready_only:
                age = pc.get("age", 1 if pc["ready"] else 0)
                pc["age"] = age + 1
                landed = age >= 4 or (age >= 1 and (
                    self._worker is None or all(
                        ev is None or ev.query()
                        for _, (_, _, ev) in pc["rels"])))
                if not landed:
                    remaining.append(pc)
                    continue
            if n_kf - h._last_closure_nkf \
                    < self.cfg.loop.closure_cooldown_kfs:
                continue
            for cand, (rel, pk, _) in pc["rels"]:
                with h._stage("relpose readback"):
                    vals = pk.cpu().numpy()
                if not vals[17] > 0.5:
                    continue
                fid_cand = int(kf_fid[cand])
                if h._closure_is_dup(pc["fid"], fid_cand, int(vals[16])):
                    continue
                self._land_closure(pc["slot"], cand, rel, pc["fid"],
                                   fid_cand, vals, n_kf)
                m = self._read_map()
                for later in self._loop_stash:
                    ca = later["cand_all"]
                    later["covis_rows"] = None if ca is None or not len(ca) \
                        else h._covis(m, ca).cpu().numpy()
                break
        self._closure_pend = remaining

    def _land_closure(self, slot: int, cand: int, rel, fid: int,
                      fid_cand: int, vals: np.ndarray, n_kf: int) -> None:
        """Close on the live carry: here on the main thread, or from the
        mapping worker through the main thread at its next chunk
        boundary (the job then reads on from the corrected map). n_kf:
        the keyframe count the deciding fold saw, which starts the
        cooldown."""
        w = self._worker
        if w is None or not w.on_thread():
            self._apply_close(slot, cand, rel, fid, fid_cand, vals, n_kf)
            return
        w.request_close(lambda: self._apply_close(slot, cand, rel, fid,
                                                  fid_cand, vals, n_kf))
        w.reacquire()

    def _apply_close(self, slot: int, cand: int, rel, fid: int,
                     fid_cand: int, vals: np.ndarray, n_kf: int) -> None:
        """Main thread, between chunks: the close (pose graph, merge, seam
        BA) on the live map, the landmark snapshot rebuilt from it and the
        head re-seeded through the latest keyframe. The pose-graph tier
        covers the live keyframes, those of chunks in flight included
        (one readback at this rare event; the JAX engine pads the folded
        count by the queue instead, its _tier_margin). The snapshot's
        latest slot goes to the carry on the device, so no host mirror of
        it is consumed later (JAX's _pending_counts handshake)."""
        h = self._host
        w = self._worker
        if w is not None and w.cuda:
            main = torch.cuda.current_stream(self.device)
            for t in rel:
                if torch.is_tensor(t):
                    t.record_stream(main)
        h.map = self.carry.m
        h._n_kf_valid_host = int(h.map.kf_valid.sum())
        latest_T_old = self.carry.latest_T
        h._dispatch_close(slot, cand, rel, fid, fid_cand, vals,
                          n_keyframes=n_kf)
        with h._stage("snapshot"):
            lm, latest_T, counts = h._take_snapshot(h.map)
            self._rebuild_carry(
                m=h.map, lm_Xw=lm[0], lm_desc=lm[1], lm_ids=lm[2],
                lm_valid=lm[3], latest_slot=counts[0], latest_T=latest_T,
                T_cw=se3.compose(se3.compose(self.carry.T_cw,
                                             se3.inv(latest_T_old)),
                                 latest_T))
        self.n_replays += 1
        self.closures_landed.append(self._n_dispatched)
        if w is not None:
            w.publish(self.carry.m)

    def run(self, frames) -> None:
        """Convenience: iterate (left, right) pairs in chunks."""
        buf = []
        for left, right in frames:
            buf.append(np.stack([left, right]))
            if len(buf) == self.chunk_size:
                self.process_chunk(np.stack(buf))
                buf = []
        if buf:
            self.process_chunk(np.stack(buf))
        self.flush()

    @property
    def map(self) -> MapState:
        """The map after a flush (the JAX engine's)."""
        self.flush()
        return self.carry.m

    def trajectory_refined(self) -> List[np.ndarray]:
        """Per-frame poses re-expressed against the current keyframe poses
        (after a flush, as the JAX engine's)."""
        self.flush()
        kf_T = self.carry.m.kf_T_cw.cpu().numpy()
        return [rel @ kf_T[slot] for slot, rel in self._traj_anchor]
