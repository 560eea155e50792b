"""Multi-sequence SLAM: B independent sequences ("lanes") on one device,
or split over several.

Counterpart of slam_toolkit_tpu/parallel/mesh.py, under the same names.
The JAX package batches the whole per-frame engine over a leading
sequence axis with jax.vmap and shards that axis over a device mesh. Here
a batched carry is a ChunkCarry whose tensors have a leading lane axis B
(the map too); `frame_id` is one host int, as every lane starts
together (a 0-dim device int in the static carry of a graphed chunk).
Every tracker.method runs in every layout. Three layouts run it:

- lanes in turn (multi_sequence_lane_chunk, the JAX lax.map over lanes):
  each lane runs the single-sequence chunk (pipeline/scan_engine.
  make_chunk_fn, one CUDA graph a lane, launched once a lane a chunk) on
  a copy of its views t[b] of the batched carry, keyframe event and all,
  written back after the chunk; no new kernel.
- batched lanes (multi_sequence_chunk, multi_sequence_engine, the JAX
  vmap): pipeline/scan_engine.make_batched_frame_body runs everything
  before the keyframe flag once over all B lanes, with batched entries
  of the patch-gather, top-2 and pose-LM kernels, then, on a frame where
  any lane is flagged, the keyframe event once over all lanes with the
  flags as its lane mask, with batched entries of the stereo-SAD and
  local-BA kernels (JAX lowers its vmapped lax.cond to both branches,
  masked: the same computation). multi_sequence_chunk runs it on a
  static carry as one CUDA graph for any B, launched once a chunk: the
  frames a WHILE node, the keyframe event an IF node on any lane's flag
  inside it (scan_engine._StaticBatchedChunk); multi_sequence_engine's
  per-frame step is eager.
- lanes over devices (multi_sequence_shard_chunk, the JAX shard_map): a
  mesh is a tuple of torch.devices; shard_batch splits the lanes evenly
  into one batched carry a device, and each device's lanes run the lane
  chunk eagerly on their own host thread, with no communication between
  them.

batched_bootstrap, as the JAX package's, gives a carry without the
photometric anchor that "direct" and "hybrid" track against (kf_img,
kf_ab, and for "hybrid" kf_refvals); JAX's multi_sequence_chunk then
fails on a None field, the port's raises ValueError naming the missing
fields (scan_engine.require_anchor). The caller adds the anchor as
ChunkedSlamEngine builds its own: the keyframe's left image, (a, b) =
(0, 0), and direct_lm.reference_values at latest_T.

Entry points that make state take device="cuda" by default and raise on
a host without CUDA; the others run on the device of the data given.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.frame import add_stereo, build_frame
from slam_toolkit_tpu_torch.frontend.tracker import track_pose
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.mapping.ba_adapter import local_ba_step
from slam_toolkit_tpu_torch.mapping.map_state import (MapState, empty_map,
                                                      insert_keyframe)
from slam_toolkit_tpu_torch.pipeline.engine import full_float32
from slam_toolkit_tpu_torch.pipeline.scan_engine import (
    ChunkCarry, _eager_chunk, _snapshot, _StaticBatchedChunk, lane,
    make_batched_frame_body, make_chunk_fn, write_lane)

Mesh = Tuple[torch.device, ...]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    return device


def make_mesh(n_devices: int, device: str = "cuda") -> Mesh:
    """The first n_devices devices of a type: cuda:0 .. cuda:n-1, or the
    CPU n times (one host thread a shard)."""
    dev = _device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),) * n_devices
    if n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} devices asked, "
                         f"{torch.cuda.device_count()} present")
    return tuple(torch.device("cuda", i) for i in range(n_devices))


def batched_empty_map(cfg: SlamConfig, batch: int,
                      device="cuda") -> MapState:
    """B empty maps with a leading lane axis (contiguous, so each lane's
    in-place updates stay in its rows)."""
    one = empty_map(cfg, _device(device))
    return MapState(*(t.unsqueeze(0).repeat((batch,) + (1,) * t.dim())
                      for t in one))


def batched_bootstrap(cfg: SlamConfig, cam: StereoCamera):
    """f(maps, lefts (B, H, W), rights (B, H, W)) -> batched ChunkCarry:
    frame 0 of every lane inserted as its first keyframe at the identity,
    with no tracked landmarks and quality 2 * min_matches, then each
    lane's landmark snapshot (the JAX batched_bootstrap: no weak-mappoint
    cull, no BA, no photometric anchor). Stereo, insert and snapshot run
    once over the lanes (one batched SAD launch)."""

    @full_float32()
    def boot(maps: MapState, lefts: torch.Tensor,
             rights: torch.Tensor) -> ChunkCarry:
        dev = lefts.device
        B = lefts.shape[0]
        frames = add_stereo(build_frame(lefts, cam, cfg), lefts, rights, cam,
                            cfg)
        L = cfg.map.track_landmarks
        zi = torch.zeros((B, L), dtype=torch.int32, device=dev)
        no = torch.zeros((B, L), dtype=torch.bool, device=dev)
        eye = torch.eye(4, dtype=torch.float32, device=dev).repeat(B, 1, 1)
        snap = _snapshot(maps, cfg)
        maps, slot = insert_keyframe(
            maps, frames, eye, 0, zi, zi, no, cfg,
            lm_snapshot=(snap[0], snap[3]),
            quality=float(2 * cfg.tracker.min_matches))
        lm = _snapshot(maps, cfg)
        return ChunkCarry(
            m=maps, T_cw=eye, velocity=eye.clone(), lm_Xw=lm[0],
            lm_desc=lm[1], lm_ids=lm[2], lm_valid=lm[3], latest_slot=slot,
            latest_T=maps.kf_T_cw[torch.arange(B, device=dev), slot],
            frame_id=1,
            inlier_peak=torch.zeros((B,), dtype=torch.float32, device=dev))

    return boot


def batched_track_step(cfg: SlamConfig, cam: StereoCamera):
    """f(maps, images (B, H, W), T_preds (B, 4, 4)) -> (T_cw (B, 4, 4),
    n_inliers (B,)): each lane's image tracked against its own map's
    local landmarks, the tracking batched over the lanes."""

    @full_float32()
    def step(maps: MapState, images: torch.Tensor, T_preds: torch.Tensor):
        frame = build_frame(images, cam, cfg)
        lm = _snapshot(maps, cfg)
        res = track_pose(frame, lm[0], lm[1], lm[3], T_preds, cam, cfg)
        return res.T_cw, res.n_inliers

    return step


def batched_map_step(cfg: SlamConfig, cam: StereoCamera):
    """f(maps) -> maps: local BA of every lane's window, one batched solve
    (updated in place)."""

    @full_float32()
    def step(maps: MapState) -> MapState:
        return local_ba_step(maps, cam, cfg)

    return step


def shard_batch(mesh: Mesh, tree) -> List:
    """Split a batched tree (a tensor, or a NamedTuple of them such as a
    carry or a map) into len(mesh) equal runs of lanes, run i on
    mesh[i]. The lane count must divide evenly."""
    n = len(mesh)

    def split(t, i):
        if torch.is_tensor(t):
            if t.shape[0] % n:
                raise ValueError(f"{t.shape[0]} lanes do not split over "
                                 f"{n} devices")
            k = t.shape[0] // n
            return t[i * k:(i + 1) * k].to(mesh[i]).contiguous()
        if isinstance(t, tuple):
            return type(t)(*(split(f, i) for f in t))
        return t

    return [split(tree, i) for i in range(n)]


def multi_sequence_step(cfg: SlamConfig, cam: StereoCamera, mesh: Mesh):
    """One step of every lane: track (batched), then local BA of every
    map. f(maps, images, T_preds) -> (maps, T_cw, n_inliers), on the
    device of the data (one device; split lanes with shard_batch)."""
    track = batched_track_step(cfg, cam)
    ba = batched_map_step(cfg, cam)

    def step(maps: MapState, images: torch.Tensor, T_preds: torch.Tensor):
        T_new, n_inl = track(maps, images, T_preds)
        return ba(maps), T_new, n_inl

    return step


def multi_sequence_engine(cfg: SlamConfig, cam: StereoCamera, mesh: Mesh):
    """The full engine step batched over lanes, per frame, for every
    tracker.method. Returns (bootstrap, step): bootstrap(maps, lefts,
    rights) -> carry (frame 0 of every lane, no photometric anchor);
    step(carry, lefts, rights) -> (carry, packed (B, 36))."""
    body = full_float32()(_vmapped_frame_body(cfg, cam))
    return batched_bootstrap(cfg, cam), body


def _vmapped_frame_body(cfg: SlamConfig, cam: StereoCamera):
    """The per-frame body over the lane axis, shared by the per-frame and
    chunked batched steps (scan_engine.make_batched_frame_body)."""
    return make_batched_frame_body(cfg, cam)


def _lane_chunk_body(cfg: SlamConfig, cam: StereoCamera, graphs: bool,
                     capacity=None):
    """One lane's chunk: (carry, b, images (C, 2, H, W)) -> packed (C, 36)
    on lane b of the batched carry, through the single-sequence chunk
    (scan_engine.make_chunk_fn, one a lane: its keyframe event runs only
    on the lane's own keyframes). The lane's views are copied into that
    chunk's static carry, and its final state is written back into the
    batch."""
    chunks = {}

    def run(carry: ChunkCarry, b: int, images: torch.Tensor):
        if b not in chunks:
            chunks[b] = make_chunk_fn(cfg, cam, graphs, capacity)
        c, packed = chunks[b](lane(carry, b), images)
        write_lane(carry.m, b, c.m)
        for f in ChunkCarry._fields:
            dst, src = getattr(carry, f), getattr(c, f)
            if f not in ("m", "frame_id") and torch.is_tensor(src) and \
                    src.data_ptr() != dst[b].data_ptr():
                dst[b] = src
        return packed

    return run


def _lane_chunk(cfg: SlamConfig, cam: StereoCamera, graphs: bool,
                capacity=None):
    run = _lane_chunk_body(cfg, cam, graphs, capacity)

    def chunk(carry: ChunkCarry, images: torch.Tensor):
        packed = [run(carry, b, images[:, b])
                  for b in range(images.shape[1])]
        carry = carry._replace(frame_id=carry.frame_id + images.shape[0])
        return carry, torch.stack(packed, dim=1)

    return chunk


def multi_sequence_lane_chunk(cfg: SlamConfig, cam: StereoCamera,
                              graphs: bool = True, capacity=None):
    """Lanes in turn: chunk(carry, images (C, B, 2, H, W)) -> (carry,
    packed (C, B, 36)). Each lane runs its C frames through the
    single-sequence chunk before the next lane starts, so a lane pays the
    keyframe event only on its own keyframes. graphs and capacity as
    scan_engine.make_chunk_fn's (one CUDA graph a lane, launched once a
    lane a chunk; at most `capacity` frames a chunk)."""
    return full_float32()(_lane_chunk(cfg, cam, graphs, capacity))


def multi_sequence_chunk(cfg: SlamConfig, cam: StereoCamera,
                         graphs: bool = True, capacity=None):
    """Batched lanes: chunk(carry, images (C, B, 2, H, W)) -> (carry,
    packed (C, B, 36)), C steps of the batched frame body (one launch of
    each batched kernel a frame for all B lanes, the keyframe event's on
    a frame where any lane is flagged), for every tracker.method; a
    photometric one needs the carry's anchor (ValueError otherwise).
    graphs=True: the steps on a static batched carry, one CUDA graph on
    a CUDA device for any B, launched once a chunk of at most `capacity`
    frames (None: as many as the longest chunk yet, captured again when
    a longer one comes; scan_engine._StaticBatchedChunk); graphs=False:
    the batched frame body eagerly.
    The carry returned is overwritten by the next call, as JAX's donated
    carry is."""
    if graphs:
        return _StaticBatchedChunk(cfg, cam, capacity)
    return _eager_chunk(_vmapped_frame_body(cfg, cam))


def multi_sequence_shard_chunk(cfg: SlamConfig, cam: StereoCamera,
                               mesh: Mesh):
    """Lanes over devices: chunk(carries, images (C, B, 2, H, W)) ->
    (carries, packed (C, B, 36) on mesh[0]). `carries` is shard_batch's
    list, one batched carry a device; device i takes the i-th run of B /
    len(mesh) lanes and runs the lane chunk on them on its own host
    thread (its camera a copy on that device). No data moves between the
    devices but the images in and the packed rows out."""
    cams = [StereoCamera(*(type(f)(*(t.to(d) if torch.is_tensor(t) else t
                                     for t in f)) if isinstance(f, tuple)
                           else f.to(d) for f in cam)) for d in mesh]
    chunks = [_lane_chunk(cfg, c, graphs=False) for c in cams]

    @full_float32()
    def chunk(carries: List[ChunkCarry], images: torch.Tensor):
        k = images.shape[1] // len(mesh)

        def run(i):
            imgs = images[:, i * k:(i + 1) * k].to(mesh[i])
            return chunks[i](carries[i], imgs)
        with ThreadPoolExecutor(max_workers=len(mesh)) as pool:
            outs = list(pool.map(run, range(len(mesh))))
        packed = torch.cat([p.to(mesh[0]) for _, p in outs], dim=1)
        return [c for c, _ in outs], packed

    return chunk
