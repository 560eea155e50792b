"""The port's headline bench: bench.py's main() on one CUDA card.

    python -m slam_toolkit_tpu_torch.tools.bench
    BENCH_METHOD=hybrid python -m slam_toolkit_tpu_torch.tools.bench
    BENCH_LOOP=1 python -m slam_toolkit_tpu_torch.tools.bench
    BENCH_DP=4 [BENCH_DP_MODE=lane|vmap] python -m \
        slam_toolkit_tpu_torch.tools.bench

The protocol of bench.py's main(): SlamConfig() at KITTI width, the
straight synthetic track (world seed 7, 0.8 m a frame, BENCH_FRAMES
frames, default 160) in chunks of BENCH_CHUNK (16); 3 warm-up chunks,
then the remaining chunks timed on the host clock, ending in
torch.cuda.synchronize(); trajectory_refined() against the ground truth
for ATE and RPE; then blocked_chunk_ms, the least time of one chunk with
nothing before it (chunks 0-2 again). For the indirect tracker it also
runs the sweep: BENCH_SEEDS (3) runs of BENCH_SWEEP_FRAMES (96) frames
on world seeds 7, 11 and 13 (seed 7 is the headline sequence's prefix),
each timed after 2 warm-up chunks. BENCH_METHOD=direct|hybrid picks the
tracker and suffixes the metric's name.

BENCH_DP=B runs bench.py's main_dp() instead: B independent sequences
("lanes", parallel/mesh) through the full engine step on one card, every
lane the headline's cached sequence (lanes share no state, so equal
inputs measure the same work as distinct ones). Frame 0 of every lane
bootstraps (mesh.batched_bootstrap); frames 1 .. in chunks of
BENCH_CHUNK (16), the ragged tail dropped; 3 warm-up chunks, the rest
timed on the host clock ending in a synchronise. BENCH_DP_MODE picks the
layout: "lane" (the default, mesh.multi_sequence_lane_chunk: lanes in
turn, each lane's keyframe event only on its own keyframes) or "vmap"
(mesh.multi_sequence_chunk: the step batched over the lanes, one launch
of the gather, top-2 and pose-LM kernels a frame for all B lanes, the
keyframe event once over the lanes on a frame where any is flagged). It
reports aggregate frames/s (B x frames / s) and per-lane frames/s, lane
0's ATE from its raw rows (no refinement: a coarse check), keyframes a
lane, and on the card the device work of the last warm-up chunk's first
4 frames (torch.profiler: operations a frame of all lanes, busy share).
No vs_baseline: bench.py's 500 is a TPU number. BENCH_TINY=1 runs it at
SlamConfig.tiny() (a smoke test of the harness, as in bench.py).
BENCH_OPTION=O1|O2|O3 runs it under that option set (OPTIONS below).
BENCH_DP_STAGGER=k starts lane b k * b frames into a longer render of
the same track, so the lanes keyframe on different frames and the
batched keyframe event runs with lanes masked out (0, the default: every
lane the same frames).

BENCH_LOOP=1 runs bench.py's main_loop() instead: full SLAM on a closed
KITTI-scale track with BoW loop detection and closing between chunks.
BENCH_FRAMES (320) frames of loop_track (four clothoid corners, world
seed 7, texture period 170 m) in chunks of 16: the track closes at ~85%
of the frames, then re-drives its start. The vocabulary (k=10, L=3) is
trained on the port's descriptors of every 8th left frame, written as a
DBoW2 text file and read back from it. 3 warm-up chunks, the rest timed;
then ATE, the seam (mean distance between both visits' centres of the
same physical poses) and its profile by quarter, the closures and
replays, the blocked chunk, the revisit's drift against ground truth,
and each closure's loop-edge error against it. Switches:
BENCH_LOOP_TRACK=fig8 (a figure-eight: two seams and a final pass),
BENCH_LOOP_VOCAB=0 (the same frames with loop closing off),
BENCH_LOOP_GROUP=sim3 (the 7-DoF pose graph) and
BENCH_LOOP_OVER="key=val,..." (LoopConfig overrides). The engine's
schedule comes from SLAM_QUEUE_DEPTH and SLAM_LOOP_THREAD (default 0 and
0, inline; the JAX package's bench runs 2 and 1, two chunks in flight
and the loop phases on the mapping thread); the record names both.

BENCH_CLUSTER=1 runs bench.py's main_cluster() instead: the dense
motion-clustering workload (cluster/tracker.FusedDenseTracker, queue
depth 2) at 1241x376 with DenseConfig(max_points=18688) on
make_cluster_scene's BENCH_FRAMES (60) frames: a laterally translating
camera through a depth-banded world and 3 movers. The frames are staged
on the card before timing; 5 warm-up frames, the rest timed (ending in a
synchronise). Gates, as bench.py's (exit 1 on a miss): the movers keep
one distinct cluster id each over the last 20 frames, and on probe
frames 10, n/2 and n-2 against cluster_scene_gt the disparity p95 <= 0.3
px with <= 0.5% over 3 px and the flow EPE p95 <= 2.0 px with <= 6% over
3 px. Then one blocked dense_frame, the ms of each stage on the card
(each between two synchronises, median of 3), and on 5 frames each of
a second run the host syncs a frame (CUDA's sync debug mode), the
tracker's waits for its packed row a frame (an event wait, which the
debug mode does not see), and the card's kernels a frame and busy share
(one torch.profiler pass).

The engines run graphed (scan_engine.make_chunk_fn: CUDA graphs of the
step on a static carry, captured in the first warm-up chunk; the
cluster tracker's fused step as one CUDA graph, captured at its first
frame after the seed); BENCH_GRAPHS=0 runs the same bench with the
eager step (the same rows bit for bit), for the comparison. Every
record says which in `graphs`.

Frames are rendered once (data/synthetic; in parallel processes) and
cached as .npy files named by track, seed, frames, step and size, in
BENCH_CACHE if it is set, else the temporary directory
(tempfile.gettempdir()); the loop bench caches its vocabulary beside
its frames, under the same name. Prints
one JSON line, the keys of bench.py's (less vs_baseline, a target of the
TPU rounds) and the card's name and power limit, the kernels' build
time, keyframes made and culled, and the engine's TF32 setting.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

WARMUP_CHUNKS = 3
SWEEP_WARMUP_CHUNKS = 2
SWEEP_SEEDS = (7, 11, 13, 17, 19)
HEADLINE_SEED = 7
# The option sets chip_smoke's phase 15 runs at full width, as {config
# section: {field: value}}: O1 every off-default extractor option that
# selects something in the port (steered bfloat16 descriptors on the
# poly pyramid) with descriptor stereo; O2 the SAD stereo's BRIEF gate;
# O3 O1 with upright descriptors. Steered descriptors sample the rotated pattern by element
# (brief.compute_descriptors), so bfloat16 patches reach the gather
# kernel only with upright ones: O3 is the path of its bfloat16 entry.
_O3 = {"extractor": {"descriptor_dtype": "bfloat16", "pyramid_mode": "poly"},
       "matcher": {"stereo_method": "descriptor"}}
OPTIONS = {
    "O1": {"extractor": {**_O3["extractor"], "steer_rotation": True},
           "matcher": _O3["matcher"]},
    "O2": {"matcher": {"stereo_brief_gate": True}},
    "O3": _O3,
}


def with_option(cfg, name: str):
    """cfg (a SlamConfig of either package) with OPTIONS[name] set."""
    import dataclasses
    return dataclasses.replace(cfg, **{
        sec: dataclasses.replace(getattr(cfg, sec), **fields)
        for sec, fields in OPTIONS[name].items()})
STEP_M = 0.8
DP_PROFILED = 4               # BENCH_DP: frames under torch.profiler
LOOP_VOCAB_EVERY = 8          # the loop bench's vocabulary: every 8th frame
LOOP_VOCAB_K, LOOP_VOCAB_LEVELS = 10, 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")


def stage_frames(cfg, n_frames: int, seed: int = HEADLINE_SEED,
                 cache: Optional[str] = None
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """((N, 2, H, W) uint8 stereo frames, N ground-truth poses): mapped
    from the cache, or rendered (make_sequence's world and straight
    track, through render_stack) and cached."""
    from slam_toolkit_tpu_torch.data.synthetic import forward_trajectory
    base = os.path.join(_cache_dir(cache), (
        f"slam_torch_bench_seed{seed}_{n_frames}f_step{STEP_M}_"
        f"{cfg.camera.width}x{cfg.camera.height}"))
    t0 = time.perf_counter()
    if os.path.exists(base + ".npy"):
        stacked = np.load(base + ".npy", mmap_mode="r")
        gt = list(np.load(base + ".gt.npy"))
        _log(f"mapped {n_frames} cached frames of seed {seed} from "
             f"{base}.npy in {time.perf_counter() - t0:.1f} s")
        return stacked, gt
    gt = forward_trajectory(n_frames, STEP_M)
    stacked = render_stack(dict(cfg=cfg, seed=seed), gt)
    _log(f"rendered {n_frames} frames of seed {seed} in "
         f"{time.perf_counter() - t0:.1f} s, cached as {base}.npy")
    _save_cached(base, stacked, gt)
    return stacked, gt


_RENDER_WORLD = None
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _set_render_world(world_kw) -> None:
    """Worker initializer: the world built from make_world's arguments
    (a world's textures are ~0.1 GB; sending them to each worker costs
    more than building them there)."""
    from slam_toolkit_tpu_torch.data.synthetic import make_world
    global _RENDER_WORLD
    _RENDER_WORLD = None if world_kw is None else make_world(**world_kw)


def _render_one(T: np.ndarray) -> np.ndarray:
    from slam_toolkit_tpu_torch.data.synthetic import render_stereo
    left, right = render_stereo(_RENDER_WORLD, T)
    return np.stack([np.clip(left, 0, 255),
                     np.clip(right, 0, 255)]).astype(np.uint8)


def render_stack(world_kw: dict, poses) -> np.ndarray:
    """(N, 2, H, W) uint8 stereo frames of `poses` in the world
    make_world(**world_kw) builds, rendered by a pool of spawned worker
    processes (one a core, one thread each; in this process when the
    frames hold fewer than 2**22 pixels in all, where starting workers
    costs more); the pool is closed before returning."""
    import multiprocessing as mp
    cam = world_kw["cfg"].camera
    n = 1 if cam.width * cam.height * len(poses) < 2 ** 22 \
        else min(len(poses), os.cpu_count() or 1)
    if n <= 1:
        _set_render_world(world_kw)
        try:
            return np.stack([_render_one(T) for T in poses])
        finally:
            _set_render_world(None)
    threads = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        pool = mp.get_context("spawn").Pool(
            n, initializer=_set_render_world, initargs=(world_kw,))
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    with pool:
        return np.stack(pool.map(_render_one, poses, chunksize=1))


def _cache_dir(cache: Optional[str]) -> str:
    return cache or os.environ.get("BENCH_CACHE") or tempfile.gettempdir()


def _save_cached(base: str, stacked: np.ndarray, gt) -> None:
    os.makedirs(os.path.dirname(base), exist_ok=True)
    for suffix, arr in ((".gt.npy", np.stack(gt)), (".npy", stacked)):
        tmp = f"{base}.{os.getpid()}.tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, base + suffix)         # the frames last: complete


def loop_geometry(n: int, chunk: int, track: str = "clothoid"):
    """bench.py main_loop's split of n frames: (lap, revisit, extent,
    lobe): the frame where the track closes, the frames re-driven after
    it, the track's rough half-extent (m) and, for the figure-eight, the
    lobe length (else None)."""
    if track == "fig8":
        lobe = (n - 2 * chunk) // 3 // chunk * chunk
        return 3 * lobe, n - 3 * lobe, lobe * STEP_M / 3.0, lobe
    lap = (n * 17 // 20) // chunk * chunk
    return lap, n - lap, lap * STEP_M / 4.0, None


def loop_cache_base(cfg, n_frames: int, chunk: int, track: str,
               cache: Optional[str]) -> str:
    """The loop bench's cache name for one (track, frames, chunk, size),
    its frames' (.npy), ground truth's (.gt.npy) and vocabulary's
    (.vocab.txt) stem."""
    return os.path.join(_cache_dir(cache), (
        f"slam_torch_loop_{track}_seed{HEADLINE_SEED}_{n_frames}f_"
        f"chunk{chunk}_step{STEP_M}_{cfg.camera.width}x{cfg.camera.height}"))


def stage_loop_frames(cfg, n_frames: int, chunk: int = 16,
                      track: str = "clothoid", cache: Optional[str] = None
                      ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The loop bench's frames and ground truth (bench.py main_loop's
    world and track), mapped from the cache or rendered and cached."""
    from slam_toolkit_tpu_torch.data.synthetic import fig8_track, loop_track
    lap, revisit, extent, lobe = loop_geometry(n_frames, chunk, track)
    base = loop_cache_base(cfg, n_frames, chunk, track, cache)
    t0 = time.perf_counter()
    if os.path.exists(base + ".npy"):
        _log(f"mapped {n_frames} cached loop frames from {base}.npy")
        return np.load(base + ".npy", mmap_mode="r"), \
            list(np.load(base + ".gt.npy"))
    world_kw = dict(cfg=cfg, seed=HEADLINE_SEED, half_width=extent + 12.0,
                    half_length=extent + 12.0, ground_y=1.6, tex_size=2048,
                    texels_per_m=12.0)
    if track == "fig8":
        f8 = fig8_track(lobe, step=STEP_M)
        lobe1, lobe2 = f8[:lobe], f8[lobe:]
        gt = lobe1 + lobe1 + lobe2 + lobe1[:revisit]
    else:
        t = loop_track(lap, step=STEP_M)
        gt = t + t[:revisit]
    stacked = render_stack(world_kw, gt)
    _log(f"rendered {n_frames} loop frames in "
         f"{time.perf_counter() - t0:.1f} s, cached as {base}.npy")
    _save_cached(base, stacked, gt)
    return stacked, gt


def loop_vocabulary(cfg, stacked: np.ndarray, path: str, device="cuda"):
    """main_loop's vocabulary: trained (k=10, L=3, seed 0) on the port's
    descriptors of every 8th left frame of `stacked`, the run's own
    frames, written as the DBoW2 text file `path` and read back from it
    (the file is kept: a later call with the same path only reads it)."""
    from slam_toolkit_tpu_torch.loop import vocab as V
    from slam_toolkit_tpu_torch.ops.extractor import extract
    n = stacked.shape[0]
    if not os.path.exists(path):
        t0 = time.perf_counter()
        corpus = []
        for i in range(0, n, LOOP_VOCAB_EVERY):
            img = torch.from_numpy(np.array(stacked[i, 0])).to(
                device, torch.float32)
            f = extract(img, cfg.extractor)
            corpus.append(f.desc[f.valid].cpu().numpy())
        voc = V.train(np.concatenate(corpus), k=LOOP_VOCAB_K,
                      levels=LOOP_VOCAB_LEVELS, seed=0)
        tmp = f"{path}.{os.getpid()}.tmp"
        V.save_dbow2_text(voc, tmp)
        os.replace(tmp, path)
        _log(f"trained the vocabulary ({voc.num_words} words) in "
             f"{time.perf_counter() - t0:.1f} s, saved as {path}")
    return V.load_dbow2_text(path)


def _centers(traj) -> np.ndarray:
    return np.stack([-np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3]
                     for T in traj])


def loop_edge_error(e: dict, gt) -> Tuple[float, float, np.ndarray]:
    """A closure's loop-edge error against ground truth: (translation m,
    rotation deg, translation in the candidate camera's frame)."""
    E_meas = np.asarray(e["T_meas"]) @ np.linalg.inv(
        np.asarray(e["T_cand_pre"]))
    E_gt = np.asarray(gt[e["frame"]]) @ np.linalg.inv(
        np.asarray(gt[e["fid_cand"]]))
    D = E_meas @ np.linalg.inv(E_gt)
    ang = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2,
                                       -1, 1)))
    t_cam = np.asarray(gt[e["fid_cand"]])[:3, :3] @ D[:3, 3]
    return float(np.linalg.norm(D[:3, 3])), float(ang), t_cam


def run_loop(cfg, vocab, stacked, gt, chunk: int = 16, device="cuda",
             track: str = "clothoid", graphs: bool = True) -> dict:
    """bench.py main_loop's run: fps over the chunks after 3 warm-up
    chunks, ATE, the seam and its profile, the closures, replays,
    keyframes, the blocked chunk, the revisit drift and the loop-edge
    errors."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    device = torch.device(device)
    n = stacked.shape[0]
    lap, revisit, _, lobe = loop_geometry(n, chunk, track)
    chunks = _chunks(stacked, chunk, device)
    eng = ChunkedSlamEngine(cfg, vocab=vocab, chunk_size=chunk, device=device,
                            graphs=graphs)
    warm_s = _timed(eng, chunks[:WARMUP_CHUNKS], device)
    eng.warmup()
    _log(f"loop warm-up ({WARMUP_CHUNKS} chunks, first uses) in "
         f"{warm_s:.1f} s")
    dt = _timed(eng, chunks[WARMUP_CHUNKS:], device)
    n_timed = sum(int(c.shape[0]) for c in chunks[WARMUP_CHUNKS:])
    fps = n_timed / dt
    traj = eng.trajectory_refined()
    ate = ate_rmse(traj, gt, align=True)
    centers, gt_c = _centers(traj), _centers(gt)
    prof = np.linalg.norm(centers[lap:lap + revisit] - centers[:revisit],
                          axis=1)
    seam = float(np.mean(prof))
    q = max(revisit // 4, 1)
    profile = [float(prof[:q].mean()), float(prof[q:3 * q].mean()),
               float(prof[3 * q:].mean())]
    drift = np.linalg.norm((centers[lap:lap + revisit] - centers[lap])
                           - (gt_c[lap:lap + revisit] - gt_c[lap]), axis=1)
    out = {"fps": fps, "ate_m": ate, "seam_m": seam,
           "seam_profile_m": profile, "revisit_drift_m": float(drift[-1]),
           "n_keyframes": eng.n_keyframes, "n_culls": eng.n_culls,
           "replays": eng.n_replays, "queue_depth": eng.queue_depth,
           "loop_thread": eng.loop_thread}
    if track == "fig8":
        out["seam_lap2_m"] = float(np.mean(np.linalg.norm(
            centers[lobe:2 * lobe:4] - centers[:lobe:4], axis=1)))
        out["seam_lobe2_m"] = float(np.linalg.norm(
            centers[3 * lobe - 1] - centers[0]))
    closures = [e for e in eng.loop_events if "cand" in e]
    out["closures"] = len(closures)
    out["relocalizations"] = sum("reloc_to" in e for e in eng.loop_events)
    out["closure_events"] = []
    for e in closures:
        brief = {k: v for k, v in e.items()
                 if k not in ("T_meas", "T_cand_pre")}
        t_err, r_err, t_cam = loop_edge_error(e, gt)
        brief["edge_err_m"], brief["edge_err_deg"] = t_err, r_err
        brief["edge_err_cam_xyz_m"] = [float(v) for v in t_cam]
        out["closure_events"].append(brief)
        _log(f"closure {brief}")
    if eng._host is not None:
        out["pose_graph_tiers"] = list(eng._host.close_tiers)
    _log(f"loop: {n_timed} frames in {dt:.2f} s, {fps:.2f} fps, ATE "
         f"{ate:.4f} m, seam {seam:.4f} m (profile by quarter "
         f"{[round(v, 3) for v in profile]}), closures {len(closures)}, "
         f"replays {eng.n_replays}, keyframes {eng.n_keyframes}, revisit "
         f"drift {out['revisit_drift_m']:.3f} m")
    out["blocked_chunk_ms"] = min(1000.0 * _timed(eng, [c], device)
                                  for c in chunks[:3])
    return out


def loop_record(cfg, n_frames: int = 320, chunk: int = 16, device="cuda",
                track: str = "clothoid", use_vocab: bool = True,
                cache: Optional[str] = None, graphs: bool = True) -> dict:
    """The loop bench's JSON record (bench.py main_loop's keys less
    vs_baseline, plus the card, its power limit, the kernels' build
    time, keyframes, tf32 and the seam profile, closure events with their
    loop-edge errors, and the pose-graph tiers)."""
    device = torch.device(device)
    build_s = _build_kernels(device)
    card, power = _card(device)
    stacked, gt = stage_loop_frames(cfg, n_frames, chunk, track, cache)
    vocab = loop_vocabulary(cfg, stacked, loop_cache_base(
        cfg, n_frames, chunk, track, cache) + ".vocab.txt", device) \
        if use_vocab else None
    r = run_loop(cfg, vocab, stacked, gt, chunk, device, track, graphs)
    out = {
        "metric": "kitti_scale_full_slam_loop_fps" + (
            f"_{track}" if track != "clothoid" else ""),
        "value": round(r["fps"], 2), "unit": "frames/s",
        "ate_m": round(r["ate_m"], 3), "seam_m": round(r["seam_m"], 3),
        "closures": r["closures"], "replays": r["replays"],
        "blocked_chunk_ms": round(r["blocked_chunk_ms"], 1), "chunk": chunk,
        "loop_closing": use_vocab, "graphs": graphs,
        "queue_depth": r["queue_depth"], "loop_thread": r["loop_thread"],
        "backend": f"torch-{device.type}",
        "card": card, "power_limit": power,
        "kernel_build_s": None if build_s is None else round(build_s, 2),
        "n_keyframes": r["n_keyframes"], "tf32": False,
        "seam_profile_m": [round(v, 3) for v in r["seam_profile_m"]],
        "revisit_drift_m": round(r["revisit_drift_m"], 3),
        "relocalizations": r["relocalizations"],
        "closure_events": r["closure_events"],
        "pose_graph_tiers": r.get("pose_graph_tiers", []),
    }
    for k in ("seam_lap2_m", "seam_lobe2_m"):
        if k in r:
            out[k] = round(r[k], 3)
    return out


def _chunks(stacked: np.ndarray, chunk: int, device: torch.device):
    """The frames as float32 chunks on the device, uploaded before any
    timing (bench.py stages its chunks on the chip the same way)."""
    n = stacked.shape[0]
    out = [torch.from_numpy(np.array(stacked[i:i + chunk])).to(
        device, torch.float32) for i in range(0, n, chunk)]
    _sync(device)
    return out


def _timed(eng, chunks, device: torch.device) -> float:
    """Seconds to process `chunks`, ending in a device synchronise."""
    t0 = time.perf_counter()
    for c in chunks:
        eng.process_chunk(c)
    eng.flush()
    _sync(device)
    return time.perf_counter() - t0


def run_headline(cfg, n_frames: int = 160, chunk: int = 16, device="cuda",
                 cache: Optional[str] = None, graphs: bool = True) -> dict:
    """bench.py's main() run: fps over the chunks after the warm-up, ATE
    and RPE of trajectory_refined(), blocked_chunk_ms, keyframes made and
    culled."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse, rpe
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    device = torch.device(device)
    stacked, gt = stage_frames(cfg, n_frames, HEADLINE_SEED, cache)
    chunks = _chunks(stacked, chunk, device)
    eng = ChunkedSlamEngine(cfg, chunk_size=chunk, device=device,
                            graphs=graphs)
    warm_s = _timed(eng, chunks[:WARMUP_CHUNKS], device)
    _log(f"warm-up ({WARMUP_CHUNKS} chunks, first uses) in {warm_s:.1f} s")
    dt = _timed(eng, chunks[WARMUP_CHUNKS:], device)
    n_timed = sum(int(c.shape[0]) for c in chunks[WARMUP_CHUNKS:])
    fps = n_timed / dt
    traj = eng.trajectory_refined()
    ate = ate_rmse(traj, gt, align=True)
    rpe_t, rpe_r = rpe(traj, gt)
    n_kf, n_culls = eng.n_keyframes, eng.n_culls
    _log(f"{n_timed} frames in {dt:.2f} s, {fps:.2f} fps, ATE {ate:.4f} m, "
         f"RPE {rpe_t:.4f} m / {np.degrees(rpe_r):.3f} deg, keyframes "
         f"{n_kf}, culls {n_culls}, mappoints "
         f"{int(eng.map.mp_valid.sum())}")
    # one chunk with the pipeline drained (bench.py: chunks 0-2 again)
    blocked_ms = min(1000.0 * _timed(eng, [c], device) for c in chunks[:3])
    _log(f"blocked chunk {blocked_ms:.1f} ms ({blocked_ms / chunk:.2f} "
         f"ms/frame vs {1000.0 / fps:.2f} ms/frame over the timed run)")
    return {"fps": fps, "ate_m": ate, "rpe_t_m": rpe_t,
            "blocked_chunk_ms": blocked_ms, "n_keyframes": n_kf,
            "n_culls": n_culls}


def run_sweep(cfg, n_frames: int = 96, chunk: int = 16, device="cuda",
              n_seeds: int = 3, headline_frames: int = 160,
              cache: Optional[str] = None,
              graphs: bool = True) -> Optional[dict]:
    """bench.py's _multi_seed_sweep: n_frames on each of the first
    n_seeds world seeds, fps after 2 warm-up chunks and ATE; seed 7 is
    the headline sequence's prefix. None for fewer than 2 seeds."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    if n_seeds <= 1:
        return None
    device = torch.device(device)
    rows = []
    for seed in SWEEP_SEEDS[:n_seeds]:
        if seed == HEADLINE_SEED and headline_frames >= n_frames:
            stacked, gt = stage_frames(cfg, headline_frames, seed, cache)
            stacked, gt = stacked[:n_frames], gt[:n_frames]
        else:
            stacked, gt = stage_frames(cfg, n_frames, seed, cache)
        n = stacked.shape[0] // chunk * chunk
        chunks = _chunks(stacked[:n], chunk, device)
        eng = ChunkedSlamEngine(cfg, chunk_size=chunk, device=device,
                                graphs=graphs)
        _timed(eng, chunks[:SWEEP_WARMUP_CHUNKS], device)
        dt = _timed(eng, chunks[SWEEP_WARMUP_CHUNKS:], device)
        n_timed = sum(int(c.shape[0]) for c in chunks[SWEEP_WARMUP_CHUNKS:])
        traj = eng.trajectory_refined()
        ate = ate_rmse(traj, gt[:len(traj)], align=True)
        rows.append({"seed": seed, "fps": round(n_timed / dt, 1),
                     "ate_m": round(ate, 3)})
        _log(f"sweep {rows[-1]}")
    ates = [r["ate_m"] for r in rows]
    return {"seeds": len(rows), "frames": n_frames,
            "ate_mean_m": round(float(np.mean(ates)), 3),
            "ate_max_m": round(float(np.max(ates)), 3), "per_seed": rows}


def _card(device: torch.device):
    """(name, power limit) as nvidia-smi prints them; (None, None) off
    the card."""
    if device.type != "cuda":
        return None, None
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    name, limit = (s.strip() for s in out.strip().splitlines()[0].split(","))
    return name, limit


def _build_kernels(device: torch.device) -> Optional[float]:
    """Refuse a missing card; build and load the kernels on one (seconds,
    None off the card)."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    if device.type != "cuda":
        return None
    from slam_toolkit_tpu_torch.utils import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    _log(f"kernels built and loaded in {build_s:.2f} s")
    return build_s


def bench_record(cfg, n_frames: int = 160, chunk: int = 16, device="cuda",
                 n_seeds: int = 3, sweep_frames: int = 96,
                 cache: Optional[str] = None, graphs: bool = True) -> dict:
    """The bench's JSON record for cfg (its tracker.method picks the
    metric's suffix; the sweep runs for the indirect tracker only)."""
    device = torch.device(device)
    build_s = _build_kernels(device)
    card, power = _card(device)
    method = cfg.tracker.method
    r = run_headline(cfg, n_frames, chunk, device, cache, graphs)
    out = {
        "metric": "kitti_scale_track_lba_fps" + (
            "" if method == "indirect" else f"_{method}"),
        "value": round(r["fps"], 2),
        "unit": "frames/s",
        "ate_m": round(r["ate_m"], 3),
        "rpe_t_m": round(r["rpe_t_m"], 4),
        "blocked_chunk_ms": round(r["blocked_chunk_ms"], 1),
        "chunk": chunk,
        "graphs": graphs,
        "backend": f"torch-{device.type}",
        "card": card,
        "power_limit": power,
        "kernel_build_s": None if build_s is None else round(build_s, 2),
        "n_keyframes": r["n_keyframes"],
        "n_culls": r["n_culls"],
        # the engine runs its work with TF32 off (scan_engine.full_float32)
        "tf32": False,
    }
    if method == "indirect":
        sweep = run_sweep(cfg, sweep_frames, chunk, device, n_seeds,
                          n_frames, cache, graphs)
        if sweep:
            out["sweep"] = sweep
    return out


CLUSTER_MAX_POINTS = 18688        # the stride-5 grid of a 1241x376 frame
CLUSTER_WARMUP = 5
CLUSTER_GATES = {"disp_p95_px": 0.3, "disp_gt3px_frac": 0.005,
                 "flow_epe_p95_px": 2.0, "flow_gt3px_frac": 0.06}


def mover_persistence(outs, scene, n: int, cfg):
    """bench.py main_cluster's mover gate: the majority label of the
    samples inside each of the first 3 ground-truth mover boxes (10 px in
    from the edges) on every live frame of the last 20; outs[k] is frame
    k + 1. Returns (persistent, distinct, the ids by mover, clusters
    alive on the last live frame)."""
    from slam_toolkit_tpu_torch.cluster.tracker import _sample_grid
    h, w = scene.frames[0][0].shape
    uv = _sample_grid(h, w, cfg.sample_stride, cfg.max_points)[0].astype(
        np.float32)

    def box_major(out, box):
        x, y, s, _ = box
        m = ((uv[:, 0] >= x + 10) & (uv[:, 0] < x + s - 10)
             & (uv[:, 1] >= y + 10) & (uv[:, 1] < y + s - 10))
        labs = out["labels"][:len(m)][m]
        labs = labs[labs >= 0]
        if labs.size == 0:
            return -1
        vals, cnts = np.unique(labs, return_counts=True)
        return int(vals[np.argmax(cnts)])

    live = [(k + 1, o) for k, o in enumerate(outs) if not o["skipped"]]
    ids = {j: [] for j in range(3)}
    for fidx, o in live:
        if fidx >= n - 20:
            for j, box in enumerate(scene.mover_boxes[fidx][:3]):
                ids[j].append(box_major(o, box))
    seen = [v for v in ids.values() if v]
    persist = all(len(set(v)) == 1 and v[0] >= 0 for v in seen)
    distinct = len({v[0] for v in seen}) == len(seen)
    alive = int((live[-1][1]["sizes"] > 0).sum()) if live else 0
    return persist, distinct, ids, alive


def cluster_quality(scene, cfg, device, probes) -> dict:
    """Disparity and flow of dense_frame on the probe frames against the
    scene's analytic ground truth: the worst p95 and >3 px fraction of
    each over the probes."""
    from slam_toolkit_tpu_torch.cluster.tracker import dense_frame
    from slam_toolkit_tpu_torch.data.synthetic import cluster_scene_gt
    from slam_toolkit_tpu_torch.pipeline.engine import full_float32
    d_p95, d_frac, f_p95, f_frac = [], [], [], []
    for t in probes:
        gl, gr = scene.frames[t]
        with torch.no_grad(), full_float32():
            fr = dense_frame(*(torch.from_numpy(a).to(device) for a in
                               (gl, gr, scene.frames[t - 1][0])),
                             scene.cam, cfg)
        disp, flow = fr.disparity.cpu().numpy(), fr.flow.cpu().numpy()
        gt_d, gt_f, gt_v = cluster_scene_gt(scene, t)
        md = gt_v & (disp > 0)
        derr = np.abs(disp[md] - gt_d[md])
        d_p95.append(float(np.percentile(derr, 95)))
        d_frac.append(float(np.mean(derr > 3.0)))
        epe = np.linalg.norm(flow - gt_f, axis=-1)[gt_v]
        f_p95.append(float(np.percentile(epe, 95)))
        f_frac.append(float(np.mean(epe > 3.0)))
    return {"disp_p95_px": max(d_p95), "disp_gt3px_frac": max(d_frac),
            "flow_epe_p95_px": max(f_p95), "flow_gt3px_frac": max(f_frac)}


def cluster_stage_ms(scene, cfg, device, t: int = 4, reps: int = 3) -> dict:
    """ms of each stage of the workload on frame t (against t - 1), the
    tracker state from a stepwise run over frames 0 .. t - 1: the Sobel
    mask, the disparity, the flow, the whole dense_frame, track_clusters
    and one RANSAC round over the residual points; each between two
    synchronises, median of `reps` after a first use."""
    from slam_toolkit_tpu_torch.cluster import flow as flow_mod
    from slam_toolkit_tpu_torch.cluster import stereo_bm
    from slam_toolkit_tpu_torch.cluster import tracker as trk
    from slam_toolkit_tpu_torch.pipeline.engine import full_float32
    from slam_toolkit_tpu_torch.utils import threefry
    st = trk.DenseTracker(scene.cam, cfg, device=device)
    for k in range(t):
        st.track(*scene.frames[k])
    gl, gr = (torch.from_numpy(a).to(device) for a in scene.frames[t])
    cam, gs = scene.cam, st._grid_shape
    key = threefry.prng_key(t + 1)
    labels = torch.from_numpy(st.labels).to(device)
    stages = {
        "sobel": lambda: stereo_bm.sobel_edge_mask(gl),
        "disparity": lambda: stereo_bm.disparity(
            gl, gr, cfg.num_disparities, cfg.block_size),
        "flow": lambda: flow_mod.farneback_flow(
            st.prev_gray, gl, levels=cfg.flow_levels, win=cfg.flow_win,
            max_flow_x=cfg.max_flow_x, max_flow_y=cfg.max_flow_y),
        "dense_frame": lambda: trk.dense_frame(gl, gr, st.prev_gray, cam,
                                               cfg)}
    out = {}
    with torch.no_grad(), full_float32():
        f = trk.dense_frame(gl, gr, st.prev_gray, cam, cfg)
        stages["track_clusters"] = lambda: trk.track_clusters(
            f, labels, st.prev_depth, torch.from_numpy(st.is_ground).to(
                device), torch.from_numpy(st.alive).to(device), key, cam,
            cfg, gs)
        stages["ransac_round"] = lambda: trk.ransac_round(
            f, labels < 0, st.prev_depth, torch.zeros((), dtype=torch.bool,
                                                      device=device),
            threefry.fold_in(key, 100), cam, cfg, gs)
        for name, fn in stages.items():
            fn()                                    # first use
            times = []
            for _ in range(reps):
                _sync(device)
                t0 = time.perf_counter()
                fn()
                _sync(device)
                times.append(1000.0 * (time.perf_counter() - t0))
            out[name] = float(np.median(times))
    return out


def cluster_counts(scene, cfg, device, start: int = 5, n: int = 5,
                   graphs: bool = True) -> dict:
    """Host syncs and the tracker's row waits a frame and, where the
    profiler sees the card, kernels a frame and the card's busy share, of
    the fused tracker on frames start .. start + n - 1 (syncs, waits) and
    the n after them (profiler) of a fresh run."""
    from slam_toolkit_tpu_torch.cluster.tracker import FusedDenseTracker
    from slam_toolkit_tpu_torch.utils.timing import (count_syncs,
                                                     device_activity)
    tr = FusedDenseTracker(scene.cam, cfg, queue_depth=2, device=device,
                           graphs=graphs)
    staged = [tuple(torch.from_numpy(a).to(device) for a in fr)
              for fr in scene.frames[:start + 2 * n]]

    def run(frames):
        for gl, gr in frames:
            tr.process(gl, gr)

    run(staged[:start])
    waits = tr.waits
    _, syncs = count_syncs(run, staged[start:start + n])
    out = {"syncs_per_frame": syncs / n,
           "waits_per_frame": (tr.waits - waits) / n}
    if device.type == "cuda":
        _, act = device_activity(run, staged[start + n:start + 2 * n])
        out["kernels_per_frame"] = None if act["kernels"] is None else \
            act["kernels"] / n
        out["busy_share"] = act["busy"]
        out["profiled_ms_per_frame"] = act["wall_ms"] / n
    return out


def cluster_record(n_frames: int = 60, device="cuda",
                   graphs: bool = True) -> dict:
    """bench.py main_cluster's run and JSON record (its keys less
    vs_baseline, plus the card, its power limit, tf32, graphs, the stage
    times, syncs, row waits and kernels a frame, the card's busy share
    and the graph's captures). The gates are in the record's "gates"
    entry; main() exits 1 when one fails."""
    from slam_toolkit_tpu_torch.cluster.tracker import (DenseConfig,
                                                        FusedDenseTracker,
                                                        dense_frame)
    from slam_toolkit_tpu_torch.data.synthetic import make_cluster_scene
    from slam_toolkit_tpu_torch.pipeline.engine import full_float32
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    card, power = _card(device)
    n, warm = n_frames, CLUSTER_WARMUP
    t0 = time.perf_counter()
    scene = make_cluster_scene(n_frames=n)
    cfg = DenseConfig(max_points=CLUSTER_MAX_POINTS)
    _log(f"cluster scene of {n} frames in {time.perf_counter() - t0:.1f} s")
    staged = [tuple(torch.from_numpy(a).to(device) for a in fr)
              for fr in scene.frames]
    _sync(device)
    tr = FusedDenseTracker(scene.cam, cfg, queue_depth=2, device=device,
                           graphs=graphs)
    outs = []
    t0 = time.perf_counter()
    for i, (gl, gr) in enumerate(staged):
        o = tr.process(gl, gr)
        if o is not None:
            outs.append(o)
        if i == warm - 1:
            _sync(device)
            _log(f"cluster warm-up ({warm} frames) in "
                 f"{time.perf_counter() - t0:.1f} s")
            t_start = time.perf_counter()
    outs += tr.flush()
    _sync(device)
    fps = (n - warm) / (time.perf_counter() - t_start)
    persist, distinct, ids, alive = mover_persistence(outs, scene, n, cfg)
    live = sum(not o["skipped"] for o in outs)
    _log(f"cluster: {fps:.2f} fps, {live}/{n} live frames, {alive} "
         f"clusters alive, mover ids "
         f"{[v[0] if v else None for v in ids.values()]} "
         f"persist={persist} distinct={distinct}")
    q = cluster_quality(scene, cfg, device, (10, n // 2, n - 2))
    with torch.no_grad(), full_float32():
        args = [staged[2][0], staged[2][1], staged[1][0]]
        _sync(device)
        t0 = time.perf_counter()
        dense_frame(*args, scene.cam, cfg)
        _sync(device)
        dense_ms = 1000.0 * (time.perf_counter() - t0)
    stages = cluster_stage_ms(scene, cfg, device)
    counts = cluster_counts(scene, cfg, device, graphs=graphs)
    _log(f"cluster quality {q}; blocked dense_frame {dense_ms:.1f} ms; "
         f"stages {stages}; {counts}")
    gates = {"movers": persist and distinct,
             **{k: q[k] <= v for k, v in CLUSTER_GATES.items()}}
    return {
        "metric": "kitti_scale_dense_cluster_fps", "value": round(fps, 2),
        "unit": "frames/s",
        "disp_p95_px": round(q["disp_p95_px"], 3),
        "disp_gt3px_frac": round(q["disp_gt3px_frac"], 5),
        "flow_epe_p95_px": round(q["flow_epe_p95_px"], 3),
        "flow_gt3px_frac": round(q["flow_gt3px_frac"], 5),
        "dense_frame_ms": round(dense_ms, 1),
        "backend": f"torch-{device.type}", "card": card,
        "power_limit": power, "tf32": False, "graphs": tr.graphed,
        "captures": (tr.graph_stats() or {}).get("captures", 0),
        "frames": n,
        "live_frames": live, "clusters_alive": alive,
        "mover_ids": [v[0] if v else None for v in ids.values()],
        "stage_ms": {k: round(v, 2) for k, v in stages.items()},
        **{k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in counts.items()},
        "gates": gates}


def _loop_config(cfg):
    """BENCH_LOOP_GROUP (pose_graph_group) and BENCH_LOOP_OVER
    ("key=val,...": LoopConfig fields, numbers parsed by the field's
    type) applied to cfg.loop."""
    import dataclasses
    if os.environ.get("BENCH_LOOP_GROUP"):
        cfg = cfg.replace(loop=dataclasses.replace(
            cfg.loop, pose_graph_group=os.environ["BENCH_LOOP_GROUP"]))
    if os.environ.get("BENCH_LOOP_OVER"):
        over = {}
        for kv in os.environ["BENCH_LOOP_OVER"].split(","):
            k, v = kv.split("=")
            cur = getattr(cfg.loop, k)
            over[k] = type(cur)(float(v)) \
                if isinstance(cur, (int, float)) else v
        _log(f"loop overrides: {over}")
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, **over))
    return cfg


def dp_record(cfg, lanes: int = 4, mode: str = "lane", n_frames: int = 160,
              chunk: int = 16, device="cuda",
              cache: Optional[str] = None, graphs: bool = True,
              option: Optional[str] = None, stagger: int = 0) -> dict:
    """bench.py main_dp's record for B = `lanes` sequences in layout
    `mode` ("lane" or "vmap"), with the card, its power limit and the
    device work a frame; under option set `option` (None: none), lane b
    starting `stagger` * b frames into the track."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
    from slam_toolkit_tpu_torch.parallel import mesh
    from slam_toolkit_tpu_torch.utils.timing import device_activity
    if mode not in ("lane", "vmap"):
        raise ValueError(f"BENCH_DP_MODE={mode!r}: 'lane' or 'vmap'")
    if option is not None:
        cfg = with_option(cfg, option)
    device = torch.device(device)
    build_s = _build_kernels(device)
    card, power = _card(device)
    stacked, gt = stage_frames(cfg, n_frames + stagger * (lanes - 1),
                               HEADLINE_SEED, cache)
    cam = StereoCamera.from_config(cfg.camera, device)
    n_full = (n_frames - 1) // chunk * chunk
    if n_full < n_frames - 1:
        _log(f"dp: dropping {n_frames - 1 - n_full} tail frames (not a "
             f"full {chunk}-chunk)")

    def lanes_of(i: int, n: int) -> torch.Tensor:
        """Frames i .. i + n - 1 of every lane, (n, B, 2, H, W)."""
        a = np.stack([stacked[b * stagger + i:b * stagger + i + n]
                      for b in range(lanes)], axis=1)
        return torch.from_numpy(a).to(device, torch.float32)
    chunks = [lanes_of(i, chunk) for i in range(1, 1 + n_full, chunk)]
    first = lanes_of(0, 1)[0]                          # (B, 2, H, W)
    carry = mesh.batched_bootstrap(cfg, cam)(
        mesh.batched_empty_map(cfg, lanes, device), first[:, 0],
        first[:, 1])
    step = (mesh.multi_sequence_lane_chunk if mode == "lane"
            else mesh.multi_sequence_chunk)(cfg, cam, graphs=graphs)
    packs, act = [], None
    t0 = time.perf_counter()
    for i, c in enumerate(chunks[:WARMUP_CHUNKS]):
        if device.type == "cuda" and i == WARMUP_CHUNKS - 1:
            # the first DP_PROFILED frames of the last warm-up chunk under
            # the profiler (it slows the host several times over), a call
            # a frame: it records one iteration of a WHILE body a launch
            def frame_by_frame(carry):
                for k in range(DP_PROFILED):
                    carry, packed = step(carry, c[k:k + 1])
                    packs.append(packed)
                return carry
            carry, act = device_activity(frame_by_frame, carry)
            c = c[DP_PROFILED:]
        carry, packed = step(carry, c)
        packs.append(packed)
    _sync(device)
    _log(f"dp: warm-up ({WARMUP_CHUNKS} chunks, first uses) in "
         f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for c in chunks[WARMUP_CHUNKS:]:
        carry, packed = step(carry, c)
        packs.append(packed)
    _sync(device)
    dt = time.perf_counter() - t0
    n_timed = sum(int(c.shape[0]) for c in chunks[WARMUP_CHUNKS:])
    rows = torch.cat(packs).cpu().numpy()               # (N, B, 36)
    if not np.isfinite(rows).all():
        raise RuntimeError("non-finite DP engine output")
    traj0 = [rows[i, 0, :16].reshape(4, 4) for i in range(rows.shape[0])]
    ate = ate_rmse(traj0, gt[1:1 + len(traj0)], align=True)
    agg = lanes * n_timed / dt
    kfs = carry.m.kf_valid.sum(-1).cpu().tolist()
    _log(f"dp ({mode}): {n_timed} frames x {lanes} lanes in {dt:.2f} s, "
         f"{agg:.2f} aggregate fps ({n_timed / dt:.2f} a lane), lane-0 ATE "
         f"{ate:.3f} m, keyframes a lane {kfs}")
    per_frame = None if act is None or act["kernels"] is None else \
        act["kernels"] / DP_PROFILED
    return {
        "metric": f"kitti_scale_dp{lanes}_aggregate_fps",
        "value": round(agg, 2), "unit": "frames/s",
        "per_lane_fps": round(n_timed / dt, 2), "lanes": lanes,
        "dp_mode": mode, "graphs": graphs, "frames_timed": n_timed,
        "option": option, "stagger": stagger,
        "chunk": chunk,
        "ate_lane0_raw_m": round(ate, 3), "keyframes_per_lane": kfs,
        "kernels_per_frame": None if per_frame is None
        else round(per_frame, 1),
        "busy": None if act is None or act["busy"] is None
        else round(act["busy"], 4),
        "backend": f"torch-{device.type}", "card": card,
        "power_limit": power,
        "kernel_build_s": None if build_s is None else round(build_s, 2),
        "tf32": False}


def main() -> int:
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    cfg = SlamConfig()
    graphs = os.environ.get("BENCH_GRAPHS", "1") != "0"
    if os.environ.get("BENCH_CLUSTER"):
        out = cluster_record(int(os.environ.get("BENCH_FRAMES", "60")),
                             graphs=graphs)
        print(json.dumps(out))
        if not all(out["gates"].values()):
            _log(f"FAIL: cluster gates {out['gates']}")
            return 1
        return 0
    if os.environ.get("BENCH_DP"):
        # BENCH_TINY=1: SlamConfig.tiny(), a smoke test of the harness
        print(json.dumps(dp_record(
            SlamConfig.tiny() if os.environ.get("BENCH_TINY") else cfg,
            lanes=int(os.environ["BENCH_DP"]),
            mode=os.environ.get("BENCH_DP_MODE", "lane"),
            n_frames=int(os.environ.get("BENCH_FRAMES", "160")),
            chunk=int(os.environ.get("BENCH_CHUNK", "16")), graphs=graphs,
            option=os.environ.get("BENCH_OPTION") or None,
            stagger=int(os.environ.get("BENCH_DP_STAGGER", "0")))))
        return 0
    if os.environ.get("BENCH_LOOP"):
        print(json.dumps(loop_record(
            _loop_config(cfg),
            n_frames=int(os.environ.get("BENCH_FRAMES", "320")),
            chunk=int(os.environ.get("BENCH_CHUNK", "16")),
            track=os.environ.get("BENCH_LOOP_TRACK", "clothoid"),
            use_vocab=os.environ.get("BENCH_LOOP_VOCAB", "1") != "0",
            graphs=graphs)))
        return 0
    method = os.environ.get("BENCH_METHOD") or "indirect"
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, method=method))
    out = bench_record(
        cfg, n_frames=int(os.environ.get("BENCH_FRAMES", "160")),
        chunk=int(os.environ.get("BENCH_CHUNK", "16")),
        n_seeds=int(os.environ.get("BENCH_SEEDS", "3")),
        sweep_frames=int(os.environ.get("BENCH_SWEEP_FRAMES", "96")),
        graphs=graphs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
