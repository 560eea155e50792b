"""How far the headline's ATE moves under input changes far below one
intensity level.

    python -m slam_toolkit_tpu_torch.tools.ate_spread [--eps 1e-3] [--draws 6]
    python -m slam_toolkit_tpu_torch.tools.ate_spread --loop [--draws 5]
        [--draw D ...] [--device cpu] [--cache DIR]

Runs the bench's headline sequence (tools/bench.stage_frames: world seed
7, 0.8 m a frame, SlamConfig() at 1241x376) through the engine once as
it is (draw 0, the bench's own reading) and once per draw with uniform
noise in [-eps, eps] added to every pixel (draw d from
numpy.random.default_rng(d), the same array the JAX package's
port_reference/jax_f32_loop.py adds), and reports ATE and RPE of
trajectory_refined() for each. Tracking and mapping form a closed loop,
so a difference of rounding size (another backend's summation order or
matmul precision) can grow into another trajectory; the spread of these
runs is the band a single-seed ATE carries. Nothing is timed. Prints one
JSON line.

With --loop it does the same for the loop bench (BENCH_LOOP=1 of
tools/bench: the 320-frame clothoid of tools/bench.stage_loop_frames,
its cached vocabulary, chunks of 16, loop closing on): draw 0 and
--draws noisy draws (default 5), each run's ATE, seam (the mean distance
between both visits' camera centres of the re-driven poses), closures
(frame, candidate frame, inliers, loop-edge error against the ground
truth) and keyframes, each frame's tracking inliers and the keyframes'
frame numbers (where two runs of one draw part), and the medians of ATE
and seam over the noisy draws. The engine's schedule comes from
SLAM_QUEUE_DEPTH and SLAM_LOOP_THREAD, named in the output.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _check(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    return device


def _draw(frames: torch.Tensor, d: int, eps: float) -> torch.Tensor:
    """Draw d of the frames: as they are for d = 0, else with uniform
    noise in [-eps, eps] from numpy.random.default_rng(d) over the whole
    stack, made on the host in float32 and uploaded once. The JAX
    package's reading of the same draw (port_reference/jax_f32_loop.py
    --noise-seed d) adds the same numpy array."""
    if not d:
        return frames
    noise = np.random.default_rng(d).uniform(
        -eps, eps, tuple(frames.shape)).astype(np.float32)
    return frames + torch.from_numpy(noise).to(frames.device)


def _run(eng, frames: torch.Tensor, chunk: int):
    for i in range(0, frames.shape[0], chunk):
        eng.process_chunk(frames[i:i + chunk])
    return eng


def ate_spread(cfg, n_frames: int = 160, chunk: int = 16, eps: float = 1e-3,
               draws: int = 6, device="cuda",
               cache: Optional[str] = None) -> dict:
    """ATE, RPE and keyframes of draw 0 (the sequence as it is) and of
    `draws` noisy copies (draw d's noise from numpy seed d, `_draw`)."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse, rpe
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.tools.bench import HEADLINE_SEED, stage_frames
    device = _check(device)
    stacked, gt = stage_frames(cfg, n_frames, HEADLINE_SEED, cache)
    frames = torch.from_numpy(np.array(stacked)).to(device, torch.float32)
    runs = []
    for d in range(draws + 1):
        eng = _run(ChunkedSlamEngine(cfg, chunk_size=chunk, device=device),
                   _draw(frames, d, eps), chunk)
        traj = eng.trajectory_refined()
        runs.append({"draw": d, "ate_m": ate_rmse(traj, gt, align=True),
                     "rpe_t_m": rpe(traj, gt)[0],
                     "n_keyframes": eng.n_keyframes})
        sys.stderr.write(f"[ate_spread] {runs[-1]}\n")
    ates = [r["ate_m"] for r in runs]
    return {"seed": HEADLINE_SEED, "frames": n_frames, "eps": eps,
            "ate_min_m": min(ates), "ate_max_m": max(ates),
            "ate_median_m": float(np.median(ates)), "runs": runs}


def loop_spread(cfg, n_frames: int = 320, chunk: int = 16,
                eps: float = 1e-3, draws: int = 5, device="cuda",
                cache: Optional[str] = None,
                only: Optional[Sequence[int]] = None) -> dict:
    """ATE, seam, closures and keyframes of the loop bench's run on draw
    0 and on `draws` noisy copies (noise as ate_spread's), or on the
    draws listed in `only`, and their medians over the noisy draws."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.tools import bench
    device = _check(device)
    stacked, gt = bench.stage_loop_frames(cfg, n_frames, chunk, "clothoid",
                                          cache)
    vocab = bench.loop_vocabulary(cfg, stacked, bench.loop_cache_base(
        cfg, n_frames, chunk, "clothoid", cache) + ".vocab.txt", device)
    lap, revisit, _, _ = bench.loop_geometry(n_frames, chunk)
    frames = torch.from_numpy(np.array(stacked)).to(device, torch.float32)
    runs = []
    for d in (range(draws + 1) if only is None else only):
        eng = _run(ChunkedSlamEngine(cfg, vocab=vocab, chunk_size=chunk,
                                     device=device),
                   _draw(frames, d, eps), chunk)
        traj = eng.trajectory_refined()
        c = bench._centers(traj)
        runs.append({
            "draw": d, "ate_m": ate_rmse(traj, gt, align=True),
            "seam_m": float(np.mean(np.linalg.norm(
                c[lap:lap + revisit] - c[:revisit], axis=1))),
            "closures": [
                {"frame": e["frame"], "fid_cand": e["fid_cand"],
                 "inliers": e["inliers"],
                 "edge_err_m": bench.loop_edge_error(e, gt)[0]}
                for e in eng.loop_events if "cand" in e],
            "n_keyframes": eng.n_keyframes,
            "inliers": [r["inliers"] for r in eng.frame_stats],
            "keyframes": [r["frame"] for r in eng.frame_stats if r["kf"]]})
        sys.stderr.write(f"[ate_spread] {runs[-1]}\n")
    noisy = [r for r in runs if r["draw"]] or runs
    return {"track": "clothoid", "frames": n_frames, "eps": eps,
            "queue_depth": eng.queue_depth, "loop_thread": eng.loop_thread,
            "ate_median_m": float(np.median([r["ate_m"] for r in noisy])),
            "seam_median_m": float(np.median([r["seam_m"] for r in noisy])),
            "ate_min_m": min(r["ate_m"] for r in noisy),
            "ate_max_m": max(r["ate_m"] for r in noisy), "runs": runs}


def main() -> int:
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.tools.bench import _card
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loop", action="store_true",
                    help="the loop bench's clothoid instead of the headline")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames (default 160; 320 with --loop)")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--draws", type=int, default=None,
                    help="noisy draws (default 6; 5 with --loop)")
    ap.add_argument("--draw", type=int, action="append", default=None,
                    help="with --loop: run only this draw (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "path)")
    ap.add_argument("--cache", default=None,
                    help="frame cache directory (default: bench's)")
    args = ap.parse_args()
    if args.loop:
        out = loop_spread(SlamConfig(), args.frames or 320, eps=args.eps,
                          draws=5 if args.draws is None else args.draws,
                          device=args.device, cache=args.cache,
                          only=args.draw)
    else:
        out = ate_spread(SlamConfig(), args.frames or 160, eps=args.eps,
                         draws=6 if args.draws is None else args.draws,
                         device=args.device, cache=args.cache)
    out["card"], out["power_limit"] = _card(torch.device(args.device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
