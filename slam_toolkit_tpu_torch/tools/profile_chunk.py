"""Where a chunk's time goes on the card: torch.profiler over one steady
chunk of the main path and of the same frames with the hybrid tracker,
each run eager (make_frame_body, graphs=False) and graphed
(scan_engine.make_chunk_fn's one CUDA graph a chunk, the default).

    python -m slam_toolkit_tpu_torch.tools.profile_chunk [--frames 48]

Takes the bench's synthetic straight track (tools/bench.stage_frames:
world seed 7, +0.8 m/frame, SlamConfig() at 1241x376, mapped from the
bench's frame cache when it is there), runs chunks of 16 frames and
profiles the last chunk of each configuration and mode (the graphs are
captured in the first chunk, outside the profiled one); graphed, that
chunk runs a frame a call, as torch.profiler records one iteration of a
WHILE body a graph launch. Prints, per configuration, the eager and the
graphed column: the profiled chunk's wall time (host clock, ending in a
synchronize), the device time summed over its kernels and copies, the
device busy share, the chunk before it timed in one call without the
profiler and its busy share at the profiled device time a frame,
kernels per frame, host-to-device copies, and the host's CUDA API calls
that put work on the card or wait for it (kernel launches, graph
launches, copies, synchronisations; utils/timing.API_KINDS), a chunk
call's and a frame's at chunks of 16, with the graph launches a chunk
call (one, graphed); then the kernels that take the most device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from collections import Counter, defaultdict

import torch

CHUNK = 16                     # frames a chunk


def profile(cfg, frames, chunk: int = CHUNK, top: int = 12,
            graphs: bool = True) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils.timing import api_kind
    eng = ChunkedSlamEngine(cfg, chunk_size=chunk, device="cuda",
                            graphs=graphs)
    starts = list(range(0, len(frames), chunk))
    for i in starts[:-2]:
        eng.process_chunk(frames[i:i + chunk])
    torch.cuda.synchronize()
    steady = frames[starts[-2]:starts[-2] + chunk]
    t0 = time.perf_counter()
    eng.process_chunk(steady)              # no profiler: its wall alone
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    last = frames[starts[-1]:]
    # graphed, a call a frame: the profiler records one iteration of a
    # WHILE body a graph launch, so a chunk of one frame is all of it
    calls = [last[k:k + 1] for k in range(len(last))] if graphs else [last]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in calls:
            eng.process_chunk(c)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0, 0.0])
    api = Counter()
    n_kernels = n_h2d = 0
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            kind = api_kind(e.name)
            if kind:
                api[kind] += 1
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        by_name[e.name][0] += 1
        by_name[e.name][1] += us
        if "HtoD" in e.name:
            n_h2d += 1
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            n_kernels += 1
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    n = len(last)
    # a chunk call's host calls do not grow with its frames: a frame's
    # share at `chunk` frames a call
    per_call = {k: v / len(calls) for k, v in api.items()}
    per_frame = len(steady) if graphs else n
    return {"frames": n, "calls": len(calls), "wall_ms": wall_ms,
            "device_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms,
            "steady_frames": len(steady), "steady_ms": chunk_ms,
            "steady_busy": busy_us / 1e3 / n * len(steady) / chunk_ms,
            "kernels_per_frame": n_kernels / n, "h2d_copies": n_h2d,
            "api_per_frame": sum(per_call.values()) / per_frame,
            "api_per_chunk": sum(per_call.values()),
            "graph_launches": per_call.get("graph launches", 0),
            "api_kinds_per_frame": {k: round(v / per_frame, 3)
                                    for k, v in sorted(per_call.items())},
            "graph_stats": eng._chunk.graph_stats() if graphs else None,
            "top": [(name[:70], c, us / 1e3) for name, (c, us) in tops]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_chunk: needs a CUDA device")
    from slam_toolkit_tpu_torch.config import SlamConfig
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    from slam_toolkit_tpu_torch.tools.bench import stage_frames
    cfg = SlamConfig()
    frames, _ = stage_frames(cfg, args.frames)
    hybrid = cfg.replace(tracker=dataclasses.replace(cfg.tracker,
                                                     method="hybrid"))
    for name, c in (("main path", cfg), ("hybrid", hybrid)):
        runs = {mode: profile(c, frames, chunk=CHUNK,
                              graphs=mode == "graphed")
                for mode in ("eager", "graphed")}
        for mode, r in runs.items():
            print(f"[{card}] {name}, {mode}: last chunk of {r['frames']} "
                  f"frames in {r['calls']} call(s), wall {r['wall_ms']:.1f} "
                  f"ms, device {r['device_ms']:.1f} ms, busy "
                  f"{100 * r['busy_share']:.1f}%; the chunk before "
                  f"({r['steady_frames']} frames, one call, no profiler) "
                  f"{r['steady_ms']:.1f} ms, busy at this device time a "
                  f"frame {100 * r['steady_busy']:.1f}%; "
                  f"{r['kernels_per_frame']:.0f} kernels a frame, "
                  f"{r['h2d_copies']} host-to-device copies, "
                  f"{r['api_per_frame']:.2f} host CUDA calls a frame at "
                  f"chunks of {CHUNK} "
                  f"{r['api_kinds_per_frame']} ({r['api_per_chunk']:.2f} a "
                  f"chunk call, {r['graph_launches']:.2f} graph launches a "
                  f"chunk call)"
                  + (f", graphs {r['graph_stats']}" if r["graph_stats"]
                     else ""))
        for mode, r in runs.items():
            print(f"    {mode}, top kernels:")
            for kname, count, ms in r["top"]:
                print(f"    {ms:9.3f} ms {count:6d}x  {kname}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
