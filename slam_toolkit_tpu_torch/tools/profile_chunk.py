"""Where a chunk's time goes on the card: torch.profiler over one steady
chunk of the main path, of the same frames with the fused FAST kernel
(ExtractorConfig.fused_fast) and with the hybrid tracker, each run eager
(make_frame_body, graphs=False) and graphed (scan_engine.make_chunk_fn's
CUDA graphs, the default).

    python -m slam_toolkit_tpu_torch.tools.profile_chunk [--frames 48]

Takes the bench's synthetic straight track (tools/bench.stage_frames:
world seed 7, +0.8 m/frame, SlamConfig() at 1241x376, mapped from the
bench's frame cache when it is there), runs chunks of 16 frames and
profiles the last chunk of each configuration and mode (the graphs are
captured in the first chunk, outside the profiled one). Prints, per
configuration, the eager and the graphed column: the chunk's wall time
(host clock, ending in a synchronize), the device time summed over its
kernels and copies, the device busy share, kernels per frame,
host-to-device copies, and the host's CUDA API calls per frame that put
work on the card or wait for it (kernel launches, graph launches,
copies, synchronisations), each kind counted; then the kernels that
take the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from collections import Counter, defaultdict

import torch

# the host's CUDA runtime calls that put work on the card or wait for it
API_KINDS = (("graph launches", ("cudaGraphLaunch",)),
             ("kernel launches", ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchCooperativeKernel")),
             ("copies", ("cudaMemcpy", "cudaMemset", "cuMemcpy")),
             ("syncs", ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize")))


def api_kind(name: str):
    for kind, prefixes in API_KINDS:
        if name.startswith(prefixes):
            return kind
    return None


def profile(cfg, frames, chunk: int = 16, top: int = 12,
            graphs: bool = True) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    eng = ChunkedSlamEngine(cfg, chunk_size=chunk, device="cuda",
                            graphs=graphs)
    starts = list(range(0, len(frames), chunk))
    for i in starts[:-1]:
        eng.process_chunk(frames[i:i + chunk])
    torch.cuda.synchronize()
    last = frames[starts[-1]:]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.process_chunk(last)
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
    return {"frames": n, "wall_ms": wall_ms, "device_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms,
            "kernels_per_frame": n_kernels / n, "h2d_copies": n_h2d,
            "api_per_frame": sum(api.values()) / n,
            "api_kinds_per_frame": {k: round(v / n, 2)
                                    for k, v in sorted(api.items())},
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
    fused = cfg.replace(extractor=dataclasses.replace(cfg.extractor,
                                                      fused_fast=True))
    hybrid = cfg.replace(tracker=dataclasses.replace(cfg.tracker,
                                                     method="hybrid"))
    for name, c in (("main path", cfg), ("fused_fast", fused),
                    ("hybrid", hybrid)):
        runs = {mode: profile(c, frames, graphs=mode == "graphed")
                for mode in ("eager", "graphed")}
        for mode, r in runs.items():
            print(f"[{card}] {name}, {mode}: last chunk of {r['frames']} "
                  f"frames, wall {r['wall_ms']:.1f} ms, device "
                  f"{r['device_ms']:.1f} ms, busy "
                  f"{100 * r['busy_share']:.1f}%, "
                  f"{r['kernels_per_frame']:.0f} kernels a frame, "
                  f"{r['h2d_copies']} host-to-device copies, "
                  f"{r['api_per_frame']:.1f} host CUDA calls a frame "
                  f"{r['api_kinds_per_frame']}"
                  + (f", graphs {r['graph_stats']}" if r["graph_stats"]
                     else ""))
        for mode, r in runs.items():
            print(f"    {mode}, top kernels:")
            for kname, count, ms in r["top"]:
                print(f"    {ms:9.3f} ms {count:6d}x  {kname}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
