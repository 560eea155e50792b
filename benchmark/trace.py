"""What a traced run reads besides the program's counters: the card's
utilization from NVML, and a torch.profiler sub-window.

NvmlSampler runs `nvidia-smi` in its loop mode beside the window and
stamps each utilization.gpu sample with the host clock. ProfileWindow
reduces the profiler's events of its sub-window to the device's busy
seconds (the union of its kernels, copies and fills), the seconds and
launches of each kernel by name, the top device operations and the idle
gaps by what the host was doing. Under a CUDA-graph WHILE node the
profiler records one iteration of each launch, so the busy seconds
undercount the chunk's device work; the mean time of a recorded kernel
launch stays usable.
"""

from __future__ import annotations

import heapq
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SHORT_GAP_US = 20.0        # idle gaps shorter than this are summed apart
NAME_CHARS = 160           # operation names are cut to this length


class NvmlSampler:
    """utilization.gpu of one card every `period_ms`, as (host time,
    percent) pairs, from `nvidia-smi -lms`."""

    def __init__(self, index: int, period_ms: int = 100):
        self.samples: List[Tuple[float, float]] = []
        self._proc: Optional[subprocess.Popen] = None
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "-i", str(index),
                 "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", str(period_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                self.samples.append((time.perf_counter(),
                                     float(line.strip())))
            except ValueError:
                continue

    def stop(self) -> List[Tuple[float, float]]:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._thread.join(timeout=10)
            self._proc = None
        return self.samples


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events, t0_us: float, t1_us: float) -> dict:
    """The sub-window [t0_us, t1_us] (profiler clock, microseconds) of a
    profiler's events: busy seconds, window seconds, per kernel name
    [launches, seconds], the top device operations and the idle gaps
    summed by the innermost host event covering each gap's middle."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if tr.end < t0_us or tr.start > t1_us or e.name.startswith("bench."):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in dev:
        per_name[name][0] += 1
        per_name[name][1] += (b - a) * 1e-6
    busy = _merge([(max(a, t0_us), min(b, t1_us)) for _, a, b in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0_us] + [x for iv in busy for x in iv] + [t1_us]
    long_gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            gaps[f"gaps under {SHORT_GAP_US:g} us (between device ops)"] += \
                (b - a) * 1e-6
        else:
            long_gaps.append((0.5 * (a + b), (b - a) * 1e-6))
    # each long gap named by the shortest host event over its middle: a
    # sweep over the gaps' middles, the host events that have started
    # kept in a heap by their end
    host.sort(key=lambda h: h[1])
    active: list = []
    k = 0
    for mid, secs in sorted(long_gaps):
        while k < len(host) and host[k][1] <= mid:
            n, s0, e0 = host[k]
            heapq.heappush(active, (e0, s0, n))
            k += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = min(((e0 - s0, n) for e0, s0, n in active),
                    default=(0, "(no host event)"))[1]
        gaps[label] += secs
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (t1_us - t0_us) * 1e-6,
            "kernels": {k: list(v) for k, v in per_name.items()},
            "device_ops": [[n[:NAME_CHARS], v[1]] for n, v in top_ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in top_gaps]}


class ProfileWindow:
    """torch.profiler over a run of chunks: start(), stop() (each ending
    in a synchronise), then result(), the events inside the
    "bench.profiled_window" range reduced by reduce_events."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.__enter__()
        self._rf = torch.profiler.record_function("bench.profiled_window")
        self._rf.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def result(self) -> dict:
        events = self.prof.events()
        span = [e for e in events if e.name == "bench.profiled_window" and
                e.device_type == torch.autograd.DeviceType.CPU]
        if not span:
            return {}
        t0, t1 = span[0].time_range.start, span[0].time_range.end
        return reduce_events(events, t0, t1)
