"""Per-stage timing and a profiler hook.

Counterpart of slam_toolkit_tpu/utils/timing.py. The reference's only
instrumentation is one steady_clock measurement around Track() (ref
src/pipeline.cpp:144,209-212). StageTimer ends each stage by waiting
for the card (torch.cuda.synchronize on every device its result's
tensors live on), so a stage's wall-clock time includes its queued
device work; device_trace records a torch.profiler trace of a block. StreamStages
times stages on any thread and stream without synchronising them.
device_activity reads one block's kernels, busy share and host CUDA
calls (graph launches among them) from torch.profiler.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter, defaultdict
from typing import Dict, List

import torch


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists,
    dicts and NamedTuples."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the device work behind every CUDA tensor in `tree`;
    returns `tree`."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a block; put its result in the yielded list to have the
        stage wait for that result's device work."""
        t0 = time.perf_counter()
        box: List = []
        yield box
        if self.sync and box:
            block_until_ready(box[0])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time_stage(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.sync:
            block_until_ready(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {1000*tot/max(n,1):9.2f} ms/call "
                         f"x{n:5d} = {tot:7.2f} s")
        return "\n".join(lines)


class StreamStages:
    """Host and device time of named stages that run on any thread and
    stream, without a synchronisation while they run: each stage records
    the host clock and, on a card, a CUDA event on the current stream at
    its start and end. summary() waits for the events and gives per stage
    the count, the host seconds and the device milliseconds between each
    pair of events (the stage's stream's time, a wait on another stream
    included). The loop closer's fold stages read it
    (pipeline/engine.SlamEngine.stages)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: List[tuple] = []   # (name, host s, start, end)

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        cuda = device is not None and torch.device(device).type == "cuda"
        ev = None
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host = time.perf_counter() - t0
            if cuda:
                ev[1].record(torch.cuda.current_stream(device))
            with self.lock:
                self.records.append((name, host, ev))

    def summary(self) -> Dict[str, dict]:
        """{stage: {"n", "host_s", "device_ms"}} in the order the stages
        first ran; device_ms is None off a card."""
        out: Dict[str, dict] = {}
        with self.lock:
            records = list(self.records)
        for name, host, ev in records:
            r = out.setdefault(name, {"n": 0, "host_s": 0.0,
                                      "device_ms": None})
            r["n"] += 1
            r["host_s"] += host
            if ev is not None:
                ev[1].synchronize()
                r["device_ms"] = (r["device_ms"] or 0.0) + \
                    ev[0].elapsed_time(ev[1])
        return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of a block (the host, and the card when there
    is one), written to <logdir>/trace.json for chrome://tracing or
    Perfetto; yields the profiler (key_averages() for a table)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def count_syncs(fn, *args, **kw):
    """(fn's result, the host synchronisations it made on the card): the
    operations CUDA's sync debug mode reports (a read of a device value,
    a copy from pageable memory, a synchronize). 0 off the card."""
    import warnings
    if not torch.cuda.is_available():
        return fn(*args, **kw), 0
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    # torch's own note that the mode is a prototype ("... does not yet
    # detect all synchronizing operations", once a process) is no sync
    return out, sum("called a synchronizing" in str(w.message)
                    for w in seen)


# the host's CUDA runtime calls that put work on the card or wait for it
API_KINDS = (("graph launches", ("cudaGraphLaunch",)),
             ("kernel launches", ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchCooperativeKernel")),
             ("copies", ("cudaMemcpy", "cudaMemset", "cuMemcpy")),
             ("syncs", ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize")))


def api_kind(name: str):
    """The API_KINDS kind of a host event's name, or None."""
    for kind, prefixes in API_KINDS:
        if name.startswith(prefixes):
            return kind
    return None


def device_activity(fn, *args, **kw):
    """(fn's result, {"kernels", "device_ms", "wall_ms", "busy",
    "host_calls", "graph_launches"}): the card's work in one
    torch.profiler pass over fn (kernels, copies and fills), their summed
    device time, the host wall time of the pass (ending in a
    synchronise), the busy share device_ms / wall_ms, and the host's CUDA
    calls of API_KINDS in the pass (the final synchronise included), CUDA
    graph launches among them. The device counts are None where the
    profiler saw no device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        wall = 1000.0 * (time.perf_counter() - t0)
    dev, api = [], Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        else:
            api[api_kind(e.name)] += 1
    calls = {"host_calls": sum(n for k, n in api.items() if k),
             "graph_launches": api["graph launches"]}
    if not dev:
        return out, {"kernels": None, "device_ms": None, "wall_ms": wall,
                     "busy": None, **calls}
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1000.0
    return out, {"kernels": len(dev), "device_ms": busy, "wall_ms": wall,
                 "busy": busy / wall, **calls}
