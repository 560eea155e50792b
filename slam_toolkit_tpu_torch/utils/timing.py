"""The program's tracer, device stamps and a profiler hook.

Counterpart of slam_toolkit_tpu/utils/timing.py. The reference's only
instrumentation is one steady_clock measurement around Track() (ref
src/pipeline.cpp:144,209-212). StreamStages is the program's one span
recorder: host spans on any thread and stream, without synchronising
them, and the card's clock read by stamps inside CUDA graphs (stamp),
on one clock. device_trace records a torch.profiler trace of a block;
device_activity reads one block's kernels, busy share and host CUDA
calls (graph launches among them) from torch.profiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import os
import threading
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from slam_toolkit_tpu_torch.utils import cuda_lib


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


# the stamp kernel (csrc/stamp.cu): dst, row (or null), base, width
_STAMP = cuda_lib.CudaKernel("slam_stamp", cuda_lib.PTR, cuda_lib.PTR,
                             ctypes.c_longlong, cuda_lib.INT)


def stamp(buf: torch.Tensor, base: int, row: Optional[torch.Tensor] = None,
          width: int = 0) -> None:
    """Write the clock, in nanoseconds, into the int64 slot base + row *
    width of `buf` (flat, contiguous), or slot base where `row` is None;
    `row` is a 0-dim int64 index on buf's device, read when the stamp
    runs. On a card: the stamp kernel on the current stream, which reads
    %globaltimer when it runs (a kernel node when captured, so a CUDA
    graph stamps every execution of a conditional body). On the CPU, the
    plain version: time.perf_counter_ns() now, the row read on the
    host."""
    if cuda_lib.on_cuda(buf):
        cuda_lib.check_cuda(buf, "stamp buffer", torch.int64, (None,))
        if row is not None:
            cuda_lib.check_cuda(row, "stamp row", torch.int64, (),
                                buf.device)
        _STAMP(buf.device, buf.data_ptr(),
               None if row is None else row.data_ptr(), base, width)
        return
    at = base if row is None else base + int(row) * width
    buf.view(-1)[at] = time.perf_counter_ns()


class Span(NamedTuple):
    """One span: its name and id, the id of the span that caused it and
    of the outermost one above it (its root: a chunk's, in the chunked
    engine), its thread, its host start and end on
    time.perf_counter_ns(), and the CUDA events at its ends (or
    None)."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: str
    start_ns: int
    end_ns: int
    events: Optional[tuple]


class StreamStages:
    """The program's tracer: spans on any thread and stream, and device
    stamps, on one clock, time.perf_counter_ns(); nothing synchronises
    while spans run, and nothing is written anywhere: the records stay in
    memory until asked for (summary, spans, export).

    A span (stage) records its name, an id, its parent (the span open
    on its thread, or the `cause` given: a span of another thread that
    caused it), its root, its thread and its host start and end; given a
    CUDA `device`, also a CUDA event on the current stream at each end.
    While torch.profiler records, a span is also a record_function
    range, so the profiler's trace names the program's spans beside the
    card's kernels.

    Device stamps (stamp) read the card's clock; sync_clock measures its
    offset from the host clock (the stamp launched between two host
    reads around a synchronise, the shortest of several round trips:
    offset from its midpoint, error half of it), at the tracer's start
    and whenever the owner asks again, so that drift shows.
    add_stamps maps a chunk's stamps to the host clock with the newest
    offset. Off a card the stamps are the host clock: offset 0, error 0.

    summary() gives per stage its count, host seconds and device
    milliseconds: the loop closer's fold stages read it
    (pipeline/engine.SlamEngine.stages); the chunked engine's spans and
    stamps go through the same recorder (ChunkedSlamEngine(trace=True))."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.lock = threading.Lock()
        self.records: List[Span] = []
        self.stamps: List[dict] = []
        self.clock: List[dict] = []
        self._ids = itertools.count(1)
        self._roots: Dict[int, int] = {}
        self._local = threading.local()
        self.sync_clock()

    def _stack(self) -> list:
        return self._local.__dict__.setdefault("stack", [])

    def current(self) -> Optional[int]:
        """The id of the innermost span open on this thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def stage(self, name: str, device=None, cause: Optional[int] = None):
        """A span named `name` around the block; yields its id. `cause`:
        the parent where no span is open on this thread."""
        stack = self._stack()
        parent = stack[-1] if stack else cause
        sid = next(self._ids)
        with self.lock:
            root = sid if parent is None else self._roots.get(parent,
                                                               parent)
            self._roots[sid] = root
        cuda = device is not None and torch.device(device).type == "cuda"
        ev = None
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(torch.cuda.current_stream(device))
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        stack.append(sid)
        t0 = time.perf_counter_ns()
        try:
            yield sid
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            if cuda:
                ev[1].record(torch.cuda.current_stream(device))
            if rf is not None:
                rf.__exit__(None, None, None)
            span = Span(name, sid, parent, root,
                        threading.current_thread().name, t0, t1, ev)
            with self.lock:
                self.records.append(span)

    def summary(self) -> Dict[str, dict]:
        """{stage: {"n", "host_s", "device_ms"}} in the order the stages
        first ended; device_ms is None for stages without events."""
        out: Dict[str, dict] = {}
        with self.lock:
            records = list(self.records)
        for s in records:
            r = out.setdefault(s.name, {"n": 0, "host_s": 0.0,
                                        "device_ms": None})
            r["n"] += 1
            r["host_s"] += (s.end_ns - s.start_ns) * 1e-9
            if s.events is not None:
                s.events[1].synchronize()
                r["device_ms"] = (r["device_ms"] or 0.0) + \
                    s.events[0].elapsed_time(s.events[1])
        return out

    def spans(self) -> List[Span]:
        """The spans that have ended, in the order they ended."""
        with self.lock:
            return list(self.records)

    def sync_clock(self, tries: int = 16) -> dict:
        """Measure the device clock's offset from the host clock (host =
        device - offset_ns) and its error, and keep it in `clock` with
        the host time it was taken at."""
        now = time.perf_counter_ns()
        if self.device is None or self.device.type != "cuda":
            rec = {"host_ns": now, "offset_ns": 0, "error_ns": 0}
        else:
            stream = torch.cuda.current_stream(self.device)
            buf = torch.zeros(tries, dtype=torch.int64, device=self.device)
            stream.synchronize()
            trips = []
            for k in range(tries):
                h0 = time.perf_counter_ns()
                stamp(buf, k)
                stream.synchronize()
                trips.append((h0, time.perf_counter_ns()))
            dev = buf.tolist()
            k = min(range(tries), key=lambda j: trips[j][1] - trips[j][0])
            h0, h1 = trips[k]
            rec = {"host_ns": (h0 + h1) // 2,
                   "offset_ns": dev[k] - (h0 + h1) // 2,
                   "error_ns": (h1 - h0) // 2}
        with self.lock:
            self.clock.append(rec)
        return rec

    def add_stamps(self, span: int, slots: Tuple[str, ...], graph,
                   frames) -> None:
        """A chunk's device stamps, read back: `graph` its (start, end)
        and `frames` its rows of stamps in `slots` order (0: not
        stamped), device clock; kept on the host clock, with the span
        that launched the chunk and its root."""
        off = self.clock[-1]["offset_ns"] if self.clock else 0

        def host(t):
            return None if t == 0 else int(t) - off
        with self.lock:
            self.stamps.append({
                "span": span, "root": self._roots.get(span, span),
                "slots": tuple(slots),
                "graph": tuple(host(t) for t in graph),
                "frames": [[host(t) for t in r] for r in frames]})

    def export(self) -> dict:
        """Everything recorded, as plain data on the host clock: "spans"
        (name, id, parent, root, thread, start_ns, end_ns, and device_ms
        where the span has events), "stamps" (add_stamps') and "clock"
        (sync_clock's readings)."""
        spans = []
        for s in self.spans():
            d = s._asdict()
            ev = d.pop("events")
            if ev is not None:
                ev[1].synchronize()
                d["device_ms"] = ev[0].elapsed_time(ev[1])
            spans.append(d)
        with self.lock:
            return {"spans": spans, "stamps": list(self.stamps),
                    "clock": list(self.clock)}


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
