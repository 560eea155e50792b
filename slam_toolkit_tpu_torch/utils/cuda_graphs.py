"""CUDA graphs of the engine's steps, with launch counts that count replays.

A CUDA graph records the kernels a step launches once, at its capture,
and then replays them with one host call and none of the Python that
launched them: the port's counterpart of the JAX package's jitted chunk
(pipeline/scan_engine.make_chunk_fn). A step is captured only after a
warm-up on a side stream (as torch.cuda.graphs asks): the warm-up makes
the step's first-call constants (lru_cached device tables), takes the
kernels' shared-memory attributes and creates the libraries' handles,
none of which may happen inside a capture. The warm-up runs the step for
real, so its caller hands it throwaway state.

A kernel wrapper counts its launches in Python (utils/cuda_lib
LaunchCount), so a capture would count launches that never ran and a
replay none that did. StepGraphs records each count's change over a
capture, takes it back, and adds it on every replay of that graph. The
warm-up's launches are set-up, as the kernels' build is: they are taken
back too and kept in `setup_launches`.

Graphs on one pool must replay in the order they were captured (a
later graph's outputs may sit in an earlier one's scratch memory).
Programs replayed in any order (the loop programs) take a pool each
(shared_pool=False).

run_if is the JAX programs' lax.cond(pred, body, identity) on a device
flag. Inside a capture it is a CUDA-graph IF node, added by the kernel
library (csrc/graph_cond.cu: a kernel that sets the node's condition
from the flag, the node, and the body captured into the node's child
graph from a stream of its own, its allocations routed to a private
pool); the torch this port runs on binds no conditional nodes. The body
runs at a replay only when the flag, read by the device, is set, so a
graph that branches needs no host read. Its plain
version, on the CPU and eagerly on a card, reads the flag on the host.
A body's results leave it only through copy_ into tensors allocated
before the node (a tensor it allocates holds stale memory after a
replay that skipped it). A body adds one to a device count of its
executions; its kernels' launches are counted per execution when a count
is read (utils/cuda_lib.settle), and its capture's are taken back. A
warm-up runs every body whatever its flag holds.

run_while is the JAX programs' lax.while_loop(cond, body) over state
written in place, and with it lax.scan over a chunk's frames (the frame
index a device counter the body advances, the inputs indexed by it and
the outputs written at it, pipeline/scan_engine._StaticChunk). Inside a
capture it is a CUDA-graph WHILE node (csrc/graph_cond.cu: the kernel
that sets the node's condition from the flag before the node, and again
as the body's last node), its body captured as an IF body is; a replay
then runs every iteration with no host call between them. A body's
execution count is its iterations. A body may hold IF nodes (the chunk's
keyframe event), up to MAX_DEPTH deep. Its plain version reads the flag
on the host before each iteration; a warm-up runs the body once.

A failed capture or replay raises, as does a refused conditional node
(CUDA before 12.4); nothing falls back to eager launches, to a replay an
iteration or to a flag read on the host.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

from slam_toolkit_tpu_torch.utils import cuda_lib

_LOCAL = threading.local()   # .capturing: the StepGraphs capturing, .warming
MAX_BODIES = 64              # conditional nodes in one graph
MAX_DEPTH = 4                # conditional nodes nested in their bodies
_RUNS_LOCK = threading.Lock()
# plain-version executions of run_if's and run_while's bodies, by name
# (callers reset it)
plain_runs: collections.Counter = collections.Counter()


def taken(pred: torch.Tensor) -> bool:
    """The plain version's reading of a flag: a host read (on a card a
    synchronisation)."""
    return bool(pred)


@functools.lru_cache(maxsize=None)
def _entries() -> dict:
    """The library's slam_if_begin(flag, body stream, stream),
    slam_if_end(body stream), slam_while_begin(flag, body stream, stream,
    &handle), slam_while_end(flag, handle, body stream) and
    slam_stream_create(&stream)."""
    lib = cuda_lib.library().cdll
    args = {"slam_if_begin": [cuda_lib.PTR] * 3,
            "slam_if_end": [cuda_lib.PTR],
            "slam_while_begin": [cuda_lib.PTR] * 3 + [
                ctypes.POINTER(ctypes.c_ulonglong)],
            "slam_while_end": [cuda_lib.PTR, ctypes.c_ulonglong,
                               cuda_lib.PTR],
            "slam_stream_create": [ctypes.POINTER(ctypes.c_void_p)]}
    out = {}
    for name, types in args.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, cuda_lib.INT
        out[name] = fn
    return out


def _body_streams(device: torch.device) -> list:
    """This thread's streams on `device` for conditional bodies, one a
    nesting depth (MAX_DEPTH): streams of their own, as one of torch's
    pool may be the very stream that captures; made once, before a
    capture (a thread captures one graph at a time)."""
    made = _LOCAL.__dict__.setdefault("streams", {})
    if device not in made:
        create = _entries()["slam_stream_create"]
        made[device] = []
        for _ in range(MAX_DEPTH):
            h = ctypes.c_void_p()
            _check(create(ctypes.byref(h)), "slam_stream_create")
            made[device].append(torch.cuda.ExternalStream(h.value,
                                                          device=device))
    return made[device]


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = cuda_lib.library().cdll.slam_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}); CUDA-graph "
                           "conditional nodes need CUDA 12.4 or later")


@contextlib.contextmanager
def _allocating_to(g: "StepGraphs", pool) -> None:
    """Route this thread's allocations to `pool` (a body's stream is not
    the capture's, so the capture's own routing misses it); held until
    `g` is gone, as a graph holds its pool."""
    dev = g.device.index if g.device.index is not None else \
        torch.cuda.current_device()
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev, pool)
    g._pool_holds[(dev, pool)] += 1
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(dev, pool)


def _release(holds) -> None:
    """Give back the body pools' holds (a graph's own pool is released
    with the graph)."""
    for (dev, pool), n in holds.items():
        for _ in range(n):
            torch._C._cuda_releasePool(dev, pool)


@contextlib.contextmanager
def warming():
    """A warm-up: every run_if body inside runs whatever its flag holds,
    and every run_while body once (its first-call constants and handles
    made outside any capture)."""
    prev = getattr(_LOCAL, "warming", False)
    _LOCAL.warming = True
    try:
        yield
    finally:
        _LOCAL.warming = prev


def run_if(pred: torch.Tensor, fn: Callable, *args, name: str = "if"
           ) -> None:
    """fn(*args) where the 0-dim bool tensor `pred` is set, as
    lax.cond(pred, fn, identity) for an fn that writes its results in
    place and returns nothing. Inside a StepGraphs capture, an IF node
    on `pred` whose body is fn (executions counted under `name`); in a
    StepGraphs warm-up, fn whatever `pred` holds; otherwise the plain
    version: fn when `pred`, read on the host, is set (counted in
    plain_runs[name])."""
    g = getattr(_LOCAL, "capturing", None)
    if g is not None:
        g._if_node(pred, fn, args, name)
    elif getattr(_LOCAL, "warming", False):
        fn(*args)
    elif taken(pred):
        with _RUNS_LOCK:
            plain_runs[name] += 1
        fn(*args)


def run_while(cond: torch.Tensor, fn: Callable, *args, name: str = "while"
              ) -> None:
    """fn(*args) for as long as the 0-dim bool tensor `cond` is set, as
    lax.while_loop(cond, fn, state) for an fn that writes its results,
    and the next value of `cond`, in place and returns nothing. Inside a
    StepGraphs capture, a WHILE node on `cond` whose body is fn
    (iterations counted under `name`); in a StepGraphs warm-up, fn once
    whatever `cond` holds; otherwise the plain version: fn while `cond`,
    read on the host before each iteration, is set (each iteration
    counted in plain_runs[name]).

    A graph launch runs all the iterations, so whatever the body draws
    from torch's generator (its graph-safe offset advances once a
    launch) would repeat every iteration: the bodies draw none (the
    engine's RANSAC draws are utils/threefry hashes of device counts)."""
    if not (torch.is_tensor(cond) and cond.dtype == torch.bool
            and cond.dim() == 0):
        raise ValueError(f"a WHILE node's flag is a 0-dim bool tensor, got "
                         f"{getattr(cond, 'dtype', type(cond).__name__)} "
                         f"{tuple(getattr(cond, 'shape', ()))}")
    g = getattr(_LOCAL, "capturing", None)
    if g is not None:
        g._while_node(cond, fn, args, name)
    elif getattr(_LOCAL, "warming", False):
        fn(*args)
    else:
        while taken(cond):
            with _RUNS_LOCK:
                plain_runs[name] += 1
            fn(*args)


class StepGraphs:
    """Named CUDA graphs on one device, captured once on one shared memory
    pool (or, with shared_pool=False, a pool each) and replayed by name.
    `captures` and `capture_s` (warm-up included) say what capturing
    cost, `graph_s` what each graph's capture cost with the warm-ups
    since the one before; `capture_threads` names the threads that
    captured."""

    def __init__(self, device, shared_pool: bool = True):
        self.device = torch.device(device)
        self.shared_pool = shared_pool
        self.pool = None
        self._pools: List = []
        self._graphs: Dict[str, tuple] = {}
        self._pool_of: Dict[str, tuple] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.graph_s: Dict[str, float] = {}
        self._warm_s = 0.0
        self.setup_launches: Dict[str, int] = {}
        self.capture_threads: set = set()
        self.replays: collections.Counter = collections.Counter()
        # conditional bodies: (name, executions, flag, {LaunchCount: n},
        # "if" or "while")
        self._bodies: List[tuple] = []
        # a memory pool for each nesting depth of bodies, held (its
        # begins counted) until this object is gone
        self._depth = 0
        self._body_pools: List = []
        self._pool_holds = collections.Counter()
        fin = weakref.finalize(self, _release, self._pool_holds)
        fin.atexit = False

    def warm_up(self, fn: Callable, *args) -> None:
        """fn(*args) once on a side stream, waited for, every run_if body
        in it run; its launches are not counted (see the module's
        note)."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with warming(), cuda_lib.counts_apart() as delta:
            with torch.cuda.stream(side):
                fn(*args)
            main.wait_stream(side)
            torch.cuda.synchronize(self.device)
        for c, n in delta.items():
            key = getattr(c, "symbol", type(c).__name__)
            self.setup_launches[key] = self.setup_launches.get(key, 0) + n
        dt = time.perf_counter() - t0
        self.capture_s += dt
        self._warm_s += dt

    def capture(self, name: str, fn: Callable, *args,
                error_mode: str = "global"):
        """Capture fn(*args) as graph `name`; returns fn's outputs, tensors
        of the pool that every replay writes anew. error_mode is
        torch.cuda.graph's capture_error_mode: "thread_local" lets other
        threads use the card meanwhile."""
        if name in self._graphs:
            raise RuntimeError(f"graph {name!r} is captured already")
        t0 = time.perf_counter()
        self.capture_threads.add(threading.current_thread().name)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected object
        # holding a CUDA graph destroys it, which a capturing stream
        # refuses (and the capture is lost)
        collecting = gc.isenabled()
        gc.disable()
        n_bodies = len(self._bodies)
        # the bodies' execution counts: memory of no graph pool, which a
        # replay rewrites wherever the capture reused a freed block
        self._runs = torch.zeros(MAX_BODIES, dtype=torch.int64,
                                 device=self.device)
        self._n_runs = 0
        self._streams = _body_streams(self.device)
        _LOCAL.capturing = self
        try:
            with cuda_lib.counts_apart() as delta:
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode=error_mode):
                    out = fn(*args)
        except BaseException:
            del self._bodies[n_bodies:]
            raise
        finally:
            _LOCAL.capturing = None
            if collecting:
                gc.enable()
        self._runs.zero_()
        for body in self._bodies[n_bodies:]:
            cuda_lib.defer(self, body[1], body[3])
        if self.shared_pool:
            if self.pool is None:
                self.pool = graph.pool()
                self._pools.append(self.pool)
            self._pool_of[name] = tuple(self.pool)
        else:
            self._pools.append(graph.pool())
            self._pool_of[name] = tuple(graph.pool())
        self._graphs[name] = (graph, dict(delta),
                              len(self._bodies) > n_bodies)
        self.captures += 1
        dt = time.perf_counter() - t0
        self.capture_s += dt
        self.graph_s[name] = self._warm_s + dt
        self._warm_s = 0.0
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._graphs

    def _if_node(self, pred: torch.Tensor, fn: Callable, args,
                 name: str) -> None:
        self._node("if", pred, fn, args, name)

    def _while_node(self, cond: torch.Tensor, fn: Callable, args,
                    name: str) -> None:
        self._node("while", cond, fn, args, name)

    def _node(self, kind: str, pred: torch.Tensor, fn: Callable, args,
              name: str) -> None:
        """run_if ("if") or run_while ("while") inside a capture: an IF or
        WHILE node on `pred` (csrc/graph_cond.cu), fn captured into its
        body on a stream of this nesting depth, its allocations routed to
        a pool of that depth, with one add to the body's execution count
        (an iteration's, for a WHILE node); the body's launches kept
        apart (cuda_lib.defer after the capture). The count is a slot of
        a buffer allocated before the capture."""
        what = kind.upper()
        if not (pred.is_cuda and pred.dtype == torch.bool
                and pred.numel() == 1):
            raise ValueError(f"an {what} node's flag is a one-element bool "
                             f"CUDA tensor, got {pred.dtype} "
                             f"{tuple(pred.shape)} on {pred.device}")
        lib, d = _entries(), self._depth
        if d == MAX_DEPTH:
            raise RuntimeError(f"conditional nodes nested deeper than "
                               f"{MAX_DEPTH}")
        if d == len(self._body_pools):
            self._body_pools.append(torch.cuda.graph_pool_handle())
            self._pools.append(self._body_pools[d])
        body, pool = self._streams[d], self._body_pools[d]
        if self._n_runs == MAX_BODIES:
            raise RuntimeError(f"more than {MAX_BODIES} conditional nodes "
                               "in a graph")
        runs = self._runs[self._n_runs]        # a slot of its own
        self._n_runs += 1
        stream = torch.cuda.current_stream(self.device)
        handle = ctypes.c_ulonglong()
        if kind == "if":
            err = lib["slam_if_begin"](pred.data_ptr(), body.cuda_stream,
                                       stream.cuda_stream)
        else:
            err = lib["slam_while_begin"](pred.data_ptr(), body.cuda_stream,
                                          stream.cuda_stream,
                                          ctypes.byref(handle))
        _check(err, f"slam_{kind}_begin")
        self._depth += 1
        try:
            with torch.cuda.stream(body), _allocating_to(self, pool):
                with cuda_lib.counts_apart() as delta:
                    fn(*args)
                runs.add_(1)
        finally:
            self._depth -= 1
            if kind == "if":
                err = lib["slam_if_end"](body.cuda_stream)
            else:                  # the flag's kernel: the body's last node
                err = lib["slam_while_end"](pred.data_ptr(), handle.value,
                                            body.cuda_stream)
        _check(err, f"slam_{kind}_end")
        # the flag lives as long as the graph
        self._bodies.append((name, runs, pred, dict(delta), kind))

    def replay(self, name: str) -> None:
        graph, delta, bodies = self._graphs[name]
        graph.replay()
        self.replays[name] += 1
        for c, n in delta.items():
            c.add(n)
        if bodies:
            cuda_lib.mark_unsettled(self)

    def executions(self) -> Dict[str, Dict[str, int]]:
        """Executions of the graphs' conditional bodies since their
        capture (a WHILE body's iterations), by kind ("if", "while") and
        name (bodies of one name summed): one synchronise and one
        readback."""
        out: Dict[str, Dict[str, int]] = {"if": {}, "while": {}}
        if not self._bodies:
            return out
        torch.cuda.synchronize(self.device)
        got = torch.stack([b[1] for b in self._bodies]).tolist()
        for b, n in zip(self._bodies, got):
            out[b[4]][b[0]] = out[b[4]].get(b[0], 0) + n
        return out

    def pool_bytes(self, names=None) -> Optional[int]:
        """Bytes the caching allocator holds in the graphs' pools (those of
        graphs `names`, default all), or None where its snapshot names no
        pool."""
        if not self._pools:
            return 0
        segs = torch.cuda.memory_snapshot()
        if not any("segment_pool_id" in s for s in segs):
            return None
        pools = {tuple(p) for p in self._pools} if names is None else \
            {self._pool_of[n] for n in names}
        return sum(s["total_size"] for s in segs
                   if tuple(s.get("segment_pool_id", ())) in pools)

    def stats(self) -> dict:
        """Captures, capture seconds, pool bytes, set-up launches,
        capturing threads, graph launches by graph name ("replays"), IF
        nodes ("if_nodes") with their bodies' executions by name
        ("if_runs"), and WHILE nodes ("while_nodes") with their bodies'
        iterations by name ("while_runs")."""
        runs = self.executions()
        return {"captures": self.captures, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes(),
                "setup_launches": dict(self.setup_launches),
                "capture_threads": sorted(self.capture_threads),
                "replays": dict(self.replays),
                "if_nodes": sum(b[4] == "if" for b in self._bodies),
                "if_runs": runs["if"],
                "while_nodes": sum(b[4] == "while" for b in self._bodies),
                "while_runs": runs["while"]}


def merged_stats(graphs) -> Optional[dict]:
    """One stats dict over several StepGraphs (None entries and sets with
    no capture left out): captures, seconds, pool bytes and nodes summed
    (pool bytes None if any is unknown), set-up launches, replays, body
    runs and capturing threads merged; None where nothing was
    captured."""
    parts = [g.stats() for g in graphs if g is not None and g.captures]
    if not parts:
        return None
    pools = [p["pool_bytes"] for p in parts]
    merged = {k: collections.Counter() for k in
              ("setup_launches", "replays", "if_runs", "while_runs")}
    for p in parts:
        for k, c in merged.items():
            c.update(p[k])
    return {"captures": sum(p["captures"] for p in parts),
            "capture_s": sum(p["capture_s"] for p in parts),
            "pool_bytes": None if None in pools else sum(pools),
            **{k: dict(c) for k, c in merged.items()},
            "capture_threads": sorted({t for p in parts
                                       for t in p["capture_threads"]}),
            "if_nodes": sum(p["if_nodes"] for p in parts),
            "while_nodes": sum(p["while_nodes"] for p in parts)}
