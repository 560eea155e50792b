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
later graph's outputs may sit in an earlier one's scratch memory), as
the chunk's two graphs do. Programs replayed in any order (the loop
programs) take a pool each (shared_pool=False).

A failed capture or replay raises; nothing falls back to eager launches.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from slam_toolkit_tpu_torch.utils import cuda_lib


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

    def warm_up(self, fn: Callable, *args) -> None:
        """fn(*args) once on a side stream, waited for; its launches are
        not counted (see the module's note)."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with cuda_lib.counts_apart() as delta:
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
        try:
            with cuda_lib.counts_apart() as delta:
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode=error_mode):
                    out = fn(*args)
        finally:
            if collecting:
                gc.enable()
        if self.shared_pool:
            if self.pool is None:
                self.pool = graph.pool()
                self._pools.append(self.pool)
            self._pool_of[name] = tuple(self.pool)
        else:
            self._pools.append(graph.pool())
            self._pool_of[name] = tuple(graph.pool())
        self._graphs[name] = (graph, dict(delta))
        self.captures += 1
        dt = time.perf_counter() - t0
        self.capture_s += dt
        self.graph_s[name] = self._warm_s + dt
        self._warm_s = 0.0
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._graphs

    def replay(self, name: str) -> None:
        graph, delta = self._graphs[name]
        graph.replay()
        for c, n in delta.items():
            c.add(n)

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
        return {"captures": self.captures, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes(),
                "setup_launches": dict(self.setup_launches),
                "capture_threads": sorted(self.capture_threads)}


def merged_stats(graphs) -> Optional[dict]:
    """One stats dict over several StepGraphs (None entries and sets with
    no capture left out): captures, seconds and pool bytes summed (None if
    any is unknown), set-up launches and capturing threads merged; None
    where nothing was captured."""
    parts = [g.stats() for g in graphs if g is not None and g.captures]
    if not parts:
        return None
    pools = [p["pool_bytes"] for p in parts]
    setup: Dict[str, int] = {}
    for p in parts:
        for k, n in p["setup_launches"].items():
            setup[k] = setup.get(k, 0) + n
    return {"captures": sum(p["captures"] for p in parts),
            "capture_s": sum(p["capture_s"] for p in parts),
            "pool_bytes": None if None in pools else sum(pools),
            "setup_launches": setup,
            "capture_threads": sorted({t for p in parts
                                       for t in p["capture_threads"]})}
