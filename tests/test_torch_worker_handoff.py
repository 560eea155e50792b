"""The mapping worker's hand-offs with the main thread, on the CPU.

A threaded ChunkedSlamEngine (queue_depth=2, loop_thread=True) runs
tests/test_loop_e2e.py's circle world in the port's terms (SlamConfig.
tiny(), 72 frames with a blind window, a vocabulary trained on them;
test_torch_cuda._loop_world), chunks of 8, three times: in lockstep (the
worker drained after each chunk), free-running, and free-running with a
worker that lags a fold (each job starts only once the main thread has
folded the next chunk, or drains). The free-running runs are watched by
WorkerGuard, which holds them to the single-writer rule of the JAX
engine's mapping thread: a job reads no attribute of the host SlamEngine
or of the chunked engine that the main thread wrote after the job was
submitted, the main thread writes none that the running job has read,
and a job writes none but the stash and the pending measurements it owns;
writes the main thread makes while it serves a job's closure
(_MappingWorker.serve) are that job's hand-off. Each test is one hand-off
of scan_engine._MappingWorker's list that the CPU can show.
"""

import gc
import pathlib
import subprocess
import sys
import textwrap
import threading
from collections import deque

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.pipeline import scan_engine
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
from slam_toolkit_tpu_torch.utils import cuda_graphs, cuda_lib

from test_torch_cuda import _loop_world

torch.set_num_threads(1)
CHUNK = 8
TIMEOUT_S = 60.0


class WorkerGuard:
    """Watches objects (by a class swap) while a mapping worker runs jobs
    on `thread`: every attribute a job reads and every attribute the other
    threads write, item writes and reads of the arrays given to
    watch_array too. `violations` lists each break of the single-writer
    rule (see the module's note). The caller marks the jobs: submitted()
    in submit order, start() and end() around each on the worker, wait()
    while a job waits for its closure, and serving() around the main
    thread's service of closures."""

    def __init__(self, thread: threading.Thread):
        self.thread = thread
        self.lock = threading.RLock()
        self.clock = 0
        self.last_write: dict = {}     # name -> clock of its last write
        self.writes: list = []         # (clock, name) of every write
        self.submits: deque = deque()
        self.job = None                # {"submit", "reads", "waiting"}
        self.serving_depth = 0
        self.violations: list = []
        self.reads_seen: set = set()

    # ---- the watched objects
    def watch(self, obj, label: str, owned=()) -> None:
        guard, cls = self, type(obj)

        def getattribute(o, name):
            guard.read(f"{label}.{name}")
            return object.__getattribute__(o, name)

        def setattr_(o, name, value):
            guard.write(f"{label}.{name}", name in owned)
            cls.__setattr__(o, name, value)
        obj.__class__ = type(f"Watched{cls.__name__}", (cls,), {
            "__getattribute__": getattribute, "__setattr__": setattr_})

    def watch_array(self, arr: np.ndarray, label: str) -> np.ndarray:
        guard = self

        class Watched(np.ndarray):
            def __getitem__(a, idx):
                if a is target:
                    guard.read(f"{label}[{_key(idx)}]")
                return np.ndarray.__getitem__(a, idx)

            def __setitem__(a, idx, value):
                if a is target:
                    guard.write(f"{label}[{_key(idx)}]")
                np.ndarray.__setitem__(a, idx, value)
        target = arr.view(Watched)
        return target

    # ---- the jobs
    def submitted(self) -> None:
        with self.lock:
            self.submits.append(self.clock)

    def start(self) -> None:
        with self.lock:
            self.job = {"submit": self.submits.popleft(), "reads": set(),
                        "waiting": False}

    def end(self) -> None:
        with self.lock:
            self.job = None

    def wait(self, waiting: bool) -> None:
        with self.lock:
            if self.job is not None:
                self.job["waiting"] = waiting

    def serving(self, on: bool) -> None:
        with self.lock:
            self.serving_depth += 1 if on else -1

    # ---- the accesses
    def read(self, name: str) -> None:
        if threading.current_thread() is not self.thread:
            return
        with self.lock:
            job = self.job
            if job is None or job["waiting"]:
                return
            job["reads"].add(name)
            self.reads_seen.add(name)
            if self.last_write.get(name, -1) > job["submit"]:
                self.violations.append(
                    f"a job read {name}, written after its submission")

    def write(self, name: str, owned: bool = False) -> None:
        with self.lock:
            if threading.current_thread() is self.thread:
                if not owned and self.job is not None:
                    self.violations.append(f"a job wrote {name}")
                return
            if self.serving_depth:
                return                  # a closure the job waits for
            self.clock += 1
            self.last_write[name] = self.clock
            self.writes.append((self.clock, name))
            job = self.job
            if job is not None and not job["waiting"] and \
                    name in job["reads"]:
                self.violations.append(
                    f"{name} written while a job that read it ran")


def _key(idx):
    return int(idx) if isinstance(idx, (int, np.integer)) else repr(idx)


def _instrument(eng, lag: bool = False) -> dict:
    """Put a WorkerGuard on eng's host and eng itself (the stash and the
    pending measurements are the jobs'), its keyframe-frame mirror
    watched by item, and record: which threads reach the CUDA-graph
    machinery, where each close runs, and the BoW database's uses. With
    `lag`, each job starts only once the main thread has folded another
    chunk after the job's own, or drains."""
    w, h = eng._worker, eng._host
    rec = {"guard": WorkerGuard(w.thread), "closes": [], "bow": [],
           "graph_threads": set(), "folds": 0, "db_ptrs": _db_ptrs(h)}
    g = rec["guard"]
    cv, draining = threading.Condition(), threading.Event()
    job_folds: deque = deque()          # the folds done when each came
    orig_submit, orig_job = w.submit, eng._run_job

    def submit(kind, args):
        g.submitted()
        with cv:
            job_folds.append(rec["folds"])
        orig_submit(kind, args)

    def run_job(kind, args):
        if lag:
            fold = job_folds.popleft()
            with cv:
                cv.wait_for(lambda: rec["folds"] > fold or
                            draining.is_set(), TIMEOUT_S)
        g.start()
        try:
            orig_job(kind, args)
        finally:
            g.end()
    orig_fold = eng._loop_fold

    def loop_fold(packed_np, p):
        orig_fold(packed_np, p)
        with cv:
            rec["folds"] += 1
            cv.notify_all()

    orig_request, orig_serve, orig_drain = w.request_close, w.serve, w.drain

    def request_close(fn):
        g.wait(True)
        try:
            orig_request(fn)
        finally:
            g.wait(False)

    def serve():
        g.serving(True)
        try:
            orig_serve()
        finally:
            g.serving(False)

    def drain():
        draining.set()
        with cv:
            cv.notify_all()
        try:
            orig_drain()
        finally:
            draining.clear()

    orig_close = eng._apply_close

    def apply_close(*args):
        rec["closes"].append({
            "thread": threading.current_thread(),
            "job_waits": g.job is not None and g.job["waiting"],
            "outstanding": w.outstanding})
        return orig_close(*args)

    def bow_use(name, fn):
        def used(*args, **kw):
            rec["bow"].append((name, threading.current_thread(),
                               w.bow_lock.locked(), _db_ptrs(h)))
            return fn(*args, **kw)
        return used

    for name in ("_bow_register", "_bow_register_only", "_try_relocalize"):
        setattr(h, name, bow_use(name, getattr(h, name)))
    w.submit, w.request_close, w.serve, w.drain = (submit, request_close,
                                                   serve, drain)
    eng._run_job, eng._loop_fold, eng._apply_close = (run_job, loop_fold,
                                                      apply_close)
    eng._kf_fid_host = g.watch_array(eng._kf_fid_host, "engine._kf_fid_host")
    g.watch(h, "host")
    g.watch(eng, "engine", owned=("_loop_stash", "_closure_pend"))
    return rec


def _db_ptrs(h) -> tuple:
    buf = h._db_buf
    return tuple(t.data_ptr() for t in (buf if isinstance(buf, tuple)
                                        else (buf,)))


def _graph_spies(monkeypatch, seen: dict) -> None:
    """Record in seen["threads"] the threads that reach the conditional
    nodes' and the captures' machinery and cuda_lib's settling."""
    def spy(mod, name):
        orig = getattr(mod, name)

        def f(*a, **k):
            seen["threads"].add(threading.current_thread())
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, f)
    spy(scan_engine, "run_if")
    spy(scan_engine, "run_while")
    spy(cuda_graphs.StepGraphs, "capture")
    spy(cuda_graphs.StepGraphs, "_node")
    spy(cuda_lib, "settle")
    spy(cuda_lib, "mark_unsettled")


def _run(eng, arr, lockstep: bool = False) -> np.ndarray:
    rows = []
    for i in range(0, len(arr), CHUNK):
        rows.append(eng.process_chunk(arr[i:i + CHUNK]))
        if lockstep:
            eng._worker.drain()
    rows.append(eng.flush())
    return np.concatenate(rows)


def _closures(eng):
    return [(e["kf_slot"], e["cand"]) for e in eng.loop_events
            if "cand" in e]


@pytest.fixture(scope="module")
def runs():
    cfg, arr, voc = _loop_world()

    def engine():
        return ChunkedSlamEngine(cfg, vocab=voc, chunk_size=CHUNK,
                                 device="cpu", queue_depth=2,
                                 loop_thread=True)
    out = {}
    lock = engine()
    out["lockstep"] = (lock, _run(lock, arr, lockstep=True), None)
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        _graph_spies(mp, seen)
        for name, lag in (("free", False), ("lagged", True)):
            eng = engine()
            rec = _instrument(eng, lag)
            seen["threads"] = rec["graph_threads"]
            out[name] = (eng, _run(eng, arr), rec)
    return out


@pytest.mark.parametrize("name", ["free", "lagged"])
def test_jobs_read_no_mirror_written_after_submit(runs, name):
    """The host mirrors (frame ids, keyframe counts, the keyframe slots'
    frame ids) that the main thread writes at every fold: a job reads only
    the copy taken at its submission. Under a worker a fold behind
    (lagged), reading the live ones would break the rule at every job."""
    eng, _, rec = runs[name]
    g = rec["guard"]
    assert g.violations == []
    written = {n for _, n in g.writes}
    assert {"host.n_keyframes", "host.frame_id", "engine.n_keyframes"} \
        <= written
    assert not any(n.startswith("engine._kf_fid_host[") for n in
                   g.reads_seen)
    assert rec["folds"] == len(range(0, 72, CHUNK))
    w = eng._worker
    assert w.error is None and w.outstanding == 0 and not w.requests
    assert eng._closure_pend == [] and eng._loop_stash == []


def test_guard_sees_a_race():
    """WorkerGuard itself: a job that reads a mirror the main thread then
    writes, or writes after the job's submission and before its read, or
    a job's own write, is a violation; a write while the main thread
    serves the job's closure is not."""
    class Host:
        pass
    h = Host()
    h.n_keyframes = 0
    steps = [threading.Event() for _ in range(4)]
    worker = None

    def job():
        g.start()
        _ = h.n_keyframes                  # read, then the main writes
        steps[0].set()
        steps[1].wait(TIMEOUT_S)
        g.end()
        g.start()                          # submitted before the write
        _ = h.n_keyframes
        g.wait(True)
        steps[2].set()
        steps[3].wait(TIMEOUT_S)
        g.wait(False)
        _ = h.other                        # written while it waited
        h.n_keyframes = 1                  # a job's write
        g.end()
    worker = threading.Thread(target=job)
    g = WorkerGuard(worker)
    h.other = 0
    g.watch(h, "host")
    g.submitted()
    g.submitted()
    worker.start()
    steps[0].wait(TIMEOUT_S)
    h.n_keyframes = 2
    steps[1].set()
    steps[2].wait(TIMEOUT_S)
    g.serving(True)
    h.other = 3
    g.serving(False)
    steps[3].set()
    worker.join(TIMEOUT_S)
    assert not worker.is_alive()
    assert g.violations == [
        "host.n_keyframes written while a job that read it ran",
        "a job read host.n_keyframes, written after its submission",
        "a job wrote host.n_keyframes"]


def test_bow_database_in_place_under_lock(runs):
    """The BoW database: one buffer that every registration writes in
    place and nothing replaces (its address never moves, and `bow_db` is
    never assigned after the bootstrap), each use under the worker's
    bow_lock, on both threads."""
    for name in ("free", "lagged"):
        eng, _, rec = runs[name]
        uses = rec["bow"]
        assert {n for n, *_ in uses} >= {"_bow_register", "_try_relocalize"}
        assert all(locked for _, _, locked, _ in uses)
        assert {p for *_, p in uses} == {rec["db_ptrs"]}
        assert _db_ptrs(eng._host) == rec["db_ptrs"]
        # the bootstrap's one assignment (the first keyframe's row)
        assert [n for _, n in rec["guard"].writes].count("host.bow_db") == 1


def test_close_runs_on_main_with_worker_waiting(runs):
    """A closure runs on the main thread, while the job that decided it
    waits for it (request_close) or with the worker idle (a flush)."""
    for name in ("free", "lagged"):
        eng, _, rec = runs[name]
        assert rec["closes"], name
        for c in rec["closes"]:
            assert c["thread"] is threading.main_thread()
            assert c["job_waits"] or c["outstanding"] == 0, c
        assert eng.n_replays == len(rec["closes"])


def test_graph_machinery_only_on_main(runs):
    """The chunk's WHILE and IF machinery, captures and the settling of
    conditional bodies' launches are reached from the main thread alone:
    the worker's jobs replay only loop programs."""
    for name in ("free", "lagged"):
        eng, _, rec = runs[name]
        assert rec["graph_threads"] == {threading.main_thread()}
        assert eng._worker.thread not in rec["graph_threads"]


def test_free_running_rows_and_closures_match_lockstep(runs):
    """Free-running against lockstep: the rows returned before the first
    closure landed bit-equal, every closure one that lockstep took (slot
    and candidate), the same relocalizations."""
    lock, lock_rows, _ = runs["lockstep"]
    for name in ("free", "lagged"):
        eng, rows, _ = runs[name]
        first = min(eng.closures_landed[:1] + lock.closures_landed[:1]
                    + [len(lock_rows) + 2])
        n = first - 1
        assert n > 0
        np.testing.assert_array_equal(rows[:n], lock_rows[:n])
        assert _closures(eng) and set(_closures(eng)) <= \
            set(_closures(lock))
        assert [e for e in eng.loop_events if "reloc_to" in e] == \
            [e for e in lock.loop_events if "reloc_to" in e]


def test_worker_thread_ends_with_engine():
    """The worker's end: dropping the engine stops and joins its thread;
    an engine still alive when the interpreter exits is stopped at exit,
    before finalization (a thread that ran torch work and outlives it
    aborts the process)."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.loop import vocab as V
    cfg = SlamConfig.tiny()
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (9, 2, cfg.camera.height,
                                cfg.camera.width)).astype(np.float32)
    eng = ChunkedSlamEngine(cfg, vocab=V.synthesize(4, 3, seed=0),
                            chunk_size=4, device="cpu", queue_depth=2,
                            loop_thread=True)
    eng.process_chunk(imgs[:5])
    eng.process_chunk(imgs[5:])
    eng.flush()
    t = eng._worker.thread
    assert t.is_alive()
    del eng
    gc.collect()
    t.join(TIMEOUT_S)
    assert not t.is_alive()
    code = textwrap.dedent("""
        import numpy as np, torch
        from slam_toolkit_tpu_torch.config import SlamConfig
        from slam_toolkit_tpu_torch.loop import vocab as V
        from slam_toolkit_tpu_torch.pipeline.scan_engine import \\
            ChunkedSlamEngine
        torch.set_num_threads(1)
        cfg = SlamConfig.tiny()
        rng = np.random.default_rng(0)
        imgs = rng.uniform(0, 255, (9, 2, cfg.camera.height,
                                    cfg.camera.width)).astype(np.float32)
        eng = ChunkedSlamEngine(cfg, vocab=V.synthesize(4, 3, seed=0),
                                chunk_size=4, device="cpu", queue_depth=2,
                                loop_thread=True)
        eng.process_chunk(imgs[:5])
        eng.process_chunk(imgs[5:])
        eng.flush()
        print("ran", flush=True)
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert p.returncode == 0 and "ran" in p.stdout, p.stderr[-2000:]
