"""The harness: finds a cell's parts by name, sets the port up, drives
the measured window, and assembles the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name BENCHMARK.json
gives it:

- a configuration: the `file` its BENCHMARK.json entry names (under
  configs/), holding the port's settings as run ("slam": SlamConfig's
  sections, "engine": the chunked engine's arguments);
- a traffic mix: traffic/<traffic>.json, read by feeder.Circuit;
- a cell's limits on the numbers `correct` compares: limits/<cell>.json;
- a per-layer metric: metrics/<name>.py, whose read(ctx) returns the
  metric or None where it finds nothing to read.

The drive: the traffic's drives (drive_laps laps of the circuit, each a
logged sequence run through a fresh engine), the first one's bootstrap
and warm-up chunks in set-up, then chunks of consecutive frames, each
handed to ChunkedSlamEngine.process_chunk once the last one's rows are
back, a new engine where a drive ends, until `seconds` have passed.
frames_per_s is the rows returned over the window's seconds, and
pose_latency_p95_ms the 95th percentile, over every frame the window
completed, of the time from its chunk being handed in to its row being
on the host (a new drive's engine and first captures count in its first
chunk). What the check reads of each drive is copied on the device when the
drive ends and to the host once the window has closed. With trace, the
per-layer metrics are read from a run of their own: the program's
counters around the window, NVML's utilization beside it, and a
torch.profiler sub-window after it, over a fresh drive's first lap.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent          # the benchmark's folder
REPO = ROOT.parent
CACHE = ROOT / ".cache"                         # the lap's render
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_toolkit_tpu")


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


# ---- finding a cell's parts by name -------------------------------------
def load_spec(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, cell: str, root: Path = ROOT,
            repo: Path = REPO) -> dict:
    """The cell's entry, its configuration file, its traffic file, its
    limits, and the metrics it reports (name -> entry) by trace mode."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def reports(m: dict) -> bool:
        return cell in m.get("workloads", [cell])

    return {
        "cell": w,
        "config": _json(repo / conf["file"]),
        "traffic": _json(root / "traffic" / f"{w['traffic']}.json"),
        "limits": _json(root / "limits" / f"{cell}.json"),
        "end_to_end": {m["name"]: m for m in spec["end_to_end"]
                       if reports(m)},
        "per_layer": {m["name"]: m for m in spec["per_layer"]
                      if reports(m)},
        "root": root,
    }


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """metrics/<name>.py's read(ctx)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is jax,
    jaxlib, flax or slam_toolkit_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by nearest rank over every value given."""
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def end_to_end(d: "Drive") -> dict:
    """The end-to-end readings of a window, by metric name."""
    ms = [1000.0 * x for x in d.latency_s]
    return {"frames_per_s": d.returned / d.window_s,
            "pose_latency_p95_ms": percentile(ms, 95),
            "setup_s": d.ctx["setup_s"]}


# ---- set-up ----------------------------------------------------------------
def slam_config(sections: dict):
    """The port's SlamConfig with every section's fields from a
    configuration file."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    base = SlamConfig()
    return dataclasses.replace(base, **{
        sec: dataclasses.replace(getattr(base, sec), **fields)
        for sec, fields in sections.items()})


class Setup:
    """What every run of a cell builds once: the port's configuration,
    the circuit's frames on the device and the kernels."""

    def __init__(self, parts: dict, device: str, cache: Path = CACHE):
        import torch
        self.parts = parts
        self.device = torch.device(device)
        self.cfg_doc = parts["config"]
        self.traffic = parts["traffic"]
        self.cfg = slam_config(self.cfg_doc["slam"])
        self.drive_frames = int(self.traffic["track"]["frames_per_lap"]) * \
            int(self.traffic["drive_laps"])
        from benchmark.feeder import Circuit
        self.circuit = Circuit(self.cfg_doc["slam"]["camera"], self.traffic,
                               cache, self.device, log=log)
        if self.device.type == "cuda":
            from slam_toolkit_tpu_torch.utils import cuda_lib
            cuda_lib.library()                  # nvcc, or the build cache

    def engine(self):
        from slam_toolkit_tpu_torch.pipeline.scan_engine import \
            ChunkedSlamEngine
        e = self.cfg_doc["engine"]
        return ChunkedSlamEngine(
            self.cfg, vocab=None, chunk_size=int(e["chunk_size"]),
            device=self.device, graphs=bool(e["graphs"]),
            queue_depth=int(e["queue_depth"]),
            loop_thread=bool(e["loop_thread"]))


# ---- the program's counters (read around the window, never inside) -------
def graph_counters(eng) -> dict:
    """Captures summed over the chunk's graphs and the keyframe, cull
    and loop programs' of the engine's mapping host, and the chunk's
    keyframe IF-body runs. The engine keeps these graph sets in private
    members; this reads them directly, so that a renamed member fails
    the run instead of reading nothing, and changes nothing. A graph set
    with nothing captured (off a card) reads None."""
    chunk = eng._chunk.graph_stats()
    parts = [chunk, eng._mapper.graph_stats(),
             eng._mapper.loop_graph_stats()]
    return {"captures": sum(p["captures"] for p in parts if p is not None),
            "keyframe_if_runs": None if chunk is None
            else chunk["if_runs"]["keyframe"]}


# ---- the drive --------------------------------------------------------------
MAP_FIELDS = ("kf_valid", "kf_frame_id", "kf_xy", "kf_desc", "kf_kpt_valid",
              "kf_right_x_norm", "kf_has_stereo", "mp_valid", "mp_ref_kf",
              "mp_kpt", "mp_invd")


class Session:
    """One drive of the traffic (one logged sequence: drive_laps laps
    from the lap's frame 0) through a fresh engine, and what the check
    reads of it."""

    def __init__(self, setup: "Setup", index: int, hook=None):
        self.index = index
        self.first = index * setup.drive_frames  # its frame 0 in the run
        self.eng = setup.engine()
        if hook is not None:
            self.eng = hook(self.eng)
        self.rows: Dict[int, np.ndarray] = {}
        self.states: Dict[int, dict] = {}       # device copies
        self.map: Optional[dict] = None         # device copies, at its end
        self.g = 0                               # its next frame
        self.window_first = None                 # its first window frame
        self.handed = self.returned = 0

    def keep_rows(self, rows) -> None:
        """Rows come back in frame order, one a frame but the bootstrap
        frame 0: the k-th row of the drive is frame k + 1's."""
        base = len(self.rows) + 1
        for i, r in enumerate(rows):
            self.rows[base + i] = r

    def end(self) -> None:
        """Copy on the device what the check reads of the engine's map,
        and free the engine: no host copy, no wait."""
        m = self.eng.map
        self.map = {f: getattr(m, f).clone() for f in MAP_FIELDS}
        self.eng = None


class Drive:
    """One run's window: its latencies, the sessions it drove, and what
    a traced run read."""

    def __init__(self):
        self.latency_s: List[float] = []        # one entry a frame
        self.sessions: List[Session] = []       # ended, in order
        self.handed = self.returned = 0
        self.window_s = 0.0
        self.chunks = 0
        self.ctx: dict = {}


def drive(setup: Setup, seed: int, seconds: float, trace: bool,
          t_start: float, hook=None, min_chunks: int = 1) -> Drive:
    """The set-up's first session and warm-up, then the window: chunks
    handed in one after another, a fresh session wherever a drive ends,
    until `seconds` have passed and at least min_chunks chunks ran. With
    trace, the program's counters and NVML are read over the window, and
    the profiler's sub-window follows it, so that neither the profiler
    nor its processing falls inside the window: profile_chunks chunks of
    a fresh drive, after its bootstrap chunk."""
    import torch

    from benchmark.check import STATE_FIELDS
    d = Drive()
    circ, chunk = setup.circuit, int(setup.cfg_doc["engine"]["chunk_size"])
    cuda = setup.device.type == "cuda"
    tr = setup.traffic.get("trace", {})
    counted = {"captures": 0, "keyframe_if_runs": 0}
    base: dict = {}

    def count(s: Session) -> None:
        """Add a session's graph work since `base` (its start if it
        started in the window) to the window's counts."""
        now = graph_counters(s.eng)
        was = base if s.index == 0 else {}
        for k in counted:
            counted[k] += (now[k] or 0) - (was.get(k) or 0)

    sess = Session(setup, 0, hook)
    for _ in range(int(setup.traffic["warmup_chunks"])):
        sess.keep_rows(sess.eng.process_chunk(
            circ.chunk(seed, sess.first + sess.g, chunk)))
        sess.g += chunk
    if cuda:
        torch.cuda.synchronize(setup.device)
    if trace:
        from benchmark.trace import NvmlSampler, ProfileWindow
        base = graph_counters(sess.eng)
        nvml = NvmlSampler(setup.device.index or 0,
                           int(tr.get("nvml_period_ms", 200))) \
            if cuda else None

    def step(counting: bool) -> float:
        """Hand in the next chunk (a new session where the drive ends);
        returns when its rows came back."""
        nonlocal sess
        t_new = None
        if sess.g + chunk > setup.drive_frames:      # the drive is over
            if counting:
                count(sess)
            sess.end()
            d.sessions.append(sess)
            t_new = time.perf_counter()
            sess = Session(setup, sess.index + 1, hook)
            sess.window_first = 0
        imgs = circ.chunk(seed, sess.first + sess.g, chunk)
        state = None if sess.eng.carry is None else \
            {f: getattr(sess.eng.carry, f).clone() for f in STATE_FIELDS}
        culls = sess.eng.n_culls
        t1 = time.perf_counter()
        rows = sess.eng.process_chunk(imgs)
        t2 = time.perf_counter()
        if state is not None and sess.eng.n_culls == culls:
            sess.states[sess.g] = state       # no cull rebuilt the snapshot
        n_in = chunk - (1 if sess.g == 0 else 0)  # the bootstrap frame
        sess.handed += n_in
        sess.returned += len(rows)
        d.handed += n_in
        d.returned += len(rows)
        sess.keep_rows(rows)
        # a new session's start (engine and first captures) counts in
        # its first chunk's latency
        d.latency_s += [t2 - (t1 if t_new is None else t_new)] * len(rows)
        sess.g += chunk
        d.chunks += 1
        return t2

    d.ctx["setup_s"] = time.perf_counter() - t_start
    t_w0 = time.perf_counter()
    sess.window_first = sess.g
    while True:
        t2 = step(trace)
        if t2 - t_w0 >= seconds and d.chunks >= min_chunks:
            break
    d.window_s = t2 - t_w0
    frames, chunks = d.returned, d.chunks
    d.ctx["chunk_ms"] = [1000.0 * x for x in d.latency_s[::chunk]]
    per_chunk = d.ctx["chunk_ms"]
    log(f"window: {d.chunks} chunks, {d.returned} frames, "
        f"{sess.index + 1} drive(s) in {d.window_s:.3f} s; chunk ms min "
        f"{min(per_chunk):.1f} median {float(np.median(per_chunk)):.1f} "
        f"max {max(per_chunk):.1f}; set-up {d.ctx['setup_s']:.2f} s")
    if trace:
        samples = nvml.stop() if nvml is not None else []
        count(sess)
        profile = {}
        if cuda:
            # a fresh drive, its bootstrap chunk (and captures) first: the
            # profiler over a drive's first lap (PERF.md)
            sess.end()
            d.sessions.append(sess)
            sess = Session(setup, sess.index + 1, hook)
            step(False)
            prof = ProfileWindow()
            prof.start()
            for _ in range(int(tr["profile_chunks"])):
                step(False)
            prof.stop()
            profile = prof.result()
        d.ctx.update(counted=counted,
                     nvml=[(t, u) for t, u in samples
                           if t_w0 <= t <= t_w0 + d.window_s],
                     profile=profile, chunks=chunks, frames=frames,
                     window_s=d.window_s, config=setup.cfg_doc["slam"],
                     card=torch.cuda.get_device_name(setup.device)
                     if cuda else None)
    sess.end()
    d.sessions.append(sess)
    return d


def artifacts(s: Session):
    """The check's host copy of a session that has ended, made once the
    window has closed."""
    from benchmark.check import Artifacts
    m = {f: v.cpu().numpy() for f, v in s.map.items()}
    slots = np.flatnonzero(m["kf_valid"])
    kf = {"slot": slots,
          "frame_id": m["kf_frame_id"][slots].astype(np.int64)}
    for name in ("xy", "desc", "kpt_valid", "right_x_norm", "has_stereo"):
        kf[name] = m["kf_" + name][slots]
    mv = m["mp_valid"]
    mp = {"ref_kf": m["mp_ref_kf"][mv], "kpt": m["mp_kpt"][mv],
          "invd": m["mp_invd"][mv]}
    return Artifacts(
        rows=s.rows, handed=s.handed, returned=s.returned,
        window=(s.window_first if s.window_first is not None else s.g, s.g),
        first=s.first,
        states={g: {k: v.cpu() for k, v in st.items()}
                for g, st in s.states.items()},
        keyframes=kf, mappoints=mp)


# ---- one run of a cell ------------------------------------------------------
def run(parts: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", cache: Path = CACHE,
        engine_hook: Optional[Callable] = None, min_chunks: int = 1) -> dict:
    """One run: the result line's object. engine_hook(engine) may wrap
    each session's engine (the tests plant faults with it)."""
    import torch
    setup = Setup(parts, device, cache)
    d = drive(setup, seed, seconds, trace, t_start, engine_hook, min_chunks)
    cuda = setup.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(setup.device)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(setup.device) if cuda
           else "cpu", "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
               setup.device)) if cuda else 0}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        prof = d.ctx.get("profile") or {}
        if prof:
            dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
        for name, entry in parts["per_layer"].items():
            v = metric_reader(name, parts["root"])(d.ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": entry["unit"]}
    else:
        values = end_to_end(d)
        for name, entry in parts["end_to_end"].items():
            metrics[name] = {"value": values[name], "unit": entry["unit"]}
    attempted, failed = d.handed, d.handed - d.returned
    sessions = [artifacts(s) for s in d.sessions]
    del d
    if cuda:
        torch.cuda.empty_cache()
    from benchmark.check import judge, verdict
    numbers = judge(sessions, setup.circuit, setup.cfg_doc, setup.traffic,
                    seed)
    correct, lines = verdict(numbers, parts["limits"])
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
        out["trace_note"] = (
            "torch.profiler records one iteration of each CUDA-graph WHILE "
            "launch (a chunk's first frame), so busy_s and device_ops "
            "undercount the chunk's device work by its other frames")
    out["numbers"] = {k: v for k, v in numbers.items() if k not in
                      parts["limits"]}
    out["checks"] = {name: {"value": v, "limit": f"{op} {b}"}
                     for name, v, op, b in lines}
    return out
