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
  metric or None where it finds nothing to read;
- a configuration's vocabulary (loop closing): its optional "vocabulary"
  recipe, built in set-up from the lap's noise-free left frames by the
  benchmark's own extractor and trainer (reference/), cached under
  .cache/ and handed to the engine through the port's loop.vocab.load;
- a configuration's own checks: its optional "checks" list names
  checks/<name>.py modules, whose hooks keep device copies of what they
  need (after_chunk(engine, g) after a call in which a closure landed
  or a relocalization ran, at_end(engine) when a drive ends) and whose
  numbers(sessions, circuit, cfg_doc, traffic, seed) add to what
  `correct` compares (check.judge).

The drive: the traffic's drives (drive_laps laps of the circuit, each a
logged sequence run through a fresh engine), the first one's bootstrap
and warm-up chunks in set-up, then chunks of consecutive frames, each
handed to ChunkedSlamEngine.process_chunk once the last one's rows are
back, a new engine where a drive ends, until `seconds` have passed.
frames_per_s is the rows returned over the window's seconds, and
pose_latency_p95_ms the 95th percentile, over every frame the window
completed, of the time from its chunk being handed in to its row being
on the host (a new drive's engine and first captures count in its first
chunk). Where a drive ends, the engine's flush() ends it as a logged
drive ends (the mapping worker drained, the stashed detections closed);
what the check reads of each drive is then copied on the device, and to
the host once the window has closed. With trace, the per-layer metrics
are read from a run of their own, its engines built with trace=True:
the program's counters around the window, its spans and device stamps
(each drive's tracer), NVML's utilization beside it, and a
torch.profiler sub-window after it, over a fresh drive's first lap.
"""

from __future__ import annotations

import hashlib
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
CACHE = ROOT / ".cache"                 # the lap's render, vocabularies
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


def _module(kind: str, name: str, root: Path):
    """<root>/<kind>/<name>.py, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}",
        root / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """metrics/<name>.py's read(ctx)."""
    return _module("metrics", name, root).read


def check_modules(cfg_doc: dict, root: Path = ROOT) -> dict:
    """The configuration's own checks by name: checks/<name>.py for each
    name its "checks" list gives (none without the list). Each defines
    numbers(); after_chunk() and at_end() are optional."""
    mods = {name: _module("checks", name, root)
            for name in cfg_doc.get("checks", [])}
    for name, mod in mods.items():
        if not callable(getattr(mod, "numbers", None)):
            raise AttributeError(f"checks/{name}.py defines no numbers()")
    return mods


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


def vocabulary(recipe: dict, circuit, extractor: dict, cache: Path,
               device):
    """The vocabulary a configuration's "vocabulary" recipe states, on
    `device`: descriptors of every `every`-th noise-free left frame of
    the lap (so no --seed moves it) from the benchmark's frozen
    extractor, a tree of `k` branches and `levels` levels from its frozen
    trainer (`seed`, at most `max_train` descriptors), cached under a
    hash of the recipe, the lap, the extractor's section and the two
    sources, and read by the port's public loop.vocab.load."""
    import torch

    from benchmark.reference import extractor as ref_ext
    from benchmark.reference import vocab_train
    from slam_toolkit_tpu_torch.loop import vocab as V
    key = hashlib.sha256(json.dumps(
        {"recipe": recipe, "lap": circuit.name, "extractor": extractor},
        sort_keys=True).encode())
    for mod in (vocab_train, ref_ext):
        key.update(Path(mod.__file__).read_bytes())
    path = Path(cache) / f"vocab_{key.hexdigest()[:16]}.npz"
    t0 = time.perf_counter()
    if not path.exists():
        corpus = []
        with torch.no_grad():
            for i in range(0, circuit.n, int(recipe["every"])):
                f = ref_ext.extract(circuit.lap_left(i), extractor)
                corpus.append(f.desc[f.valid].cpu().numpy())
        tree = vocab_train.train(np.concatenate(corpus), int(recipe["k"]),
                                 int(recipe["levels"]), int(recipe["seed"]),
                                 int(recipe["max_train"]))
        path.parent.mkdir(parents=True, exist_ok=True)
        vocab_train.save(tree, str(path))
        log(f"trained the vocabulary ({tree.weights.size} words) in "
            f"{time.perf_counter() - t0:.1f} s into {path}")
    return V.to_device(V.load(str(path)), device)


class Setup:
    """What every run of a cell builds once: the port's configuration,
    the circuit's frames on the device, the kernels, and where the
    configuration states them its vocabulary and its own checks."""

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
        self.vocab = None
        if "vocabulary" in self.cfg_doc:
            self.vocab = vocabulary(self.cfg_doc["vocabulary"], self.circuit,
                                    self.cfg_doc["slam"]["extractor"], cache,
                                    self.device)
        self.checks = check_modules(self.cfg_doc, parts["root"])
        if self.device.type == "cuda":
            from slam_toolkit_tpu_torch.utils import cuda_lib
            cuda_lib.library()                  # nvcc, or the build cache

    def engine(self, trace: bool = False):
        from slam_toolkit_tpu_torch.pipeline.scan_engine import \
            ChunkedSlamEngine
        e = self.cfg_doc["engine"]
        return ChunkedSlamEngine(
            self.cfg, vocab=self.vocab, chunk_size=int(e["chunk_size"]),
            device=self.device, graphs=bool(e["graphs"]),
            queue_depth=int(e["queue_depth"]),
            loop_thread=bool(e["loop_thread"]), trace=trace)


# ---- the program's counters (read around the window, never inside) -------
def graph_counters(eng) -> dict:
    """Captures summed over the chunk's graphs and the keyframe, cull
    and loop programs' of the engine's mapping host, the chunk's
    keyframe IF-body runs, the closures landed and the loop events
    (closures and relocalizations) logged. The engine keeps the graph
    sets in private members; this reads them directly, so that a renamed
    member fails the run instead of reading nothing, and changes
    nothing. A graph set with nothing captured (off a card) reads
    None."""
    chunk = eng._chunk.graph_stats()
    parts = [chunk, eng._mapper.graph_stats(),
             eng._mapper.loop_graph_stats()]
    return {"captures": sum(p["captures"] for p in parts if p is not None),
            "keyframe_if_runs": None if chunk is None
            else chunk["if_runs"]["keyframe"],
            "closures_landed": len(eng.closures_landed),
            "loop_events": len(eng.loop_events)}


def loop_counts(eng) -> tuple:
    """(loop events logged, closures landed): a call that grows either
    re-seeded the engine's state inside it."""
    return len(eng.loop_events), len(eng.closures_landed)


def to_host(x):
    """A hook's device copies on the host: tensors, inside dicts, lists
    and tuples too; anything else as it is."""
    import torch
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


# ---- the drive --------------------------------------------------------------
MAP_FIELDS = ("kf_valid", "kf_frame_id", "kf_xy", "kf_desc", "kf_kpt_valid",
              "kf_right_x_norm", "kf_has_stereo", "mp_valid", "mp_ref_kf",
              "mp_kpt", "mp_invd")


class Session:
    """One drive of the traffic (one logged sequence: drive_laps laps
    from the lap's frame 0) through a fresh engine, and what the check
    reads of it."""

    def __init__(self, setup: "Setup", index: int, hook=None,
                 trace: bool = False):
        self.index = index
        self.first = index * setup.drive_frames  # its frame 0 in the run
        self.eng = setup.engine(trace)
        if hook is not None:
            self.eng = hook(self.eng)
        self.checks = setup.checks
        self.rows: Dict[int, np.ndarray] = {}
        self.states: Dict[int, dict] = {}       # device copies
        self.map: Optional[dict] = None         # device copies, at its end
        self.g = 0                               # its next frame
        self.window_first = None                 # its first window frame
        self.handed = self.returned = 0
        # each chunk in flight: [time handed in, frames whose rows are
        # due, whether they count (a window chunk) or not (set-up)]
        self.in_flight: List[list] = []
        # the checks' hooks' device copies, by check name
        self.kept = {name: {"after_chunk": {}, "at_end": None}
                     for name in self.checks}
        self.loop_events: List[dict] = []        # at its end
        self.closures_landed: List[int] = []
        self.tracer = None                       # at its end, when traced
        self.setup_chunks = 0                    # chunks run in set-up

    def keep_rows(self, rows) -> None:
        """Rows come back in frame order, one a frame but the bootstrap
        frame 0: the k-th row of the drive is frame k + 1's."""
        base = len(self.rows) + 1
        for i, r in enumerate(rows):
            self.rows[base + i] = r

    def hand(self, t: float, n: int, counts: bool = True) -> None:
        """A chunk of n frames handed in at host time t."""
        self.in_flight.append([t, n, counts])
        if counts:
            self.handed += n

    def back(self, rows, t: float) -> List[float]:
        """Keep rows that came back at host time t, in frame order, and
        the latencies of those that count, each from its own chunk's
        hand-in (counted as returned)."""
        self.keep_rows(rows)
        out, n = [], len(rows)
        while n and self.in_flight:
            t0, due, counts = self.in_flight[0]
            k = min(n, due)
            if counts:
                out += [t - t0] * k
            n -= k
            if k == due:
                self.in_flight.pop(0)
            else:
                self.in_flight[0][1] = due - k
        self.returned += len(out)
        return out

    def flush(self) -> List[float]:
        """The engine's flush(): every chunk in flight folded, the mapping
        worker drained, the stashed detections closed; the rows it
        returns kept and counted, and their latencies."""
        rows = self.eng.flush()
        return self.back(rows, time.perf_counter())

    def end(self, before_free: Optional[Callable] = None) -> List[float]:
        """End the drive as a user's logged drive ends: flush(), then the
        checks' at_end hooks; copy on the device what the check reads of
        the map, keep the loop logs and the tracer, call before_free(self)
        while the engine lives, and free the engine: no host copy of the
        map, no wait. Returns the flushed rows' latencies."""
        flushed = self.flush()
        eng = self.eng
        for name, mod in self.checks.items():
            if hasattr(mod, "at_end"):
                self.kept[name]["at_end"] = mod.at_end(eng)
        m = eng.carry.m
        self.map = {f: getattr(m, f).clone() for f in MAP_FIELDS}
        self.loop_events = list(eng.loop_events)
        self.closures_landed = list(eng.closures_landed)
        self.tracer = eng.tracer
        if before_free is not None:
            before_free(self)
        self.eng = None
        return flushed


class Drive:
    """One run's window: its latencies, the sessions it drove, and what
    a traced run read."""

    def __init__(self):
        self.latency_s: List[float] = []        # one entry a frame
        self.sessions: List[Session] = []       # ended, in order
        self.handed = self.returned = 0
        self.late = 0              # rows back after the window closed
        self.window_s = 0.0
        self.chunks = 0
        self.ctx: dict = {}


def drive(setup: Setup, seed: int, seconds: float, trace: bool,
          t_start: float, hook=None, min_chunks: int = 1) -> Drive:
    """The set-up's first session and warm-up, then the window: chunks
    handed in one after another, a fresh session wherever a drive ends,
    until `seconds` have passed and at least min_chunks chunks ran. With
    trace, every engine traced, the program's counters and NVML are read
    over the window, and the profiler's sub-window follows it, so that
    neither the profiler nor its processing falls inside the window:
    profile_chunks chunks of a fresh drive, after its bootstrap chunk."""
    import torch

    from benchmark.check import STATE_FIELDS
    d = Drive()
    circ, chunk = setup.circuit, int(setup.cfg_doc["engine"]["chunk_size"])
    cuda = setup.device.type == "cuda"
    tr = setup.traffic.get("trace", {})
    counted = {"captures": 0, "keyframe_if_runs": 0, "closures_landed": 0,
               "loop_events": 0}
    base: dict = {}

    def count(s: Session) -> None:
        """Add a session's graph work and loop counts since `base` (its
        start if it started in the window) to the window's counts."""
        now = graph_counters(s.eng)
        was = base if s.index == 0 else {}
        for k in counted:
            counted[k] += (now[k] or 0) - (was.get(k) or 0)

    def new_session(index: int) -> Session:
        return Session(setup, index, hook, trace)

    sess = new_session(0)
    for _ in range(int(setup.traffic["warmup_chunks"])):
        n_in = chunk - (1 if sess.g == 0 else 0)    # the bootstrap frame
        sess.hand(time.perf_counter(), n_in, counts=False)
        sess.back(sess.eng.process_chunk(
            circ.chunk(seed, sess.first + sess.g, chunk)),
            time.perf_counter())
        sess.g += chunk
        sess.setup_chunks += 1
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
            flushed = sess.end(count if counting else None)
            d.returned += len(flushed)
            d.latency_s += flushed
            d.sessions.append(sess)
            t_new = time.perf_counter()
            sess = new_session(sess.index + 1)
            sess.window_first = 0
        eng = sess.eng
        imgs = circ.chunk(seed, sess.first + sess.g, chunk)
        state = None if eng.carry is None else \
            {f: getattr(eng.carry, f).clone() for f in STATE_FIELDS}
        culls, loops = eng.n_culls, loop_counts(eng)
        t1 = time.perf_counter()
        rows = eng.process_chunk(imgs)
        t2 = time.perf_counter()
        looped = loop_counts(eng) != loops
        # a state is sampled where no cull rebuilt the snapshot and no
        # closure or relocalization re-seeded the head inside the call
        if state is not None and eng.n_culls == culls and not looped:
            sess.states[sess.g] = state
        if looped:
            for name, mod in setup.checks.items():
                if hasattr(mod, "after_chunk"):
                    sess.kept[name]["after_chunk"][sess.g] = \
                        mod.after_chunk(eng, sess.g)
        n_in = chunk - (1 if sess.g == 0 else 0)  # the bootstrap frame
        # a new session's start (engine and first captures) counts in
        # its first chunk's latency
        sess.hand(t1 if t_new is None else t_new, n_in)
        lat = sess.back(rows, t2)
        d.handed += n_in
        d.returned += len(lat)
        d.latency_s += lat
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
    samples = nvml.stop() if trace and nvml is not None else []
    # the window's last drive; rows its flush returns came back late
    d.late += len(sess.end(count if trace else None))
    d.sessions.append(sess)
    if not trace:
        return d
    window = list(d.sessions)
    profile = {}
    if cuda:
        # a fresh drive, its bootstrap chunk (and captures) first: the
        # profiler over a drive's first lap (PERF.md). Its engine is not
        # traced: under the profiler a span is a record_function range,
        # whose device-side copy would read as busy device time. With a
        # vocabulary the mapping worker is drained (flush) before the
        # profiler starts and before it stops, as the engine asks.
        sess = Session(setup, sess.index + 1, hook)
        step(False)
        prof = ProfileWindow()
        if setup.vocab is not None:
            d.late += len(sess.flush())
        prof.start()
        for _ in range(int(tr["profile_chunks"])):
            step(False)
        if setup.vocab is not None:
            d.late += len(sess.flush())
        prof.stop()
        profile = prof.result()
        d.late += len(sess.end())
        d.sessions.append(sess)
    # the window's drives' spans and stamps, the set-up's chunks marked
    spans = [dict(s.tracer.export(), setup_chunks=s.setup_chunks)
             for s in window]
    d.ctx.update(counted=counted,
                 nvml=[(t, u) for t, u in samples
                       if t_w0 <= t <= t_w0 + d.window_s],
                 profile=profile, spans=spans, chunks=chunks, frames=frames,
                 window_s=d.window_s, config=setup.cfg_doc["slam"],
                 card=torch.cuda.get_device_name(setup.device)
                 if cuda else None)
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
        keyframes=kf, mappoints=mp, loop_events=s.loop_events,
        closures_landed=s.closures_landed, kept=to_host(s.kept))


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
    attempted, failed = d.handed, d.handed - d.returned - d.late
    sessions = [artifacts(s) for s in d.sessions]
    del d
    if cuda:
        torch.cuda.empty_cache()
    from benchmark.check import judge, verdict
    numbers = judge(sessions, setup.circuit, setup.cfg_doc, setup.traffic,
                    seed, checks=setup.checks)
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
