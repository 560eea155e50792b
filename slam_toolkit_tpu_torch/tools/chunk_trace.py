"""Where a chunk graph's device time goes, from the chunked engine's trace.

ChunkedSlamEngine(trace=True) keeps, for every chunk, the device stamps
of its graph (pipeline/scan_engine.FRAME_STAMPS, and the graph's start
and end) and its host spans, on one clock (utils/timing.StreamStages).
This module reads one engine's export (StreamStages.export()), or a
list of them, one a drive in the order they ran:

- chunk_graph_ms: a chunk's device time between its graph's two
  chunk-level stamps;
- frame_layers: a frame's device milliseconds by layer: extraction
  (start to extracted), top-2 and pose LM (extracted to tracked, the
  keyframe rule, carry writes and pack included), the keyframe IF body
  (kf_start to kf_end: stereo, insert and cull, local BA, snapshot and
  writes), and the rest (the fetch, the row store, the WHILE node's
  condition between frames, and the graph's head and tail);
- device_gaps: the device's time between one chunk graph's end stamp
  and the next one's start stamp within a drive, and the host spans
  that cover each gap (gap_cover); a drive's start (its engine,
  bootstrap and captures) lies between two exports and is reported
  apart (drive_starts);
- layer_metrics: the five figures PERF.md names (chunk_graph_ms_p95,
  extract_ms_per_frame, track_pose_ms_per_frame, keyframe_event_ms,
  device_gap_ms_per_chunk) over the chunks given.

Run as a program it drives a cell of the repository's benchmark
(benchmark/harness.run, --trace 0's path) once untraced and once traced
a seed, the order turned round each seed, each session's engine built
with trace=True in the traced runs, with CUDA events around every
replay of the chunk graph in both (replay_events), and prints a line a
run: the end-to-end metrics, the events' chunk time by level (the
chunk's two speeds, PERF.md), and for a traced run its figures, the
breakdown by level, the host spans over the device's gaps, the stamps
against the events, and the clock's error and drift:

    python -m slam_toolkit_tpu_torch.tools.chunk_trace \\
        --workload vo_circuit --seeds 11,12 --seconds 51

With --out it also writes the full readings, each chunk's graph time
among them, to that JSON file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Optional

MS = 1e-6                                 # milliseconds a nanosecond
LAYERS = ("extract", "track_pose", "keyframe", "kf_stereo", "kf_insert",
          "kf_ba", "kf_snapshot", "rest")


def _exports(ex) -> List[dict]:
    return [ex] if isinstance(ex, dict) else list(ex)


def _stamped(ex: dict) -> List[dict]:
    """The export's chunks whose graph has both stamps, in the order
    they were folded."""
    return [c for c in ex["stamps"] if None not in c["graph"]]


def chunk_graph_ms(chunk: dict) -> float:
    return (chunk["graph"][1] - chunk["graph"][0]) * MS


def frame_layers(chunk: dict) -> List[Dict[str, float]]:
    """Each frame's device ms by layer (LAYERS; the keyframe's parts are
    0 on a frame with no keyframe event, "kf" False); a chunk's frames'
    layers, "rest" included, sum to its chunk_graph_ms."""
    at = {name: k for k, name in enumerate(chunk["slots"])}
    out = []
    prev_end = chunk["graph"][0]
    for r in chunk["frames"]:
        def t(name):
            return r[at[name]]
        d = {k: 0.0 for k in LAYERS}
        d["kf"] = t("kf_start") is not None
        d["extract"] = (t("extracted") - t("start")) * MS
        d["track_pose"] = (t("tracked") - t("extracted")) * MS
        after = t("tracked")
        if d["kf"]:
            d["keyframe"] = (t("kf_end") - t("kf_start")) * MS
            d["kf_stereo"] = (t("kf_stereo") - t("kf_start")) * MS
            d["kf_insert"] = (t("kf_inserted") - t("kf_stereo")) * MS
            d["kf_ba"] = (t("kf_ba") - t("kf_inserted")) * MS
            d["kf_snapshot"] = (t("kf_end") - t("kf_ba")) * MS
            after = t("kf_end")
        # before the frame's start (the graph's head, or the WHILE node's
        # condition after the last frame), between the tracking and the
        # keyframe event, and the row store
        d["rest"] = ((t("start") - prev_end) +
                     ((t("kf_start") - t("tracked"))
                      if d["kf"] else 0) +
                     (t("stored") - after)) * MS
        prev_end = t("stored")
        out.append(d)
    if out:
        out[-1]["rest"] += (chunk["graph"][1] - prev_end) * MS
    return out


def device_gaps(ex: dict) -> List[dict]:
    """The gaps between consecutive chunk graphs of one export (one
    engine): {"ms", "start_ns", "end_ns", "after": the earlier chunk's
    dispatch span}."""
    cs = _stamped(ex)
    return [{"ms": (b["graph"][0] - a["graph"][1]) * MS,
             "start_ns": a["graph"][1], "end_ns": b["graph"][0],
             "after": a["span"]} for a, b in zip(cs, cs[1:])]


def drive_starts(exports) -> List[float]:
    """The device's ms from one export's last chunk graph end to the
    next export's first chunk graph start (a new engine's start, its
    bootstrap and captures)."""
    exs = [e for e in _exports(exports) if _stamped(e)]
    return [(_stamped(b)[0]["graph"][0] - _stamped(a)[-1]["graph"][1]) * MS
            for a, b in zip(exs, exs[1:])]


def _union(intervals) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gap_cover(ex: dict, gap: dict) -> Dict[str, float]:
    """The share of `gap` (device_gaps') that each host span name of the
    export covers, by name (spans of one name merged first)."""
    a, b = gap["start_ns"], gap["end_ns"]
    if b <= a:
        return {}
    by_name: Dict[str, list] = {}
    for s in ex["spans"]:
        lo, hi = max(s["start_ns"], a), min(s["end_ns"], b)
        if hi > lo:
            by_name.setdefault(s["name"], []).append((lo, hi))
    return {n: sum(hi - lo for lo, hi in _union(iv)) / (b - a)
            for n, iv in by_name.items()}


def _p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def layer_metrics(exports, skip: int = 0) -> Optional[dict]:
    """chunk_graph_ms_p95 (nearest rank over the chunks),
    extract_ms_per_frame and track_pose_ms_per_frame (means over the
    frames), keyframe_event_ms (the mean IF-body run) and
    device_gap_ms_per_chunk (the mean gap within a drive), with the
    counts behind them; the first export's first `skip` chunks (set-up)
    left out. None where no chunk was stamped."""
    chunks, gaps = [], []
    for k, ex in enumerate(_exports(exports)):
        cs = _stamped(ex)[skip if k == 0 else 0:]
        chunks += cs
        gaps += device_gaps({"stamps": cs, "spans": ex["spans"]})
    if not chunks:
        return None
    frames = [f for c in chunks for f in frame_layers(c)]
    kf = [f["keyframe"] for f in frames if f["kf"]]
    return {"chunk_graph_ms_p95": _p95([chunk_graph_ms(c) for c in chunks]),
            "extract_ms_per_frame": statistics.fmean(
                f["extract"] for f in frames),
            "track_pose_ms_per_frame": statistics.fmean(
                f["track_pose"] for f in frames),
            "keyframe_event_ms": statistics.fmean(kf) if kf else None,
            "device_gap_ms_per_chunk": statistics.fmean(
                g["ms"] for g in gaps) if gaps else None,
            "chunks": len(chunks), "frames": len(frames),
            "keyframe_runs": len(kf), "gaps": len(gaps)}


def breakdown(chunks: List[dict]) -> Optional[dict]:
    """Per-layer device ms a frame (LAYERS) over `chunks`, their mean
    chunk_graph_ms, and the share of the graph time that extraction,
    tracking and the keyframe event sum to."""
    frames = [f for c in chunks for f in frame_layers(c)]
    if not frames:
        return None
    per = {k: statistics.fmean(f[k] for f in frames) for k in LAYERS}
    graph = sum(chunk_graph_ms(c) for c in chunks)
    staged = sum(f["extract"] + f["track_pose"] + f["keyframe"]
                 for f in frames)
    return {"ms_per_frame": per, "chunks": len(chunks),
            "frames": len(frames),
            "chunk_graph_ms_mean": graph / len(chunks),
            "staged_share": staged / graph}


def by_level(exports, split_ms: float, skip: int = 0) -> dict:
    """The chunks of `exports` split by their chunk_graph_ms at split_ms
    (the two speeds, PERF.md): per level the breakdown of its full
    chunks (those of the most frames) and the mean device gap after its
    chunks within a drive; the first export's first `skip` chunks left
    out."""
    out = {"slow": {"chunks": [], "gaps": []},
           "fast": {"chunks": [], "gaps": []}}
    for k, ex in enumerate(_exports(exports)):
        cs = _stamped(ex)[skip if k == 0 else 0:]
        n = max((len(c["frames"]) for c in cs), default=0)
        for c in cs:
            if len(c["frames"]) == n:
                lvl = "slow" if chunk_graph_ms(c) > split_ms else "fast"
                out[lvl]["chunks"].append(c)
        for a, b in zip(cs, cs[1:]):
            lvl = "slow" if chunk_graph_ms(a) > split_ms else "fast"
            out[lvl]["gaps"].append((b["graph"][0] - a["graph"][1]) * MS)
    return {lvl: {"breakdown": breakdown(v["chunks"]),
                  "gap_ms_mean": statistics.fmean(v["gaps"])
                  if v["gaps"] else None, "gaps": len(v["gaps"])}
            for lvl, v in out.items()}


def _largest_gap(exports, skip: int = 0) -> Optional[dict]:
    """The largest device gap within a drive, and the host spans over
    it."""
    best = None
    for k, ex in enumerate(_exports(exports)):
        cs = _stamped(ex)[skip if k == 0 else 0:]
        for g in device_gaps({"stamps": cs, "spans": ex["spans"]}):
            if best is None or g["ms"] > best[1]["ms"]:
                best = (ex, g)
    return None if best is None else {
        "ms": best[1]["ms"], "cover": gap_cover(*best)}


def _mean_cover(exports, skip: int = 0) -> Dict[str, float]:
    """Each host span name's share of the device gaps within a drive,
    averaged over the gaps."""
    covers = []
    for k, ex in enumerate(_exports(exports)):
        cs = _stamped(ex)[skip if k == 0 else 0:]
        covers += [gap_cover(ex, g) for g in
                   device_gaps({"stamps": cs, "spans": ex["spans"]})]
    names = {n for c in covers for n in c}
    return {n: sum(c.get(n, 0.0) for c in covers) / len(covers)
            for n in sorted(names)}


@contextlib.contextmanager
def replay_events(out: list):
    """CUDA events recorded around each replay of graph "chunk" while the
    block runs (appended to `out` as (start, end) pairs): the chunk
    graph's device time whether or not the engine is traced."""
    import torch

    from slam_toolkit_tpu_torch.utils import cuda_graphs
    orig = cuda_graphs.StepGraphs.replay

    def replay(self, name):
        if name != "chunk":
            return orig(self, name)
        stream = torch.cuda.current_stream(self.device)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
        orig(self, name)
        ev[1].record(stream)
        out.append(ev)
    cuda_graphs.StepGraphs.replay = replay
    try:
        yield
    finally:
        cuda_graphs.StepGraphs.replay = orig


def _run_cell(harness, parts, seed: int, seconds: float, traced: bool,
              exports: list, **kw) -> dict:
    """One --trace 0 run of the cell (harness.run, `kw` its further
    arguments); every session's engine rebuilt with trace=traced, the
    traced ones' exports appended to `exports`."""
    import time

    from slam_toolkit_tpu_torch.pipeline.scan_engine import (
        ChunkedSlamEngine, _StaticChunk)
    tracers = []

    def hook(e):
        eng = ChunkedSlamEngine(
            e.cfg, cam=e.cam, vocab=e.vocab, chunk_size=e.chunk_size,
            device=e.device, graphs=isinstance(e._chunk, _StaticChunk),
            queue_depth=e.queue_depth, loop_thread=e.loop_thread,
            trace=traced)
        if traced:
            tracers.append(eng.tracer)
        return eng
    out = harness.run(parts, seed, seconds, False, time.perf_counter(),
                      engine_hook=hook, **kw)
    exports += [t.export() for t in tracers]
    return out


def _report(exports, events, split_ms: float, skip: int) -> dict:
    """A traced run's figures; with the CUDA events around its replays,
    each chunk's stamped graph time against its events'."""
    chunks = [c for ex in exports for c in _stamped(ex)]
    rel = [abs(chunk_graph_ms(c) - e[0].elapsed_time(e[1])) /
           e[0].elapsed_time(e[1]) for c, e in zip(chunks, events)]
    clocks = [ex["clock"] for ex in exports]
    return {"metrics": layer_metrics(exports, skip),
            "levels": by_level(exports, split_ms, skip),
            "drive_start_ms": drive_starts(exports),
            "gap_cover_mean": _mean_cover(exports, skip),
            "largest_gap": _largest_gap(exports, skip),
            "graph_within_chunk_span": [_within(ex, _stamped(ex))
                                        for ex in exports],
            "stamps_vs_events_max_rel": max(rel) if rel and
            len(chunks) == len(events) else None,
            "clock_error_ns": [c["error_ns"] for cl in clocks for c in cl],
            "clock_drift_ns": [cl[-1]["offset_ns"] - cl[0]["offset_ns"]
                               for cl in clocks]}


def _event_levels(events, split_ms: float) -> dict:
    """The CUDA-event time of the chunk replays by level: median, mean
    and count."""
    ms = [e[0].elapsed_time(e[1]) for e in events]
    out = {}
    for lvl, vals in (("slow", [m for m in ms if m > split_ms]),
                      ("fast", [m for m in ms if m <= split_ms])):
        out[lvl] = {"median": statistics.median(vals) if vals else None,
                    "mean": statistics.fmean(vals) if vals else None,
                    "n": len(vals)}
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="vo_circuit")
    ap.add_argument("--seeds", default="11,12")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--split-ms", type=float, default=186.0,
                    help="chunk graph ms between the fast and slow level")
    ap.add_argument("--out", default=None,
                    help="a JSON file for the full readings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from benchmark import harness
    harness.CACHE.mkdir(parents=True, exist_ok=True)
    parts = harness.resolve(harness.load_spec(), args.workload)
    skip = int(parts["traffic"]["warmup_chunks"])
    runs = []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for traced in ((False, True) if k % 2 == 0 else (True, False)):
            exports: list = []
            events: list = []
            with replay_events(events):
                out = _run_cell(harness, parts, seed, args.seconds, traced,
                                exports)
            torch.cuda.synchronize()
            run = {"seed": seed, "traced": traced, "correct": out["correct"],
                   "end_to_end": {n: m["value"]
                                  for n, m in out["metrics"].items()},
                   "event_ms_by_level": _event_levels(events,
                                                      args.split_ms)}
            if traced:
                run.update(_report(exports, events, args.split_ms, skip))
                run["chunk_graph_ms"] = [[chunk_graph_ms(c)
                                          for c in _stamped(ex)]
                                         for ex in exports]
            runs.append(run)
            print(json.dumps({k: v for k, v in run.items()
                              if k != "chunk_graph_ms"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "runs": runs},
                      f)
    return 0


def _within(ex: dict, chunks: List[dict]) -> Optional[float]:
    """The share of `chunks` whose graph stamps lie inside the host span
    "chunk" that launched them (on one clock, within its error)."""
    if not chunks:
        return None
    err = max(c["error_ns"] for c in ex["clock"])
    spans = {s["id"]: s for s in ex["spans"]}
    ok = 0
    for c in chunks:
        root = spans.get(c["root"])
        ok += root is not None and \
            root["start_ns"] - err <= c["graph"][0] and \
            c["graph"][1] <= root["end_ns"] + err
    return ok / len(chunks)


if __name__ == "__main__":
    raise SystemExit(main())
