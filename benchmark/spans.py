"""The chunk graph's figures from a traced run's spans and stamps.

A frozen copy of the reduction in the port's tools/chunk_trace (its
layer_metrics and what it reads), so that a change to the program's
tools cannot move the per-layer metrics. It reads ctx["spans"]: one
export a drive of the window, in the order they ran, each
utils.timing.StreamStages.export() of a ChunkedSlamEngine(trace=True)
(host spans and each chunk's device stamps, on the host clock) with
"setup_chunks", the chunks that drive ran in set-up, which are left
out. The figures:

- chunk_graph_ms_p95: the nearest-rank 95th percentile over the chunks
  of a chunk graph's device time between its two chunk-level stamps;
- extract_ms_per_frame: a frame's device time from its start to
  "extracted", the mean over the frames;
- track_pose_ms_per_frame: from "extracted" to "tracked" (top-2, pose
  LM, keyframe rule, carry writes, pack), the mean over the frames;
- keyframe_event_ms: the keyframe IF body (kf_start to kf_end), the mean
  over its runs;
- device_gap_ms_per_chunk: the device's time between one chunk graph's
  end stamp and the next one's start within a drive, the mean over the
  gaps.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

MS = 1e-6                                 # milliseconds a nanosecond


def _stamped(ex: dict) -> List[dict]:
    """The export's chunks whose graph has both stamps, in the order
    they were folded."""
    return [c for c in ex["stamps"] if None not in c["graph"]]


def chunk_graph_ms(chunk: dict) -> float:
    return (chunk["graph"][1] - chunk["graph"][0]) * MS


def frame_layers(chunk: dict) -> List[Dict[str, float]]:
    """Each frame's device ms: "extract", "track_pose", and with "kf"
    True the keyframe IF body's "keyframe" (0 on a frame with none)."""
    at = {name: k for k, name in enumerate(chunk["slots"])}
    out = []
    for r in chunk["frames"]:
        def t(name):
            return r[at[name]]
        kf = t("kf_start") is not None
        out.append({"kf": kf,
                    "extract": (t("extracted") - t("start")) * MS,
                    "track_pose": (t("tracked") - t("extracted")) * MS,
                    "keyframe": (t("kf_end") - t("kf_start")) * MS
                    if kf else 0.0})
    return out


def device_gaps(chunks: List[dict]) -> List[float]:
    """The ms between consecutive chunk graphs of one drive."""
    return [(b["graph"][0] - a["graph"][1]) * MS
            for a, b in zip(chunks, chunks[1:])]


def _p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def layer_metrics(exports: List[dict]) -> Optional[dict]:
    """The five figures over the exports' chunks, each export's set-up
    chunks left out (a figure with nothing to read is None), with the
    counts behind them; None where no chunk was stamped."""
    chunks, gaps = [], []
    for ex in exports:
        cs = _stamped(ex)[int(ex.get("setup_chunks", 0)):]
        chunks += cs
        gaps += device_gaps(cs)
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
            "device_gap_ms_per_chunk": statistics.fmean(gaps)
            if gaps else None,
            "chunks": len(chunks), "frames": len(frames),
            "keyframe_runs": len(kf), "gaps": len(gaps)}


def figure(ctx: dict, name: str) -> Optional[float]:
    """One figure of ctx["spans"]; None in a run without spans."""
    spans = ctx.get("spans")
    got = layer_metrics(spans) if spans else None
    return None if got is None else got[name]
