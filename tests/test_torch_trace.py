"""The program's tracer (utils/timing.StreamStages) and the chunked
engine's trace, on the CPU.

ChunkedSlamEngine(trace=True) records host spans around each chunk's
upload, bootstrap, headroom, dispatch (launch, capture) and fold
(readback_wait, rows, the loop's stages) and, from the static chunk,
device stamps at each layer boundary of a frame (scan_engine
FRAME_STAMPS) and around the chunk's frames; off a card the stamps are
the plain version's host clock. These tests hold a traced engine to an
untraced one bit for bit, the spans' nesting, the stamps' order and
keyframe slots, an untraced engine's silence, the tracer's threads,
causes and profiler ranges, and tools/chunk_trace's figures against
values worked out by hand. tests/test_torch_cuda.py holds the stamps to
CUDA events on the card.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data.synthetic import make_sequence
from slam_toolkit_tpu_torch.loop import vocab as V
from slam_toolkit_tpu_torch.pipeline.scan_engine import (FRAME_STAMPS,
                                                         ChunkedSlamEngine)
from slam_toolkit_tpu_torch.tools import chunk_trace
from slam_toolkit_tpu_torch.utils import timing

torch.set_num_threads(1)

CHUNKS = ((0, 6), (6, 11), (11, 14))    # the bootstrap frame, then 5s
CHILDREN = {"upload", "bootstrap", "headroom", "dispatch", "fold"}


def _cfg():
    """The tiny configuration, keyframes often (decay 0.95)."""
    cfg = SlamConfig.tiny()
    return dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, decay_ratio=0.95))


@pytest.fixture(scope="module")
def images():
    _, _, frames = make_sequence(SlamConfig.tiny(), n_frames=14, seed=3,
                                 step=0.25)
    return np.stack([np.stack([l, r]) for l, r in frames]).astype(
        np.float32)


def _drive(images, trace: bool, **kw):
    eng = ChunkedSlamEngine(_cfg(), chunk_size=5, device="cpu", trace=trace,
                            **kw)
    return eng, [eng.process_chunk(images[a:b]) for a, b in CHUNKS]


@pytest.fixture(scope="module")
def drives(images):
    return _drive(images, False), _drive(images, True)


def test_traced_engine_is_the_untraced_one(drives):
    """Tracing changes nothing the engine computes: rows and map bit-equal
    over a drive with keyframes and frames without."""
    (plain, rows_p), (traced, rows_t) = drives
    for a, b in zip(rows_p, rows_t):
        np.testing.assert_array_equal(a, b)
    kf = np.concatenate(rows_t)[:, 34] > 0.5
    assert kf.any() and (~kf).any()
    for f in plain.map._fields:
        assert torch.equal(getattr(plain.map, f), getattr(traced.map, f)), f
    assert plain.tracer is None


def test_one_chunk_span_a_call_with_its_children_nested(drives):
    """One root span "chunk" a process_chunk call; its children are the
    listed stages (bootstrap on the first call only), launch under
    dispatch, readback_wait and rows under fold; every span shares its
    chunk's root, and no child lies outside its parent's interval."""
    (_, _), (eng, _) = drives
    spans = eng.tracer.spans()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["chunk"] * len(CHUNKS)
    for k, r in enumerate(roots):
        kids = {s.name for s in spans if s.parent == r.id}
        assert kids == (CHILDREN if k == 0 else CHILDREN - {"bootstrap"})
    for s in spans:
        assert by_id[s.root].name == "chunk" and s.thread == "MainThread"
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.root == s.root
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    parent = {s.name: by_id[s.parent].name for s in spans
              if s.parent is not None}
    assert parent["launch"] == "dispatch"
    assert parent["readback_wait"] == parent["rows"] == "fold"


def test_frame_stamps_follow_the_frame(drives):
    """A chunk's stamps a frame, one row a frame returned: non-decreasing
    in slot order (the keyframe slots, where stamped), each frame after
    the one before, all inside the chunk's two graph stamps, and those
    inside the span that dispatched it."""
    (_, _), (eng, rows) = drives
    ex = eng.tracer.export()
    spans = {s["id"]: s for s in ex["spans"]}
    assert [len(c["frames"]) for c in ex["stamps"]] == [len(r) for r in rows]
    for c in ex["stamps"]:
        assert c["slots"] == FRAME_STAMPS
        flat = [t for r in c["frames"] for t in r if t is not None]
        assert flat == sorted(flat)
        g0, g1 = c["graph"]
        assert g0 <= flat[0] and flat[-1] <= g1
        d = spans[c["span"]]
        assert d["name"] == "dispatch" and c["root"] == d["root"]
        assert d["start_ns"] <= g0 and g1 <= d["end_ns"]
    assert ex["clock"] and ex["clock"][0]["offset_ns"] == 0


def test_keyframe_slots_filled_exactly_on_keyframe_rows(drives):
    """The IF body's five stamps are set on the frames whose row carries
    the keyframe flag, and on no other frame; the frame-level four on
    every frame."""
    (_, _), (eng, rows) = drives
    kf_slots = [k for k, n in enumerate(FRAME_STAMPS) if n.startswith("kf")]
    for c, r in zip(eng.tracer.export()["stamps"], rows):
        for stamps, row in zip(c["frames"], r):
            kf = bool(row[34] > 0.5)
            assert [stamps[k] is not None for k in kf_slots] == \
                [kf] * len(kf_slots)
            assert all(t is not None for k, t in enumerate(stamps)
                       if k not in kf_slots)


def test_untraced_engine_records_and_stamps_nothing(images, monkeypatch):
    """An untraced engine makes no call of the stamp entry and has no
    tracer or stamp buffer; a traced one (the spy's control) stamps
    every slot of its frames and the graph's two."""
    calls = []
    orig = timing.stamp

    def spy(*a, **kw):
        calls.append(a[1])
        return orig(*a, **kw)
    monkeypatch.setattr(timing, "stamp", spy)
    eng, rows = _drive(images[:11], False)
    assert calls == [] and eng.tracer is None
    assert eng._chunk.stamp_buf is None
    eng, rows = _drive(images[:6], True)
    n_kf = int((rows[0][:, 34] > 0.5).sum())
    assert len(calls) == 2 + 4 * len(rows[0]) + 5 * n_kf


def test_loop_stages_are_children_of_the_fold(images):
    """With a vocabulary the loop's stages (SlamEngine.stages) are the
    engine's tracer: the fold's (scores readback, detect, ...) lie under
    a fold of the chunk that runs them, the BoW register under the
    dispatch that runs it right after the chunk (JAX _loop_dispatch);
    summary() reads them as before."""
    eng = ChunkedSlamEngine(_cfg(), vocab=V.synthesize(4, 3, seed=0),
                            chunk_size=5, device="cpu", trace=True)
    for a, b in CHUNKS:
        eng.process_chunk(images[a:b])
    assert eng._host.stages is eng.tracer
    spans = eng.tracer.spans()
    by_id = {s.id: s for s in spans}
    loop = [s for s in spans if s.name in ("register", "scores readback",
                                           "detect", "covis")]
    assert {s.name for s in loop} >= {"register", "scores readback"}
    for s in loop:
        up = s
        while up.parent is not None and up.name not in ("fold", "dispatch"):
            up = by_id[up.parent]
        assert up.name == ("dispatch" if s.name == "register" else "fold")
        assert by_id[s.root].name == "chunk"
    summ = eng.tracer.summary()
    assert summ["chunk"]["n"] == len(CHUNKS)
    assert summ["register"]["device_ms"] is None


def test_tracer_threads_causes_and_profiler_ranges():
    """Spans nest on their own thread; a span on another thread takes
    the cause it is given as parent and that span's root; while
    torch.profiler records, each span is a record_function range."""
    tr = timing.StreamStages()
    with tr.stage("outer") as outer:
        with tr.stage("inner") as inner:
            assert tr.current() == inner
        t = threading.Thread(target=_in_span, args=(tr, "job", inner),
                             name="worker")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert tr.current() is None
    s = {x.name: x for x in tr.spans()}
    assert s["inner"].parent == outer and s["inner"].root == outer
    assert s["job"].parent == inner and s["job"].root == outer
    assert s["job"].thread == "worker"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.stage("profiled_span"):
            torch.ones(4).sum()
    assert "profiled_span" in {e.name for e in prof.events()}
    assert tr.summary()["profiled_span"]["n"] == 1


def _in_span(tr, name, cause):
    with tr.stage(name, cause=cause):
        pass


def test_cpu_stamps_are_the_host_clock():
    """The plain stamp writes time.perf_counter_ns() into slot base + row
    * width (or base), reading the row on the host; the CPU clock's
    offset and error are 0."""
    import time
    buf = torch.zeros(12, dtype=torch.int64)
    t0 = time.perf_counter_ns()
    timing.stamp(buf, 2, torch.tensor(3), 3)
    timing.stamp(buf, 0)
    t1 = time.perf_counter_ns()
    nz = torch.nonzero(buf).flatten().tolist()
    assert nz == [0, 11]
    assert t0 <= int(buf[11]) <= int(buf[0]) <= t1
    assert timing.StreamStages().sync_clock() | {"host_ns": 0} == \
        {"host_ns": 0, "offset_ns": 0, "error_ns": 0}


# ---- tools/chunk_trace's figures on a hand-made trace --------------------
MS = 1_000_000                      # ns a millisecond


def _chunk(graph, frames):
    """A stamped chunk: graph (start, end) ms and frame rows as dicts of
    slot -> ms."""
    return {"span": 0, "root": 0, "slots": FRAME_STAMPS,
            "graph": tuple(int(g * MS) for g in graph),
            "frames": [[None if f.get(n) is None else int(f[n] * MS)
                        for n in FRAME_STAMPS] for f in frames]}


def _frame(start, extracted, tracked, stored, kf=None):
    d = {"start": start, "extracted": extracted, "tracked": tracked,
         "stored": stored}
    if kf is not None:
        d.update(zip(FRAME_STAMPS[3:8], kf))
    return d


def _hand_made():
    """Two drives. A: chunk (0, 30) with a frame of 4 ms extraction and 3
    ms tracking and a keyframe frame (3, 4; IF body 18 to 27), chunk
    (31, 50) with two frames (4, 4; 3, 3); B: chunk (100, 120), one
    keyframe frame (5, 4; IF body 111 to 118), chunk (122.5, 130), one
    frame (3, 3). Host spans in A's gap: fold 30.5-31.2, launch
    30.8-31.5."""
    a = {"stamps": [
        _chunk((0, 30), [_frame(1, 5, 8, 9),
                         _frame(10, 13, 17, 28, (18, 19, 20, 26, 27))]),
        _chunk((31, 50), [_frame(32, 36, 40, 41), _frame(42, 45, 48, 49)])],
        "spans": [{"name": "fold", "start_ns": int(30.5 * MS),
                   "end_ns": int(31.2 * MS)},
                  {"name": "launch", "start_ns": int(30.8 * MS),
                   "end_ns": int(31.5 * MS)}],
        "clock": [{"host_ns": 0, "offset_ns": 0, "error_ns": 0}]}
    b = {"stamps": [
        _chunk((100, 120), [_frame(101, 106, 110, 119,
                                   (111, 112, 113, 117, 118))]),
        _chunk((122.5, 130), [_frame(123, 126, 129, 129.5)])],
        "spans": [], "clock": a["clock"]}
    return [a, b]


@pytest.mark.parametrize("name,skip,want", [
    ("chunk_graph_ms_p95", 0, 30.0),
    ("chunk_graph_ms_p95", 1, 20.0),
    ("extract_ms_per_frame", 0, 22 / 6),
    ("track_pose_ms_per_frame", 0, 21 / 6),
    ("keyframe_event_ms", 0, 8.0),
    ("device_gap_ms_per_chunk", 0, 1.75),
])
def test_layer_metrics_by_hand(name, skip, want):
    """Each figure over the hand-made drives: the nearest-rank p95 of the
    chunks' graph times (30, 19, 20, 7.5; skipping the first chunk 19,
    20, 7.5), the mean extraction (4, 3, 4, 3, 5, 3) and tracking (3, 4,
    4, 3, 4, 3) of the six frames, the mean IF body (9, 7) and the mean
    gap within a drive (1 and 2.5; the drive's start, 50 ms, apart)."""
    got = chunk_trace.layer_metrics(_hand_made(), skip)
    assert got[name] == pytest.approx(want, abs=1e-9)
    assert chunk_trace.drive_starts(_hand_made()) == [50.0]


def test_layer_metrics_without_stamps_is_none():
    """No stamped chunk (an untraced engine's export, or a graph whose
    end stamp is missing): None, and no gap."""
    empty = {"stamps": [], "spans": [], "clock": []}
    assert chunk_trace.layer_metrics([empty, empty]) is None
    half = _hand_made()[0]
    half["stamps"][0]["graph"] = (0, None)
    assert len(chunk_trace.device_gaps(half)) == 0


def test_frame_layers_sum_to_the_graph_and_gaps_are_covered():
    """A chunk's frame layers, the rest included, sum to its graph time;
    gap_cover gives each host span's share of a gap (fold 0.5 of A's 1
    ms gap, launch 0.2)."""
    a = _hand_made()[0]
    for c in a["stamps"]:
        layers = chunk_trace.frame_layers(c)
        total = sum(f[k] for f in layers for k in ("extract", "track_pose",
                                                   "keyframe", "rest"))
        assert total == pytest.approx(chunk_trace.chunk_graph_ms(c))
    kf = chunk_trace.frame_layers(a["stamps"][0])[1]
    assert (kf["kf_stereo"], kf["kf_insert"], kf["kf_ba"],
            kf["kf_snapshot"]) == pytest.approx((1, 1, 6, 1))
    gap = chunk_trace.device_gaps(a)[0]
    assert gap["ms"] == pytest.approx(1.0)
    assert chunk_trace.gap_cover(a, gap) == pytest.approx(
        {"fold": 0.5, "launch": 0.2})
