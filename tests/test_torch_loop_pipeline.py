"""The chunked engine's pipelined schedule: the in-flight chunk queue
(queue_depth, SLAM_QUEUE_DEPTH) and the mapping worker thread
(loop_thread, SLAM_LOOP_THREAD), on the CPU, on tests/test_loop_e2e.py's
circle_setup world (SlamConfig.tiny(), chunks of 8), and the state the
worker shares with the main thread (launch counts, full_float32).

Without a vocabulary the queue changes only when rows come back. With
one, depth 2 with the thread off is deterministic here (every result
has landed when it is read), and the JAX engine under
SLAM_QUEUE_DEPTH=2 SLAM_LOOP_THREAD=0 gave the same events in two runs
(a relocalization at frame 32 onto slot 0 with 59 inliers, after which
the two chunks in flight are folded at once; the closure of frame 48
onto frame 0 with 124 inliers), so the port is held to them. Under the
thread, which fold a closure lands in depends on timing, so those runs
are held to invariants.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from slam_toolkit_tpu.pipeline.scan_engine import \
    ChunkedSlamEngine as JaxEngine
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.loop import vocab as TV
from slam_toolkit_tpu_torch.pipeline import engine as t_engine
from slam_toolkit_tpu_torch.pipeline import scan_engine
from slam_toolkit_tpu_torch.pipeline.scan_engine import \
    ChunkedSlamEngine as TorchEngine
from slam_toolkit_tpu_torch.utils import cuda_lib

from test_loop_e2e import circle_setup  # noqa: F401  (fixture)

torch.set_num_threads(1)
CHUNK = 8
KEYS = ("frame", "kf_slot", "cand", "fid_cand", "reloc_to")
TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def world(circle_setup):  # noqa: F811
    cfg, _, gt, frames, voc = circle_setup
    arr = np.stack([np.stack([l, r]) for l, r in frames]).astype(np.float32)
    tvoc = TV._from_numpy(np.asarray(voc.nodes), np.asarray(voc.children),
                          np.asarray(voc.word_id), np.asarray(voc.weights),
                          voc.k, voc.levels)
    return {"cfg": cfg, "gt": gt, "arr": arr, "voc": voc, "tvoc": tvoc}


def _run(eng, arr, chunk=CHUNK):
    """Every chunk through process_chunk, then flush: the returns."""
    outs = [eng.process_chunk(arr[i:i + chunk])
            for i in range(0, len(arr), chunk)]
    return outs + [eng.flush()]


def _rows(outs):
    return np.concatenate(outs, axis=0)


@pytest.fixture(scope="module")
def open_rows(world):
    """Depth 0, no vocabulary: the reference rows (the first 40 frames)."""
    eng = TorchEngine(SlamConfig.tiny(), chunk_size=CHUNK, device="cpu")
    return _rows(_run(eng, world["arr"][:40]))


@pytest.mark.parametrize("depth,thread", [(1, False), (2, False),
                                          (2, True)])
def test_queue_rows_bit_equal(world, open_rows, depth, thread):
    """No vocabulary: the rows at depth 1 and 2 (the thread asked for or
    not: without a vocabulary there is no worker), concatenated with what
    flush returns, are depth 0's bit for bit; the first `depth` calls
    return none, and each later call a chunk's."""
    eng = TorchEngine(SlamConfig.tiny(), chunk_size=CHUNK, device="cpu",
                      queue_depth=depth, loop_thread=thread)
    assert eng.queue_depth == depth and not eng.loop_thread
    assert eng._worker is None
    outs = _run(eng, world["arr"][:40])
    assert [len(o) for o in outs[:depth]] == [0] * depth
    # 40 frames: the bootstrap frame has no row
    n = [CHUNK - 1] + [CHUNK] * 4
    assert [len(o) for o in outs] == [0] * depth + n[:5 - depth] + [
        sum(n[5 - depth:])]
    np.testing.assert_array_equal(_rows(outs), open_rows)
    assert eng.trajectory_refined() is not None and not eng._pending


def test_knobs_from_environment(monkeypatch):
    """None reads SLAM_QUEUE_DEPTH and SLAM_LOOP_THREAD; the defaults are
    0 and off (the JAX engine's are 2 and on); no vocabulary, no
    thread."""
    voc = TV.synthesize(2, 2, seed=0)
    cfg = SlamConfig.tiny()
    eng = TorchEngine(cfg, vocab=voc, device="cpu")
    assert eng.queue_depth == 0 and not eng.loop_thread
    monkeypatch.setenv("SLAM_QUEUE_DEPTH", "2")
    monkeypatch.setenv("SLAM_LOOP_THREAD", "1")
    eng = TorchEngine(cfg, vocab=voc, device="cpu")
    assert eng.queue_depth == 2 and eng.loop_thread
    assert eng._worker.thread.daemon and eng._worker.thread.is_alive()
    assert not TorchEngine(cfg, device="cpu").loop_thread
    eng = TorchEngine(cfg, vocab=voc, device="cpu", queue_depth=0,
                      loop_thread=False)
    assert eng.queue_depth == 0 and eng._worker is None
    with pytest.raises(ValueError):
        TorchEngine(cfg, device="cpu", queue_depth=-1)


@pytest.fixture(scope="module")
def depth2_runs(world):
    """The JAX engine and the port at depth 2 with the loop phases
    inline."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLAM_QUEUE_DEPTH", "2")
        mp.setenv("SLAM_LOOP_THREAD", "0")
        je = JaxEngine(world["cfg"], vocab=world["voc"], chunk_size=CHUNK)
        jouts = _run(je, world["arr"])
    te = TorchEngine(SlamConfig.tiny(), vocab=world["tvoc"],
                     chunk_size=CHUNK, device="cpu", queue_depth=2,
                     loop_thread=False)
    touts = _run(te, world["arr"])
    return je, jouts, te, touts


def test_depth2_loop_events_match_jax(depth2_runs):
    """Depth 2, thread off: the JAX engine's events under the same
    schedule (frame, slots, the candidate's frame; inliers within 2; the
    closure's measured pose within 0.2 m), the same replays and keyframe
    decisions, and nothing pending after the flush. The relocalization
    folds the chunks in flight at once; their rows come back in frame
    order."""
    je, jouts, te, touts = depth2_runs
    ej, et = je.loop_events, te.loop_events
    assert [e for e in ej if "cand" in e] and [e for e in ej
                                               if "reloc_to" in e], ej
    assert len(et) == len(ej), (et, ej)
    for a, b in zip(et, ej):
        assert {k: a.get(k) for k in KEYS} == {k: b.get(k) for k in KEYS}
        assert abs(a["inliers"] - b["inliers"]) <= 2
        if "cand" in b:
            assert set(a) == set(b)
            np.testing.assert_allclose(a["T_meas"], b["T_meas"], atol=0.2)
    assert te.n_replays == je.n_replays >= 1
    assert [s["kf"] for s in te.frame_stats] == \
        [s["kf"] for s in je.frame_stats]
    assert te._closure_pend == [] and te._loop_stash == []
    assert sum(len(o) for o in touts) == len(te.trajectory) - 1
    assert [len(o) for o in touts[:2]] == [0, 0]
    rows = _rows(touts)
    np.testing.assert_array_equal(
        rows[:, :16].reshape(-1, 4, 4), np.stack(te.trajectory[1:]))


def _threaded(world, **kw):
    return TorchEngine(SlamConfig.tiny(), vocab=world["tvoc"],
                       chunk_size=CHUNK, device="cpu", loop_thread=True,
                       **kw)


def test_threaded_closes_loop(world):
    """The mapping worker at depth 2: a closure onto the revisited start,
    every pose finite, nothing pending once trajectory_refined() (which
    flushes first) returns, and every frame's row."""
    te = _threaded(world, queue_depth=2)
    arr = world["arr"]
    for i in range(0, len(arr), CHUNK):
        te.process_chunk(arr[i:i + CHUNK])
    assert te._pending                     # chunks still in flight
    traj = te.trajectory_refined()
    assert len(traj) == len(arr) and not te._pending
    assert all(np.isfinite(T).all() for T in traj)
    closures = [e for e in te.loop_events if "cand" in e]
    assert closures and te.n_replays >= 1
    # the circle's start, revisited from frame 48 on
    assert all(e["frame"] >= 48 and e["fid_cand"] <= 2 for e in closures)
    assert len(te.closures_landed) == te.n_replays
    assert te._closure_pend == [] and te._loop_stash == []
    assert te._worker.outstanding == 0 and not te._worker.requests


def test_threaded_map_flushes_first(world):
    """`map` flushes as the JAX engine's does: the chunks in flight are
    folded and the worker's jobs are done before the map is handed out."""
    te = _threaded(world, queue_depth=1)
    arr = world["arr"][:24]
    for i in range(0, len(arr), CHUNK):
        te.process_chunk(arr[i:i + CHUNK])
    assert len(te._pending) == 1
    m = te.map
    assert not te._pending and te._worker.outstanding == 0
    assert len(te.trajectory) == len(arr)
    assert int(m.kf_valid.sum()) == te._n_kf_valid


def test_worker_exception_raised_at_flush(world, monkeypatch):
    """An exception in phase 1 on the worker is kept, not swallowed: the
    chunks after it run on, and the next flush raises it (once)."""
    te = _threaded(world, queue_depth=0)
    seen = []

    def boom(*args):
        seen.append(threading.current_thread())
        raise KeyError("phase 1 failed")
    monkeypatch.setattr(te, "_loop_phase1", boom)
    arr = world["arr"][:24]
    for i in range(0, len(arr), CHUNK):
        te.process_chunk(arr[i:i + CHUNK])
    with pytest.raises(KeyError, match="phase 1 failed"):
        te.flush()
    assert seen and all(t is te._worker.thread for t in seen)
    assert len(te.trajectory) == len(arr)
    te.flush()                              # raised once


def _tiny_ring():
    base = SlamConfig.tiny()
    return dataclasses.replace(
        base, map=dataclasses.replace(base.map, max_keyframes=12),
        keyframe=dataclasses.replace(base.keyframe, decay_ratio=0.95))


@pytest.fixture(scope="module")
def ring_frames():
    from slam_toolkit_tpu.config import SlamConfig as JaxConfig
    from slam_toolkit_tpu.data.synthetic import make_sequence
    jcfg = JaxConfig.tiny()
    jcfg = dataclasses.replace(jcfg, map=dataclasses.replace(
        jcfg.map, max_keyframes=12))
    _, gt, frames = make_sequence(jcfg, n_frames=32, seed=3, step=0.25)
    return np.stack([np.stack([l, r]) for l, r in frames]).astype(
        np.float32)


def test_headroom_with_chunks_in_flight(ring_frames):
    """tests/test_torch_capacity.py's 12-keyframe ring, chunks of 4, at
    depth 2: every frame in flight counts toward the headroom, so the
    live ring never holds more than its capacity; the flush before a cull
    folds the chunks in flight, so the culls fall where depth 0's do and
    the rows, culls and re-anchored trajectory are depth 0's bit for
    bit."""
    out = {}
    for depth in (0, 2):
        eng = TorchEngine(_tiny_ring(), chunk_size=4, device="cpu",
                          queue_depth=depth)
        outs, live = [], []
        for i in range(0, len(ring_frames), 4):
            outs.append(eng.process_chunk(ring_frames[i:i + 4]))
            live.append(int(eng.carry.m.kf_valid.sum()))
        outs.append(eng.flush())
        out[depth] = (eng, _rows(outs), live)
    (e0, r0, live0), (e2, r2, live2) = out[0], out[2]
    cap = e2.cfg.map.max_keyframes
    assert max(live2) <= cap and e2.n_keyframes > cap
    assert e2.n_culls == e0.n_culls >= 2
    np.testing.assert_array_equal(r2, r0)
    assert [s for s, _ in e2._traj_anchor] == [s for s, _ in e0._traj_anchor]
    assert [s for s, _ in e2._traj_anchor][1:] != \
        r2[:, 32].astype(int).tolist()          # culled anchors moved
    np.testing.assert_array_equal(np.stack(e2.trajectory_refined()),
                                  np.stack(e0.trajectory_refined()))


def test_full_float32_two_threads():
    """full_float32 open on two threads: one thread leaving its block
    does not turn TF32 back on under the other's; the caller's flags come
    back when the last block closes."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_out, b_done = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with t_engine.full_float32():
            a_in.set()
            b_in.wait(TIMEOUT_S)
        a_out.set()

    def b():
        a_in.wait(TIMEOUT_S)
        with t_engine.full_float32():
            b_in.set()
            a_out.wait(TIMEOUT_S)
            seen["b"] = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
        b_done.set()
    try:
        ts = [threading.Thread(target=f) for f in (a, b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in ts)
        assert seen["b"] == (False, False)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_launch_counts_under_threads():
    """LaunchCount.add loses no increment under eight threads and a short
    switch interval; counting() sees only its own thread's launches (its
    nested blocks' too), and counts_apart takes back only those (the
    worker's launches during a capture stay counted) and hides them from
    an enclosing counting()."""
    c = cuda_lib.LaunchCount()
    n_threads, n_adds = 8, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [c.add()
                                               for _ in range(n_adds)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT_S)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    assert c.launches == n_threads * n_adds

    c.launches = 0
    inside, other_done = threading.Event(), threading.Event()

    def other():
        inside.wait(TIMEOUT_S)
        c.add(5)
        other_done.set()
    t = threading.Thread(target=other)
    t.start()
    with cuda_lib.counting() as outer:
        c.add(1)
        with cuda_lib.counts_apart() as apart:
            c.add(3)
            with cuda_lib.counting() as inner:
                c.add(2)
            inside.set()
            other_done.wait(TIMEOUT_S)
    t.join(TIMEOUT_S)
    assert not t.is_alive()
    assert inner == {c: 2} and apart == {c: 5} and outer == {c: 1}
    assert c.launches == 1 + 5        # this thread's outside, the other's


def test_submit_refuses_before_capture(world, monkeypatch):
    """A mapping job is only queued once the chunk's CUDA graphs exist (a
    global-mode capture fails if another thread touches the card): the
    check, driven here by faking a CUDA engine whose chunk has not
    captured."""
    te = _threaded(world, queue_depth=0)
    assert isinstance(te._chunk, scan_engine._StaticChunk)
    monkeypatch.setattr(te, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="captured"):
        te._submit("p2", ())
    assert te._worker.outstanding == 0
