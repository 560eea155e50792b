"""The JAX chunk's lax.scan as utils/cuda_graphs.run_while, on the CPU.

On a card run_while is a CUDA-graph WHILE node inside a capture: the
chunk (pipeline/scan_engine._StaticChunk) is one graph whose frames are
the node's iterations, the frame index, the images and the packed rows
on the device, and whose keyframe event is an IF node inside the body.
Off a capture it is its plain version, which reads the flag on the host
before each iteration; a warm-up runs the body once. These tests hold
the plain version, its refusals, and the static chunk over chunks
shorter than its capacity against the eager chunk (make_frame_body
frame by frame, the JAX-parity path of tests/test_torch_engine.py),
with no host read in the WHILE body but the flags'.
tests/test_torch_cuda.py holds the captured graph to eager on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data.synthetic import make_sequence
from slam_toolkit_tpu_torch.pipeline.scan_engine import (ChunkedSlamEngine,
                                                         ChunkCarry)
from slam_toolkit_tpu_torch.utils import cuda_graphs

from torch_host_guard import (PLAIN_TWINS, HostOpGuard, HostReadGuard,
                              stand_aside)

torch.set_num_threads(1)

CAPACITY = 5
LENGTHS = (5, 4, 3, 1)           # the chunks after the bootstrap frame
FRAMES = 1 + sum(LENGTHS)


# ---- run_while's plain version, warm-up and refusals --------------------
def _counter(n: int):
    """A loop state: a 0-dim count, a bound, the flag and a log of the
    count at each iteration; the body advances the count and rewrites
    the flag in place."""
    i = torch.zeros((), dtype=torch.int64)
    bound = torch.tensor(n)
    go = torch.gt(bound, 0)
    seen = []

    def body(step):
        seen.append(int(i))
        i.add_(step)
        torch.lt(i, bound, out=go)
    return go, body, seen


@pytest.mark.parametrize("n", [0, 1, 4])
def test_plain_while_runs_while_set(n):
    """Off a capture the body runs for as long as the flag is set: not at
    all when it is false at entry, n times otherwise, with its arguments,
    each iteration counted in plain_runs under its name."""
    go, body, seen = _counter(n)
    n0 = cuda_graphs.plain_runs["t_while"]
    cuda_graphs.run_while(go, body, 1, name="t_while")
    assert seen == list(range(n))
    assert cuda_graphs.plain_runs["t_while"] - n0 == n
    assert not bool(go)


def test_warm_up_runs_the_while_body_once():
    """Inside a warm-up the body runs once, its flag unread and its runs
    uncounted, whatever the flag holds."""
    n0 = cuda_graphs.plain_runs["t_warm_while"]
    for n in (0, 3):
        go, body, seen = _counter(n)
        with cuda_graphs.warming():
            cuda_graphs.run_while(go, body, 1, name="t_warm_while")
        assert seen == [0]
    assert cuda_graphs.plain_runs["t_warm_while"] == n0


@pytest.mark.parametrize("flag", [torch.ones(()), torch.tensor([True]),
                                  torch.ones((2, 1), dtype=torch.bool),
                                  True])
def test_while_refuses_a_flag_not_0_dim_bool(flag):
    """A flag that is not a 0-dim bool tensor raises before the body
    runs, in the plain version and inside a capture; so does a flag off
    the card inside a capture (no WHILE node is added)."""
    seen = []
    with pytest.raises(ValueError, match="0-dim bool tensor"):
        cuda_graphs.run_while(flag, seen.append, 1, name="t_refused")
    g = cuda_graphs.StepGraphs("cpu")
    with pytest.raises(ValueError, match="bool CUDA tensor"):
        g._while_node(torch.tensor(True), seen.append, (1,), "t_refused")
    assert seen == [] and g._bodies == []


# ---- the static chunk against the eager chunk ---------------------------
@pytest.fixture(scope="module")
def images():
    _, _, frames = make_sequence(SlamConfig.tiny(), n_frames=FRAMES, seed=3,
                                 step=0.25)
    return np.stack([np.stack([l, r]) for l, r in frames]).astype(
        np.float32)


def _cfg():
    """The tiny configuration, keyframes often (decay 0.95)."""
    cfg = SlamConfig.tiny()
    return dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, decay_ratio=0.95))


def _run(images, graphs: bool):
    eng = ChunkedSlamEngine(_cfg(), chunk_size=CAPACITY, device="cpu",
                            graphs=graphs)
    a, rows = 0, []
    for k, n in enumerate(LENGTHS):
        b = a + n + (k == 0)
        rows.append(eng.process_chunk(images[a:b]))
        a = b
    return eng, rows


def test_scan_is_the_eager_chunk(images):
    """The static chunk (capacity 5, the engine's chunk_size) over chunks
    of 5, 4, 3 and 1 frames against the eager chunk: each chunk's rows
    and the final carry, map included, bit-equal; the WHILE body run
    once a frame and the keyframe body once a keyframe row; a chunk
    longer than the capacity raises."""
    n0 = dict(cuda_graphs.plain_runs)
    eng_s, rows_s = _run(images, True)
    ran = {k: cuda_graphs.plain_runs[k] - n0.get(k, 0)
           for k in ("frame", "keyframe")}
    eng_e, rows_e = _run(images, False)
    assert [len(r) for r in rows_s] == list(LENGTHS)
    for a, b in zip(rows_s, rows_e):
        np.testing.assert_array_equal(a, b)
    rows = np.concatenate(rows_s)
    n_kf = int((rows[:, 34] > 0.5).sum())
    assert n_kf >= 2 and (rows[:, 34] < 0.5).any()
    assert ran == {"frame": FRAMES - 1, "keyframe": n_kf}
    for f in ChunkCarry._fields:
        got, want = getattr(eng_s.carry, f), getattr(eng_e.carry, f)
        if f == "m":
            for g, w, name in zip(got, want, got._fields):
                assert torch.equal(g, w), name
        elif f == "frame_id":
            assert int(got) == want == FRAMES
        elif want is None:
            assert got is None, f
        else:
            assert torch.equal(got, want), f
    run = eng_s._chunk
    assert run.capacity == CAPACITY and run.graphs is None
    with pytest.raises(ValueError, match="at most 5"):
        eng_s.process_chunk(images[:CAPACITY + 1])


def test_scan_step_reads_nothing_back(images, monkeypatch):
    """The WHILE body (_scan_step): frame i taken from the images buffer,
    tracking, the keyframe event where flagged, the row stored at i, i
    advanced and go = i < n, on keyframes and tracking-only frames, reads
    nothing back to the host and uploads nothing but the plain version's
    flag reads (nodes' flags on the card)."""
    guard = HostReadGuard()
    for mod, names in PLAIN_TWINS + ((cuda_graphs, ("taken",)),):
        stand_aside(monkeypatch, guard, mod, names)
    eng = ChunkedSlamEngine(_cfg(), chunk_size=CAPACITY, device="cpu")
    eng.process_chunk(images[:CAPACITY + 1])
    run = eng._chunk
    n = 4
    run.images[:n].copy_(torch.from_numpy(images[6:6 + n]))
    run.n.fill_(n)
    run.i.zero_()
    for k in range(n):
        with guard, HostOpGuard(guard):
            run._scan_step(run.static)
        assert int(run.i) == k + 1 and bool(run.go) == (k + 1 < n)
    assert guard.seen == [] and guard.paused == 0
    flags = (run.rows[:n, 34] > 0.5).tolist()
    assert True in flags and False in flags, flags
