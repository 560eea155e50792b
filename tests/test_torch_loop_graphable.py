"""The loop programs on static buffers, on the CPU: against the eager
programs, bit for bit, and reading nothing back.

With graphs=True (the default) SlamEngine runs the loop programs that
the JAX engine jits (register, register_packed, covis, relpose, reloc,
seam; pipeline/engine._LoopPrograms) on static buffers: the inputs
copied in, the outputs in buffers the next run overwrites, copied out
where a caller keeps them; on a card each is a CUDA graph per map it
reads, captured before the mapping worker's first job. On the CPU the
same code runs eagerly on the same buffers. These tests hold the chunked
engine on that path to graphs=False (every loop program eager, on
fresh tensors) on tests/test_loop_e2e.py's circle_setup
world (SlamConfig.tiny(), chunks of 8: a relocalization, then a
closure), at queue depth 0 and at depth 2 with the mapping worker, the
worker run in lockstep (each fold's jobs finished, and the closures they
decide served, before the next chunk) so that both runs take the same
schedule. The events themselves are held to the JAX package's by
tests/test_torch_loop_e2e.py and tests/test_torch_loop_pipeline.py, which
run the default path. tests/test_torch_cuda.py holds the replayed graphs
to the eager programs on the card.
"""

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.loop import vocab as TV
from slam_toolkit_tpu_torch.mapping.map_state import MapState
from slam_toolkit_tpu_torch.pipeline.engine import _copy_in, _LoopPrograms
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine

from test_loop_e2e import circle_setup  # noqa: F401  (fixture)
from torch_host_guard import (PLAIN_TWINS, HostOpGuard, HostReadGuard,
                              stand_aside)

torch.set_num_threads(1)
CHUNK = 8


@pytest.fixture(scope="module")
def world(circle_setup):  # noqa: F811
    _, _, _, frames, voc = circle_setup
    arr = np.stack([np.stack([l, r]) for l, r in frames]).astype(np.float32)
    tvoc = TV._from_numpy(np.asarray(voc.nodes), np.asarray(voc.children),
                          np.asarray(voc.word_id), np.asarray(voc.weights),
                          voc.k, voc.levels)
    return arr, tvoc


def _run(world, graphs: bool, depth: int = 0, thread: bool = False):
    arr, tvoc = world
    eng = ChunkedSlamEngine(SlamConfig.tiny(), vocab=tvoc, chunk_size=CHUNK,
                            device="cpu", graphs=graphs, queue_depth=depth,
                            loop_thread=thread)
    outs = []
    for i in range(0, len(arr), CHUNK):
        outs.append(eng.process_chunk(arr[i:i + CHUNK]))
        if thread:
            eng._worker.drain()
    outs.append(eng.flush())
    return eng, np.concatenate(outs)


def _same(a, ra, b, rb) -> None:
    """Two runs' rows, events, replays, refined poses, map and database
    bit-equal."""
    np.testing.assert_array_equal(ra, rb)
    assert a.loop_events == b.loop_events
    assert a.n_replays == b.n_replays and \
        a.closures_landed == b.closures_landed
    np.testing.assert_array_equal(np.stack(a.trajectory_refined()),
                                  np.stack(b.trajectory_refined()))
    for f in MapState._fields:
        assert torch.equal(getattr(a.map, f), getattr(b.map, f)), f
    assert torch.equal(a._host.bow_db, b._host.bow_db)


@pytest.fixture(scope="module")
def depth0(world):
    return _run(world, True), _run(world, False)


def test_static_loop_programs_are_eager_depth0(depth0):
    """Depth 0, loop phases inline: the static-buffer programs ran (the
    relocalization, the closure's relative poses, covisibility and every
    chunk's registration), the eager run ran none, and both give the
    same rows, events (a relocalization and a closure), poses and map."""
    (a, ra), (b, rb) = depth0
    kinds = {k for e in a.loop_events for k in ("cand", "reloc_to")
             if k in e}
    assert kinds == {"cand", "reloc_to"}, a.loop_events
    runs = a._host._loop.runs
    assert all(runs[n] > 0 for n in ("register_packed", "covis", "relpose",
                                     "reloc")), runs
    assert not any(b._host._loop.runs.values())
    assert a._host._loop.frozen and a.carry is a._chunk.static
    assert a._host.loop_graph_stats() is None         # nothing captured
    _same(a, ra, b, rb)


def test_static_loop_programs_are_eager_worker(world):
    """Depth 2 with the mapping worker in lockstep: its jobs run the
    programs on the two published map copies (programs of their own),
    and the run equals the eager one bit for bit."""
    a, ra = _run(world, True, 2, True)
    b, rb = _run(world, False, 2, True)
    assert [e for e in a.loop_events if "cand" in e]
    bufs = a._worker.bufs
    progs = a._host._loop._progs
    assert {name for name, key in progs
            if key in {_LoopPrograms._key(m) for m in bufs}} == \
        {"register", "covis", "relpose"}
    assert a._worker.error is None and not a._closure_pend
    _same(a, ra, b, rb)


def test_pending_measurement_keeps_its_values(depth0):
    """A relative pose's results are copied out of the program's static
    outputs: a measurement kept across later runs (pending across folds)
    still holds its own pair's values, while the static outputs hold the
    last run's."""
    (a, _), _ = depth0
    h, m = a._host, a.carry.m
    e = next(e for e in a.loop_events if "cand" in e)
    cur, cand = e["kf_slot"], e["cand"]
    rel, pk, _ = a._measure(m, cur, cand)
    kept = [t.clone() for t in (*rel, pk)]
    others = [(cand, cur), (cur, (cand + 1) % int(m.kf_valid.sum()))]
    for c, d in others:
        h._relpose(m, c, d)
    for k, t in zip(kept, (*rel, pk)):
        assert torch.equal(k, t)
    static = h._loop._out[h._loop.program("relpose", m).gname][1]
    assert not torch.equal(static, pk)
    fresh = h._relpose_program(m, cur, cand)[1]
    assert torch.equal(fresh, pk)


def _program_inputs(a, arr, name: str) -> tuple:
    """Inputs of program `name` from the depth-0 run's closure (for reloc,
    the last frame's features)."""
    e = next(e for e in a.loop_events if "cand" in e)
    cur, cand = e["kf_slot"], e["cand"]
    i64 = torch.int64
    if name == "register":
        return (torch.tensor([cur, cand, 0, 0], dtype=i64),
                torch.tensor([True, True, False, False]))
    if name == "register_packed":
        packed = torch.zeros((CHUNK, 36))
        packed[2, 32], packed[2, 34] = cur, 1.0
        packed[5, 32], packed[5, 34] = cand, 1.0
        return (packed,)
    if name == "covis":
        return (torch.tensor([cur, cand] + [0] * 6, dtype=i64),
                torch.tensor([True, True] + [False] * 6))
    if name == "reloc":
        fr = a._host._build(torch.from_numpy(arr[-1, 0]))
        return fr.feats, fr.norm_xy, cand
    return cur, cand                                  # relpose, seam


@pytest.mark.parametrize("name", _LoopPrograms.NAMES)
def test_loop_programs_read_nothing_back(world, depth0, monkeypatch, name):
    """Each loop program on its static buffers makes no host read, no
    upload and no data-dependent shape (the kernels' plain twins excused,
    as in tests/test_torch_graph_step.py); seam BA runs on a copy of the
    map."""
    (a, _), _ = depth0
    m = a.carry.m
    prog = a._host._loop.program(name, m)
    for buf, v in zip(prog.inputs[1:], _program_inputs(a, world[0], name)):
        _copy_in(buf, v)
    if name == "seam":
        m = MapState(*(t.clone() for t in m))
    guard = HostReadGuard()
    for mod, names in PLAIN_TWINS:
        stand_aside(monkeypatch, guard, mod, names)
    with torch.no_grad(), guard, HostOpGuard(guard):
        prog.fn(a._host, m, *prog.inputs[1:])
    assert guard.seen == []
