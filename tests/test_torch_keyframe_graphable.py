"""The keyframe programs, the culls and the close on static buffers, on the
CPU: against the eager programs bit for bit, reading nothing back, and
the close against the JAX package.

With graphs=True (the default) SlamEngine runs the programs the JAX
engine jits around a keyframe (stereo, insert, ba, snapshot, cull,
cull_any) and the close (one program per pose-graph tier) on static
buffers (pipeline/engine._LoopPrograms), and the chunked engine runs its
headroom culls through its host's cull programs; on a card each is a
CUDA graph. On the CPU the same code runs eagerly on the same buffers.
These tests hold both engines past a small keyframe ring to graphs=False,
show that each program makes no host read, and hold the close program's
body (device slots, the static pose-graph layout of
optim/pose_graph.segment_widths, solve_ex) to the JAX close within
tests/test_torch_loop_close.py's tolerances. tests/test_torch_cuda.py
holds the replayed graphs to the eager programs on the card.
SlamConfig.tiny(), the port's own synthetic sequences.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JaxConfig
from slam_toolkit_tpu.loop import closer as j_closer
from slam_toolkit_tpu.mapping.map_state import MapState as JaxMap
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data.synthetic import make_sequence
from slam_toolkit_tpu_torch.mapping.map_state import MapState
from slam_toolkit_tpu_torch.optim import pose_graph
from slam_toolkit_tpu_torch.pipeline.engine import (MAX_CLOSED_LOOPS,
                                                    SlamEngine, _copy_in,
                                                    _LoopPrograms)
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
from slam_toolkit_tpu_torch.utils import convert

from torch_host_guard import (PLAIN_TWINS, HostOpGuard, HostReadGuard,
                              stand_aside)

torch.set_num_threads(1)

N_FRAMES = 17
TIER = 32


def _ring(cfg, n: int):
    """A keyframe ring of n slots that fills (decay 0.95: keyframes
    often)."""
    return dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, max_keyframes=n),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))


def _group(cfg, group: str):
    """The pose-graph group; SE3 over 3 iterations (see
    test_close_program_matches_jax)."""
    iters = 3 if group == "se3" else cfg.loop.posegraph_iterations
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, pose_graph_group=group, posegraph_iterations=iters))


@pytest.fixture(scope="module")
def frames():
    _, _, fr = make_sequence(SlamConfig.tiny(), n_frames=32, seed=3,
                             step=0.25)
    return fr


def _process(cfg, frames, graphs: bool) -> SlamEngine:
    eng = SlamEngine(cfg, device="cpu", graphs=graphs)
    for left, right in frames:
        eng.process(left, right)
    return eng


@pytest.fixture(scope="module")
def ring_runs(frames):
    """The per-frame engine over 17 frames with a ring of 9: static and
    eager."""
    cfg = _ring(SlamConfig.tiny(), 9)
    return (_process(cfg, frames[:N_FRAMES], True),
            _process(cfg, frames[:N_FRAMES], False))


def _same_maps(a: MapState, b: MapState) -> None:
    for f in MapState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_keyframe_programs_are_eager(ring_runs):
    """The static engine ran every keyframe program (the culls at least
    twice) and the eager one none; poses, refined poses, keyframe flags,
    inliers, anchors, the map and the tracking state bit-equal."""
    a, b = ring_runs
    runs = a._kf.runs
    assert all(runs[n] > 0 for n in ("stereo", "insert", "ba", "snapshot")), \
        runs
    assert runs["insert"] == sum(s["kf"] for s in a.frame_stats)
    assert runs["cull"] + runs["cull_any"] >= 2, runs
    assert not any(b._kf.runs.values())
    np.testing.assert_array_equal(np.stack(a.trajectory),
                                  np.stack(b.trajectory))
    np.testing.assert_array_equal(np.stack(a.trajectory_refined()),
                                  np.stack(b.trajectory_refined()))
    assert [(s["kf"], s["inliers"]) for s in a.frame_stats] == \
        [(s["kf"], s["inliers"]) for s in b.frame_stats]
    assert [s for s, _ in a._traj_anchor] == [s for s, _ in b._traj_anchor]
    _same_maps(a.map, b.map)
    for f in ("T_cw", "velocity", "_latest_kf_T_dev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_static_map_keeps_its_addresses(ring_runs):
    """Every program wrote the map in place: its tensors are the ones the
    engine allocated, which the programs are keyed by."""
    a, _ = ring_runs
    key = _LoopPrograms._key(a.map)
    assert {k for _, k in a._kf._progs if k} == {key}


def _chunked(cfg, frames, graphs: bool):
    eng = ChunkedSlamEngine(cfg, chunk_size=4, device="cpu", graphs=graphs)
    arr = np.stack([np.stack([l, r]) for l, r in frames]).astype(np.float32)
    rows = [eng.process_chunk(arr[i:i + 4]) for i in range(0, len(arr), 4)]
    rows.append(eng.flush())
    return eng, np.concatenate(rows)


def test_chunked_culls_are_eager(frames):
    """The chunked engine past a ring of 12 (tests/test_torch_capacity.py's
    run): its headroom culls ran through the cull programs at least twice,
    and the rows, anchors and map equal the eager engine's bit for bit."""
    cfg = _ring(SlamConfig.tiny(), 12)
    a, ra = _chunked(cfg, frames, True)
    b, rb = _chunked(cfg, frames, False)
    assert a.n_culls >= 2 and a.n_culls == b.n_culls
    runs = a._mapper._kf.runs
    assert runs["cull"] >= a.n_culls, runs
    assert not any(b._mapper._kf.runs.values())
    np.testing.assert_array_equal(ra, rb)
    assert [s for s, _ in a._traj_anchor] == [s for s, _ in b._traj_anchor]
    np.testing.assert_array_equal(np.stack(a.trajectory_refined()),
                                  np.stack(b.trajectory_refined()))
    _same_maps(a.map, b.map)


@pytest.fixture(scope="module")
def close_map(frames):
    """A map of the tiny configuration's 128-slot ring after 17 frames
    (decay 0.95: a keyframe every second frame or so), and a loop of its newest keyframe onto its oldest: the measured pose
    is the newest keyframe's moved by 5 cm (the drift the close removes),
    the ring holds one earlier loop."""
    cfg = _ring(SlamConfig.tiny(), SlamConfig.tiny().map.max_keyframes)
    eng = _process(cfg, frames[:N_FRAMES], False)
    m = eng.map
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, -1)).numpy()
    valid = np.flatnonzero(m.kf_valid.numpy())
    cur = int(np.argmax(fid))
    cand = int(valid[np.argmin(fid[valid])])
    mid = int(valid[len(valid) // 2])
    T_loop = m.kf_T_cw[cur].clone()
    T_loop[:3, 3] += torch.tensor([0.05, 0.0, -0.03])
    E = MAX_CLOSED_LOOPS
    ring = [torch.zeros(E, dtype=torch.int32),
            torch.zeros(E, dtype=torch.int32),
            torch.eye(4).repeat(E, 1, 1), torch.zeros(E, dtype=torch.bool),
            torch.ones(E)]
    ring[0][0], ring[1][0], ring[3][0], ring[4][0] = cand, mid, True, 0.5
    ring[2][0] = m.kf_T_cw[mid] @ torch.linalg.inv(m.kf_T_cw[cand])
    assert len(valid) >= 4 and cur != cand
    return {"eng": eng, "m": m, "cur": cur, "cand": cand, "T": T_loop,
            "ring": ring, "q": torch.tensor(37.0)}


def _close_values(d, scale: float) -> tuple:
    """close@TIER's inputs: (cur, cand, T_loop, scale, q, k, *ring)."""
    return (d["cur"], d["cand"], d["T"], torch.tensor(scale), d["q"], 1,
            *d["ring"])


def _copy(m: MapState) -> MapState:
    return MapState(*(t.clone() for t in m))


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_close_program_matches_jax(close_map, group):
    """The close program's body on its static buffers (device slots, ring
    index and measurement, the static pose-graph layout, solve_ex) equals
    the eager close with host ints bit for bit, and the JAX close_loop
    within tests/test_torch_loop_close.py's tolerances: keyframe poses to
    5e-3, anchored inverse depths to 1e-3 relative; the ring gains the
    loop at index 1. SE3 runs 3 iterations: on this graph the JAX SE3
    solve stalls after its second step (its se3.log goes NaN at small
    angles, tests/test_torch_loop_geometry.py), while the port's goes on
    (the parent commit's close gives the same numbers); Sim3 runs the
    configured 20."""
    d = close_map
    cfg = _group(SlamConfig.tiny(), group)
    eng = SlamEngine(cfg, device="cpu", own_map=False)
    scale = 1.03 if group == "sim3" else 1.0
    vals = _close_values(d, scale)
    progs = _LoopPrograms(eng)
    prog = progs.program(f"close@{TIER}", d["m"], vals)
    for buf, v in zip(prog.inputs[1:], vals):
        _copy_in(buf, v)
    m_prog = _copy(d["m"])
    ring = prog.fn(eng, m_prog, *prog.inputs[1:])
    m_eager, *ring_eager = eng._close_body(
        _copy(d["m"]), d["cur"], d["cand"], d["T"], *d["ring"], 1,
        torch.tensor(scale), d["q"], TIER)
    for f in MapState._fields:
        assert torch.equal(getattr(m_prog, f), getattr(m_eager, f)), f
    for x, y in zip(ring, ring_eager):
        assert torch.equal(x, y)
    assert int(ring[0][1]) == d["cand"] and int(ring[1][1]) == d["cur"]
    assert bool(ring[3][1]) and not bool(ring[3][2:].any())

    jcfg = dataclasses.replace(JaxConfig.tiny(), loop=dataclasses.replace(
        JaxConfig.tiny().loop, pose_graph_group=group,
        posegraph_iterations=cfg.loop.posegraph_iterations))
    jm = JaxMap(**{f: jnp.asarray(convert.to_numpy(f, getattr(d["m"], f)))
                   for f in MapState._fields})
    w = float(np.clip(float(d["q"]) / (2.0 * cfg.loop.min_matches),
                      cfg.loop.loop_edge_min_weight, 1.0))
    ci, cj, cT, cv, cw = (jnp.asarray(t.numpy()) for t in d["ring"])
    mj = j_closer.close_loop(jm, jnp.int32(d["cur"]), jnp.int32(d["cand"]),
                             jnp.asarray(d["T"].numpy()), ci, cj, cT, cv,
                             jcfg, tier=TIER, loop_scale=scale,
                             loop_weight=w, prev_loops_w=cw)
    valid = d["m"].kf_valid.numpy()
    np.testing.assert_allclose(m_prog.kf_T_cw.numpy()[valid],
                               np.asarray(mj.kf_T_cw)[valid], atol=5e-3)
    np.testing.assert_allclose(m_prog.mp_invd.numpy(),
                               np.asarray(mj.mp_invd), rtol=1e-3)
    moved = np.abs(np.asarray(mj.kf_T_cw) - d["m"].kf_T_cw.numpy()).max()
    assert moved > 1e-4                       # the closure moved poses


@pytest.mark.parametrize("tier", [8, 32])
def test_segment_widths_bound_the_close(tier):
    """The close's assembly keys (tier - 1 chain edges, then 1 +
    MAX_CLOSED_LOOPS loop edges, invalid ones clamped to tier - 1 as
    close_loop does): no key of H or b repeats more often than
    segment_widths allows, and SegmentSum at those widths sums as an
    in-order scatter-add (float64 reference)."""
    rng = np.random.default_rng(tier)
    L = 1 + MAX_CLOSED_LOOPS
    for n_invalid in (0, L // 2, L):
        li, lj = rng.integers(0, tier, L), rng.integers(0, tier, L)
        li[:n_invalid] = lj[:n_invalid] = tier - 1
        ei = np.concatenate([np.arange(tier - 1), li])
        ej = np.concatenate([np.arange(1, tier), lj])
        N = tier
        kh = np.concatenate([ei * N + ei, ej * N + ej, ei * N + ej,
                             ej * N + ei])
        kb = np.concatenate([ei, ej])
        w_h, w_b = pose_graph.segment_widths(len(ei), tier - 1)
        assert np.bincount(kh).max() <= w_h
        assert np.bincount(kb).max() <= w_b
        rows = rng.normal(size=(len(kh), 2, 3)).astype(np.float32)
        out = pose_graph.SegmentSum(torch.from_numpy(kh), N * N, w_h)(
            torch.from_numpy(rows))
        ref = np.zeros((N * N, 2, 3))
        np.add.at(ref, kh, rows.astype(np.float64))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _guarded(monkeypatch, fn, *args) -> list:
    guard = HostReadGuard()
    for mod, names in PLAIN_TWINS:
        stand_aside(monkeypatch, guard, mod, names)
    with torch.no_grad(), guard, HostOpGuard(guard):
        fn(*args)
    return guard.seen


@pytest.mark.parametrize("name", _LoopPrograms.KEYFRAME_NAMES)
def test_keyframe_programs_read_nothing_back(ring_runs, monkeypatch, name):
    """Each keyframe program on its static buffers (the static run's last
    inputs) makes no host read, no upload and no data-dependent shape
    (the kernels' plain twins excused, as in
    tests/test_torch_graph_step.py); programs that write the map run on a
    copy of it."""
    eng = ring_runs[0]
    m = None if name == "stereo" else eng.map
    prog = eng._kf.program(name, m)
    if prog.mutates_map:
        m = _copy(m)
    assert _guarded(monkeypatch, prog.fn, eng, m, *prog.inputs[1:]) == []


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_close_program_reads_nothing_back(close_map, monkeypatch, group):
    """close@32 (close_loop, merge_mappoints, the ring update) on its static
    buffers makes no host read, on a copy of the map."""
    d = close_map
    eng = SlamEngine(_group(SlamConfig.tiny(), group), device="cpu",
                     own_map=False)
    vals = _close_values(d, 1.03)
    prog = _LoopPrograms(eng).program(f"close@{TIER}", d["m"], vals)
    for buf, v in zip(prog.inputs[1:], vals):
        _copy_in(buf, v)
    # once first, as a capture's warm-up runs it (the info row's constant)
    prog.fn(eng, _copy(d["m"]), *prog.inputs[1:])
    assert _guarded(monkeypatch, prog.fn, eng, _copy(d["m"]),
                    *prog.inputs[1:]) == []
