"""SlamEngine.process's per-frame programs on static buffers, on the CPU:
against the eager programs, bit for bit.

With graphs=True (the default) process runs _build and _track (or
_track_direct) on static buffers (pipeline/engine._StaticTrack): the
image copied in, the pose state copied in every frame, the landmark
snapshot and the photometric anchor copied in when the engine holds new
ones; on a card the two programs are CUDA graphs captured once and
replayed. On the CPU the same programs run eagerly on the same buffers.
These tests hold that path to graphs=False (process as it was) exactly
for the three trackers through keyframe-ring culls, a relocalization's
re-track and a checkpoint restore, and show that the programs read
nothing back to the host. tests/test_torch_cuda.py holds the replayed
graphs to the eager programs on the card. SlamConfig.tiny(), the port's
own synthetic sequences.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data.synthetic import (make_sequence, make_world,
                                                   render_stereo)
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.loop import vocab as TV
from slam_toolkit_tpu_torch.ops.extractor import extract
from slam_toolkit_tpu_torch.pipeline import checkpoint
from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine

from torch_host_guard import (PLAIN_TWINS, HostOpGuard, HostReadGuard,
                              stand_aside)

torch.set_num_threads(1)

METHODS = ("indirect", "hybrid", "direct")
N_FRAMES = 17


def _cfg(method: str) -> SlamConfig:
    """The tiny configuration with a ring of 9 keyframes that culls
    (decay 0.95 makes keyframes often)."""
    cfg = SlamConfig.tiny()
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, method=method),
        map=dataclasses.replace(cfg.map, max_keyframes=9),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))


@pytest.fixture(scope="module")
def frames():
    _, _, fr = make_sequence(SlamConfig.tiny(), n_frames=N_FRAMES, seed=3,
                             step=0.25)
    return fr


def _run(cfg, frames, graphs: bool, **kw) -> SlamEngine:
    eng = SlamEngine(cfg, device="cpu", graphs=graphs, **kw)
    for left, right in frames:
        T = eng.process(left, right)
        np.testing.assert_array_equal(T, eng.trajectory[-1])
    return eng


def _same(a: SlamEngine, b: SlamEngine) -> None:
    """Two engines' trajectories, frame stats (less the clock), anchors,
    maps and tracking state bit-equal."""
    np.testing.assert_array_equal(np.stack(a.trajectory),
                                  np.stack(b.trajectory))
    np.testing.assert_array_equal(np.stack(a.trajectory_refined()),
                                  np.stack(b.trajectory_refined()))
    strip = [{k: v for k, v in s.items() if k != "elapsed_ms"}
             for s in a.frame_stats]
    assert strip == [{k: v for k, v in s.items() if k != "elapsed_ms"}
                     for s in b.frame_stats]
    assert [s for s, _ in a._traj_anchor] == [s for s, _ in b._traj_anchor]
    for f in a.map._fields:
        assert torch.equal(getattr(a.map, f), getattr(b.map, f)), f
    for f in ("T_cw", "velocity", "_latest_kf_T_dev", "_kf_ab"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a._kf_img is None) == (b._kf_img is None)
    if a._kf_img is not None:
        assert torch.equal(a._kf_img, b._kf_img)


@pytest.mark.parametrize("method", METHODS)
def test_static_process_is_the_eager_process(frames, method):
    """graphs=True on the CPU (the static buffers, no capture) against
    graphs=False: every pose, flag, inlier count, map field and the
    tracking state bit-equal over 17 frames with keyframe-ring culls."""
    cfg = _cfg(method)
    eager = _run(cfg, frames, graphs=False)
    static = _run(cfg, frames, graphs=True)
    assert eager._static is None and static._static is not None
    assert static.graph_stats() is None               # nothing captured
    assert sum(s["kf"] for s in eager.frame_stats) >= 5
    assert int(eager.map.kf_valid.sum()) < eager.n_keyframes   # culled
    _same(static, eager)


@pytest.mark.parametrize("method", ["hybrid", "direct"])
def test_anchor_is_a_copy(frames, method):
    """The photometric anchor is not the static image buffer that the next
    frame overwrites, and holds the latest keyframe's image."""
    eng = _run(_cfg(method), frames, graphs=True)
    st = eng._static
    assert eng._kf_img.data_ptr() != st.img.data_ptr()
    last_kf = max(i for i, s in enumerate(eng.frame_stats) if s["kf"])
    np.testing.assert_array_equal(eng._kf_img.numpy(), frames[last_kf][0])


def _reloc_frames():
    """tests/test_torch_engine_process.py's relocalization case: 12 frames
    of a circle, 2 of noise, then poses 4-5 again."""
    cfg = SlamConfig.tiny()
    world = make_world(cfg, seed=7, half_width=15.0, half_length=15.0,
                       ground_y=1.6)
    n, radius = 48, 6.0
    dT = se3.exp(torch.tensor([0, 0, 2 * np.pi * radius / n, 0,
                               2 * np.pi / n, 0.0]))
    T, gt = torch.eye(4), []
    for _ in range(n):
        gt.append(T.numpy().copy())
        T = se3.normalize(dT @ T)
    frames = [render_stereo(world, T) for T in gt[:12]]
    rng = np.random.default_rng(1)
    shape = frames[0][0].shape
    frames += [(rng.uniform(0, 255, shape).astype(np.float32),
                rng.uniform(0, 255, shape).astype(np.float32))
               for _ in range(2)]
    frames += [render_stereo(world, T) for T in gt[4:6]]
    return cfg, frames


def test_relocalization_retrack_is_the_eager_one():
    """With a vocabulary, a lost frame relocalizes and the static path
    re-tracks it from the relocalized pose by copying into its buffers:
    the events, poses and maps bit-equal to graphs=False."""
    cfg, frames = _reloc_frames()
    corpus = torch.cat([f.desc[f.valid] for f in (
        extract(torch.from_numpy(lf), cfg.extractor)
        for lf, _ in frames[::4])]).numpy()
    voc = TV.train(corpus, k=6, levels=3, seed=0)
    eager = _run(cfg, frames, graphs=False, vocab=voc)
    static = _run(cfg, frames, graphs=True, vocab=voc)
    rel = [e for e in static.loop_events if "reloc_to" in e]
    assert rel, static.loop_events
    assert static.loop_events == eager.loop_events
    assert static.frame_stats[-1]["inliers"] >= cfg.tracker.min_matches
    _same(static, eager)


def test_checkpoint_restore_repoints_the_buffers(frames, tmp_path):
    """A checkpoint loaded into an engine that has run (its static buffers
    bound) is copied into the same buffers: the run resumed from frame 8
    ends bit-equal to the uninterrupted one."""
    cfg = _cfg("indirect")
    path = os.path.join(tmp_path, "state")
    ref = SlamEngine(cfg, device="cpu", graphs=False)
    for i, (left, right) in enumerate(frames):
        if i == 8:
            checkpoint.save(ref, path)
        ref.process(left, right)
    eng = _run(cfg, frames[:12], graphs=True)
    st = eng._static
    checkpoint.load(eng, path)
    for left, right in frames[8:]:
        eng.process(left, right)
    assert eng._static is st
    _same(eng, ref)


@pytest.mark.parametrize("method", METHODS)
def test_tracking_programs_read_nothing_back(frames, monkeypatch, method):
    """_build and the tracking program, as the static path runs them after
    its first frame, make no host read, no upload and no data-dependent
    shape (the kernels' plain twins excused, as in
    tests/test_torch_graph_step.py)."""
    eng = _run(_cfg(method), frames[:4], graphs=True)
    st = eng._static
    st.img.copy_(torch.from_numpy(frames[4][0]))
    guard = HostReadGuard()
    for mod, names in PLAIN_TWINS:
        stand_aside(monkeypatch, guard, mod, names)
    with torch.no_grad(), guard, HostOpGuard(guard):
        st._track(eng, eng._build(st.img))
    assert guard.seen == []


def test_loop_events_property():
    """loop_events reads as a list and a checkpoint restore sets it."""
    eng = SlamEngine(SlamConfig.tiny(), device="cpu")
    assert eng.loop_events == []
    ev = ({"frame": 3, "reloc_to": 0, "inliers": 40},)
    eng.loop_events = ev
    assert eng.loop_events == list(ev) and isinstance(eng.loop_events, list)
