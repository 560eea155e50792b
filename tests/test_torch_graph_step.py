"""The static-carry step that scan_engine.make_chunk_fn captures as CUDA
graphs, on the CPU: against the eager step, bit for bit.

On a CUDA device make_chunk_fn launches one CUDA graph a chunk (its
frames a WHILE node; each frame tracking, then the keyframe event as an
IF node on the device flag) over a static carry, and
multi_sequence_chunk one for any number of lanes. On the CPU
the same functions run eagerly, as the graph's plain version: these
tests hold them to make_frame_body and make_batched_frame_body (the
eager steps, graphs=False) exactly, through
a keyframe-ring cull and a carry re-seeded from the host between chunks,
and show that the captured functions read nothing back to the host and
upload nothing. tests/test_torch_cuda.py holds the replayed graphs to
the eager step on the card. SlamConfig.tiny(), the port's own synthetic
sequence.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data.synthetic import make_sequence
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.parallel import mesh
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine

from torch_host_guard import (PLAIN_TWINS, HostOpGuard, HostReadGuard,
                              stand_aside)

torch.set_num_threads(1)

METHODS = ("indirect", "hybrid", "direct")
N_FRAMES = 17                     # frame 0 bootstraps, then 4 chunks of 4
CHUNKS = [(0, 5), (5, 9), (9, 13), (13, 17)]
RESEED_BEFORE = 2                 # the host re-seeds the carry before it
LANES = 2


def _cfg(method: str) -> SlamConfig:
    """The tiny configuration with a ring of 11 keyframes that culls
    between the chunks (decay 0.95 makes keyframes often)."""
    cfg = SlamConfig.tiny()
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, method=method),
        map=dataclasses.replace(cfg.map, max_keyframes=11),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))


@pytest.fixture(scope="module")
def images():
    _, _, frames = make_sequence(SlamConfig.tiny(), n_frames=N_FRAMES,
                                 seed=3, step=0.25)
    return np.stack([np.stack([l, r]) for l, r in frames]).astype(
        np.float32)


def _run(method: str, images, graphs: bool):
    """The engine over CHUNKS; before chunk RESEED_BEFORE the host
    re-seeds the head as a relocalization does (pose kept, velocity
    reset, inlier peak reset)."""
    eng = ChunkedSlamEngine(_cfg(method), chunk_size=4, device="cpu",
                            graphs=graphs)
    rows, culls = [], []
    for i, (a, b) in enumerate(CHUNKS):
        if i == RESEED_BEFORE:
            eng._rebuild_carry(T_cw=eng.carry.T_cw.clone(),
                               velocity=torch.eye(4))
        rows.append(eng.process_chunk(images[a:b]))
        culls.append(eng.n_culls)
    return eng, np.concatenate(rows), culls


@pytest.fixture(scope="module")
def runs(images):
    return {(m, g): _run(m, images, g) for m in METHODS
            for g in (False, True)}


@pytest.mark.parametrize("method", METHODS)
def test_static_step_is_the_eager_step(runs, method):
    """(a) make_chunk_fn's static-carry step against make_frame_body: every
    packed row bit-equal over four chunks, with keyframe-ring culls and a
    re-seeded carry between them; the maps and the trajectories equal."""
    (eager, rows_e, culls_e), (graph, rows_g, culls_g) = \
        runs[(method, False)], runs[(method, True)]
    assert culls_g == culls_e and culls_e[-1] >= 1, culls_e
    assert culls_e[RESEED_BEFORE - 1] < culls_e[-1]   # a cull after chunk 1
    assert (rows_e[:, 34] > 0.5).sum() >= 4
    assert rows_g.shape == (N_FRAMES - 1, 36)
    np.testing.assert_array_equal(rows_g, rows_e)
    for f in eager.map._fields:
        assert torch.equal(getattr(graph.map, f), getattr(eager.map, f)), f
    for f in ("T_cw", "velocity", "lm_Xw", "lm_ids", "lm_valid",
              "latest_slot", "latest_T", "inlier_peak", "kf_img", "kf_ab",
              "kf_refvals"):
        a, b = getattr(graph.carry, f), getattr(eager.carry, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    np.testing.assert_array_equal(np.stack(graph.trajectory_refined()),
                                  np.stack(eager.trajectory_refined()))


def _batched_run(images, graphs: bool):
    """Two lanes (the sequence and its frames shifted by one) through
    multi_sequence_chunk: frames 1-8 and 9-16 as two chunks; before the
    second the host resets every lane's velocity."""
    cfg = _cfg("indirect")
    cam = StereoCamera.from_config(cfg.camera, "cpu")
    seqs = np.stack([images[:N_FRAMES - 1], images[1:]], axis=1)
    imgs = torch.from_numpy(seqs)                    # (16, 2, 2, H, W)
    carry = mesh.batched_bootstrap(cfg, cam)(
        mesh.batched_empty_map(cfg, LANES, "cpu"), imgs[0, :, 0],
        imgs[0, :, 1])
    chunk = mesh.multi_sequence_chunk(cfg, cam, graphs=graphs)
    carry, p0 = chunk(carry, imgs[1:8])
    carry = carry._replace(velocity=torch.eye(4).repeat(LANES, 1, 1))
    carry, p1 = chunk(carry, imgs[8:])
    return carry, torch.cat([p0, p1]).numpy()


def test_batched_static_step_is_the_eager_step(images):
    """(b) multi_sequence_chunk's static batched step against
    make_batched_frame_body, two lanes: every packed row and the maps
    bit-equal, across a carry the host changed between the chunks."""
    c_e, rows_e = _batched_run(images, False)
    c_g, rows_g = _batched_run(images, True)
    assert rows_g.shape == (N_FRAMES - 2, LANES, 36)
    assert (rows_e[..., 34] > 0.5).sum(0).min() >= 2
    np.testing.assert_array_equal(rows_g, rows_e)
    for f in c_e.m._fields:
        assert torch.equal(getattr(c_g.m, f), getattr(c_e.m, f)), f
    assert int(c_g.frame_id) == c_e.frame_id == N_FRAMES - 1


# ---- (c) nothing read back or uploaded inside the captured functions ---
@pytest.fixture
def guard(monkeypatch):
    g = HostReadGuard()
    for mod, names in PLAIN_TWINS:
        stand_aside(monkeypatch, g, mod, names)
    return g


@pytest.mark.parametrize("method", METHODS)
def test_captured_functions_read_nothing_back(images, guard, method):
    """(c) The frame graph's two halves (tracking; the keyframe event, its
    IF body), after one warm-up call (the engine's first chunk), run with
    no host read or upload."""
    eng = ChunkedSlamEngine(_cfg(method), chunk_size=4, device="cpu")
    eng.process_chunk(images[:5])
    run = eng._chunk
    run.left.copy_(torch.from_numpy(images[5, 0]))
    run.right.copy_(torch.from_numpy(images[5, 1]))
    with guard, HostOpGuard(guard):
        t = run._track_step(run.static)
        run._keyframe_step(run.static, t)
    assert guard.seen == []
    assert guard.paused == 0


def test_batched_captured_functions_read_nothing_back(images, guard):
    """(c) The batched frame graph's halves (the keyframe event over both
    lanes, the flags as its mask) the same way."""
    cfg = _cfg("indirect")
    cam = StereoCamera.from_config(cfg.camera, "cpu")
    imgs = torch.from_numpy(np.stack([images[:8], images[1:9]], axis=1))
    carry = mesh.batched_bootstrap(cfg, cam)(
        mesh.batched_empty_map(cfg, LANES, "cpu"), imgs[0, :, 0],
        imgs[0, :, 1])
    run = mesh.multi_sequence_chunk(cfg, cam)
    run(carry, imgs[1:4])
    run.left.copy_(imgs[4, :, 0])
    run.right.copy_(imgs[4, :, 1])
    with guard, HostOpGuard(guard):
        t = run._track_step(run.static)
        run._keyframe_step(run.static, t)
    assert guard.seen == []


GUARDED = {
    "bool": lambda x: bool(x[0] > 1),
    "item": lambda x: x.sum().item(),
    "0-dim index": lambda x: x[x.argmax()],
    "mask index": lambda x: x[x > 2],
    "nonzero": lambda x: torch.nonzero(x),
    "as_tensor": lambda x: torch.as_tensor(2.0),
    "cpu": lambda x: x.cpu()}


@pytest.mark.parametrize("case", list(GUARDED))
def test_guard_sees_host_reads(case):
    """The guard itself catches each kind of host read it is there for."""
    x = torch.arange(6.0)
    g = HostReadGuard()
    with g, HostOpGuard(g):
        GUARDED[case](x)
    assert g.seen, case


@pytest.mark.parametrize("method", METHODS)
def test_frame_id_advances_on_the_device(runs, method):
    """(d) The static carry's frame id is a 0-dim int32 that the step
    advances on the device; each keyframe's slot holds the id of its
    frame, as the eager engine's host counter wrote it."""
    (eager, rows, _), (graph, _, _) = runs[(method, False)], \
        runs[(method, True)]
    fid = graph.carry.frame_id
    assert torch.is_tensor(fid) and fid.dtype == torch.int32 and \
        fid.dim() == 0
    assert int(fid) == N_FRAMES
    assert eager.carry.frame_id == N_FRAMES
    m = graph.map
    valid = m.kf_valid.numpy()
    kf_frames = [i + 1 for i in np.flatnonzero(rows[:, 34] > 0.5)
                 if valid[int(rows[i, 32])]
                 and int(m.kf_frame_id[int(rows[i, 32])]) == i + 1]
    assert kf_frames, "no keyframe of the run is still in the ring"
    assert max(kf_frames) == max(np.flatnonzero(rows[:, 34] > 0.5)) + 1
    assert torch.equal(m.kf_frame_id, eager.map.kf_frame_id)


@pytest.mark.parametrize("method", ["hybrid", "direct"])
def test_anchor_is_not_the_input_buffer(runs, images, method):
    """(e) The photometric anchor is a copy: not the static image buffer
    that the next frame overwrites, and it holds the latest keyframe's
    image after the chunk, whatever frame came last."""
    (graph, rows, _) = runs[(method, True)]
    run = graph._chunk
    kf_img = graph.carry.kf_img
    assert kf_img.data_ptr() not in (run.left.data_ptr(),
                                     run.right.data_ptr())
    last_kf = int(np.flatnonzero(rows[:, 34] > 0.5)[-1]) + 1
    np.testing.assert_array_equal(kf_img.numpy(), images[last_kf, 0])
    if last_kf != N_FRAMES - 1:
        assert not torch.equal(kf_img, run.left)
