"""The JAX programs' lax.cond as utils/cuda_graphs.run_if, on the CPU.

On a card run_if is a CUDA-graph IF node inside a capture: the chunk's
graph runs each frame's keyframe event under one on the device flag, and
the cluster step's skip gate and RANSAC rounds under one each. Off a
capture it is its plain version, which reads the flag on the host; a
warm-up runs every body. These tests hold the plain version and the
launch counting of bodies on the CPU, the restructured cluster
fused_step against the host-gated step (bit for bit, the rounds run
counted equal) and JAX fused_step (bit for bit but the flow p95 and the
motions' float rounding), and the chunk's frame function against
the eager step, with no host read but the flag's.
tests/test_torch_cuda.py holds the captured graphs to eager on the card.
"""

import dataclasses
import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolkit_tpu.cluster import tracker as j_trk
from slam_toolkit_tpu.config import CameraConfig as JCam
from slam_toolkit_tpu_torch.cluster import tracker as t_trk
from slam_toolkit_tpu_torch.config import CameraConfig as TCam
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data.synthetic import make_sequence
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
from slam_toolkit_tpu_torch.utils import cuda_graphs, cuda_lib, threefry

import torch_cluster_scene as tcs
from test_torch_cluster_masked import host_gated_step
from torch_host_guard import (PLAIN_TWINS, HostOpGuard, HostReadGuard,
                              stand_aside)

torch.set_num_threads(1)

# scene frames of each cluster step after the seed (frame 0): frame 2's
# pair twice, so that the second time the flow is zero and the gate skips
CLUSTER_ORDER = (0, 1, 2, 2, 3, 4, 5, 6)


# ---- run_if's plain version and warm-up --------------------------------
@pytest.mark.parametrize("flag", [True, False])
def test_plain_if_runs_the_body_when_set(flag):
    """Off a capture the body runs exactly when the flag is set, with its
    arguments, and plain_runs counts it under its name."""
    seen = []
    n0 = cuda_graphs.plain_runs["t_plain"]
    cuda_graphs.run_if(torch.tensor(flag), seen.append, 7, name="t_plain")
    assert seen == ([7] if flag else [])
    assert cuda_graphs.plain_runs["t_plain"] - n0 == int(flag)


def test_warm_up_runs_every_body():
    """Inside a warm-up every body runs, its flag unread and uncounted;
    after it the plain version reads flags again."""
    seen = []
    n0 = cuda_graphs.plain_runs["t_warm"]
    with cuda_graphs.warming():
        cuda_graphs.run_if(torch.tensor(False), seen.append, 1,
                           name="t_warm")
        cuda_graphs.run_if(torch.tensor(True), seen.append, 2,
                           name="t_warm")
    cuda_graphs.run_if(torch.tensor(False), seen.append, 3, name="t_warm")
    assert seen == [1, 2]
    assert cuda_graphs.plain_runs["t_warm"] == n0


class _Owner:
    """Stands for the StepGraphs that holds a body."""


def test_executions_counter_counts():
    """A body's launches are counted once per execution when a count is
    read: at `launches`, at launch_counts(), into an open counting()
    block; nothing before a replay marks the counts unsettled, nothing on
    a thread that did not replay them, and a body whose graph is gone is
    read once more, then dropped."""
    k = cuda_lib.LaunchCount()
    runs = torch.zeros((), dtype=torch.int64)
    owner = _Owner()
    cuda_lib.defer(owner, runs, {k: 3})
    runs.add_(2)
    assert k.launches == 0                 # no replay marked since
    cuda_lib.mark_unsettled(owner)
    assert k.launches == 6
    runs.add_(1)
    cuda_lib.mark_unsettled(owner)
    with cuda_lib.counting() as d:
        runs.add_(1)                       # a replay inside the block
        cuda_lib.mark_unsettled(owner)
    assert d == {k: 3}                     # the run before is not the block's
    assert k.launches == 12
    with cuda_lib.counting() as d:
        cuda_lib.mark_unsettled(owner)     # a replay that skipped the body
    assert d == {}
    k.launches = 0
    runs.add_(4)
    cuda_lib.mark_unsettled(owner)
    other = threading.Thread(target=cuda_lib.settle)
    other.start()
    other.join()
    assert k._n == 0                       # not that thread's replay
    assert k in cuda_lib.launch_counts() and k.launches == 12
    runs.add_(1)
    cuda_lib.mark_unsettled(owner)
    del owner
    gc.collect()
    assert k.launches == 15
    assert all(e[1] is not runs for e in cuda_lib._DEFERRED)


class _Lib:
    """Stands for the kernel library's error strings."""
    class cdll:
        @staticmethod
        def slam_cuda_error_string(err):
            return b"operation not supported"


def test_if_node_refuses(monkeypatch):
    """There is no fallback: inside a capture a flag that is not a
    one-element bool on the card raises before any node is added, and an
    IF node the library cannot add (CUDA before 12.4) raises."""
    g = cuda_graphs.StepGraphs("cpu")
    seen = []
    for flag in (torch.tensor(True), torch.ones(()), torch.ones(2, 1)):
        with pytest.raises(ValueError, match="bool CUDA tensor"):
            g._if_node(flag, seen.append, (1,), "x")
    assert g._bodies == [] and seen == []
    monkeypatch.setattr(cuda_lib, "library", lambda: _Lib)
    with pytest.raises(RuntimeError, match="conditional nodes need CUDA"):
        cuda_graphs._check(801, "slam_if_begin")
    cuda_graphs._check(0, "slam_if_begin")


# ---- the cluster step --------------------------------------------------
@pytest.fixture(scope="module")
def cluster_runs():
    """The scene's frames through JAX fused_step (jitted), the port's
    fused_step (run_if's plain version) and the host-gated step from the
    same seed: per step the JAX row, the port's (state, row, rounds run)
    and the host-gated (state, row, rounds)."""
    cam_kw = dict(fx=tcs.FX, fy=tcs.FX, cx=64.0, cy=48.0,
                  baseline=tcs.BASE, width=tcs.W, height=tcs.H)
    tcam, cfg_kw = TCam(**cam_kw), tcs.tracker_args()[1]
    jcam = JCam(**cam_kw)
    cfg = t_trk.DenseConfig(**cfg_kw)
    jcfg = j_trk.DenseConfig(**cfg_kw)
    _, _, gs = t_trk._sample_grid(tcs.H, tcs.W, cfg.sample_stride,
                                  cfg.max_points)
    frames = [tcs.make_scene(t) for t in CLUSTER_ORDER]
    jtr = j_trk.FusedDenseTracker(jcam, jcfg)
    jtr._state = jtr._seed_fn(jnp.asarray(frames[0][0]),
                              jnp.asarray(frames[0][1]))
    seed = t_trk.FusedDenseTracker(tcam, cfg, device="cpu")._seed(
        *(torch.from_numpy(a) for a in frames[0]))
    new, old = seed, seed
    out = []
    for i, (l, r) in enumerate(frames[1:]):
        key = threefry.prng_key(i + 2)
        jtr._state, jrow = jtr._step_fn(jtr._state, jnp.asarray(l),
                                        jnp.asarray(r),
                                        jax.random.PRNGKey(i + 2))
        gl, gr = torch.from_numpy(l), torch.from_numpy(r)
        ran = cuda_graphs.plain_runs["round"]
        new, row = t_trk.fused_step(
            t_trk.FusedState(*(t.clone() for t in new)), gl, gr,
            torch.from_numpy(t_trk.frame_draws(key, cfg)), tcam, cfg, gs)
        ran = cuda_graphs.plain_runs["round"] - ran
        old, row_h, rounds = host_gated_step(old, gl, gr, key, tcam, cfg,
                                             gs)
        out.append((np.asarray(jrow), new, row, ran, old, row_h, rounds))
    return cfg, out


def test_cluster_step_is_the_host_gated_step(cluster_runs):
    """The step with its branches under run_if: every row and state
    bit-equal to the host-gated step's, and the rounds it runs the
    host-gated count, over frames with a skipped one and rounds that stop
    before max_ransac_rounds."""
    cfg, out = cluster_runs
    for _, new, row, ran, old, row_h, rounds in out:
        assert torch.equal(row, row_h)
        for name, a, b in zip(t_trk.FusedState._fields, new, old):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert ran == (rounds or 0)
    rounds = [o[6] for o in out]
    assert None in rounds
    assert any(r is not None and 0 < r < cfg.max_ransac_rounds
               for r in rounds), rounds


def test_cluster_step_matches_jax_fused_step(cluster_runs):
    """Against JAX fused_step (lax.cond gate, lax.scan of lax.cond rounds)
    on every frame: labels, the skip flag, the point, tracked and new
    cluster counts, sizes, ground and accepted flags bit for bit; the
    flow p95 within 1e-6 relative and the accepted motions within 1e-3
    (float32 rounding of the two packages' arithmetic, as
    test_torch_cluster_tracker.py holds the motions)."""
    cfg, out = cluster_runs
    P, C = cfg.max_points, cfg.max_clusters
    exact = np.r_[0:P + 1, P + 2:P + 5 + 3 * C]
    for t, (jrow, _, row, _, _, _, _) in enumerate(out):
        row = row.numpy()
        np.testing.assert_array_equal(row[exact], jrow[exact],
                                      err_msg=str(t))
        np.testing.assert_allclose(row[P + 1], jrow[P + 1], rtol=1e-6)
        np.testing.assert_allclose(row[P + 5 + 3 * C:],
                                   jrow[P + 5 + 3 * C:], atol=1e-3)
    assert [bool(o[0][P] > 0.5) for o in out].count(True) == 1
    assert sum(o[0][P + 4] for o in out) >= 3          # clusters made


# ---- the chunk's frame function ----------------------------------------
FRAMES = 13


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


def test_frame_function_is_the_eager_step(images):
    """make_chunk_fn's frame (tracking, then the keyframe event under
    run_if on the flag) against make_frame_body over chunks with
    keyframes: rows and maps bit-equal, and the keyframe body run once
    for each row whose keyframe flag is set."""
    n0 = cuda_graphs.plain_runs["keyframe"]
    eng_g = ChunkedSlamEngine(_cfg(), chunk_size=4, device="cpu")
    rows_g = np.concatenate([eng_g.process_chunk(images[a:a + 4])
                             for a in range(0, FRAMES, 4)])
    ran = cuda_graphs.plain_runs["keyframe"] - n0
    eng_e = ChunkedSlamEngine(_cfg(), chunk_size=4, device="cpu",
                              graphs=False)
    rows_e = np.concatenate([eng_e.process_chunk(images[a:a + 4])
                             for a in range(0, FRAMES, 4)])
    np.testing.assert_array_equal(rows_g, rows_e)
    n_kf = int((rows_g[:, 34] > 0.5).sum())
    assert n_kf >= 2 and ran == n_kf
    assert (rows_g[:, 34] < 0.5).any()
    for f in eng_e.map._fields:
        assert torch.equal(getattr(eng_g.map, f), getattr(eng_e.map, f)), f


def test_frame_function_reads_nothing_back(images, monkeypatch):
    """The captured frame function, on a keyframe and on a tracking-only
    frame, reads nothing back to the host and uploads nothing but the
    plain version's flag read (an IF node's flag on the card)."""
    guard = HostReadGuard()
    for mod, names in PLAIN_TWINS + ((cuda_graphs, ("taken",)),):
        stand_aside(monkeypatch, guard, mod, names)
    eng = ChunkedSlamEngine(_cfg(), chunk_size=4, device="cpu")
    eng.process_chunk(images[:5])
    run = eng._chunk
    flags = []
    for i in (5, 6, 7, 8):
        run.left.copy_(torch.from_numpy(images[i, 0]))
        run.right.copy_(torch.from_numpy(images[i, 1]))
        with guard, HostOpGuard(guard):
            run._frame_step(run.static)
        flags.append(bool(run.row[34] > 0.5))
    assert guard.seen == [] and guard.paused == 0
    assert True in flags and False in flags, flags
