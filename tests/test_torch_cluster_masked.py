"""The cluster tracker's fused step, branching on device flags, on the CPU.

cluster/tracker.fused_step branches as the JAX program does
(lax.cond(skip, ...), the lax.scan of lax.cond-gated RANSAC rounds):
each side of the skip gate and each round is a utils/cuda_graphs.run_if
body on a device flag, which FusedDenseTracker captures as an IF node
of one CUDA graph; on the CPU run_if's plain version reads the flag.
`host_gated_step` below is the step as the port ran it before its graph:
the skip gate and each round's stop flag read on the host, a round after
the stop not run, each PnP-RANSAC's uniforms drawn from its threefry
key. The two are held equal bit for bit over frames of
make_cluster_scene (cut to 188x320 and one mover) that include a skipped
frame (a pair given twice) and frames whose rounds stop early, with the
rounds run counted equal, and the step is shown to make no host read
but the plain version's flag reads. tests/test_torch_cuda.py holds the
replayed graph to the eager step on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.cluster import tracker as trk
from slam_toolkit_tpu_torch.data.synthetic import make_cluster_scene
from slam_toolkit_tpu_torch.utils import cuda_graphs, threefry

from torch_host_guard import HostOpGuard, HostReadGuard, stand_aside

torch.set_num_threads(1)

H, W = 188, 320
# scene frame of each step; the pair of frame 1 twice: the second time
# the flow is zero and the skip gate holds
ORDER = (0, 1, 1, 2, 3, 4)


def _old_pack(labels, skipped, flow_p95, n_points, n_tracked, n_new, sizes,
              is_ground, cluster_ok, cluster_T) -> torch.Tensor:
    def f(v):
        if isinstance(v, torch.Tensor):
            return v.float().reshape(-1)
        return torch.full((1,), float(v), device=labels.device)
    return torch.cat([f(labels), f(skipped), f(flow_p95), f(n_points),
                      f(n_tracked), f(n_new), f(sizes), f(is_ground),
                      f(cluster_ok), f(cluster_T)])


def host_gated_step(state, gl, gr, key, cam, cfg, grid_shape):
    """The fused step with host reads (the port before its CUDA graph):
    (new state, packed row, RANSAC rounds run)."""
    C = cfg.max_clusters
    f = trk.dense_frame(gl, gr, state.prev_gray, cam, cfg)
    n_points = torch.sum(f.pts_valid)
    if bool(f.flow_p95 < cfg.min_flow_p95):
        zc = torch.zeros(C)
        return state, _old_pack(state.labels, 1.0, f.flow_p95, n_points,
                                -1.0, 0.0, zc, state.is_ground, zc,
                                torch.zeros(C, 4, 4)), None
    out = trk.track_clusters(f, state.labels, state.prev_depth,
                             state.is_ground, state.alive, key, cam, cfg,
                             grid_shape)
    labels, alive, is_ground, ever = (out.labels, state.alive,
                                      state.is_ground, state.ever_created)
    n_new = torch.zeros((), dtype=torch.int64)
    stop = torch.sum(labels < 0) < 10
    rounds = 0
    for rnd in range(cfg.max_ransac_rounds):
        if bool(stop):
            break
        rounds += 1
        ground_round = ~ever
        rout = trk.ransac_round(f, labels < 0, state.prev_depth,
                                ground_round, threefry.fold_in(key, 100 + rnd),
                                cam, cfg, grid_shape)
        labels, alive, is_ground, ever, done, made = trk._new_clusters(
            rout, labels, alive, is_ground, ever, ground_round, cfg)
        n_new = n_new + made
        stop = done | (torch.sum(labels < 0) < 10)
    cnt = trk._counts(torch.where(labels >= 0, labels, C), C + 1)
    new_state = trk.FusedState(labels=labels, is_ground=is_ground,
                               alive=cnt[:C] > 0, ever_created=ever,
                               prev_gray=gl, prev_depth=f.depth)
    return new_state, _old_pack(labels, 0.0, f.flow_p95, n_points,
                                torch.sum(labels >= 0), n_new, cnt[:C],
                                is_ground, out.cluster_ok,
                                out.cluster_T), rounds


@pytest.fixture(scope="module")
def scene():
    sc = make_cluster_scene(n_frames=max(ORDER) + 1, height=H, width=W,
                            n_movers=1)
    cam = dataclasses.replace(sc.cam, width=W, height=H, cx=W / 2.0,
                              cy=H / 2.0)
    cfg = trk.DenseConfig(max_points=2624)
    _, _, gs = trk._sample_grid(H, W, cfg.sample_stride, cfg.max_points)
    frames = [tuple(torch.from_numpy(a) for a in sc.frames[i])
              for i in ORDER]
    return cam, cfg, gs, frames


@pytest.fixture(scope="module")
def runs(scene):
    """Both steps over the frames from the same seed: each step's (state,
    row), the reference's rounds and the rounds fused_step ran. fused_step
    writes the state it is given, so it gets a copy of the last one."""
    cam, cfg, gs, frames = scene
    seed = trk.FusedDenseTracker(cam, cfg, device="cpu")._seed(*frames[0])
    old, new = seed, seed
    out = []
    for i, (gl, gr) in enumerate(frames[1:]):
        key = threefry.prng_key(i + 2)
        old, row_old, rounds = host_gated_step(old, gl, gr, key, cam, cfg,
                                               gs)
        ran = cuda_graphs.plain_runs["round"]
        new, row_new = trk.fused_step(
            trk.FusedState(*(t.clone() for t in new)), gl, gr,
            torch.from_numpy(trk.frame_draws(key, cfg)), cam, cfg, gs)
        out.append((old, row_old, rounds, new, row_new,
                    cuda_graphs.plain_runs["round"] - ran))
    return out


def test_masked_step_is_the_host_gated_step(runs, scene):
    """Every frame's packed row and state bit-equal to the host-gated
    step's; the frames include a skipped one, one that made clusters and
    one whose rounds stopped before cfg.max_ransac_rounds."""
    _, cfg, _, _ = scene
    for old, row_old, rounds, new, row_new, ran in runs:
        assert torch.equal(row_new, row_old)
        for name, a, b in zip(trk.FusedState._fields, new, old):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert ran == (rounds or 0)
    rounds = [o[2] for o in runs]
    assert None in rounds                             # skipped
    assert any(r is not None and 0 < r < cfg.max_ransac_rounds
               for r in rounds), rounds
    assert any(float(o[1][cfg.max_points + 4]) > 0 for o in runs)


def test_skipped_frame_keeps_the_state(runs, scene):
    """The skipped frame (the same pair again) returns the state it was
    given, the previous frame included, value for value, and the skipped
    row: n_tracked -1, no motions, no sizes."""
    _, cfg, _, _ = scene
    i = [k for k, o in enumerate(runs) if o[2] is None][0]
    before, after = runs[i - 1][3], runs[i][3]
    for name, a, b in zip(trk.FusedState._fields, after, before):
        assert torch.equal(a, b), name
    v = runs[i][4].numpy()
    P, C = cfg.max_points, cfg.max_clusters
    assert v[P] == 1.0 and v[P + 3] == -1.0 and v[P + 4] == 0.0
    assert not v[P + 5:P + 5 + C].any() and not v[P + 5 + 3 * C:].any()


def test_masked_step_reads_nothing_back(scene, monkeypatch):
    """fused_step on the CPU makes no host read, no upload and no
    data-dependent shape but run_if's plain flag reads (an IF node's
    flag on the card): nothing a CUDA graph cannot capture."""
    cam, cfg, gs, frames = scene
    state = trk.FusedDenseTracker(cam, cfg, device="cpu")._seed(*frames[0])
    draws = torch.from_numpy(trk.frame_draws(threefry.prng_key(2), cfg))
    guard = HostReadGuard()
    stand_aside(monkeypatch, guard, cuda_graphs, ("taken",))
    with torch.no_grad(), guard, HostOpGuard(guard):
        new, row = trk.fused_step(state, *frames[1], draws, cam, cfg, gs)
    assert guard.seen == []
    assert guard.paused == 0
    assert row.shape == (cfg.max_points + 5 + 3 * cfg.max_clusters
                         + 16 * cfg.max_clusters,)


@pytest.mark.parametrize("shape,n_keys", [((64, 4), 16), ((100, 4), 6),
                                          ((3,), 1)])
def test_uniform_rows_are_the_keys_uniforms(shape, n_keys):
    """threefry.uniform_rows (every key in one hash) gives each key's
    uniform() draws bit for bit, and choice_p_rows from them the same
    indices as from the keys."""
    keys = threefry.split(threefry.prng_key(41), n_keys)
    u = threefry.uniform_rows(keys, shape)
    want = np.stack([threefry.uniform(k, shape).reshape(-1) for k in keys])
    np.testing.assert_array_equal(u, want)
    p = torch.rand(n_keys, 37, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(
        threefry.choice_p_rows(None, p, shape, u=torch.from_numpy(u)),
        threefry.choice_p_rows(keys, p, shape))


def test_frame_draws_layout():
    """frame_draws: track_clusters' split keys' draws, then each round's
    fold_in(key, 100 + round) draws, every round's."""
    cfg = trk.DenseConfig()
    key = threefry.prng_key(9)
    d = trk.frame_draws(key, cfg)
    nt = cfg.max_clusters * trk.TRACK_HYPOTHESES * trk.SAMPLE
    assert d.dtype == np.float32 and d.shape == (
        nt + cfg.max_ransac_rounds * trk.ROUND_HYPOTHESES * trk.SAMPLE,)
    np.testing.assert_array_equal(
        d[:nt], np.concatenate([threefry.uniform(k, (64, 4)).reshape(-1)
                                for k in threefry.split(key, 16)]))
    np.testing.assert_array_equal(
        d[nt + 400 * 5:], threefry.uniform(threefry.fold_in(key, 105),
                                           (100, 4)).reshape(-1))


def test_tracker_runs_the_masked_step_on_the_cpu(scene):
    """FusedDenseTracker on the CPU (graphs=True asks for graphs only on a
    card) gives fused_step's rows, and captures nothing."""
    cam, cfg, gs, frames = scene
    tr = trk.FusedDenseTracker(cam, cfg, queue_depth=0, device="cpu")
    assert not tr.graphed
    assert tr.process(*frames[0]) is None
    got = tr.process(*frames[1])
    state = trk.FusedDenseTracker(cam, cfg, device="cpu")._seed(*frames[0])
    _, row = trk.fused_step(state, *frames[1], torch.from_numpy(
        trk.frame_draws(threefry.prng_key(2), cfg)), cam, cfg, gs)
    np.testing.assert_array_equal(got["labels"],
                                  row[:cfg.max_points].numpy().astype(
                                      np.int32))
    assert got["n_tracked"] == int(row[cfg.max_points + 3])
    assert tr.graph_stats() is None and tr.waits == 0
