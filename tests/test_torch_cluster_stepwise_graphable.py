"""The stepwise cluster tracker's three programs on static buffers, on
the CPU.

cluster/tracker.DenseTracker runs the JAX tracker's three jitted
programs (_frame, _track, _round) on static buffers: a CUDA graph each
on a card, the same functions eagerly here. `EagerStepwise` below is
the tracker as the port ran it before: dense_frame, track_clusters and
each ransac_round called eagerly on fresh tensors, the host state
uploaded and every output read back field by field, each PnP-RANSAC's
uniforms drawn from its threefry key. The two are held equal bit for
bit over tests/torch_cluster_scene.py's frames, which include a pair
given again one grey level brighter (the skip gate holds) and rounds
that stop before
cfg.max_ransac_rounds; the three programs are shown to make no host
read or upload, and prev_gray / prev_depth to stay put on the skipped
frame. tests/test_torch_cuda.py holds the replayed graphs to
graphs=False on the card.
"""

from typing import Optional

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.cluster import tracker as trk
from slam_toolkit_tpu_torch.pipeline.engine import full_float32
from slam_toolkit_tpu_torch.utils import threefry

from torch_cluster_scene import make_scene, tracker_args
from torch_host_guard import HostOpGuard, HostReadGuard

torch.set_num_threads(1)

# scene frame of each call; frame 3's pair twice, the second time one
# grey level brighter: no motion, so the skip gate holds, yet images a
# tracker that wrongly advanced its previous frame would keep
ORDER = (0, 1, 2, 3, 3, 4, 5, 6)
SKIPPED = 4                       # the call that repeats a pair


class EagerStepwise:
    """The stepwise tracker's loop before its programs ran on static
    buffers, with its track_clusters and ransac_round calls counted
    (`tracks`, `rounds`)."""

    def __init__(self, cam, cfg):
        self.cam, self.cfg = cam, cfg
        self.prev_gray: Optional[torch.Tensor] = None
        self.prev_depth: Optional[torch.Tensor] = None
        self.frame_idx = 0
        self.labels: Optional[np.ndarray] = None
        self.is_ground = np.zeros(cfg.max_clusters, bool)
        self.alive = np.zeros(cfg.max_clusters, bool)
        self.ever_created = False
        self._grid_shape = None
        self.tracks = 0
        self.rounds = 0

    def _alloc_cluster(self, ground: bool) -> int:
        free = np.flatnonzero(~self.alive)
        if free.size == 0:
            return -1
        cid = int(free[0])
        self.alive[cid] = True
        self.is_ground[cid] = ground
        return cid

    def track(self, left, right) -> dict:
        with torch.no_grad(), full_float32():
            return self._track(torch.from_numpy(left),
                               torch.from_numpy(right))

    def _track(self, gl, gr) -> dict:
        cfg, cam = self.cfg, self.cam
        self.frame_idx += 1
        if self._grid_shape is None:
            _, _, self._grid_shape = trk._sample_grid(
                gl.shape[0], gl.shape[1], cfg.sample_stride, cfg.max_points)
        if self.prev_gray is None:
            self.prev_gray = gl
            self.prev_depth = trk.dense_frame(gl, gr, gl, cam, cfg).depth
            return {"skipped": True, "reason": "first frame"}
        f = trk.dense_frame(gl, gr, self.prev_gray, cam, cfg)
        p95 = float(f.flow_p95)
        if p95 < cfg.min_flow_p95:
            return {"skipped": True, "reason": "low motion",
                    "flow_p95": p95}
        key = threefry.prng_key(self.frame_idx)
        P = int(f.pts_uv.shape[0])
        clusters = []
        if self.labels is not None and self.alive.any():
            self.tracks += 1
            out = trk.track_clusters(
                f, torch.from_numpy(self.labels), self.prev_depth,
                torch.from_numpy(self.is_ground),
                torch.from_numpy(self.alive), key, cam, cfg,
                self._grid_shape)
            labels = out.labels.cpu().numpy().copy()
            ok = out.cluster_ok.cpu().numpy()
            inl = out.cluster_inl.cpu().numpy()
            Ts = out.cluster_T.cpu().numpy()
            for cid in np.flatnonzero(ok):
                clusters.append({
                    "id": int(cid), "tracked": True,
                    "is_ground": bool(self.is_ground[cid]),
                    "size": int((labels == cid).sum()),
                    "rigid_inliers": int(inl[cid]), "ok": True,
                    "T": Ts[cid]})
        else:
            labels = np.full(P, -1, np.int32)
        residual = labels < 0
        n_new = 0
        for rnd in range(cfg.max_ransac_rounds):
            if int(residual.sum()) < 10:
                break
            ground_round = not self.ever_created
            self.rounds += 1
            rout = trk.ransac_round(
                f, torch.from_numpy(residual), self.prev_depth,
                torch.full((), ground_round),
                threefry.fold_in(key, 100 + rnd), cam, cfg,
                self._grid_shape)
            comp = rout.comp.cpu().numpy()
            size = rout.comp_size.cpu().numpy()
            if int(rout.n_step1) < cfg.min_cluster_size:
                break
            big_roots = np.unique(comp[(comp >= 0)
                                       & (size >= cfg.min_cluster_size)])
            assigned = 0
            T_round = rout.T_cw.cpu().numpy()
            for root in big_roots:
                cid = self._alloc_cluster(ground_round)
                if cid < 0:
                    break
                members = comp == root
                labels[members] = cid
                residual[members] = False
                assigned += int(members.sum())
                n_new += 1
                clusters.append({
                    "id": cid, "tracked": False,
                    "is_ground": bool(self.is_ground[cid]),
                    "size": int(members.sum()),
                    "rigid_inliers": int(members.sum()), "ok": True,
                    "T": T_round})
                self.ever_created = True
            if assigned < cfg.min_cluster_size:
                break
        self.alive = np.isin(np.arange(cfg.max_clusters), labels)
        self.labels = labels
        self.prev_gray = gl
        self.prev_depth = f.depth
        return {"skipped": False, "flow_p95": p95,
                "n_points": int(f.pts_valid.sum()),
                "n_tracked": int((labels >= 0).sum()),
                "n_new_clusters": n_new,
                "labels": labels,
                "pts_uv": f.pts_uv.cpu().numpy(),
                "clusters": clusters}


@pytest.fixture(scope="module")
def setup():
    cam, kw = tracker_args()
    frames = [make_scene(t) for t in ORDER]
    frames[SKIPPED] = tuple(a + 1.0 for a in frames[SKIPPED])
    return cam, trk.DenseConfig(**kw), frames


@pytest.fixture(scope="module")
def runs(setup):
    """Both trackers over the frames: each call's result, the static
    tracker's prev_gray / prev_depth after each call, and both trackers."""
    cam, cfg, frames = setup
    old = EagerStepwise(cam, cfg)
    new = trk.DenseTracker(cam, cfg, device="cpu")
    out = []
    for left, right in frames:
        o, n = old.track(left, right), new.track(left, right)
        out.append((o, n, new.prev_gray.clone(), new.prev_depth.clone(),
                    new.runs["round"]))
    return out, old, new


def _same(a, b, path=""):
    """a and b equal value for value and type for type (arrays with
    their dtype), recursively."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_static_programs_are_the_eager_loop(runs, setup):
    """Every call's result dict equal to the eager loop's, value for value
    (labels, skip flags, new-cluster counts, each cluster's slot, size,
    inliers and motion T, flow_p95, the sample grid), and the rounds run
    equal, over frames with a skipped one, clusters made and tracked, and
    rounds stopping before cfg.max_ransac_rounds."""
    out, old, new = runs
    _, cfg, _ = setup
    for o, n, *_ in out:
        _same(n, o)
    assert new.runs["round"] == old.rounds > 0
    assert new.runs["frame"] == len(ORDER)
    assert new.runs["track"] == old.tracks > 0
    live = [i for i, (o, *_) in enumerate(out) if not o["skipped"]]
    assert out[SKIPPED][0]["reason"] == "low motion"
    assert sum(out[i][0]["n_new_clusters"] for i in live) >= 3
    assert any(c["tracked"] for i in live for c in out[i][0]["clusters"])
    per_frame = np.diff([0] + [r for *_, r in out])
    assert any(0 < r < cfg.max_ransac_rounds for r in per_frame), per_frame
    np.testing.assert_array_equal(new.labels, old.labels)
    np.testing.assert_array_equal(new.alive, old.alive)
    np.testing.assert_array_equal(new.is_ground, old.is_ground)


def test_skipped_frame_keeps_prev_frame(runs, setup):
    """prev_gray and prev_depth advance on a live frame (to its left image
    and depth) and stay as they were on the skipped one; the seed's
    prev_depth is dense_frame's of the seed pair against itself."""
    out, old, new = runs
    cam, cfg, frames = setup
    seed_l, seed_r = (torch.from_numpy(a) for a in frames[0])
    with torch.no_grad(), full_float32():
        seed_depth = trk.dense_frame(seed_l, seed_r, seed_l, cam, cfg).depth
    assert torch.equal(out[0][2], seed_l)
    assert torch.equal(out[0][3], seed_depth)
    for i in range(1, len(out)):
        pg, pd = out[i][2], out[i][3]
        if i == SKIPPED:
            assert torch.equal(pg, out[i - 1][2])
            assert torch.equal(pd, out[i - 1][3])
            assert not torch.equal(pg, torch.from_numpy(frames[i][0]))
        else:
            assert torch.equal(pg, torch.from_numpy(frames[i][0]))
            assert not torch.equal(pd, out[i - 1][3])
    assert torch.equal(new.prev_gray, old.prev_gray)
    assert torch.equal(new.prev_depth, old.prev_depth)
    # prev_frame is a copy: the static frame's next run leaves it alone
    kept = [t.clone() for t in new.prev_frame]
    new._frame_program()
    for a, b in zip(new.prev_frame, kept):
        assert torch.equal(a, b)


def test_static_frame_is_dense_frame(runs, setup):
    """The static DenseFrame's fields take dense_frame's dtypes and
    values."""
    _, _, new = runs
    cam, cfg, _ = setup
    with torch.no_grad(), full_float32():
        new._frame_program()
        want = trk.dense_frame(new._gl, new._gr, new.prev_gray, cam, cfg)
    for name, a, b in zip(trk.DenseFrame._fields, new._f, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    np.testing.assert_array_equal(
        new._frame_row.numpy(),
        [float(want.flow_p95), float(want.pts_valid.sum())])


@pytest.mark.parametrize("name", trk.DenseTracker.PROGRAMS)
def test_programs_read_nothing_back(runs, name):
    """Each of the three programs makes no host read, no upload and no
    data-dependent shape: nothing a CUDA graph cannot capture."""
    _, _, new = runs
    fn = getattr(new, f"_{name}_program")
    guard = HostReadGuard()
    with torch.no_grad(), full_float32(), guard, HostOpGuard(guard):
        fn()
    assert guard.seen == []


def test_cpu_tracker_captures_nothing(setup):
    """graphs=True asks for graphs only on a card: on the CPU the
    programs run eagerly and nothing is captured."""
    cam, cfg, frames = setup
    tr = trk.DenseTracker(cam, cfg, device="cpu")
    assert not tr.graphed and tr.graphs is None
    tr.track(*frames[0])
    assert tr.graph_stats() is None and tr.runs["frame"] == 1
