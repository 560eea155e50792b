"""Multi-sequence SLAM with the photometric trackers: the port's batched
layout (slam_toolkit_tpu_torch/parallel/mesh.py) for tracker.method
"direct" and "hybrid", against the JAX package's multi_sequence_chunk and
against each lane run alone, on the CPU.

Two sequences (tests/test_torch_mesh.py's first two: SlamConfig.tiny(),
seeds 100-101, steps 0.2 + 0.05 i, 6 frames) with decay_ratio 0.9, so
that both lanes take keyframes inside the chunk, on different frames
under "direct": the keyframe event runs over the lanes with the flags as
its mask. Frame 0 bootstraps every lane (batched_bootstrap, which gives
no photometric anchor, as the JAX package's); the anchor is then built
by hand on both sides as ChunkedSlamEngine builds its own (the left image
of frame 0, (a, b) = (0, 0), and for "hybrid" the anchor's pattern
intensities at latest_T); frames 1-5 run as one chunk. Bars against JAX
(tests/test_torch_mesh.py's): slot, ok and keyframe flags exact, poses
to 2e-3, inliers to 2. Between the port's layouts, and against each lane
through make_chunk_fn alone: bit for bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JConfig
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.geometry.camera import StereoCamera as JCamera
from slam_toolkit_tpu.optim import direct_lm as j_direct_lm
from slam_toolkit_tpu.parallel import mesh as j_mesh
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.optim import direct_lm
from slam_toolkit_tpu_torch.parallel import mesh
from slam_toolkit_tpu_torch.pipeline.scan_engine import lane, make_chunk_fn

torch.set_num_threads(1)

B = 2
N_FRAMES = 6
METHODS = ("direct", "hybrid")


def _with(cfg, method):
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, method=method),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.9))


@pytest.fixture(scope="module")
def frames():
    """(lefts, rights) (B, 6, H, W) float32 of the two sequences."""
    seqs = [make_sequence(JConfig.tiny(), n_frames=N_FRAMES, seed=100 + i,
                          step=0.2 + 0.05 * i) for i in range(B)]
    lefts = np.stack([[l for l, _ in s[2]] for s in seqs]).astype(np.float32)
    rights = np.stack([[r for _, r in s[2]] for s in seqs]).astype(
        np.float32)
    return lefts, rights


def _chunk_images(lefts, rights):
    """(C, B, 2, H, W): frames 1..5 of every lane."""
    return np.stack([np.stack([lefts[:, t], rights[:, t]], axis=1)
                     for t in range(1, lefts.shape[1])])


def _jax_rows(frames, method):
    """JAX's bootstrap with the anchor added, then multi_sequence_chunk's
    (C, B, 36) rows."""
    lefts, rights = frames
    cfg = _with(JConfig.tiny(), method)
    cam = JCamera.from_config(cfg.camera)
    carry = jax.jit(j_mesh.batched_bootstrap(cfg, cam))(
        j_mesh.batched_empty_map(cfg, B), jnp.asarray(lefts[:, 0]),
        jnp.asarray(rights[:, 0]))
    kf_img = jnp.asarray(lefts[:, 0])
    kf_ab = jnp.zeros((B, 2), jnp.float32)
    refvals = None
    if method == "hybrid":
        refvals = jax.jit(jax.vmap(
            lambda T, ab, img, X, v: j_direct_lm.reference_values(
                j_direct_lm.DirectState(T_cw=T, a=ab[0], b=ab[1]), img,
                cam.left, X, v, 1.0)))(carry.latest_T, kf_ab, kf_img,
                                       carry.lm_Xw, carry.lm_valid)
    carry = carry._replace(kf_img=kf_img, kf_ab=kf_ab, kf_refvals=refvals)
    _, packed = j_mesh.multi_sequence_chunk(cfg, cam)(
        carry, jnp.asarray(_chunk_images(lefts, rights)))
    return np.asarray(packed)


def _port_boot(frames, method):
    """The port's bootstrap with the anchor built by hand: each lane's
    pattern intensities by the single reference_values, as
    ChunkedSlamEngine's bootstrap computes them."""
    lefts, rights = frames
    cfg = _with(SlamConfig.tiny(), method)
    cam = StereoCamera.from_config(cfg.camera, "cpu")
    carry = mesh.batched_bootstrap(cfg, cam)(
        mesh.batched_empty_map(cfg, B, "cpu"), torch.from_numpy(lefts[:, 0]),
        torch.from_numpy(rights[:, 0]))
    kf_img = torch.from_numpy(lefts[:, 0]).clone()
    kf_ab = torch.zeros((B, 2), dtype=torch.float32)
    refvals = None
    if method == "hybrid":
        refvals = torch.stack([direct_lm.reference_values(
            direct_lm.DirectState(T_cw=carry.latest_T[b], a=kf_ab[b, 0],
                                  b=kf_ab[b, 1]),
            kf_img[b], cam.left, carry.lm_Xw[b], carry.lm_valid[b], 1.0)
            for b in range(B)])
    return cfg, cam, carry._replace(kf_img=kf_img, kf_ab=kf_ab,
                                    kf_refvals=refvals)


@pytest.fixture(scope="module", params=METHODS)
def runs(request, frames):
    """Per method: JAX's rows, and the port's batched chunk (graphed and
    eager), lane chunk and each lane through make_chunk_fn alone."""
    method = request.param
    imgs = torch.from_numpy(_chunk_images(*frames))
    out = {"method": method, "jax": _jax_rows(frames, method)}
    for name, make in (
            ("graphed", lambda c, cm: mesh.multi_sequence_chunk(c, cm)),
            ("eager", lambda c, cm: mesh.multi_sequence_chunk(
                c, cm, graphs=False)),
            ("lane", mesh.multi_sequence_lane_chunk)):
        cfg, cam, carry = _port_boot(frames, method)
        carry, packed = make(cfg, cam)(carry, imgs)
        out[name] = (carry, packed.numpy())
    cfg, cam, carry = _port_boot(frames, method)
    out["alone"] = [make_chunk_fn(cfg, cam)(lane(carry, b), imgs[:, b])[1]
                    .numpy() for b in range(B)]
    return out


def test_batched_layout_matches_jax(runs):
    """multi_sequence_chunk against JAX's from the same anchor: (C, B, 36)
    rows at tests/test_torch_mesh.py's bars, both lanes taking keyframes
    and tracking healthy."""
    got, want = runs["graphed"][1], runs["jax"]
    assert got.shape == want.shape == (N_FRAMES - 1, B, 36)
    np.testing.assert_array_equal(got[..., 32:35], want[..., 32:35])
    np.testing.assert_allclose(got[..., :16], want[..., :16], atol=2e-3)
    assert np.abs(got[..., 35] - want[..., 35]).max() <= 2
    assert (got[..., 34].sum(0) >= 1).all()
    assert (got[..., 33] > 0.5).mean() > 0.5


def test_layouts_are_bit_equal(runs):
    """The graphed and eager batched chunks and the lane chunk: rows,
    maps, snapshots and anchors bit for bit."""
    (c_g, p_g), (c_e, p_e), (c_l, p_l) = (runs[k] for k in
                                          ("graphed", "eager", "lane"))
    np.testing.assert_array_equal(p_g, p_e)
    np.testing.assert_array_equal(p_g, p_l)
    for f in c_e.m._fields:
        assert torch.equal(getattr(c_g.m, f), getattr(c_e.m, f)), f
        assert torch.equal(getattr(c_l.m, f), getattr(c_e.m, f)), f
    fields = ["lm_Xw", "lm_ids", "lm_valid", "latest_T", "kf_img", "kf_ab"]
    if runs["method"] == "hybrid":
        fields.append("kf_refvals")
    for f in fields:
        assert torch.equal(getattr(c_g, f), getattr(c_e, f)), f
        assert torch.equal(getattr(c_l, f), getattr(c_e, f)), f


def test_each_lane_is_its_single_chunk(runs):
    """Each lane of the batched layout bit-equal to make_chunk_fn run on
    that lane alone from the same carry."""
    for b in range(B):
        np.testing.assert_array_equal(runs["graphed"][1][:, b],
                                      runs["alone"][b])


def test_anchor_follows_each_lanes_keyframes(runs, frames):
    """After the chunk each lane's anchor image is its own latest
    keyframe's left image, and the lanes keyframe on their own frames."""
    carry, rows = runs["graphed"]
    lefts = frames[0]
    for b in range(B):
        last = int(np.flatnonzero(rows[:, b, 34] > 0.5)[-1]) + 1
        np.testing.assert_array_equal(carry.kf_img[b].numpy(),
                                      lefts[b, last])


def test_per_frame_engine_is_the_chunk(runs, frames):
    """multi_sequence_engine's per-frame step, frame by frame from the
    same anchor, gives the batched chunk's rows."""
    lefts, rights = frames
    cfg, cam, carry = _port_boot(frames, runs["method"])
    _, step = mesh.multi_sequence_engine(cfg, cam, mesh.make_mesh(1, "cpu"))
    rows = []
    for t in range(1, N_FRAMES):
        carry, packed = step(carry, torch.from_numpy(lefts[:, t]),
                             torch.from_numpy(rights[:, t]))
        rows.append(packed.numpy())
    np.testing.assert_array_equal(np.stack(rows), runs["graphed"][1])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("graphs", [True, False])
def test_carry_without_anchor_raises(frames, method, graphs):
    """batched_bootstrap's carry as it is (no anchor): the batched chunk
    raises ValueError naming the missing fields, where JAX's fails on a
    None field."""
    lefts, rights = frames
    cfg = _with(SlamConfig.tiny(), method)
    cam = StereoCamera.from_config(cfg.camera, "cpu")
    carry = mesh.batched_bootstrap(cfg, cam)(
        mesh.batched_empty_map(cfg, B, "cpu"), torch.from_numpy(lefts[:, 0]),
        torch.from_numpy(rights[:, 0]))
    want = "kf_img, kf_ab, kf_refvals" if method == "hybrid" else \
        "kf_img, kf_ab"
    with pytest.raises(ValueError, match=want):
        mesh.multi_sequence_chunk(cfg, cam, graphs=graphs)(
            carry, torch.from_numpy(_chunk_images(lefts, rights))[:1])
