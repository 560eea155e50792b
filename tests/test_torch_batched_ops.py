"""The batched stages of the multi-sequence step, on the CPU: each equals
its per-lane single call (integer outputs exact, floats to 1e-5), and
extraction and tracking over 2 lanes equal jax.vmap of the JAX package's
functions at the single calls' bars (tests/test_torch_extractor.py's
exact features; the pose to 2e-3, inliers to 2). The keyframe event's
batched kernels (SAD curves, local BA) and the event itself over lanes
with a lane mask: each kept lane exactly its single call, a masked lane
untouched, and the kernels' plain versions against jax.vmap of the JAX
package's at their bars (SAD rtol 1e-5 / atol 1e-3; BA T 3e-3, X
2e-2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JConfig
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.frontend import frame as j_frame
from slam_toolkit_tpu.frontend import tracker as j_tracker
from slam_toolkit_tpu.geometry.camera import StereoCamera as JCamera
from slam_toolkit_tpu.ops import extractor as j_ext
from slam_toolkit_tpu.ops import stereo_sad as j_sad
from slam_toolkit_tpu.optim import local_ba as j_ba
from slam_toolkit_tpu_torch.config import SlamConfig, TrackerConfig
from slam_toolkit_tpu_torch.frontend.frame import add_stereo, build_frame
from slam_toolkit_tpu_torch.frontend.matching import projection_match
from slam_toolkit_tpu_torch.frontend.tracker import track_pose
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.mapping import keyframe as kf_rule
from slam_toolkit_tpu_torch.mapping.map_state import MapState
from slam_toolkit_tpu_torch.ops import (ba_kernel, match_kernel, patches,
                                        pose_lm_kernel, stereo_sad)
from slam_toolkit_tpu_torch.ops.extractor import extract, extract_batch
from slam_toolkit_tpu_torch.optim.local_ba import BAProblem
from slam_toolkit_tpu_torch.parallel import mesh
from slam_toolkit_tpu_torch.pipeline.scan_engine import (_batched_tracker,
                                                         keyframe_event, lane)
from slam_toolkit_tpu_torch.tools.bench import with_option
from torch_ba_problems import ba_problem

torch.set_num_threads(1)

B = 3


def _close(a, b, **kw):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, **kw)


def _assert_lanes(batched, singles):
    """A NamedTuple with a leading lane axis against B single results."""
    for f in batched._fields:
        for b, one in enumerate(singles):
            _close(getattr(batched, f)[b], getattr(one, f))


@pytest.fixture(scope="module")
def scene():
    """B lanes of the tiny world (seeds 100..): frames 0 and 1, and each
    lane's bootstrapped carry (its landmark snapshot) from the port."""
    seqs = [make_sequence(JConfig.tiny(), n_frames=2, seed=100 + i,
                          step=0.25 + 0.05 * i) for i in range(B)]
    lefts = np.stack([[l for l, _ in s[2]] for s in seqs]).astype(np.float32)
    rights = np.stack([[r for _, r in s[2]] for s in seqs]).astype(
        np.float32)
    cfg = SlamConfig.tiny()
    cam = StereoCamera.from_config(cfg.camera, "cpu")
    carry = mesh.batched_bootstrap(cfg, cam)(
        mesh.batched_empty_map(cfg, B, "cpu"), torch.from_numpy(lefts[:, 0]),
        torch.from_numpy(rights[:, 0]))
    return cfg, cam, lefts, rights, carry


def _pred(B_):
    """A small motion per lane as the prediction (the lanes move ~0.25 m
    forward a frame)."""
    xi = torch.zeros((B_, 6))
    xi[:, 2] = -0.2
    return se3.exp(xi)


def test_extract_batch_equals_per_lane(scene):
    cfg, _, lefts, _, _ = scene
    imgs = torch.from_numpy(lefts[:, 1])
    fb = extract_batch(imgs, cfg.extractor)
    assert fb.desc.shape == (B, cfg.extractor.max_keypoints, 8)
    _assert_lanes(fb, [extract(imgs[b], cfg.extractor) for b in range(B)])


def test_extract_batch_matches_jax_vmap(scene):
    """2 lanes against jax.vmap of the JAX extract: keypoints, octaves,
    validity, descriptors exact; responses to 2e-3 (the +1e4 boost)."""
    cfg, _, lefts, _, _ = scene
    jcfg = JConfig.tiny()
    fj = jax.jit(jax.vmap(lambda x: j_ext.extract(x, jcfg.extractor)))(
        jnp.asarray(lefts[:2, 1]))
    ft = extract_batch(torch.from_numpy(lefts[:2, 1]), cfg.extractor)
    for f in ("valid", "xy", "octave", "sigma2"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(),
                                      np.asarray(getattr(fj, f)))
    np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32),
                                  np.asarray(fj.desc))
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response),
                               rtol=0, atol=2e-3)
    assert int(ft.valid.sum()) > 200


def test_projection_match_batched_equals_per_lane(scene):
    cfg, cam, lefts, _, carry = scene
    frame = build_frame(torch.from_numpy(lefts[:, 1]), cam, cfg)
    T = _pred(B)
    mb = projection_match(carry.lm_Xw, carry.lm_desc, carry.lm_valid,
                          frame.feats, T, cam, cfg.matcher,
                          cfg.matcher.projection_radius)
    singles = [projection_match(carry.lm_Xw[b], carry.lm_desc[b],
                                carry.lm_valid[b], lane(frame, b).feats,
                                T[b], cam, cfg.matcher,
                                cfg.matcher.projection_radius)
               for b in range(B)]
    _assert_lanes(mb, singles)
    assert (mb.n_matches > 20).all()


def test_track_pose_batched_equals_per_lane(scene):
    cfg, cam, lefts, _, carry = scene
    frame = build_frame(torch.from_numpy(lefts[:, 1]), cam, cfg)
    T = _pred(B)
    rb = track_pose(frame, carry.lm_Xw, carry.lm_desc, carry.lm_valid, T,
                    cam, cfg)
    _assert_lanes(rb, [track_pose(lane(frame, b), carry.lm_Xw[b],
                                  carry.lm_desc[b], carry.lm_valid[b], T[b],
                                  cam, cfg) for b in range(B)])
    assert bool(rb.ok.all())


def test_track_pose_batched_matches_jax_vmap(scene):
    """2 lanes against jax.vmap of the JAX build_frame + track_pose on the
    same landmarks: ok and keyframe-rule inputs, the pose to 2e-3,
    inliers to 2."""
    cfg, cam, lefts, _, carry = scene
    jcfg = JConfig.tiny()
    jcam = JCamera.from_config(jcfg.camera)
    T = _pred(2)

    def one(img, Xw, desc, valid, T_pred):
        fr = j_frame.build_frame(img, jcam, jcfg)
        return j_tracker.track_pose(fr, Xw, desc, valid, T_pred, jcam, jcfg)
    rj = jax.jit(jax.vmap(one))(
        jnp.asarray(lefts[:2, 1]), jnp.asarray(carry.lm_Xw[:2].numpy()),
        jnp.asarray(carry.lm_desc[:2].numpy().view(np.uint32)),
        jnp.asarray(carry.lm_valid[:2].numpy()), jnp.asarray(T.numpy()))
    frame = build_frame(torch.from_numpy(lefts[:2, 1]), cam, cfg)
    rt = track_pose(frame, carry.lm_Xw[:2], carry.lm_desc[:2],
                    carry.lm_valid[:2], T, cam, cfg)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw),
                               atol=2e-3)
    assert np.abs(rt.n_inliers.numpy() - np.asarray(rj.n_inliers)).max() <= 2
    assert (rt.n_inliers.numpy() > 20).all()


def test_needs_keyframe_batched_equals_per_lane():
    rng = np.random.default_rng(4)
    kcfg = SlamConfig.tiny().keyframe
    xy = torch.from_numpy(rng.uniform(0, [320, 160], (B, 300, 2)).astype(
        np.float32))
    inl = torch.from_numpy(rng.random((B, 300)) < np.array([[0.9], [0.05],
                                                             [0.5]]))
    got = kf_rule.needs_keyframe(xy, inl, 320, 160, kcfg)
    want = [bool(kf_rule.needs_keyframe(xy[b], inl[b], 320, 160, kcfg))
            for b in range(B)]
    assert got.tolist() == want and got.shape == (B,)
    assert True in want and False in want


def test_gather_batched_plain_equals_per_lane():
    rng = np.random.default_rng(5)
    levels = [torch.from_numpy(rng.uniform(0, 255, (B, h, w)).astype(
        np.float32)) for h, w in ((60, 90), (40, 61), (31, 31))]
    counts = [7, 0, 3]
    ys = torch.from_numpy(rng.integers(-5, 60, (B, 10)).astype(np.int32))
    xs = torch.from_numpy(rng.integers(-5, 90, (B, 10)).astype(np.int32))
    got = patches.gather_blocks_batched(levels, ys, xs, counts, 31, 31)
    for b in range(B):
        assert torch.equal(got[b], patches.gather_blocks_multi(
            [lv[b] for lv in levels], ys[b], xs[b], counts, 31, 31))


def test_topk2_batched_plain_equals_per_lane():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (B, 50, 8),
                                      dtype=np.int64).astype(np.int32))
    bd = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (B, 70, 8),
                                       dtype=np.int64).astype(np.int32))
    bd[:, :20] = a[:, :20] ^ 3
    a_uv = torch.from_numpy(rng.uniform(0, 100, (B, 50, 2)).astype(
        np.float32))
    b_xy = a_uv[:, rng.integers(0, 50, 70)] + 2.0
    got = match_kernel.topk2_match_batched(a, bd, a_uv, b_xy, 10.0)
    for b in range(B):
        assert torch.equal(got[b], match_kernel.topk2_match(
            a[b], bd[b], a_uv[b], b_xy[b], 10.0))
    assert bool((got[..., 0] < 1e8).any())


def test_pose_lm_batched_plain_equals_per_lane():
    rng = np.random.default_rng(7)
    n = 200
    Xw = torch.from_numpy(np.stack([rng.uniform(-5, 5, (B, n)),
                                    rng.uniform(-2, 2, (B, n)),
                                    rng.uniform(4, 30, (B, n))], -1).astype(
        np.float32))
    z = Xw[..., :2] / Xw[..., 2:3] + 0.01
    args = (torch.eye(4).repeat(B, 1, 1), Xw, z, torch.full((B, n), 1e-6),
            torch.from_numpy(rng.random((B, n)) > 0.2))
    got = pose_lm_kernel.optimize_pose_batched(*args, TrackerConfig())
    _assert_lanes(got, [pose_lm_kernel.optimize_pose(
        *(x[b] for x in args), TrackerConfig()) for b in range(B)])


# ---- the keyframe event's kernels and maps over lanes ------------------
MASK = (True, False, True)        # lane 1 masked out


def _sad_inputs(rng, h=48, w=160, k=20, max_disp=30):
    """B lanes' image pairs and clamped SAD corners (numpy)."""
    side = 2 * stereo_sad.WIN + 1
    sw = stereo_sad._strip_w(max_disp)
    imgs = rng.uniform(0, 255, (2, B, h, w)).astype(np.float32)
    xl = rng.integers(0, w, (B, k))
    yl = rng.integers(0, h, (B, k))
    ys0 = np.clip(yl - stereo_sad.WIN, 0, h - side).astype(np.int32)
    xl0 = np.clip(xl - stereo_sad.WIN, 0, w - side).astype(np.int32)
    xs0 = np.clip(xl - (max_disp + stereo_sad.WIN + stereo_sad.PAD), 0,
                  w - sw).astype(np.int32)
    return imgs[0], imgs[1], ys0, xl0, xs0, max_disp


def test_sad_curve_batched_plain_equals_per_lane():
    """Each lane the mask keeps exactly its single plain call; the masked
    lane zeros (the plain version's; the kernel leaves it unwritten)."""
    *arrs, max_disp = _sad_inputs(np.random.default_rng(8))
    t = [torch.from_numpy(a) for a in arrs]
    got = stereo_sad.sad_curve_batched(*t, max_disp, torch.tensor(MASK))
    assert got.shape == (B, 20, max_disp + 3)
    for b in range(B):
        want = stereo_sad.sad_curve_plain(*(x[b] for x in t), max_disp)
        assert torch.equal(got[b], want if MASK[b] else
                           torch.zeros_like(want))


def test_sad_curve_batched_matches_jax_vmap():
    """Every lane against jax.vmap of the JAX package's curves, the XLA
    version and the Pallas kernel in interpret mode, at the SAD bar."""
    *arrs, max_disp = _sad_inputs(np.random.default_rng(9))
    j = [jnp.asarray(a) for a in arrs]
    ref = np.asarray(jax.vmap(lambda *a: j_sad._curve_fallback(
        *a, max_disp))(*j))
    pallas = np.asarray(jax.vmap(lambda *a: j_sad._curve_pallas(
        *a, max_disp, interpret=True))(*j))
    got = stereo_sad.sad_curve_batched(
        *[torch.from_numpy(a) for a in arrs], max_disp,
        torch.ones(B, dtype=torch.bool)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-3)


def _ba_lanes():
    """B seeded local-BA problems of the same W, P (ragged: a fixed pose,
    an invalid slot, fixed and empty points), stacked; the baseline
    shared."""
    probs = [ba_problem("cpu", W=3, P=96, seed=4 + b, one_outlier=True)
             for b in range(B)]
    return BAProblem(*(f[0] if n == "baseline" else torch.stack(f)
                       for n, f in zip(BAProblem._fields, zip(*probs)))), \
        probs


def test_solve_ba_batched_plain_equals_per_lane():
    """Each lane the mask keeps exactly its single plain solve; the masked
    lane zeros (the plain version's; the kernel leaves it unwritten)."""
    p, singles = _ba_lanes()
    got = ba_kernel.solve_ba_batched(p, torch.tensor(MASK), iters=5)
    for b in range(B):
        want = ba_kernel.solve_ba(singles[b], iters=5)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w if MASK[b] else torch.zeros_like(w))


def test_solve_ba_batched_matches_jax_vmap():
    """Every lane against jax.vmap of the JAX package's solver (the one
    its engine runs on the CPU): T within 3e-3, X within 2e-2 on valid
    points."""
    p, _ = _ba_lanes()
    jp = j_ba.BAProblem(**{f: jnp.asarray(
        np.full((B,), float(p.baseline), np.float32) if f == "baseline"
        else getattr(p, f).numpy()) for f in BAProblem._fields})
    ref = jax.jit(jax.vmap(lambda q: j_ba.solve_ba(q, iters=5)))(jp)
    got = ba_kernel.solve_ba_batched(p, torch.ones(B, dtype=torch.bool),
                                     iters=5)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(ref.T_cw),
                               atol=3e-3)
    pv = p.point_valid.numpy()
    np.testing.assert_allclose(got.Xw.numpy()[pv], np.asarray(ref.Xw)[pv],
                               atol=2e-2)


def test_keyframe_event_over_lanes_equals_single(scene):
    """The keyframe event once over the lanes with MASK against the single
    keyframe_event on each lane (frame 1 made a keyframe): the kept
    lanes' maps, slots, snapshots and poses bit for bit; the masked
    lane's map bit-unchanged in every field."""
    cfg, cam, lefts, rights, carry = scene
    L, R = torch.from_numpy(lefts[:, 1]), torch.from_numpy(rights[:, 1])
    t = _batched_tracker(cfg, cam)(carry, L)

    def own(c):
        return c._replace(m=MapState(*(f.clone() for f in c.m)))
    singles = [keyframe_event(own(lane(carry, b)), lane(t.frame, b), L[b],
                              R[b], t.T_new[b], lane(t.res, b), cam, cfg)
               for b in range(B)]
    before = own(carry)
    m, slot, snap, latest_T = keyframe_event(
        own(carry), t.frame, L, R, t.T_new, t.res, cam, cfg,
        lanes=torch.tensor(MASK))
    for b in range(B):
        if MASK[b]:
            m1, slot1, snap1, latest1 = singles[b]
            for f in MapState._fields:
                assert torch.equal(getattr(m, f)[b], getattr(m1, f)), f
            assert int(slot[b]) == int(slot1)
            assert all(torch.equal(x[b], y) for x, y in zip(snap, snap1))
            assert torch.equal(latest_T[b], latest1)
            assert int(m.mp_valid[b].sum()) > int(before.m.mp_valid[b].sum())
        else:
            for f in MapState._fields:
                assert torch.equal(getattr(m, f)[b],
                                   getattr(before.m, f)[b]), f


@pytest.mark.parametrize("option", ["O1", "O2", "O3"])
def test_add_stereo_over_lanes_equals_single(scene, option):
    """add_stereo once over the lanes with MASK under each option set (O1,
    O3: descriptor stereo with subpixel refinement, the right images
    extracted over the lanes at once; O2: SAD with the BRIEF gate)
    against the single call on each lane: the kept lanes' stereo bit for
    bit, the masked lane none."""
    _, cam, lefts, rights, _ = scene
    cfg = with_option(SlamConfig.tiny(), option)
    L, R = torch.from_numpy(lefts[:, 1]), torch.from_numpy(rights[:, 1])
    got = add_stereo(build_frame(L, cam, cfg), L, R, cam, cfg,
                     lanes=torch.tensor(MASK))
    for b in range(B):
        if not MASK[b]:
            assert not got.has_stereo[b].any()
            assert not got.depth[b].any()
            continue
        one = add_stereo(build_frame(L[b], cam, cfg), L[b], R[b], cam, cfg)
        assert int(one.has_stereo.sum()) > 0
        for f in ("right_x_norm", "depth", "has_stereo"):
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f
