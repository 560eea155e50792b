"""The port's four kernel modules against the JAX package, on the CPU.

For each module holding a CUDA kernel (patch gather, top-2 matcher, pose
LM, stereo SAD) the same seeded numpy inputs go through the JAX public
entry (its XLA reference off the TPU), the Pallas kernel in interpret
mode, and the port's wrapper, which runs its plain PyTorch version for
CPU tensors. The CUDA kernels themselves are checked against the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.config import TrackerConfig
from slam_toolkit_tpu.ops import patches as j_patches
from slam_toolkit_tpu.ops import match_kernel as j_match
from slam_toolkit_tpu.ops import pose_lm_kernel as j_plk
from slam_toolkit_tpu.ops import stereo_sad as j_sad
from slam_toolkit_tpu.optim import pose_lm as j_pose_lm
from slam_toolkit_tpu_torch.ops import match_kernel as t_match
from slam_toolkit_tpu_torch.ops import patches as t_patches
from slam_toolkit_tpu_torch.ops import pose_lm_kernel as t_plk
from slam_toolkit_tpu_torch.ops import stereo_sad as t_sad

torch.set_num_threads(1)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------ patch gather
def test_gather_blocks_exact():
    """Exact against gather_blocks (XLA) and the Pallas kernel
    (interpret), including corners at 0 and at the last legal offset."""
    rng = np.random.default_rng(0)
    h, w = 64, 300
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    for bh, bw, k in [(31, 31, 40), (11, 17, 24)]:
        ys = rng.integers(0, h - bh + 1, k).astype(np.int32)
        xs = rng.integers(0, w - bw + 1, k).astype(np.int32)
        ys[:2], xs[:2] = [0, h - bh], [w - bw, 0]
        ref = np.asarray(j_patches.gather_blocks(
            jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), bh, bw))
        pallas = np.asarray(j_patches._gather_blocks_pallas(
            jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), bh, bw,
            interpret=True))
        out = t_patches.gather_blocks(_t(img), _t(ys), _t(xs), bh, bw).numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, pallas)


def test_gather_blocks_multi_exact():
    """The multi-image gather's plain version against JAX gather_blocks
    on each image's share of the corners: ragged counts, an image with no
    window, corners at 0 and at each image's last legal offset."""
    rng = np.random.default_rng(10)
    shapes, counts, bh, bw = [(64, 300), (40, 150), (33, 90), (25, 60)], \
        [17, 0, 9, 4], 23, 31
    imgs = [rng.uniform(0, 255, s).astype(np.float32) for s in shapes]
    ys = np.concatenate([rng.integers(0, h - bh + 1, k) for (h, _), k in
                         zip(shapes, counts)]).astype(np.int32)
    xs = np.concatenate([rng.integers(0, w - bw + 1, k) for (_, w), k in
                         zip(shapes, counts)]).astype(np.int32)
    ys[[0, 17]], xs[[0, 17]] = [0, 33 - bh], [300 - bw, 0]
    out = t_patches.gather_blocks_multi([_t(i) for i in imgs], _t(ys), _t(xs),
                                        counts, bh, bw).numpy()
    assert out.shape == (sum(counts), bh, bw)
    o = 0
    for img, k in zip(imgs, counts):
        if k:
            ref = np.asarray(j_patches.gather_blocks(
                jnp.asarray(img), jnp.asarray(ys[o:o + k]),
                jnp.asarray(xs[o:o + k]), bh, bw))
            np.testing.assert_array_equal(out[o:o + k], ref)
        o += k


def test_gather_blocks_multi_refuses():
    """More images than one launch takes, counts that do not match the
    corners: the wrapper raises on the CPU as on the card."""
    img = torch.zeros((40, 40))
    ys = torch.zeros(17, dtype=torch.int32)
    n = t_patches.MAX_IMAGES + 1
    with pytest.raises(ValueError, match="images"):
        t_patches.gather_blocks_multi([img] * n, ys, ys, [1] * n, 31, 31)
    t_patches.gather_blocks_multi([img] * (n - 1), ys[:n - 1], ys[:n - 1],
                                  [1] * (n - 1), 31, 31)
    with pytest.raises(ValueError, match="corners"):
        t_patches.gather_blocks_multi([img] * 2, ys, ys, [1, 2], 31, 31)


# ------------------------------------------------------------ top-2 matcher
def _match_case(m, n, seed, w=400, h=300):
    rng = np.random.default_rng(seed)
    a_desc, b_desc = (rng.integers(0, 2 ** 32, (r, 8), dtype=np.uint64)
                      .astype(np.uint32) for r in (m, n))
    k = min(m, n) // 2
    b_desc[:k] = a_desc[:k] ^ (rng.random((k, 8)) < 0.1).astype(np.uint32)
    b_desc[k:k + 4] = b_desc[:4]           # exact ties at the best distance
    a_uv = rng.uniform(0, [w, h], (m, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [w, h], (n, 2)).astype(np.float32)
    b_xy[:k] = a_uv[:k] + rng.normal(0, 15, (k, 2))
    b_xy[k:k + 4] = b_xy[:4]
    a_uv[-8:] = 1e7                        # invisible queries: empty gates
    return a_desc, b_desc, a_uv, b_xy


def _assert_topk2_equal(out, ref):
    """Distances exact; argbest exact wherever a match exists."""
    np.testing.assert_array_equal(out[:, [0, 1, 3, 4, 6, 7]],
                                  ref[:, [0, 1, 3, 4, 6, 7]])
    for c in (2, 5):
        has = ref[:, c - 2] < 1e8
        np.testing.assert_array_equal(out[has, c], ref[has, c])


def test_topk2_match_exact():
    a_desc, b_desc, a_uv, b_xy = _match_case(128, 256, seed=1)
    r = 25.0
    jargs = [jnp.asarray(x) for x in (a_desc, b_desc, a_uv, b_xy)]
    ref = np.asarray(j_match.topk2_match(*jargs, r))
    pallas = np.asarray(j_match._topk2_pallas(*jargs, r, interpret=True))
    out = t_match.topk2_match(*[_t(x) for x in (a_desc, b_desc, a_uv, b_xy)],
                              r).numpy()
    assert (ref[:, 0] < 1e8).sum() > 20 and (ref[:, 0] >= 1e8).sum() > 0
    # the XLA reference reports argbest 0 for empty rows: so does the port
    np.testing.assert_array_equal(out, ref)
    _assert_topk2_equal(out, pallas)


# ------------------------------------------------------------ pose LM
def _pose_problem(seed, n=300, noise=1e-3, outliers=0.0):
    from slam_toolkit_tpu.geometry import se3
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                   rng.uniform(4, 60, n)], -1).astype(np.float32)
    T_true = np.asarray(se3.exp(jnp.asarray(
        rng.uniform(-0.2, 0.2, 6).astype(np.float32))))
    Xc = (T_true[:3, :3] @ Xw.T).T + T_true[:3, 3]
    z = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    z += rng.normal(0, noise, z.shape).astype(np.float32)
    bad = rng.random(n) < outliers
    z[bad] += rng.normal(0, 0.3, (int(bad.sum()), 2)).astype(np.float32)
    sigma2 = np.full(n, 1e-6, np.float32)
    mask = np.ones(n, bool)
    mask[::13] = False
    return Xw, np.ascontiguousarray(z), sigma2, mask, T_true


def test_pose_lm_matches_jax():
    """T within 2e-3 and r2 within rtol 5e-2 of both the JAX solver and
    the Pallas kernel (interpret); the float32 reductions run in another
    order, so the solvers agree to tolerance, not bits."""
    cfg = TrackerConfig()
    for seed, outliers in [(0, 0.0), (3, 0.2)]:
        Xw, z, s2, mask, T_true = _pose_problem(seed, outliers=outliers)
        jargs = (jnp.eye(4), jnp.asarray(Xw), jnp.asarray(z),
                 jnp.asarray(s2), jnp.asarray(mask))
        refs = [j_pose_lm.optimize_pose(*jargs, cfg),
                j_plk.optimize_pose(*jargs, cfg, interpret=True)]
        out = t_plk.optimize_pose(torch.eye(4), _t(Xw), _t(z), _t(s2),
                                  _t(mask), cfg)
        T = out.T_cw.numpy()
        r2 = out.inlier_r2.numpy()
        assert np.abs(T - T_true).max() < 0.02
        for ref in refs:
            np.testing.assert_allclose(T, np.asarray(ref.T_cw), atol=2e-3)
            r_ref = np.asarray(ref.inlier_r2)
            fin = np.isfinite(r_ref)
            np.testing.assert_array_equal(np.isfinite(r2), fin)
            np.testing.assert_allclose(r2[fin], r_ref[fin], rtol=5e-2,
                                       atol=1e-4)


# ------------------------------------------------------------ stereo SAD
def _stereo_pair(h, w, disp, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w + disp)).astype(np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) * 0.25 + base * 0.5 +
                np.roll(base, -1, ax) * 0.25)
    base = np.round(base).astype(np.float32)
    return (np.ascontiguousarray(base[:, :w]),
            np.ascontiguousarray(base[:, disp:disp + w]))


def test_sad_curves_match_jax():
    """Curves within rtol 1e-5, atol 1e-3 of the XLA fallback and the
    Pallas kernel (interpret): 121-term float32 sums."""
    h, w, max_disp = 64, 256, 40
    left, right = _stereo_pair(h, w, 13, seed=2)
    rng = np.random.default_rng(3)
    k = 24
    side, sw = 2 * j_sad.WIN + 1, j_sad._strip_w(max_disp)
    xl = rng.integers(0, w, k)
    yl = rng.integers(0, h, k)
    ys0 = np.clip(yl - j_sad.WIN, 0, h - side).astype(np.int32)
    xl0 = np.clip(xl - j_sad.WIN, 0, w - side).astype(np.int32)
    xs0 = np.clip(xl - (max_disp + j_sad.WIN + j_sad.PAD), 0,
                  w - sw).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (left, right, ys0, xl0, xs0)]
    ref = np.asarray(j_sad._curve_fallback(*jargs, max_disp))
    pallas = np.asarray(j_sad._curve_pallas(*jargs, max_disp,
                                            interpret=True))
    out = t_sad.sad_curve(*[_t(a) for a in (left, right, ys0, xl0, xs0)],
                          max_disp).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-3)


def test_sad_match_matches_jax():
    """The full match (curve + argmin, parabola, uniqueness): ok flags
    equal; subpixel right x within 1e-4 px."""
    h, w, d = 64, 320, 17
    left, right = _stereo_pair(h, w, d, seed=4)
    rng = np.random.default_rng(5)
    k = 48
    xy = np.stack([rng.uniform(0, w, k), rng.uniform(0, h, k)],
                  -1).astype(np.float32)
    valid = rng.random(k) < 0.9
    xr_j, ok_j = j_sad.match(jnp.asarray(left), jnp.asarray(right),
                             jnp.asarray(xy), jnp.asarray(valid),
                             max_disp=40)
    xr_t, ok_t = t_sad.match(_t(left), _t(right), _t(xy), _t(valid),
                             max_disp=40)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() > k // 3
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-4)


# ------------------------------------------------------------ matching
def test_projection_match_matches_jax():
    """projection_match around the top-2 module, from the same JAX frame
    features (carried across by utils/convert.py): identical matches,
    including the duplicate-target resolution and the doubled radius."""
    import jax
    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.frontend import matching as j_matching
    from slam_toolkit_tpu.geometry.camera import StereoCamera as JCam
    from slam_toolkit_tpu.ops import extractor as j_ext
    from slam_toolkit_tpu_torch.frontend import matching as t_matching
    from slam_toolkit_tpu_torch.geometry.camera import StereoCamera as TCam
    from slam_toolkit_tpu_torch.utils import convert

    cfg = SlamConfig.tiny()
    rng = np.random.default_rng(6)
    img = np.round(rng.uniform(0, 255, (96, 128))).astype(np.float32)
    feats = jax.jit(lambda x: j_ext.extract(x, cfg.extractor))(img)
    xy = np.asarray(feats.xy)
    valid = np.asarray(feats.valid)
    desc = np.asarray(feats.desc)
    L = 200
    src = rng.choice(np.flatnonzero(valid), L)          # repeats: duplicates
    z = rng.uniform(2.0, 20.0, L).astype(np.float32)
    uv = xy[src] + rng.normal(0, 3, (L, 2)).astype(np.float32)
    Xw = np.stack([(uv[:, 0] - 64.0) / 120.0 * z,
                   (uv[:, 1] - 48.0) / 120.0 * z, z], -1).astype(np.float32)
    lm_desc = desc[src] ^ (rng.random((L, 8)) < 0.03).astype(np.uint32)
    lm_valid = rng.random(L) < 0.9
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.02
    for radius in (cfg.matcher.projection_radius, 2.0):   # 2 px: wide retry
        ref = j_matching.projection_match(
            jnp.asarray(Xw), jnp.asarray(lm_desc), jnp.asarray(lm_valid),
            feats, jnp.asarray(T), JCam.from_config(cfg.camera), cfg.matcher,
            radius)
        out = t_matching.projection_match(
            _t(Xw), _t(lm_desc), _t(lm_valid),
            convert.features_from_numpy(feats, device="cpu"), _t(T),
            TCam.from_config(cfg.camera, "cpu"), cfg.matcher, radius)
        ok = np.asarray(ref.ok)
        assert ok.sum() >= 8
        np.testing.assert_array_equal(out.ok.numpy(), ok)
        np.testing.assert_array_equal(out.kpt_idx.numpy()[ok],
                                      np.asarray(ref.kpt_idx)[ok])
