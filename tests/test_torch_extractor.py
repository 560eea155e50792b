"""Geometry and extraction: the port against the JAX package on the CPU.

Keypoint coordinates, octaves, validity and descriptors must be exact.
FAST responses and the blur are bit-exact on the same input; pyramid
levels agree to 1 ulp (see slam_toolkit_tpu_torch/ops/pyramid.py).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.data.synthetic import make_world, render_stereo
from slam_toolkit_tpu.geometry import camera as j_cam
from slam_toolkit_tpu.geometry import se3 as j_se3
from slam_toolkit_tpu.ops import brief as j_brief
from slam_toolkit_tpu.ops import extractor as j_ext
from slam_toolkit_tpu.ops import fast as j_fast
from slam_toolkit_tpu.ops import pyramid as j_pyr
from slam_toolkit_tpu_torch.geometry import camera as t_cam
from slam_toolkit_tpu_torch.geometry import se3 as t_se3
from slam_toolkit_tpu_torch.ops import brief as t_brief
from slam_toolkit_tpu_torch.ops import extractor as t_ext
from slam_toolkit_tpu_torch.ops import fast as t_fast
from slam_toolkit_tpu_torch.ops import pyramid as t_pyr

torch.set_num_threads(1)

KITTI_MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "kitti_mini")


def test_se3_matches_jax():
    """exp / inv / compose / transform / normalize within 1e-5."""
    rng = np.random.default_rng(0)
    xi = rng.uniform(-0.5, 0.5, (5, 6)).astype(np.float32)
    xi[0, 3:] = 0.0                               # small-angle branch
    X = rng.normal(0, 5, (7, 3)).astype(np.float32)
    Tj = np.asarray(j_se3.exp(jnp.asarray(xi)))
    Tt = t_se3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.numpy(), Tj, atol=1e-5)
    A, B = Tt[1], Tt[2]
    np.testing.assert_allclose(
        t_se3.compose(A, t_se3.inv(B)).numpy(),
        np.asarray(j_se3.compose(jnp.asarray(Tj[1]),
                                 j_se3.inv(jnp.asarray(Tj[2])))), atol=1e-5)
    np.testing.assert_allclose(
        t_se3.transform(A, torch.from_numpy(X)).numpy(),
        np.asarray(j_se3.transform(jnp.asarray(Tj[1]), jnp.asarray(X))),
        atol=1e-4)
    skew = Tj[3].copy()
    skew[:3, :3] += rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_se3.normalize(torch.from_numpy(skew)).numpy(),
        np.asarray(j_se3.normalize(jnp.asarray(skew))), atol=1e-6)


def test_camera_matches_jax():
    """With distortion: undistort (5 iterations), project, bounds, depth."""
    cfg = SlamConfig().camera
    import dataclasses
    cfg = dataclasses.replace(cfg, k1=-0.05, k2=0.01, p1=1e-3, p2=-5e-4)
    cj = j_cam.StereoCamera.from_config(cfg)
    ct = t_cam.StereoCamera.from_config(cfg, "cpu")
    rng = np.random.default_rng(1)
    uv = rng.uniform([0, 0], [cfg.width, cfg.height], (64, 2)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        t_cam.pixel_to_normalized(ct.left, torch.from_numpy(uv)).numpy(),
        np.asarray(j_cam.pixel_to_normalized(cj.left, jnp.asarray(uv))),
        atol=1e-6)
    Xc = rng.uniform([-10, -3, 0.5], [10, 3, 40], (64, 3)).astype(np.float32)
    p_t = t_cam.project(ct.left, torch.from_numpy(Xc))
    p_j = np.asarray(j_cam.project(cj.left, jnp.asarray(Xc)))
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(
        t_cam.in_image(ct.left, p_t).numpy(),
        np.asarray(j_cam.in_image(cj.left, jnp.asarray(p_j))))
    xr = uv[:, 0] - rng.uniform(-2, 60, 64).astype(np.float32)
    np.testing.assert_allclose(
        t_cam.stereo_depth(ct, torch.from_numpy(uv[:, 0]),
                           torch.from_numpy(xr)).numpy(),
        np.asarray(j_cam.stereo_depth(cj, jnp.asarray(uv[:, 0]),
                                      jnp.asarray(xr))), rtol=1e-6)


def test_brief_pattern_is_the_jax_pattern():
    np.testing.assert_array_equal(t_brief.sampling_pattern(),
                                  j_brief.sampling_pattern())


def _frame(cfg, z):
    world = make_world(cfg, seed=7)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -z
    left, _ = render_stereo(world, T)
    return np.clip(left, 0, 255).astype(np.uint8).astype(np.float32)


def test_pyramid_fast_blur_tiny():
    """Pyramid levels agree to 1 ulp: XLA's CPU dot fuses the two-tap
    multiply-add for some shapes and not for others, the port never
    does. Given the same level, both FAST responses and the blur equal
    the JAX package's bit for bit."""
    cfg = SlamConfig.tiny()
    img = _frame(cfg, 1.0)
    lv_j = jax.jit(lambda x: j_pyr.build_pyramid(x, cfg.extractor))(img)
    lv_t = t_pyr.build_pyramid(torch.from_numpy(img), cfg.extractor)
    for a, b in zip(lv_j, lv_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=2.5e-7, atol=0)
        b = torch.from_numpy(a.copy())
        hi_j, lo_j = jax.jit(lambda x: j_fast.dual_response(x, 20.0, 7.0))(a)
        hi_t, lo_t = t_fast.dual_response(b, 20.0, 7.0)
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(
            t_pyr.gaussian_blur(b, 7, 2.0).numpy(),
            np.asarray(jax.jit(lambda x: j_pyr.gaussian_blur(x, 7, 2.0))(a)))


def _assert_features_equal(ft, fj):
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
    np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
    np.testing.assert_array_equal(ft.sigma2.numpy(), np.asarray(fj.sigma2))
    # descriptors bit-exact (int32 words here, uint32 in JAX)
    np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32),
                                  np.asarray(fj.desc))
    # responses carry the +1e4 rank boost through a float32 round trip:
    # a 1-ulp difference in a small pyramid level shows as ~1e-3 here
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response),
                               rtol=0, atol=2e-3)


def test_upright_descriptors_levels_match_jax():
    """All levels' descriptors from one gather equal JAX's per-level
    upright_patch_descriptors on a 3-level tiny pyramid, bit for bit:
    keypoints anywhere in each level, at its corners and edges (clamped)."""
    cfg = SlamConfig.tiny()
    img = _frame(cfg, 0.5)
    levels = [np.asarray(lv) for lv in jax.jit(
        lambda x: j_pyr.build_pyramid(x, cfg.extractor))(img)][:3]
    rng = np.random.default_rng(11)
    blurred, xys = [], []
    for lv, k in zip(levels, (40, 25, 12)):
        h, w = lv.shape
        blurred.append(np.array(jax.jit(
            lambda x: j_pyr.gaussian_blur(x, 7, 2.0))(lv)))
        xy = rng.uniform(0, [w - 1, h - 1], (k, 2)).astype(np.float32)
        xy[:3] = [[0, 0], [w - 1, h - 1], [w / 2, 0]]
        xys.append(np.round(xy).astype(np.float32))
    ref = np.concatenate([np.asarray(j_brief.upright_patch_descriptors(
        jnp.asarray(b), jnp.asarray(xy))) for b, xy in zip(blurred, xys)])
    out = t_brief.upright_patch_descriptors_levels(
        [torch.from_numpy(b) for b in blurred],
        [torch.from_numpy(xy) for xy in xys])
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


def test_extract_descriptors_match_per_level_full_size(monkeypatch):
    """On one KITTI-size frame (8 levels, 2000 features) the descriptors
    extract computes from one gather of all levels equal those of
    upright_patch_descriptors run level by level on the same blurred
    levels and keypoints, bit for bit."""
    cfg = SlamConfig()
    seen, levels_fn = [], t_brief.upright_patch_descriptors_levels

    def spy(blurred, xys):
        seen.append((blurred, xys))
        return levels_fn(blurred, xys)
    monkeypatch.setattr(t_brief, "upright_patch_descriptors_levels", spy)
    ft = t_ext.extract(torch.from_numpy(_frame(cfg, 1.6)), cfg.extractor)
    (blurred, xys), = seen
    assert len(blurred) == cfg.extractor.num_levels
    ref = torch.cat([t_brief.upright_patch_descriptors(b, xy)
                     for b, xy in zip(blurred, xys)])
    assert ref.shape[0] == cfg.extractor.num_features
    np.testing.assert_array_equal(ft.desc[:ref.shape[0]].numpy(),
                                  ref.numpy())


@pytest.mark.parametrize("source", ["synthetic", "kitti_mini"])
def test_extract_matches_jax(source):
    cfg = SlamConfig.tiny()
    if source == "synthetic":
        img = _frame(cfg, 0.5)
    else:
        from slam_toolkit_tpu.data.kitti import KittiDataset
        img, _ = KittiDataset("00", root=KITTI_MINI)[3]
    fj = jax.jit(lambda x: j_ext.extract(x, cfg.extractor))(img)
    ft = t_ext.extract(torch.from_numpy(np.ascontiguousarray(img)),
                       cfg.extractor)
    assert int(ft.valid.sum()) > 100
    _assert_features_equal(ft, fj)


def test_extract_matches_jax_full_size():
    """One KITTI-size frame (1241x376, 2000 features, 8 levels)."""
    cfg = SlamConfig()
    img = _frame(cfg, 1.6)
    fj = jax.jit(lambda x: j_ext.extract(x, cfg.extractor))(img)
    ft = t_ext.extract(torch.from_numpy(img), cfg.extractor)
    assert int(ft.valid.sum()) == cfg.extractor.num_features
    _assert_features_equal(ft, fj)
