"""The fused FAST+NMS module against the JAX package, bit-exact, on the CPU.

fast_kernel.detect and detect_levels (every level of a pyramid in one
call) run their plain version (fast.detect_dual, or fast.detect with a
single threshold) for CPU tensors; the same seeded
images go through JAX's fused Pallas kernel in interpret mode and its XLA
formulation. Every comparison is exact: the responses are additions in a
fixed order. The Pallas kernel's zero halo makes it exact only from
border 5, the borders tested here. The CUDA kernel is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.data.synthetic import make_world, render_stereo
from slam_toolkit_tpu.ops import extractor as j_ext
from slam_toolkit_tpu.ops import fast as j_fast
from slam_toolkit_tpu.ops import fast_kernel as j_fk
from slam_toolkit_tpu_torch.ops import extractor as t_ext
from slam_toolkit_tpu_torch.ops import fast_kernel as t_fk
from slam_toolkit_tpu_torch.ops import pyramid as t_pyr

torch.set_num_threads(1)


def _image(h, w, seed, n_blobs=60):
    """Random blobs on a textured background: plenty of FAST corners,
    some of them at the image edge."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(40, 60, (h, w)).astype(np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(0, h - 3), rng.integers(0, w - 3)
        img[y:y + 3, x:x + 3] += rng.uniform(30, 180)
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


@pytest.mark.parametrize("border", [16, 5])
@pytest.mark.parametrize("dual", [True, False])
def test_detect_matches_jax(border, dual):
    img = _image(64, 131, seed=border + int(dual))
    thr_hi = 20.0 if dual else None
    ref = np.asarray(j_fast.detect_dual(jnp.asarray(img), 20.0, 7.0, border)
                     if dual else j_fast.detect(jnp.asarray(img), 7.0, border))
    pallas = np.asarray(j_fk.detect_fused(jnp.asarray(img), thr_hi, 7.0,
                                          border, interpret=True))
    out = t_fk.detect(torch.from_numpy(img), thr_hi, 7.0, border).numpy()
    assert t_fk.KERNEL.launches == 0
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)
    assert (out > 0).sum() > 20
    if dual:
        assert (out >= 1e4).sum() > 5          # boosted high survivors


@pytest.mark.parametrize("border", [16, 5])
@pytest.mark.parametrize("dual", [True, False])
def test_detect_levels_matches_jax(border, dual):
    """detect_levels on the levels of a tiny-camera pyramid (the port's
    build_pyramid on SlamConfig.tiny(), 4 levels) equals, level by level,
    JAX's fused Pallas kernel (interpret mode) and its XLA detector on
    the same level arrays."""
    cfg = SlamConfig.tiny()
    img = _image(cfg.camera.height, cfg.camera.width, seed=3 * border + dual)
    levels = t_pyr.build_pyramid(torch.from_numpy(img), cfg.extractor)
    assert len(levels) == cfg.extractor.num_levels
    thr_hi = 20.0 if dual else None
    n0 = t_fk.KERNEL.launches
    outs = t_fk.detect_levels(levels, thr_hi, 7.0, border)
    assert t_fk.KERNEL.launches == n0
    assert len(outs) == len(levels)
    n_corners = 0
    for lvl, out in zip(levels, outs):
        a = jnp.asarray(lvl.numpy())
        ref = np.asarray(j_fast.detect_dual(a, 20.0, 7.0, border) if dual
                         else j_fast.detect(a, 7.0, border))
        pallas = np.asarray(j_fk.detect_fused(a, thr_hi, 7.0, border,
                                              interpret=True))
        assert out.shape == lvl.shape
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(out.numpy(), pallas)
        n_corners += int((ref > 0).sum())
    assert n_corners > 20


def test_detect_levels_refuses():
    """One call takes 1 to MAX_LEVELS levels, on the CPU as on the card."""
    img = torch.zeros((40, 40))
    n = t_fk.MAX_LEVELS
    assert len(t_fk.detect_levels([img] * n, 20.0, 7.0, 16)) == n
    for bad in ([img] * (n + 1), []):
        with pytest.raises(ValueError, match="levels"):
            t_fk.detect_levels(bad, 20.0, 7.0, 16)


@pytest.mark.parametrize("dual,fused,radius", [
    pytest.param(True, True, None, id="True"),
    pytest.param(False, True, None, id="False"),
    pytest.param(True, False, None, id="True-fused_fast_off"),
    pytest.param(False, False, None, id="False-fused_fast_off"),
    pytest.param(True, False, 3, id="True-border4"),
    pytest.param(False, False, 3, id="False-border4")])
def test_extract_fused_fast_matches_jax(dual, fused, radius, monkeypatch):
    """extract with fused_fast on or off (the tiny camera, a rendered
    frame): keypoints, octaves, validity and descriptors exact against
    the JAX extract at the same setting; FAST runs as one detect_levels
    call over every budgeted level either way, as the flag selects
    nothing in the port, and below border 5 too (patch_radius 3), where
    the JAX package runs its XLA detector."""
    cfg = SlamConfig.tiny()
    ecfg = dataclasses.replace(cfg.extractor, fused_fast=fused,
                               dual_threshold=dual)
    if radius is not None:
        ecfg = dataclasses.replace(ecfg, patch_radius=radius)
    world = make_world(cfg, seed=7)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.7
    img = np.clip(render_stereo(world, T)[0], 0, 255).astype(np.uint8) \
        .astype(np.float32)
    fj = jax.jit(lambda x: j_ext.extract(x, ecfg))(img)
    calls = []
    orig = t_fk.detect_levels

    def spy(levels, *args):
        calls.append(len(levels))
        return orig(levels, *args)
    monkeypatch.setattr(t_fk, "detect_levels", spy)
    ft = t_ext.extract(torch.from_numpy(img), ecfg)
    assert calls == [ecfg.num_levels]
    assert int(ft.valid.sum()) > 100
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
    np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
    np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32),
                                  np.asarray(fj.desc))
    # the rank-boost round trip through float32 (see test_torch_extractor)
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response),
                               rtol=0, atol=2e-3)
