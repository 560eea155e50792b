"""The public functions the port gained by name, against the JAX package on
the CPU: frame.backproject, camera.normalized_project and
bilinear_sample (with tests/test_camera.py's cases), MapState.capacity,
sepconv.correlate_w / correlate_h, BENCH_TINY for the port's
BENCH_DP, fast_kernel.detect_fused, native_loader.available,
cluster/tracker.FusedOut and SlamEngine.loop_events."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JaxConfig
from slam_toolkit_tpu.data.synthetic import make_world, render_stereo
from slam_toolkit_tpu.frontend import frame as j_frame
from slam_toolkit_tpu.geometry import camera as j_cam
from slam_toolkit_tpu.geometry import se3 as j_se3
from slam_toolkit_tpu.mapping import map_state as j_map
from slam_toolkit_tpu.ops import sepconv as j_sep
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend import frame as t_frame
from slam_toolkit_tpu_torch.geometry import camera as t_cam
from slam_toolkit_tpu_torch.mapping import map_state as t_map
from slam_toolkit_tpu_torch.ops import sepconv as t_sep
from slam_toolkit_tpu_torch.utils import convert

torch.set_num_threads(1)


def test_backproject_matches_jax():
    """World points of a stereo frame's keypoints (zero depth where there
    is no stereo) within 1e-4 m of JAX's, from JAX's own frame."""
    cfg = JaxConfig.tiny()
    world = make_world(cfg, seed=7)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.5
    left, right = render_stereo(world, T)
    cam = j_cam.StereoCamera.from_config(cfg.camera)
    fr = jax.jit(lambda a, b: j_frame.add_stereo(
        j_frame.build_frame(a, cam, cfg), a, b, cam, cfg))(left, right)
    T_wc = np.asarray(j_se3.exp(jnp.array([0.1, -0.2, 0.3, 0.02, -0.01,
                                           0.05])))
    ref = np.asarray(j_frame.backproject(fr, jnp.asarray(T_wc)))
    fr_np = jax.tree_util.tree_map(np.array, fr)
    ft = t_frame.FrameState(
        feats=convert.features_from_numpy(fr_np.feats, device="cpu"),
        norm_xy=torch.from_numpy(fr_np.norm_xy),
        right_x_norm=torch.from_numpy(fr_np.right_x_norm),
        depth=torch.from_numpy(fr_np.depth),
        has_stereo=torch.from_numpy(fr_np.has_stereo))
    out = t_frame.backproject(ft, torch.from_numpy(T_wc))
    assert int(ft.has_stereo.sum()) > 30
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-4)


def test_normalized_project_matches_jax():
    rng = np.random.default_rng(0)
    Xc = rng.uniform([-5, -3, -2], [5, 3, 30], (50, 3)).astype(np.float32)
    Xc[:3, 2] = [0.0, 1e-7, -1e-7]                     # z kept off 0
    np.testing.assert_allclose(
        t_cam.normalized_project(torch.from_numpy(Xc)).numpy(),
        np.asarray(j_cam.normalized_project(jnp.asarray(Xc))), rtol=1e-6)
    assert t_cam.normalized_project(torch.ones((2, 4, 3))).shape == (2, 4, 2)


@pytest.mark.parametrize("img,uv,want", [
    (np.arange(48.0).reshape(6, 8), [[3.0, 2.0], [0.0, 0.0], [7.0, 5.0]],
     [19.0, 0.0, 47.0]),
    ([[0.0, 1.0], [2.0, 3.0]], [[0.5, 0.5]], [1.5]),
    ([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0, 7.0, 8.0]], [[-0.5, 0.0]],
     [0.5])])
def test_bilinear_sample_jax_cases(img, uv, want):
    """tests/test_camera.py's three cases (on the grid, a midpoint, the
    reflected border) on the port."""
    got = t_cam.bilinear_sample(torch.tensor(img, dtype=torch.float32),
                                torch.tensor(uv, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_bilinear_sample_matches_jax():
    """Subpixel samples inside and beyond every border, float32 within
    1e-4 of JAX's."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    uv = rng.uniform([-10, -10], [66, 50], (7, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(
        t_cam.bilinear_sample(torch.from_numpy(img),
                              torch.from_numpy(uv)).numpy(),
        np.asarray(j_cam.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))),
        rtol=0, atol=1e-4)


def test_map_capacity_matches_jax():
    """(keyframe slots, mappoint slots) of an empty map, and per lane of a
    batched one."""
    from slam_toolkit_tpu_torch.parallel import mesh
    cfg = SlamConfig.tiny()
    m = t_map.empty_map(cfg, "cpu")
    assert m.capacity == j_map.empty_map(JaxConfig.tiny()).capacity == \
        (cfg.map.max_keyframes, cfg.map.max_mappoints)
    assert mesh.batched_empty_map(cfg, 3, "cpu").capacity == m.capacity


@pytest.mark.parametrize("taps", [[0.25, 0.5, 0.25], [-1.0, 0.0, 1.0],
                                  [1.0, 4.0, 6.0, 4.0, 1.0], [2.0]])
def test_correlate_matches_jax(taps):
    """correlate_w and correlate_h (a one-channel convolution over the
    edge-replicated input, not a band matrix) within 1e-4 of JAX's band
    products, over a leading axis too; sep_correlate2d is the two in
    turn."""
    rng = np.random.default_rng(len(taps))
    x = rng.uniform(0, 255, (2, 23, 37)).astype(np.float32)
    for t_fn, j_fn in ((t_sep.correlate_w, j_sep.correlate_w),
                       (t_sep.correlate_h, j_sep.correlate_h)):
        np.testing.assert_allclose(
            t_fn(torch.from_numpy(x), taps).numpy(),
            np.asarray(j_fn(jnp.asarray(x), taps)), rtol=0, atol=1e-3)
    xt = torch.from_numpy(x)
    assert torch.equal(t_sep.sep_correlate2d(xt, taps, [1.0, 2.0, 1.0]),
                       t_sep.correlate_w(t_sep.correlate_h(
                           xt, [1.0, 2.0, 1.0]), taps))


def test_bench_tiny_runs_dp_at_the_tiny_config(monkeypatch, capsys):
    """BENCH_DP=2 BENCH_TINY=1: the port's bench hands dp_record
    SlamConfig.tiny() (run here on the CPU over 7 frames), as bench.py's
    main_dp does; without BENCH_TINY, SlamConfig()."""
    import json
    from slam_toolkit_tpu_torch.data.synthetic import make_sequence
    from slam_toolkit_tpu_torch.tools import bench
    seen = []
    real = bench.dp_record

    def stage(cfg, n, seed, cache):
        _, gt, frames = make_sequence(cfg, n_frames=n, seed=seed, step=0.25)
        return np.clip(np.stack([np.stack(f) for f in frames]), 0,
                       255).astype(np.uint8), gt

    def on_cpu(cfg, **kw):
        seen.append(cfg)
        if cfg != SlamConfig.tiny():
            return {}
        kw.update(device="cpu", n_frames=7, chunk=2)
        return real(cfg, **kw)
    monkeypatch.setattr(bench, "dp_record", on_cpu)
    monkeypatch.setattr(bench, "WARMUP_CHUNKS", 1)
    monkeypatch.setattr(bench, "stage_frames", stage)
    monkeypatch.setenv("BENCH_DP", "2")
    monkeypatch.setenv("BENCH_TINY", "1")
    assert bench.main() == 0
    assert seen == [SlamConfig.tiny()]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["lanes"] == 2 and out["frames_timed"] == 4
    assert np.isfinite(out["value"])
    monkeypatch.delenv("BENCH_TINY")
    bench.main()
    assert seen[-1] == SlamConfig()


@pytest.mark.parametrize("border", [16, 5])
@pytest.mark.parametrize("dual", [True, False])
def test_detect_fused_matches_jax(border, dual):
    """fast_kernel.detect_fused under its JAX name: JAX's interpret-mode
    Pallas kernel bit for bit on the CPU, and the same refusal of a
    border below the kernel's halo."""
    from slam_toolkit_tpu.ops import fast_kernel as j_fk
    from slam_toolkit_tpu_torch.ops import fast_kernel as t_fk
    rng = np.random.default_rng(border + 2 * int(dual))
    img = rng.uniform(40, 60, (48, 97)).astype(np.float32)
    for _ in range(50):
        y, x = rng.integers(0, 45), rng.integers(0, 94)
        img[y:y + 3, x:x + 3] += rng.uniform(30, 180)
    img = np.round(np.clip(img, 0, 255)).astype(np.float32)
    thr_hi = 20.0 if dual else None
    want = np.asarray(j_fk.detect_fused(jnp.asarray(img), thr_hi, 7.0,
                                        border, interpret=True))
    got = t_fk.detect_fused(torch.from_numpy(img), thr_hi, 7.0, border)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 10
    with pytest.raises(ValueError, match="border >= 5"):
        t_fk.detect_fused(torch.from_numpy(img), thr_hi, 7.0, 4)


def test_native_loader_available(tmp_path, monkeypatch):
    """native_loader.available under its JAX name: True where the library
    builds (as here, with g++ and libpng's headers; JAX's answer agrees),
    False where its source does not compile. The JAX package's bindings
    are pointed at the library the port built from the same source (as
    test_torch_native_loader.py's jax_native fixture does), so its answer
    does not hang on whether its own untracked native/libslamloader.so
    was built before this test ran."""
    from slam_toolkit_tpu.data import native_loader as j_native
    from slam_toolkit_tpu_torch.data import native_loader
    assert native_loader.available() is True
    monkeypatch.setattr(j_native, "_LIB_PATH",
                        native_loader.library()._name)
    monkeypatch.setattr(j_native, "_LIB", j_native._load_lib())
    assert j_native.available() is True
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
    native_loader.library.cache_clear()
    try:
        assert native_loader.available() is False
    finally:
        native_loader.library.cache_clear()


def test_fused_out_fields_match_jax():
    """cluster/tracker.FusedOut under its JAX name: the same fields in the
    same order, and the packed row's layout follows them (labels, five
    scalars, sizes, is_ground, cluster_ok, cluster_T)."""
    from slam_toolkit_tpu.cluster import tracker as j_trk
    from slam_toolkit_tpu_torch.cluster import tracker as t_trk
    assert t_trk.FusedOut._fields == j_trk.FusedOut._fields
    P, C = 7, 3
    out = t_trk.FusedOut(
        labels=torch.arange(P, dtype=torch.int32),
        skipped=torch.tensor(False), flow_p95=torch.tensor(21.5),
        n_points=torch.tensor(6), n_tracked=torch.tensor(5),
        n_new=torch.tensor(2), cluster_T=torch.eye(4).repeat(C, 1, 1),
        cluster_ok=torch.tensor([True, False, True]),
        sizes=torch.tensor([3, 0, 2]),
        is_ground=torch.tensor([False, True, False]))
    v = t_trk._pack(out).numpy()
    np.testing.assert_array_equal(v[:P], np.arange(P))
    np.testing.assert_array_equal(v[P:P + 5], [0.0, 21.5, 6, 5, 2])
    np.testing.assert_array_equal(v[P + 5:P + 5 + 3 * C],
                                  [3, 0, 2, 0, 1, 0, 1, 0, 1])
    np.testing.assert_array_equal(v[P + 5 + 3 * C:].reshape(C, 4, 4),
                                  np.tile(np.eye(4), (C, 1, 1)))


def test_engine_loop_events_is_a_property():
    """SlamEngine.loop_events is a property with a setter on both
    packages' per-frame engines (the checkpoint restore sets it)."""
    from slam_toolkit_tpu.pipeline.engine import SlamEngine as JaxEngine
    from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine
    for cls in (JaxEngine, SlamEngine):
        prop = cls.__dict__["loop_events"]
        assert isinstance(prop, property) and prop.fset is not None
    eng = SlamEngine(SlamConfig.tiny(), device="cpu")
    eng.loop_events = iter([{"frame": 1, "reloc_to": 0, "inliers": 30}])
    assert eng.loop_events == [{"frame": 1, "reloc_to": 0, "inliers": 30}]
