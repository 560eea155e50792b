"""The port's bench entry and the engine interface it drives, on the CPU
at the tiny configuration (the bench's own run is on the card)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.data import synthetic
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
from slam_toolkit_tpu_torch.tools import ate_spread, bench

torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "ate_m", "rpe_t_m", "blocked_chunk_ms",
        "chunk", "backend", "card", "power_limit", "kernel_build_s",
        "n_keyframes", "n_culls", "tf32", "graphs"}


def test_bench_record_on_cpu(tmp_path, monkeypatch):
    """The whole protocol at a tiny size (12 headline frames in chunks of
    3: 3 warm-up chunks, 1 timed; a 2-seed sweep of 9 frames): bench.py's
    keys and the port's, a finite fps and ATE, the frames rendered once
    into the cache and mapped from it on the second call."""
    cfg = SlamConfig.tiny()
    kw = dict(n_frames=12, chunk=3, device="cpu", n_seeds=2, sweep_frames=9,
              cache=str(tmp_path))
    out = bench.bench_record(cfg, **kw)
    assert set(out) == KEYS | {"sweep"}
    json.dumps(out)
    assert out["metric"] == "kitti_scale_track_lba_fps"
    assert out["backend"] == "torch-cpu" and out["card"] is None
    assert out["tf32"] is False and out["chunk"] == 3
    assert out["graphs"] is True
    assert out["value"] > 0 and np.isfinite(out["ate_m"])
    assert out["n_keyframes"] >= 2 and out["n_culls"] == 0
    sweep = out["sweep"]
    assert [r["seed"] for r in sweep["per_seed"]] == [7, 11]
    assert sweep["frames"] == 9 and sweep["seeds"] == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"slam_torch_bench_seed{s}_{n}f_step0.8_{cfg.camera.width}x"
        f"{cfg.camera.height}{ext}" for s, n in ((11, 9), (7, 12))
        for ext in (".gt.npy", ".npy")]

    def no_render(*a, **k):
        raise AssertionError("rendered again: the cache was not used")
    monkeypatch.setattr(bench, "render_stack", no_render)
    again = bench.bench_record(cfg, **kw)
    assert again["ate_m"] == out["ate_m"]
    assert again["sweep"]["ate_mean_m"] == sweep["ate_mean_m"]


def test_bench_hybrid_has_no_sweep(tmp_path):
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, method="hybrid"))
    out = bench.bench_record(cfg, n_frames=7, chunk=2, device="cpu",
                             cache=str(tmp_path))
    assert set(out) == KEYS
    assert out["metric"] == "kitti_scale_track_lba_fps_hybrid"


def test_stage_frames_match_make_sequence(tmp_path):
    cfg = SlamConfig.tiny()
    stacked, gt = bench.stage_frames(cfg, 3, seed=5, cache=str(tmp_path))
    _, gt_ref, frames = synthetic.make_sequence(cfg, n_frames=3, seed=5,
                                                step=bench.STEP_M)
    assert stacked.dtype == np.uint8 and stacked.shape[:2] == (3, 2)
    np.testing.assert_array_equal(stacked[1, 0], np.clip(
        frames[1][0], 0, 255).astype(np.uint8))
    for a, b in zip(gt, gt_ref):
        np.testing.assert_array_equal(a, b)


def test_ate_spread_draw0_is_the_headline(tmp_path):
    """Draw 0 is the bench's headline run to the last bit; a noisy draw
    runs the same protocol and gives a finite ATE."""
    cfg = SlamConfig.tiny()
    head = bench.run_headline(cfg, 12, 3, "cpu", cache=str(tmp_path))
    out = ate_spread.ate_spread(cfg, 12, 3, eps=1e-3, draws=1, device="cpu",
                                cache=str(tmp_path))
    assert [r["draw"] for r in out["runs"]] == [0, 1]
    assert out["runs"][0]["ate_m"] == head["ate_m"]
    assert out["runs"][0]["rpe_t_m"] == head["rpe_t_m"]
    assert out["runs"][0]["n_keyframes"] == head["n_keyframes"]
    assert np.isfinite(out["runs"][1]["ate_m"])
    assert out["ate_min_m"] <= out["ate_median_m"] <= out["ate_max_m"]


def test_draw_is_numpy_noise():
    """Draw d adds numpy.random.default_rng(d)'s uniform [-eps, eps]
    float32 array over the whole stack (what port_reference/
    jax_f32_loop.py --noise-seed d adds for the JAX package); draw 0 is
    the frames themselves."""
    frames = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (3, 2, 5, 7)).astype(np.float32))
    assert ate_spread._draw(frames, 0, 1e-3) is frames
    for d in (1, 4):
        want = frames.numpy() + np.random.default_rng(d).uniform(
            -1e-3, 1e-3, frames.shape).astype(np.float32)
        got = ate_spread._draw(frames, d, 1e-3)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < np.abs(got.numpy() - frames.numpy()).max() <= 1e-3 + 1e-4


def test_loop_spread_draw0_is_the_loop_bench(tmp_path):
    """ate_spread --loop at a tiny size (32 frames in chunks of 8): draw
    0 is the loop bench's run (its ATE and seam to the last bit), a noisy
    draw gives a finite ATE and seam, and the medians are the noisy
    draws'."""
    cfg = SlamConfig.tiny()
    out = ate_spread.loop_spread(cfg, 32, 8, eps=1e-3, draws=1,
                                 device="cpu", cache=str(tmp_path))
    stacked, gt = bench.stage_loop_frames(cfg, 32, 8, cache=str(tmp_path))
    vocab = bench.loop_vocabulary(cfg, stacked, bench.loop_cache_base(
        cfg, 32, 8, "clothoid", str(tmp_path)) + ".vocab.txt", "cpu")
    ref = bench.run_loop(cfg, vocab, stacked, gt, 8, "cpu")
    assert [r["draw"] for r in out["runs"]] == [0, 1]
    assert out["runs"][0]["ate_m"] == ref["ate_m"]
    assert out["runs"][0]["seam_m"] == ref["seam_m"]
    assert len(out["runs"][0]["closures"]) == ref["closures"]
    assert [c["frame"] for c in out["runs"][0]["closures"]] == \
        [c["frame"] for c in ref["closure_events"]]
    assert len(out["runs"][0]["inliers"]) == 32
    assert out["runs"][0]["keyframes"][0] == 0
    assert len(out["runs"][0]["keyframes"]) == ref["n_keyframes"]
    assert np.isfinite(out["runs"][1]["ate_m"])
    assert np.isfinite(out["runs"][1]["seam_m"])
    assert out["ate_median_m"] == out["runs"][1]["ate_m"]
    assert out["seam_median_m"] == out["runs"][1]["seam_m"]
    assert (out["queue_depth"], out["loop_thread"]) == \
        (ref["queue_depth"], ref["loop_thread"]) == (0, False)


@pytest.mark.parametrize("var", ["BENCH_DP", "BENCH_CLUSTER"])
def test_bench_refuses_modes_not_ported(var, monkeypatch):
    """No bench mode is refused as unported any more: BENCH_DP (the
    multi-sequence lanes) and BENCH_CLUSTER (the dense cluster workload)
    both run, and like every mode they want the card."""
    monkeypatch.setenv(var, "1")
    assert not hasattr(bench, "NOT_PORTED")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the mode would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()


DP_KEYS = {"metric", "value", "unit", "per_lane_fps", "lanes", "dp_mode",
           "frames_timed", "chunk", "ate_lane0_raw_m", "keyframes_per_lane",
           "kernels_per_frame", "busy", "backend", "card", "power_limit",
           "kernel_build_s", "tf32", "graphs", "option", "stagger"}


@pytest.mark.parametrize("mode", ["lane", "vmap"])
def test_dp_record_on_cpu(tmp_path, mode):
    """BENCH_DP's protocol at a tiny size (2 lanes, 14 frames: frame 0
    bootstraps, 12 in chunks of 3, the 1-frame tail dropped; 3 warm-up
    chunks, 1 timed): main_dp's metric, the port's keys, finite numbers,
    the same keyframes in every lane (they run the same frames)."""
    out = bench.dp_record(SlamConfig.tiny(), lanes=2, mode=mode,
                          n_frames=14, chunk=3, device="cpu",
                          cache=str(tmp_path))
    assert set(out) == DP_KEYS
    json.dumps(out)
    assert out["metric"] == "kitti_scale_dp2_aggregate_fps"
    assert out["dp_mode"] == mode and out["lanes"] == 2
    assert out["frames_timed"] == 3 and out["backend"] == "torch-cpu"
    assert out["value"] > 0 and out["per_lane_fps"] > 0
    assert abs(out["value"] - 2 * out["per_lane_fps"]) <= 0.02
    assert np.isfinite(out["ate_lane0_raw_m"])
    kfs = out["keyframes_per_lane"]
    assert len(kfs) == 2 and kfs[0] == kfs[1] >= 2
    assert out["kernels_per_frame"] is None and out["card"] is None


def test_dp_record_staggered_option_on_cpu(tmp_path):
    """BENCH_OPTION and BENCH_DP_STAGGER at the tiny size (O1, 2 lanes,
    lane 1 three frames ahead): the record names both, its numbers are
    finite, and the batched and in-turn layouts keep the same keyframes
    in each lane."""
    out = {mode: bench.dp_record(SlamConfig.tiny(), lanes=2, mode=mode,
                                 n_frames=11, chunk=2, device="cpu",
                                 cache=str(tmp_path), option="O1",
                                 stagger=3)
           for mode in ("lane", "vmap")}
    for rec in out.values():
        assert set(rec) == DP_KEYS
        assert rec["option"] == "O1" and rec["stagger"] == 3
        assert rec["value"] > 0 and np.isfinite(rec["ate_lane0_raw_m"])
    assert out["vmap"]["keyframes_per_lane"] == \
        out["lane"]["keyframes_per_lane"]


def test_bench_dp_mode_refused(monkeypatch):
    with pytest.raises(ValueError, match="BENCH_DP_MODE"):
        bench.dp_record(SlamConfig.tiny(), lanes=2, mode="shard",
                        device="cpu")


def test_engine_interface_and_tf32_flags():
    """The JAX engine's constructor (cfg, cam, vocab, chunk_size): a given
    camera is used as it is, a vocabulary accepted (its loop machinery
    on the engine's device); run, warmup, loop_events and elapsed_ms per
    frame; the caller's TF32 flags as they were after constructing and
    running."""
    from slam_toolkit_tpu_torch.loop import vocab as V
    cfg = SlamConfig.tiny()
    with_voc = ChunkedSlamEngine(cfg, vocab=V.synthesize(k=3, levels=2),
                                 device="cpu")
    assert with_voc._host is not None and with_voc.n_replays == 0
    assert with_voc._host.vocab.nodes.device.type == "cpu"
    assert with_voc.loop_events == []
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        cam = StereoCamera.from_config(cfg.camera, "cpu")
        eng = ChunkedSlamEngine(cfg, cam, None, 2, device="cpu")
        assert eng.cam is cam and eng.chunk_size == 2
        eng.warmup()
        _, _, frames = synthetic.make_sequence(cfg, n_frames=5, seed=3,
                                               step=0.25)
        eng.run(frames)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
    assert eng.loop_events == []
    assert len(eng.trajectory_refined()) == 5
    assert [s["frame"] for s in eng.frame_stats] == list(range(5))
    assert all(s["elapsed_ms"] >= 0 for s in eng.frame_stats)


LOOP_KEYS = {"metric", "value", "unit", "ate_m", "seam_m", "closures",
             "replays", "blocked_chunk_ms", "chunk", "loop_closing",
             "backend", "card", "power_limit", "kernel_build_s",
             "n_keyframes", "tf32", "seam_profile_m", "revisit_drift_m",
             "relocalizations", "closure_events", "pose_graph_tiers",
             "graphs", "queue_depth", "loop_thread"}


@pytest.mark.parametrize("track", ["clothoid", "fig8"])
def test_loop_bench_record_on_cpu(tmp_path, track):
    """BENCH_LOOP's protocol at a tiny size (48 frames in chunks of 8: 3
    warm-up chunks, the track closing at frame 40 for the clothoid):
    bench.py main_loop's keys and the port's, the vocabulary written as a
    DBoW2 text file and read back, the frames and vocabulary cached; the
    loop-closing-off run on the same frames."""
    cfg = SlamConfig.tiny()
    kw = dict(n_frames=48, chunk=8, device="cpu", track=track,
              cache=str(tmp_path))
    out = bench.loop_record(cfg, **kw)
    extra = {"seam_lap2_m", "seam_lobe2_m"} if track == "fig8" else set()
    assert set(out) == LOOP_KEYS | extra
    json.dumps(out)
    assert out["metric"] == "kitti_scale_full_slam_loop_fps" + (
        "_fig8" if track == "fig8" else "")
    assert out["value"] > 0 and np.isfinite(out["ate_m"])
    assert np.isfinite(out["seam_m"]) and out["loop_closing"] is True
    assert out["closures"] == len(out["closure_events"])
    # the engine's schedule: the port's defaults, the JAX engine's
    # deterministic one
    assert (out["queue_depth"], out["loop_thread"]) == (0, False)
    assert sorted(p.suffix for p in tmp_path.iterdir()) == \
        [".npy", ".npy", ".txt"]
    stem = f"slam_torch_loop_{track}_seed7_48f_chunk8_"
    assert all(p.name.startswith(stem) for p in tmp_path.iterdir())
    off = bench.loop_record(cfg, use_vocab=False, **kw)
    assert off["closures"] == 0 and off["loop_closing"] is False
    assert off["n_keyframes"] > 0


def test_loop_vocabulary_cached_per_track_and_chunk(tmp_path, monkeypatch):
    """The vocabulary is trained on the run's own frames: its file is
    named like them, one for each (track, chunk) of the same frame count,
    and a second call with the same name reads it back."""
    from slam_toolkit_tpu_torch.loop import vocab as V
    cfg = SlamConfig.tiny()
    trained = []
    train = V.train
    monkeypatch.setattr(V, "train", lambda *a, **k: trained.append(
        k) or train(*a, **k))
    _, _, frames = synthetic.make_sequence(cfg, n_frames=2, seed=3, step=0.3)
    stacked = np.stack([np.stack([np.clip(l, 0, 255), np.clip(r, 0, 255)])
                        for l, r in frames]).astype(np.uint8)
    runs = (("clothoid", 8), ("fig8", 8), ("clothoid", 4), ("clothoid", 8))
    for track, chunk in runs:
        base = bench.loop_cache_base(cfg, 48, chunk, track, str(tmp_path))
        assert base == str(tmp_path / (
            f"slam_torch_loop_{track}_seed7_48f_chunk{chunk}_step0.8_"
            f"{cfg.camera.width}x{cfg.camera.height}"))
        voc = bench.loop_vocabulary(cfg, stacked, base + ".vocab.txt", "cpu")
        assert voc.num_words > 0
    assert len(trained) == 3
    assert len(list(tmp_path.iterdir())) == 3


def test_loop_bench_switches(monkeypatch):
    """BENCH_LOOP_GROUP and BENCH_LOOP_OVER reach cfg.loop, numbers parsed
    by the field's type."""
    monkeypatch.setenv("BENCH_LOOP_GROUP", "sim3")
    monkeypatch.setenv("BENCH_LOOP_OVER", "min_matches=30,relpose_rt_rounds=2,"
                       "seam_ba=1")
    cfg = bench._loop_config(SlamConfig.tiny())
    assert cfg.loop.pose_graph_group == "sim3"
    assert cfg.loop.min_matches == 30 and cfg.loop.relpose_rt_rounds == 2
    assert cfg.loop.seam_ba is True
