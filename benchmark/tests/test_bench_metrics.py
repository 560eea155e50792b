"""The benchmark's arithmetic on the CPU: the tail, the idle share, the
roofline bounds, the profiler reduction, the counter readers and the
verdict."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, roofline
from benchmark.check import verdict
from benchmark.trace import SHORT_GAP_US, reduce_events

CARD = "NVIDIA H100 80GB HBM3"


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_tails_are_over_every_frame_not_chunk_medians():
    # 19 chunks of 16 frames at 100 ms and one at 900 ms: 5% of the
    # frames sit in the slow chunk, so the nearest-rank p95 over the
    # frames is 100 ms, and over 4% more slow frames it is 900 ms; the
    # median of the chunk medians would read 100 ms in both
    fast, slow = [0.1] * 16, [0.9] * 16
    assert harness.percentile(fast * 19 + slow, 95) == 0.1
    assert harness.percentile(fast * 15 + slow, 95) == 0.9
    assert harness.percentile(fast * 15 + slow, 90) == 0.1
    assert harness.percentile([0.3], 95) == 0.3
    assert harness.percentile(list(range(1, 101)), 95) == 95
    assert harness.percentile(list(range(1, 101)), 90) == 90


def test_end_to_end_readings_of_a_window():
    d = harness.Drive()
    d.latency_s = [0.2] * 32 + [1.0] * 16
    d.returned, d.window_s, d.ctx["setup_s"] = 48, 2.0, 12.5
    e = harness.end_to_end(d)
    assert e["frames_per_s"] == 24.0 and e["setup_s"] == 12.5
    assert e["pose_latency_p95_ms"] == 1000.0
    d.latency_s = [0.2] * 320 + [1.0] * 16
    assert harness.end_to_end(d)["pose_latency_p95_ms"] == 200.0


def test_idle_share_from_samples():
    ctx = {"nvml": [(0.0, 50.0), (0.1, 70.0), (0.2, 90.0)]}
    assert read("device_idle_share", ctx) == pytest.approx(30.0)
    assert read("device_idle_share", {"nvml": []}) is None


def test_roofline_bounds_match_chip_smoke():
    # chip_smoke.py phase 2's "Bound ms" of the pose LM (N=3072, 10
    # iterations: 0.000107 ms) and of local BA (W=8, P=1024, 10
    # iterations: 0.002873 ms), both bound by operations
    b, ops = roofline.pose_lm_work(3072, 10)
    assert ops == 3072 * (10 * 226 + 80)
    assert 1e3 * roofline.bound_s(b, ops, CARD) == pytest.approx(0.000107,
                                                                 abs=5e-7)
    b, ops = roofline.local_ba_work(8, 1024, 10)
    assert 1e3 * roofline.bound_s(b, ops, CARD) == pytest.approx(0.002873,
                                                                 abs=5e-7)
    assert b / 3.35e12 < ops / 67e12
    with pytest.raises(KeyError):
        roofline.peaks("a card the table lacks")


def test_roofline_share_readers():
    cfg = {"local_ba": {"window_keyframes": 8, "max_points": 1024,
                        "num_iterations": 10},
           "map": {"track_landmarks": 3072},
           "tracker": {"num_iterations": 10}}
    ctx = {"config": cfg, "card": CARD, "profile": {"kernels": {
        "local_ba_kernel(float const*, ...)": [4, 4 * 0.4919e-3],
        "pose_lm_kernel(float const*, ...)": [2, 2 * 0.0369e-3],
        "void at::native::elementwise": [100, 1.0]}}}
    ba = read("local_ba_roofline_share", ctx)
    lm = read("pose_lm_roofline_share", ctx)
    assert ba == pytest.approx(100 * 0.002873 / 0.4919, rel=1e-3)
    assert lm == pytest.approx(100 * 0.000107 / 0.0369, rel=5e-3)
    assert read("local_ba_roofline_share",
                dict(ctx, profile={"kernels": {}})) is None


def _ev(name, start, end, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce_events_busy_gaps_and_kernels():
    events = [
        _ev("bench.profiled_window", 0, 1000, False),
        _ev("cudaGraphLaunch", 0, 50, False),
        _ev("cudaEventSynchronize", 400, 850, False),
        _ev("k1", 100, 200, True), _ev("k1", 150, 300, True),
        _ev("k2", 305, 400, True), _ev("k2", 700, 800, True)]
    r = reduce_events(events, 0, 1000)
    assert r["busy_s"] == pytest.approx((200 + 95 + 100) * 1e-6)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["kernels"]["k1"] == [2, pytest.approx(250e-6)]
    gaps = dict(r["idle_gaps"])
    # a gap is named by the shortest host event over its middle
    assert gaps["cudaGraphLaunch"] == pytest.approx(100e-6)
    assert gaps["cudaEventSynchronize"] == pytest.approx(300e-6)
    assert gaps["(no host event)"] == pytest.approx(200e-6)
    assert any("under" in k for k in gaps) and SHORT_GAP_US > 5
    assert r["device_ops"][0][0] == "k1"


def test_counter_readers():
    ctx = {"counted": {"captures": 1, "keyframe_if_runs": 60},
           "frames": 240, "chunks": 15}
    assert read("keyframe_event_runs_per_frame", ctx) == 0.25
    assert read("captures_in_window", ctx) == 1
    assert read("captures_in_window", {}) is None
    assert read("keyframe_event_runs_per_frame", {}) is None


def test_verdict_limits():
    ok, lines = verdict({"a": 0, "b": 0.5, "c": 3},
                        {"a": {"max": 0}, "b": {"max": 1.0},
                         "c": {"min": 2}})
    assert ok and [x[2] for x in lines] == ["<=", "<=", ">="]
    assert not verdict({"a": 1}, {"a": {"max": 0}})[0]
    assert not verdict({}, {"a": {"max": 0}})[0]
    assert not verdict({"c": 1}, {"c": {"min": 2}})[0]
