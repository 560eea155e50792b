"""`correct` comes out false when the timed path is broken underneath.

A tiny cell (SlamConfig.tiny() on drives of one 128-frame lap, in chunks
of 8)
runs through the whole harness on the CPU, the chip check aside: the
drive, the copy of the program's outputs, the reference and the
verdict. Its limits are three times what a sound run of the same seed
reads (the tiny scene tracks far worse than the full-size one, so the
cells' own limits do not fit it). Each fault of benchmark/faults.py
must then fail a limit.
"""

import dataclasses
import json
import shutil
import time

import pytest

from benchmark import faults, harness

SEED = 2 ** 33 + 17
SECONDS = 1.0
CHUNKS = 15          # at least (the window's length on a shared CPU
#                      varies): past the first drive's 16 chunks


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from slam_toolkit_tpu_torch.config import SlamConfig
    root = tmp_path_factory.mktemp("bench")
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir()
    shutil.copytree(harness.ROOT / "metrics", root / "metrics")
    doc = json.loads((harness.ROOT / "configs" /
                      "kitti_stereo_vo.json").read_text())
    doc.update(name="tiny_vo", slam=dataclasses.asdict(SlamConfig.tiny()),
               engine=dict(doc["engine"], chunk_size=8))
    (root / "configs" / "tiny_vo.json").write_text(json.dumps(doc))
    traffic = json.loads((harness.ROOT / "traffic" /
                          "circuit_laps.json").read_text())
    traffic.update(
        track={"frames_per_lap": 128, "step_m": 0.5, "ramp": 8},
        drive_laps=1,
        world={"seed": 7, "half_width": 16.0, "half_length": 16.0,
               "ground_y": 1.6, "tex_size": 1024, "texels_per_m": 12.0},
        warmup_chunks=2, check={"track_frames": 2, "keyframes": 2})
    (root / "traffic" / "tiny_laps.json").write_text(json.dumps(traffic))
    spec = harness.load_spec()
    spec["configs"] = [{"name": "tiny_vo", "source": "x", "reduced": [],
                        "file": "configs/tiny_vo.json", "why": "x"}]
    spec["workloads"] = [{"name": "tiny_cell", "config": "tiny_vo",
                          "traffic": "tiny_laps", "chips": 1, "why": "x"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "vo_circuit" in m.get("workloads", []):
            m["workloads"] = ["tiny_cell"]
    cell_limits = json.loads((harness.ROOT / "limits" /
                              "vo_circuit.json").read_text())
    (root / "limits" / "tiny_cell.json").write_text(json.dumps(
        {k: {"max": 1e9} for k in cell_limits}))
    parts = harness.resolve(spec, "tiny_cell", root=root, repo=root)
    sound = run(parts, root)
    limits = {}
    for name, lim in cell_limits.items():
        v = sound["checks"][name]["value"]
        limits[name] = {"max": 3.0 * v} if "max" in lim else \
            {"min": v / 3.0}
    parts["limits"] = limits
    return parts, root


def run(parts, root, hook=None):
    return harness.run(parts, SEED, SECONDS, False, time.perf_counter(),
                       device="cpu", cache=root / ".cache", engine_hook=hook,
                       min_chunks=CHUNKS)


def test_a_sound_run_is_correct(tiny):
    parts, root = tiny
    out = run(parts, root)
    assert out["correct"], out["checks"]
    assert out["numbers"]["drives"] >= 2          # a new drive started
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "pose_latency_p95_ms",
                                   "setup_s"}       # the vo cell's
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,fails", [
    ("state_unchanged", "chunk_motion_err_p50_m"),
    ("half_left_out", "rows_missing"),
    ("row_altered", "motion_err_m"),
    ("descriptor_altered", "kf_feature_mismatch"),
])
def test_a_planted_fault_is_not_correct(tiny, fault, fails):
    parts, root = tiny
    out = run(parts, root, faults.hook(fault))
    assert not out["correct"]
    c = out["checks"][fails]
    op, bound = c["limit"].split()
    assert not (c["value"] <= float(bound) if op == "<=" else
                c["value"] >= float(bound)), c


def test_the_readings_judge_the_program_and_the_control(tiny):
    """calibrate's readings drive the cell as a run does and judge both
    the program and the control (the reference in TF32, which the CPU
    computes in float32) through the cell's verdict."""
    from benchmark.calibrate import readings
    parts, root = tiny
    setup = harness.Setup(parts, "cpu", root / ".cache")
    r = readings(setup, SEED, SECONDS, True, min_chunks=CHUNKS)
    assert r["correct"] is True, r["numbers"]
    assert isinstance(r["control_correct"], bool)
    assert set(parts["limits"]) <= set(r["control"])
    assert len(r["chunk_ms"]) >= CHUNKS
