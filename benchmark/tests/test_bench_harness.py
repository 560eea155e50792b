"""The harness on the CPU: finding a cell's parts by name, a cell added
as new files alone, BENCHMARK.json against the benchmark's contract,
and the cyclic feeder at the lap seam."""

import inspect
import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.check import verdict
from benchmark.feeder import Circuit, frame_seed
from benchmark.reference import synthetic

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_every_cell_resolves(spec):
    for w in spec["workloads"]:
        parts = harness.resolve(spec, w["name"])
        assert parts["config"]["name"] == w["config"]
        assert parts["traffic"]["kind"] == "circuit"
        assert parts["limits"], w["name"]
        e2e = set(parts["end_to_end"])
        assert e2e == {"frames_per_s", "pose_latency_p95_ms", "setup_s"}
        for name in parts["per_layer"]:
            assert callable(harness.metric_reader(name))
        # the configuration as it is run: every section the port has
        cfg = harness.slam_config(parts["config"]["slam"])
        assert cfg.extractor.max_keypoints == 2048
        assert cfg.camera.width == 1241 and cfg.camera.height == 376
    with pytest.raises(KeyError):
        harness.resolve(spec, "no_such_cell")


def test_graph_counters_fail_loudly_on_a_renamed_member():
    """The counters are read from the engine's members directly: a
    renamed member raises instead of reading nothing."""
    class Graphs:
        def __init__(self, stats):
            self.stats = stats

        def graph_stats(self):
            return self.stats

        def loop_graph_stats(self):
            return None

    chunk = Graphs({"captures": 2, "if_runs": {"keyframe": 7}})
    mapper = Graphs({"captures": 3})
    logs = dict(closures_landed=[160, 480], loop_events=[{}, {}, {}])
    eng = SimpleNamespace(_chunk=chunk, _mapper=mapper, **logs)
    assert harness.graph_counters(eng) == {"captures": 5,
                                           "keyframe_if_runs": 7,
                                           "closures_landed": 2,
                                           "loop_events": 3}
    off_card = SimpleNamespace(_chunk=Graphs(None), _mapper=Graphs(None),
                               closures_landed=[], loop_events=[])
    assert harness.graph_counters(off_card) == {"captures": 0,
                                                "keyframe_if_runs": None,
                                                "closures_landed": 0,
                                                "loop_events": 0}
    with pytest.raises(AttributeError):
        harness.graph_counters(SimpleNamespace(_chunk=chunk, **logs))
    with pytest.raises(AttributeError):
        harness.graph_counters(SimpleNamespace(_chunk=chunk, _mapper=mapper))
    with pytest.raises(KeyError):
        harness.graph_counters(SimpleNamespace(
            _chunk=Graphs({"captures": 1, "if_runs": {}}), _mapper=mapper,
            **logs))


def test_a_cell_added_as_new_files_only(tmp_path, spec):
    """A later change adds a configuration, a traffic mix, a cell, its
    limits and a per-layer metric as files and entries; no file the
    benchmark has is edited. A loop configuration too: its vocabulary
    recipe, its own check module with all three hooks, limits on that
    module's numbers and a metric of the spans and loop counters."""
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / sub, root / sub)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "configs" / "kitti_stereo_vo.json").read_text())
    cfg["name"] = "kitti_stereo_vo_o3"
    cfg["slam"]["extractor"]["fused_fast"] = True
    (root / "configs" / "kitti_stereo_vo_o3.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "traffic" / "circuit_laps.json").read_text())
    traffic["track"]["frames_per_lap"] = 544
    (root / "traffic" / "long_laps.json").write_text(json.dumps(traffic))
    (root / "limits" / "vo_o3_long.json").write_text(
        json.dumps({"rows_missing": {"max": 0}}))
    (root / "metrics" / "chunks_in_window.py").write_text(
        "def read(ctx):\n    return ctx.get('chunks')\n")
    loop = json.loads((ROOT / "configs" / "kitti_stereo_vo.json").read_text())
    loop.update(name="kitti_stereo_slam", checks=["closure_probe"],
                vocabulary={"k": 10, "levels": 6, "every": 4, "seed": 0,
                            "max_train": 100000})
    loop["slam"]["loop"]["bow_mode"] = "topw"
    (root / "configs" / "kitti_stereo_slam.json").write_text(json.dumps(loop))
    (root / "checks").mkdir()
    (root / "checks" / "closure_probe.py").write_text(
        "def after_chunk(engine, g):\n"
        "    return {'g': g, 'landed': list(engine.closures_landed)}\n"
        "def at_end(engine):\n"
        "    return len(engine.loop_events)\n"
        "def numbers(sessions, circuit, cfg_doc, traffic, seed):\n"
        "    return {'closures_landed': sum(len(a.closures_landed)\n"
        "                                   for a in sessions)}\n")
    (root / "limits" / "slam_loop.json").write_text(
        json.dumps({"closures_landed": {"min": 1}}))
    (root / "metrics" / "fold_spans_per_closure.py").write_text(
        "def read(ctx):\n"
        "    spans, n = ctx.get('spans'), ctx['counted']['closures_landed']\n"
        "    if not spans or not n:\n"
        "        return None\n"
        "    return sum(s['name'] == 'fold' for ex in spans\n"
        "               for s in ex['spans']) / n\n")
    new = json.loads(json.dumps(spec))
    new["configs"] += [
        {"name": "kitti_stereo_vo_o3", "source": "x", "reduced": [],
         "file": "benchmark/configs/kitti_stereo_vo_o3.json", "why": "x"},
        {"name": "kitti_stereo_slam", "source": "x", "reduced": [],
         "file": "benchmark/configs/kitti_stereo_slam.json", "why": "x"}]
    new["workloads"] += [
        {"name": "vo_o3_long", "config": "kitti_stereo_vo_o3",
         "traffic": "long_laps", "chips": 1, "why": "x"},
        {"name": "slam_loop", "config": "kitti_stereo_slam",
         "traffic": "circuit_laps", "chips": 1, "why": "x"}]
    new["per_layer"] += [
        {"name": "chunks_in_window", "unit": "chunks", "better": "higher",
         "source": "program_counter", "layer": "keyframe branch",
         "moves": "frames_per_s", "workloads": ["vo_o3_long"]},
        {"name": "fold_spans_per_closure", "unit": "folds",
         "better": "lower", "source": "program_span",
         "layer": "loop phases", "moves": "frames_per_s",
         "workloads": ["slam_loop"]}]
    parts = harness.resolve(new, "vo_o3_long", root=root, repo=tmp_path)
    assert parts["config"]["slam"]["extractor"]["fused_fast"] is True
    assert parts["traffic"]["track"]["frames_per_lap"] == 544
    assert parts["limits"] == {"rows_missing": {"max": 0}}
    assert "chunks_in_window" in parts["per_layer"]
    assert harness.metric_reader("chunks_in_window", root)({"chunks": 7}) == 7
    assert harness.slam_config(parts["config"]["slam"]).extractor.fused_fast
    assert harness.check_modules(parts["config"], root) == {}
    old = harness.resolve(new, "vo_circuit", root=root, repo=tmp_path)
    assert "chunks_in_window" not in old["per_layer"]
    assert "fold_spans_per_closure" not in old["per_layer"]
    # the loop cell
    parts = harness.resolve(new, "slam_loop", root=root, repo=tmp_path)
    assert parts["config"]["vocabulary"]["levels"] == 6
    assert harness.slam_config(parts["config"]["slam"]).loop.bow_mode == \
        "topw"
    mods = harness.check_modules(parts["config"], root)
    probe = mods["closure_probe"]
    eng = SimpleNamespace(closures_landed=[161], loop_events=[{}, {}])
    assert probe.after_chunk(eng, 160) == {"g": 160, "landed": [161]}
    assert probe.at_end(eng) == 2
    sessions = [SimpleNamespace(closures_landed=[161, 433]),
                SimpleNamespace(closures_landed=[])]
    got = probe.numbers(sessions, None, parts["config"], parts["traffic"], 1)
    assert verdict(got, parts["limits"]) == (
        True, [("closures_landed", 2, ">=", 1)])
    read = harness.metric_reader("fold_spans_per_closure", root)
    spans = [{"spans": [{"name": "fold"}, {"name": "fold"},
                        {"name": "rows"}], "stamps": [], "setup_chunks": 0}]
    assert read({"spans": spans, "counted": {"closures_landed": 2}}) == 1.0
    assert read({"counted": {"closures_landed": 2}}) is None
    assert "fold_spans_per_closure" in parts["per_layer"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_check_module_without_numbers_is_refused(tmp_path):
    (tmp_path / "checks").mkdir()
    (tmp_path / "checks" / "hooks_only.py").write_text(
        "def at_end(engine):\n    return None\n")
    with pytest.raises(AttributeError):
        harness.check_modules({"checks": ["hooks_only"]}, tmp_path)


def test_the_vo_engine_gets_the_arguments_it_had(monkeypatch):
    """kitti_stereo_vo has no vocabulary and no checks: its engine is
    built with vocab=None and every other argument as before, and with
    trace=True only where the run is traced."""
    from slam_toolkit_tpu_torch.pipeline import scan_engine

    import benchmark.feeder

    class Circuit:                     # no render: the engine alone
        def __init__(self, *args, **kw):
            pass

    class Built(Exception):
        pass

    seen = []
    sig = inspect.signature(scan_engine.ChunkedSlamEngine.__init__)

    def spy(self, *args, **kw):
        bound = sig.bind(self, *args, **kw)
        bound.apply_defaults()
        seen.append({k: v for k, v in bound.arguments.items()
                     if k != "self"})
        raise Built
    monkeypatch.setattr(benchmark.feeder, "Circuit", Circuit)
    monkeypatch.setattr(scan_engine.ChunkedSlamEngine, "__init__", spy)
    parts = harness.resolve(harness.load_spec(), "vo_circuit")
    setup = harness.Setup(parts, "cpu")
    assert setup.vocab is None and setup.checks == {}
    for trace in (False, True):
        with pytest.raises(Built):
            setup.engine(trace)
    e = parts["config"]["engine"]
    before = {"cfg": setup.cfg, "cam": None, "vocab": None,
              "chunk_size": e["chunk_size"], "device": setup.device,
              "graphs": e["graphs"], "queue_depth": e["queue_depth"],
              "loop_thread": e["loop_thread"], "trace": False}
    assert seen == [before, dict(before, trace=True)]


def test_benchmark_json_keeps_to_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and \
            (harness.REPO / c["file"]).is_file()
        doc = json.loads((harness.REPO / c["file"]).read_text())
        assert doc["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(spec)) < 64 * 1024


def test_the_lap_closes_into_a_continuous_drive():
    # the step from lap frame 271 to frame 0 is one step of the track:
    # 0.8 m forward, the yaw of the track's last (straightening) frame
    poses = synthetic.loop_track(272, 0.8, 12)

    def step(a, b):
        D = poses[b].astype(np.float64) @ np.linalg.inv(
            poses[a].astype(np.float64))
        ang = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2,
                                           -1, 1)))
        return np.linalg.norm(D[:3, 3]), ang

    seam_t, seam_r = step(271, 0)
    prev_t, prev_r = step(270, 271)
    assert seam_t == pytest.approx(0.8, abs=2e-3)
    assert seam_t == pytest.approx(prev_t, abs=1e-3)
    assert abs(seam_r - prev_r) < 0.2 and seam_r < 1.0
    centres = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])
    assert np.linalg.norm(centres[0] - centres[-1]) == pytest.approx(
        0.8, abs=2e-3)


def test_the_feeder_replays_the_lap_with_fresh_noise(tmp_path):
    cam = {"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0, "k1": 0.0,
           "k2": 0.0, "p1": 0.0, "p2": 0.0, "baseline": 0.5, "width": 64,
           "height": 48}
    traffic = {"track": {"frames_per_lap": 8, "step_m": 0.5, "ramp": 1},
               "world": {"seed": 3, "half_width": 6.0, "half_length": 6.0,
                         "ground_y": 1.6, "tex_size": 256,
                         "texels_per_m": 12.0},
               "noise_levels": 1}
    c = Circuit(cam, traffic, tmp_path, "cpu", log=lambda m: None)
    assert (tmp_path / f"{c.name}.npy").exists()
    chunk = c.chunk(5, 6, 4)                  # lap frames 6, 7 | 0, 1
    base = c.frames.to(torch.float32)
    for k, i in enumerate((6, 7, 0, 1)):
        d = chunk[k] - base[i]
        clipped = (base[i] == 0) | (base[i] == 255)
        assert float(d[~clipped].abs().max()) <= 1.0
        assert float((d != 0).float().mean()) > 0.5
    assert torch.equal(chunk[2], c.frame(5, 8))
    assert torch.equal(c.chunk(5, 6, 4), chunk)        # the seed decides
    assert not torch.equal(c.frame(6, 8), c.frame(5, 8))
    assert not torch.equal(c.frame(5, 0), c.frame(5, 8))   # a new lap
    assert np.array_equal(c.pose(9), c.pose(1))
    again = Circuit(cam, traffic, tmp_path, "cpu", log=lambda m: None)
    assert torch.equal(again.frames, c.frames)          # from the cache
    assert frame_seed(2 ** 40 + 3, 1, 2) != frame_seed(3, 1, 2)
    assert 0 <= frame_seed(2 ** 64 - 1, 0, 0) < 2 ** 63
