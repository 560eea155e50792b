"""A configuration with loop closing on the CPU: its vocabulary built and
cached from its recipe, handed to the engine; each drive ended by the
engine's flush(); the configuration's own check hooks and numbers; the
states a closure re-seeded left out of the tracking check. And the vo
path unchanged: a tiny drive reads the numbers the harness's earlier
drive read (transcribed below), and the frozen trainer equals the
port's."""

import dataclasses
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.check import NUMBERS, judge
from benchmark.reference import vocab_train

SEED = 2 ** 33 + 29
RECIPE = {"k": 4, "levels": 3, "every": 4, "seed": 0, "max_train": 20000}
PROBE = '''
def after_chunk(engine, g):
    return {"kf_T": engine.carry.m.kf_T_cw.clone()}


def at_end(engine):
    # after the drive's flush(): nothing in flight, no detection stashed
    return {"pending": len(engine._pending),
            "stash": len(engine._loop_stash),
            "vocab_levels": engine.vocab.levels}


def numbers(sessions, circuit, cfg_doc, traffic, seed):
    kept = [a.kept["probe"] for a in sessions]
    return {
        "probe_closures": sum(len(a.closures_landed) for a in sessions),
        "probe_events": sum(len(a.loop_events) for a in sessions),
        "probe_after_chunk": sum(len(k["after_chunk"]) for k in kept),
        "probe_ended": sum(k["at_end"] is not None and
                           k["at_end"]["pending"] == 0 and
                           k["at_end"]["stash"] == 0 and
                           k["at_end"]["vocab_levels"] == 3 for k in kept),
        "probe_sampled_at_loop": sum(g in a.states for a in sessions
                                     for g in a.kept["probe"]["after_chunk"]),
        "probe_host_copies": all(v["kf_T"].device.type == "cpu"
                                 for k in kept
                                 for v in k["after_chunk"].values())}
'''


def tiny_root(root: Path, lap: int, laps: int, vocabulary=None,
              checks=()) -> dict:
    """A tiny cell's files under root (SlamConfig.tiny() on drives of
    `laps` laps of a `lap`-frame circuit, chunks of 8) and its parts."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True)
    shutil.copytree(harness.ROOT / "metrics", root / "metrics")
    doc = json.loads((harness.ROOT / "configs" /
                      "kitti_stereo_vo.json").read_text())
    doc.update(name="tiny", slam=dataclasses.asdict(SlamConfig.tiny()),
               engine=dict(doc["engine"], chunk_size=8))
    if vocabulary is not None:
        doc.update(vocabulary=vocabulary, checks=list(checks))
    (root / "configs" / "tiny.json").write_text(json.dumps(doc))
    traffic = json.loads((harness.ROOT / "traffic" /
                          "circuit_laps.json").read_text())
    traffic.update(
        track={"frames_per_lap": lap, "step_m": 0.5, "ramp": 8},
        drive_laps=laps,
        world={"seed": 7, "half_width": 16.0, "half_length": 16.0,
               "ground_y": 1.6, "tex_size": 1024, "texels_per_m": 12.0},
        warmup_chunks=2, check={"track_frames": 2, "keyframes": 2})
    (root / "traffic" / "tiny_laps.json").write_text(json.dumps(traffic))
    spec = harness.load_spec()
    spec["configs"] = [{"name": "tiny", "source": "x", "reduced": [],
                        "file": "configs/tiny.json", "why": "x"}]
    spec["workloads"] = [{"name": "tiny_cell", "config": "tiny",
                          "traffic": "tiny_laps", "chips": 1, "why": "x"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "vo_circuit" in m.get("workloads", []):
            m["workloads"] = ["tiny_cell"]
    (root / "limits" / "tiny_cell.json").write_text(
        json.dumps({"rows_missing": {"max": 0}}))
    return harness.resolve(spec, "tiny_cell", root=root, repo=root)


@pytest.fixture
def engines(monkeypatch):
    """Each ChunkedSlamEngine built, with the calls to its flush()."""
    from slam_toolkit_tpu_torch.pipeline import scan_engine
    cls = scan_engine.ChunkedSlamEngine
    built, init, flush = [], cls.__init__, cls.flush

    def spy_init(self, *args, **kw):
        init(self, *args, **kw)
        self.flushes = 0
        built.append(self)

    def spy_flush(self):
        self.flushes += 1
        return flush(self)
    monkeypatch.setattr(cls, "__init__", spy_init)
    monkeypatch.setattr(cls, "flush", spy_flush)
    return built


def test_a_loop_configuration_drives_its_vocabulary_and_checks(
        tmp_path, engines):
    parts = tiny_root(tmp_path, lap=64, laps=3, vocabulary=RECIPE,
                      checks=["probe"])
    (tmp_path / "checks").mkdir()
    (tmp_path / "checks" / "probe.py").write_text(PROBE)
    parts["limits"] = {"rows_missing": {"max": 0},
                       "probe_closures": {"min": 1},
                       "probe_sampled_at_loop": {"max": 0}}
    # 22 window chunks end the first 192-frame drive, 3 run the second
    out = harness.run(parts, SEED, 0.0, False, time.perf_counter(),
                      device="cpu", cache=tmp_path / ".cache",
                      min_chunks=25)
    assert out["correct"], out["checks"]
    n = dict(out["numbers"], **{k: c["value"]
                                for k, c in out["checks"].items()})
    assert n["drives"] == len(engines) == 2
    # every engine got the configuration's vocabulary, untraced
    assert all(e.vocab is not None and e.vocab.k == 4 and
               e.vocab.levels == 3 and e.tracer is None for e in engines)
    # each drive's end flushed it before its at_end hook read it
    assert n["probe_ended"] == 2
    assert all(e.flushes >= 1 for e in engines)
    # closures landed; after each call that landed one the hook ran, and
    # that call's chunk-boundary state was not sampled
    assert n["probe_events"] >= n["probe_closures"] >= 1
    assert 1 <= n["probe_after_chunk"] <= n["probe_events"]
    assert n["probe_sampled_at_loop"] == 0
    assert n["probe_host_copies"] is True
    assert out["failed"] == 0


def test_the_vocabulary_is_built_by_the_benchmark_and_cached(
        tmp_path, monkeypatch):
    """Descriptors from the frozen reference extractor (the port's
    extract is never called), the frozen trainer, one npz file keyed by
    the recipe; a second build reads it through the port's loop.vocab."""
    from slam_toolkit_tpu_torch.loop import vocab as V
    from slam_toolkit_tpu_torch.ops import extractor as port_extractor
    from benchmark.feeder import Circuit
    parts = tiny_root(tmp_path, lap=16, laps=1)
    cfg = parts["config"]["slam"]
    circ = Circuit(cfg["camera"], parts["traffic"], tmp_path, "cpu")

    def refused(*args, **kw):
        raise AssertionError("the port's extractor was called")
    monkeypatch.setattr(port_extractor, "extract", refused)
    voc = harness.vocabulary(RECIPE, circ, cfg["extractor"], tmp_path, "cpu")
    files = sorted(tmp_path.glob("vocab_*.npz"))
    assert len(files) == 1 and voc.k == 4 and voc.levels == 3
    monkeypatch.setattr(vocab_train, "train", refused)
    again = harness.vocabulary(RECIPE, circ, cfg["extractor"], tmp_path,
                               "cpu")
    for a, b in zip(V.to_numpy(voc), V.to_numpy(again)):
        assert np.array_equal(a, b)
    monkeypatch.undo()                  # another recipe trains again
    harness.vocabulary(dict(RECIPE, every=8), circ, cfg["extractor"],
                       tmp_path, "cpu")
    assert len(list(tmp_path.glob("vocab_*.npz"))) == 2


@pytest.mark.parametrize("k,levels", [(10, 3), (4, 6)])
def test_the_frozen_trainer_equals_the_ports(k, levels):
    from slam_toolkit_tpu_torch.loop import vocab as V
    desc = np.random.default_rng(11).integers(
        0, 2 ** 32, size=(3000, 8), dtype=np.uint64).astype(np.uint32)
    ours = vocab_train.train(desc, k, levels, seed=5, max_train=2500)
    nodes, children, word_id, weights = V.to_numpy(
        V.train(desc, k, levels, seed=5, max_train=2500))
    assert ours.nodes.shape[0] > k ** 2
    assert np.array_equal(ours.nodes, nodes)
    assert np.array_equal(ours.children, children)
    assert np.array_equal(ours.word_id, word_id)
    assert np.array_equal(ours.weights, weights)


def test_judge_adds_a_checks_numbers_and_refuses_a_clash():
    circuit = SimpleNamespace(device=torch.device("cpu"))
    cfg_doc = {"slam": {"camera": json.loads((
        harness.ROOT / "configs" / "kitti_stereo_vo.json").read_text())[
            "slam"]["camera"]}, "engine": {"chunk_size": 16}}
    traffic = {"check": {"track_frames": 2, "keyframes": 2}}

    def check(**got):
        return SimpleNamespace(numbers=lambda *a: dict(got))

    def with_control(sessions, circuit, cfg_doc, traffic, seed,
                     control=False):
        return {"closure_gap": 9.0 if control else 1.0}
    out = judge([], circuit, cfg_doc, traffic, 3, checks={
        "a": check(closure_gap_p50=0.5),
        "b": SimpleNamespace(numbers=with_control)})
    assert out["closure_gap_p50"] == 0.5 and out["closure_gap"] == 1.0
    assert judge([], circuit, cfg_doc, traffic, 3, control=True, checks={
        "b": SimpleNamespace(numbers=with_control)})["closure_gap"] == 9.0
    for clash in ({"x": check(motion_err_m=0.0)},
                  {"x": check(mp_depth_err=0.0)},        # not in this run
                  {"x": check(a=1), "y": check(a=2)}):
        with pytest.raises(ValueError):
            judge([], circuit, cfg_doc, traffic, 3, checks=clash)


def earlier_drive(parts, root, seed, n_chunks) -> dict:
    """The harness's untraced drive as it was before configurations had
    vocabularies, checks and flushed drive ends, transcribed: a fresh
    engine a drive (vocab=None), the warm-up, then n_chunks chunks; a
    chunk-boundary state kept where no cull ran; a drive's map read
    through the engine's `map`. Returns its numbers."""
    from benchmark.check import STATE_FIELDS
    from slam_toolkit_tpu_torch.pipeline.scan_engine import \
        ChunkedSlamEngine
    setup = harness.Setup(parts, "cpu", root / ".cache")
    e = setup.cfg_doc["engine"]
    chunk, circ, ended = int(e["chunk_size"]), setup.circuit, []

    def start(index):
        return SimpleNamespace(
            index=index, first=index * setup.drive_frames, rows={},
            states={}, g=0, window_first=None, handed=0, returned=0,
            loop_events=[], closures_landed=[], kept={},
            eng=ChunkedSlamEngine(
                setup.cfg, vocab=None, chunk_size=int(e["chunk_size"]),
                device=setup.device, graphs=bool(e["graphs"]),
                queue_depth=int(e["queue_depth"]),
                loop_thread=bool(e["loop_thread"])))

    def keep(s, rows):
        base = len(s.rows) + 1
        for i, r in enumerate(rows):
            s.rows[base + i] = r

    def end(s):
        m = s.eng.map
        s.map = {f: getattr(m, f).clone() for f in harness.MAP_FIELDS}
        s.eng = None
        ended.append(s)

    s = start(0)
    for _ in range(int(setup.traffic["warmup_chunks"])):
        keep(s, s.eng.process_chunk(circ.chunk(seed, s.first + s.g, chunk)))
        s.g += chunk
    s.window_first = s.g
    for _ in range(n_chunks):
        if s.g + chunk > setup.drive_frames:
            end(s)
            s = start(s.index + 1)
            s.window_first = 0
        imgs = circ.chunk(seed, s.first + s.g, chunk)
        state = None if s.eng.carry is None else \
            {f: getattr(s.eng.carry, f).clone() for f in STATE_FIELDS}
        culls = s.eng.n_culls
        rows = s.eng.process_chunk(imgs)
        if state is not None and s.eng.n_culls == culls:
            s.states[s.g] = state
        n_in = chunk - (1 if s.g == 0 else 0)
        s.handed += n_in
        s.returned += len(rows)
        keep(s, rows)
        s.g += chunk
    end(s)
    return judge([harness.artifacts(x) for x in ended], circ,
                 setup.cfg_doc, setup.traffic, seed)


def test_a_vo_drive_reads_the_numbers_it_read_before(tmp_path):
    parts = tiny_root(tmp_path, lap=64, laps=2)
    parts["limits"] = {}
    out = harness.run(parts, SEED, 0.0, False, time.perf_counter(),
                      device="cpu", cache=tmp_path / ".cache",
                      min_chunks=18)
    before = earlier_drive(parts, tmp_path, SEED, 18)
    assert out["numbers"]["drives"] == 2
    assert out["numbers"] == before
    assert set(before) <= set(NUMBERS)     # the names a check may not take


def test_a_queued_engines_rows_are_each_counted_once(tmp_path):
    """With chunks in flight (queue_depth 2) rows come back a call or
    two late, the rest from the flush() that ends each drive: every
    frame handed in is returned once, with one latency from its own
    chunk's hand-in; the window's last drive's flush comes late."""
    parts = tiny_root(tmp_path, lap=64, laps=1)
    parts["config"]["engine"]["queue_depth"] = 2
    setup = harness.Setup(parts, "cpu", tmp_path / ".cache")
    d = harness.drive(setup, SEED, 0.0, False, time.perf_counter(),
                      min_chunks=9)
    s = d.sessions
    assert len(s) == 2 and all(x.handed == x.returned for x in s)
    assert d.handed == d.returned + d.late and d.late > 0
    assert len(d.latency_s) == d.returned
    assert all(len(x.rows) == x.g - 1 for x in s)   # but the bootstrap
    # the first drive's last rows waited for the flush, not a later call
    assert max(d.latency_s) < d.window_s
