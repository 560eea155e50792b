"""Whole-name import checks, in fresh interpreters: nothing the benchmark
runs loads jax or slam_toolkit_tpu (the port's own name begins with the
latter's, so names are compared whole), and the plain reference loads
nothing of slam_toolkit_tpu_torch."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
REFERENCE = ("benchmark.reference.extractor", "benchmark.reference.geometry",
             "benchmark.reference.stereo", "benchmark.reference.synthetic",
             "benchmark.reference.tracking", "benchmark.reference.vocab_train",
             "benchmark.check", "benchmark.roofline", "benchmark.spans")


def top_levels_after(code: str) -> set:
    """The top-level names of sys.modules after `code` ran in a fresh
    interpreter at the repo's root, with jax not imported ahead."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env={
        "PATH": "/usr/bin:/bin", "HOME": str(REPO), "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_a_run_imports_is_free_of_jax_and_the_jax_package():
    # everything run.py reaches before the chip check, then the port's
    # entry points and every metric reader the harness loads
    code = "\n".join([
        "from benchmark import run, harness, feeder, check, trace, calibrate",
        "from slam_toolkit_tpu_torch.pipeline.scan_engine import "
        "ChunkedSlamEngine",
        "from slam_toolkit_tpu_torch.utils import cuda_lib",
        "spec = harness.load_spec()",
        "for m in spec['per_layer']: harness.metric_reader(m['name'])",
        "harness.slam_config(json.load(open('benchmark/configs/"
        "kitti_stereo_vo.json'))['slam'])",
        "import json"])
    names = top_levels_after("import json\n" + code)
    assert "slam_toolkit_tpu_torch" in names
    for bad in ("jax", "jaxlib", "flax", "slam_toolkit_tpu"):
        assert bad not in names


def test_the_reference_imports_nothing_of_the_port():
    names = top_levels_after("\n".join(f"import {m}" for m in REFERENCE))
    for bad in ("slam_toolkit_tpu_torch", "slam_toolkit_tpu", "jax"):
        assert bad not in names


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")) +
                         [ROOT / "check.py", ROOT / "roofline.py",
                          ROOT / "spans.py"],
                         ids=lambda p: p.name)
def test_reference_sources_import_no_port_module(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("slam_toolkit_tpu_torch",
                                           "slam_toolkit_tpu", "jax"), n


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "slam_toolkit_tpu_torch_x", object())
    assert "slam_toolkit_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "slam_toolkit_tpu.ops", object())
    assert "slam_toolkit_tpu" in harness.forbidden_modules()
