"""run_kitti --train-vocab on the CPU: the vocabulary the port trains
from a sequence against the JAX runner's, and its extract program.

The JAX runner (slam_toolkit_tpu/run_kitti.py _get_vocab) jits extract
over every (n // 40)-th left image and trains a k=10, 3-level tree on
the valid descriptors. The port's _get_vocab runs run_kitti.VocabExtract
(the same extract on a static image buffer, one CUDA graph on a card,
eager here). Both train on tests/fixtures/kitti_mini/ (six 96x128
frames, SlamConfig.tiny()); the trees must be equal: nodes, children,
word ids and weights. tests/test_torch_cuda.py holds the graphed
extract to the eager one on the card."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from slam_toolkit_tpu import run_kitti as j_run
from slam_toolkit_tpu.data import kitti as j_kitti
from slam_toolkit_tpu_torch import run_kitti
from slam_toolkit_tpu_torch.data import kitti as t_kitti
from slam_toolkit_tpu_torch.loop import vocab as TV
from slam_toolkit_tpu_torch.ops.extractor import extract
from slam_toolkit_tpu_torch.pipeline.engine import full_float32

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fixtures", "kitti_mini")


def _args(**kw) -> argparse.Namespace:
    return argparse.Namespace(**{"vocab": None, "train_vocab": True,
                                 "seed": 0, "device": "cpu", **kw})


@pytest.fixture(scope="module")
def vocabs():
    """(the JAX runner's vocabulary, the port's) from the fixture."""
    jds = j_kitti.KittiDataset("00", root=ROOT)
    tds = t_kitti.KittiDataset("00", root=ROOT)
    jv = j_run._get_vocab(_args(), jds,
                          j_run._auto_config(jds[0][0].shape))
    tv = run_kitti._get_vocab(_args(), tds,
                              run_kitti._auto_config(tds[0][0].shape))
    return jv, tv


def test_trained_vocab_matches_jax(vocabs):
    """The two trees equal: nodes, children, word ids, weights, k and
    levels."""
    jv, tv = vocabs
    nodes, children, word_id, weights = TV.to_numpy(tv)
    np.testing.assert_array_equal(nodes, np.asarray(jv.nodes))
    np.testing.assert_array_equal(children, np.asarray(jv.children))
    np.testing.assert_array_equal(word_id, np.asarray(jv.word_id))
    np.testing.assert_array_equal(weights, np.asarray(jv.weights))
    assert (tv.k, tv.levels) == (jv.k, jv.levels) == (10, 3)
    assert tv.num_words > 100


@pytest.mark.parametrize("graphs", [True, False])
def test_vocab_extract_is_extract(graphs):
    """VocabExtract over the fixture's left images, one static buffer
    reused: each call's descriptors are extract's valid descriptors,
    in order."""
    ds = t_kitti.KittiDataset("00", root=ROOT)
    cfg = run_kitti._auto_config(ds[0][0].shape).extractor
    ex = run_kitti.VocabExtract(cfg, "cpu", graphs=graphs)
    for i in range(len(ds)):
        img = ds[i][0]
        got = ex(img)
        with torch.no_grad(), full_float32():
            f = extract(torch.from_numpy(img), cfg)
        want = f.desc[f.valid].numpy()
        assert got.dtype == np.int32 and got.shape[1] == 8
        np.testing.assert_array_equal(got, want)
        assert len(got) > 50
    assert ex.graph_stats() is None


@pytest.mark.parametrize("n", [1, 6, 39, 40, 81, 4541])
def test_vocab_frames(n):
    """The frames sampled: every (n // 40)-th, the JAX runner's."""
    step = max(1, n // 40)
    assert list(run_kitti.vocab_frames(n)) == list(range(0, n, step))


def test_run_kitti_train_vocab(tmp_path, capsys):
    """run_kitti.main --train-vocab on the fixture (the chunked engine,
    chunks of 3, loop closing on with the trained vocabulary): six
    frames, ATE < 0.1 m, and the trained vocabulary reported."""
    out = str(tmp_path / "out")
    ret = run_kitti.main(["--root", ROOT, "--seq", "00", "--device", "cpu",
                          "--train-vocab", "--chunk", "3", "--out", out])
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == ret
    assert "word vocab from 6 frames" in printed.err
    assert ret["frames"] == 6 and ret["ate_rmse_m"] < 0.1
    assert np.loadtxt(os.path.join(out, "00.txt")).shape == (6, 12)
