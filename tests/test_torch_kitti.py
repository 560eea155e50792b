"""The port's KITTI runner and what it uses, on the CPU: the dataset
reader on tests/fixtures/kitti_mini/ against the JAX KittiDataset and
OpenCV, PNGs written with each of the five PNG row filters, the plots
and covisibility stats of evaluation/viz, utils/timing, and
run_kitti.main in both engines (tests/test_run_kitti.py's checks)."""

import dataclasses
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JaxConfig
from slam_toolkit_tpu.data import kitti as j_kitti
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.evaluation import viz as j_viz
from slam_toolkit_tpu.pipeline.engine import SlamEngine as JaxEngine
from slam_toolkit_tpu_torch import run_kitti
from slam_toolkit_tpu_torch.data import kitti as t_kitti
from slam_toolkit_tpu_torch.evaluation import viz
from slam_toolkit_tpu_torch.utils import convert, timing

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fixtures", "kitti_mini")


def test_dataset_matches_jax():
    """File list, ground-truth poses (inverted 3x4 T_wc rows) and the
    camera equal to the JAX KittiDataset's; every image of both cameras
    pixel-equal to OpenCV's grayscale read, as float32."""
    t, j = t_kitti.KittiDataset("00", root=ROOT), \
        j_kitti.KittiDataset("00", root=ROOT)
    assert t.files == j.files and len(t) == len(j) == 6
    for a, b in zip(t.ground_truth(), j.ground_truth()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(t.camera_config()) == \
        dataclasses.asdict(j.camera_config())
    for i in range(len(t)):
        for img, d in zip(t[i], (t.left_dir, t.right_dir)):
            ref = cv2.imread(os.path.join(d, t.files[i]),
                             cv2.IMREAD_GRAYSCALE)
            assert img.dtype == np.float32 and img.shape == (96, 128)
            np.testing.assert_array_equal(img, ref.astype(np.float32))
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(a, b)


def _filtered_rows(img: np.ndarray, ftype) -> bytes:
    """The PNG scanlines of an 8-bit grayscale image, each row under
    filter `ftype` (0-4), or under filter row % 5 for "mixed"."""
    h, w = img.shape
    x = img.astype(np.int32)
    out = []
    for r in range(h):
        t = r % 5 if ftype == "mixed" else ftype
        cur = x[r]
        up = x[r - 1] if r else np.zeros(w, np.int32)
        left = np.concatenate([[0], cur[:-1]])
        ul = np.concatenate([[0], up[:-1]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [np.zeros(w, np.int32), left, up, (left + up) // 2, paeth][t]
        out.append(bytes([t]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
    return b"".join(out)


def _write_png(path: str, img: np.ndarray, ftype) -> None:
    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + \
            struct.pack(">I", zlib.crc32(tag + data))
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(_filtered_rows(img, ftype)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_dataset_reads_each_png_filter(tmp_path, ftype):
    """Stereo pairs written in KITTI layout with PNG row filter None,
    Sub, Up, Average or Paeth (or all five in turn) read back exactly."""
    rng = np.random.default_rng(5)
    seq = tmp_path / "sequences" / "07"
    imgs = {}
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
        for i in range(2):
            img = rng.integers(0, 256, (23, 37)).astype(np.uint8)
            img[:, :10] = np.arange(10, dtype=np.uint8) * 25   # gradients
            _write_png(str(seq / cam / f"{i:06d}.png"), img, ftype)
            imgs[cam, i] = img
    ds = t_kitti.KittiDataset("07", root=str(tmp_path))
    assert len(ds) == 2 and ds.ground_truth() == []
    for i in range(2):
        left, right = ds[i]
        np.testing.assert_array_equal(left, imgs["image_0", i])
        np.testing.assert_array_equal(right, imgs["image_1", i])


def test_run_kitti_refuses_cuda_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for mode in ([], ["--classic"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_kitti.main(["--root", ROOT] + mode)


@pytest.mark.parametrize("mode", ["classic", "chunked"])
def test_run_kitti(tmp_path, capsys, mode):
    """run_kitti.main on the fixture (--device cpu): the per-frame engine
    with --classic, else the chunked engine in chunks of 2. Six frames,
    ATE < 0.1 m, a 6x12 KITTI poses file starting at the identity,
    stats.json with 6 frame_stats, and the plots."""
    out = str(tmp_path / "out")
    extra = ["--classic"] if mode == "classic" else ["--chunk", "2"]
    ret = run_kitti.main(["--root", ROOT, "--seq", "00", "--device", "cpu",
                          "--out", out] + extra)
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats == ret
    assert stats["frames"] == 6 and stats["keyframes"] >= 1
    assert stats["ate_rmse_m"] < 0.1
    poses = np.loadtxt(os.path.join(out, "00.txt"))
    assert poses.shape == (6, 12)
    np.testing.assert_allclose(poses[0].reshape(3, 4), np.eye(4)[:3],
                               atol=1e-5)
    for f in ("trajectory.png", "map.png", "stats.json"):
        assert os.path.exists(os.path.join(out, f))
    with open(os.path.join(out, "stats.json")) as f:
        full = json.load(f)
    assert len(full["frame_stats"]) == 6


def test_viz_on_a_jax_map(tmp_path):
    """covisibility_stats of every keyframe of the JAX engine's map after
    tests/test_engine_e2e.py's ten frames, read by the port from its
    converted copy, equal the JAX function's; the port's three plots are
    written from that map and a frame's keypoints."""
    _, gt, frames = make_sequence(JaxConfig.tiny(), n_frames=10, seed=3,
                                  step=0.25)
    je = JaxEngine(JaxConfig.tiny())
    for left, right in frames:
        je.process(left, right)
    m = convert.map_state_from_numpy(je.map, "cpu")
    slots = np.flatnonzero(np.asarray(je.map.kf_valid))
    stats = [viz.covisibility_stats(m, int(s)) for s in slots]
    assert stats == [j_viz.covisibility_stats(je.map, int(s))
                     for s in slots]
    assert len(slots) >= 2 and any(st is not None for st in stats)
    traj = [np.asarray(T) for T in je.trajectory]
    for path in (viz.plot_trajectory(traj, gt, str(tmp_path / "t.png")),
                 viz.plot_map_topdown(m, str(tmp_path / "m.png")),
                 viz.draw_keypoints(frames[0][0], m.kf_xy[0],
                                    m.kf_kpt_valid[0],
                                    path=str(tmp_path / "k.png"))):
        assert os.path.getsize(path) > 1000


def test_device_trace(tmp_path):
    """device_trace writes a trace file; block_until_ready hands back the
    nest it waited for (CPU results need no wait)."""
    with timing.device_trace(str(tmp_path)) as prof:
        torch.ones(64).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert len(prof.key_averages()) > 0
    x = torch.ones(8)
    assert timing.block_until_ready({"a": [x, (x,)]}) is not None
