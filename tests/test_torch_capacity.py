"""The port's chunked engine past the keyframe ring's capacity, against the
JAX chunked engine, on the CPU.

tests/test_capacity.py's tiny ring (max_keyframes=12, decay_ratio=0.95,
32 frames of seed 3 at 0.25 m a frame, chunks of 4). The JAX engine is
flushed after every chunk, so it culls from the same state the port's
synchronous engine does. Both engines' cull calls are recorded (the
port's where its cull programs call mapping/culling.cull_most_redundant:
pipeline/engine's SlamEngine._cull and _cull_any).
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JaxConfig
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.evaluation.traj import ate_rmse
from slam_toolkit_tpu.pipeline.scan_engine import \
    ChunkedSlamEngine as JaxEngine
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.pipeline import engine as t_engine
from slam_toolkit_tpu_torch.pipeline import scan_engine
from slam_toolkit_tpu_torch.utils import convert

torch.set_num_threads(1)

CHUNK = 4
EXACT = ("kf_valid", "kf_frame_id", "kf_obs", "kf_kpt_valid", "kf_desc",
         "mp_valid", "mp_ref_kf", "mp_kpt", "mp_obs_count")


def _tiny_ring(base):
    return dataclasses.replace(
        base, map=dataclasses.replace(base.map, max_keyframes=12),
        keyframe=dataclasses.replace(base.keyframe, decay_ratio=0.95))


@pytest.fixture(scope="module")
def runs():
    jcfg = _tiny_ring(JaxConfig.tiny())
    _, gt, frames = make_sequence(jcfg, n_frames=32, seed=3, step=0.25)
    imgs = np.stack([np.stack([l, r]) for l, r in frames]).astype(np.float32)

    jeng = JaxEngine(jcfg, chunk_size=CHUNK)
    jculls, h = [], jeng._host

    def recorded(fn):
        def cull(m):
            m, slot = fn(m)
            jculls.append(int(slot))
            return m, slot
        return cull
    h._cull, h._cull_any = recorded(h._cull), recorded(h._cull_any)
    jvalid = []
    for i in range(0, len(imgs), CHUNK):
        jeng.process_chunk(imgs[i:i + CHUNK])
        jeng.flush()
        jvalid.append(int(np.asarray(jeng.map.kf_valid).sum()))

    tculls, tvalid, trows = [], [], []
    real = t_engine.cull_most_redundant

    def t_recorded(m, min_fraction, protect):
        m, slot = real(m, min_fraction, protect)
        tculls.append(int(slot))
        return m, slot
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_engine, "cull_most_redundant", t_recorded)
        teng = scan_engine.ChunkedSlamEngine(_tiny_ring(SlamConfig.tiny()),
                                             chunk_size=CHUNK, device="cpu")
        for i in range(0, len(imgs), CHUNK):
            trows.append(teng.process_chunk(imgs[i:i + CHUNK]))
            tvalid.append(int(teng.map.kf_valid.sum()))
    return {"gt": gt, "jeng": jeng, "teng": teng, "jculls": jculls,
            "tculls": tculls, "jvalid": jvalid, "tvalid": tvalid,
            "trows": np.concatenate(trows),
            "cap": jcfg.map.max_keyframes}


def test_culls_match_jax(runs):
    """The same cull calls in the same order with the same slots (-1: the
    0.8 bar found nothing and the forced eviction followed), the ring
    never over capacity, more keyframes made than it holds."""
    assert runs["tculls"] == runs["jculls"]
    culled = [s for s in runs["tculls"] if s >= 0]
    assert len(culled) >= 2, runs["tculls"]
    assert runs["teng"].n_culls == len(culled)
    assert runs["tvalid"] == runs["jvalid"]
    assert max(runs["tvalid"]) <= runs["cap"]
    assert runs["teng"].n_keyframes > runs["cap"]


def test_keyframes_and_map_match_jax(runs):
    jeng, teng = runs["jeng"], runs["teng"]
    assert [s["kf"] for s in teng.frame_stats] == \
        [s["kf"] for s in jeng.frame_stats]
    anchors = [s for s, _ in teng._traj_anchor]
    assert anchors == [s for s, _ in jeng._traj_anchor]
    # rows whose keyframe was culled were moved to another anchor
    assert anchors[1:] != runs["trows"][:, 32].astype(int).tolist()
    for f in EXACT:
        np.testing.assert_array_equal(
            convert.to_numpy(f, getattr(teng.map, f)),
            np.asarray(getattr(jeng.map, f)), err_msg=f)


def test_trajectory_matches_jax(runs):
    """trajectory_refined within 5e-3 of the JAX engine's, rows anchored
    on culled keyframes included; ATE as tests/test_capacity.py bounds
    it."""
    gt, jeng, teng = runs["gt"], runs["jeng"], runs["teng"]
    ref = np.stack(jeng.trajectory_refined())
    out = np.stack(teng.trajectory_refined())
    assert len(out) == len(gt)
    np.testing.assert_allclose(out, ref, atol=5e-3)
    assert ate_rmse(list(out), gt, align=True) < 1.0
