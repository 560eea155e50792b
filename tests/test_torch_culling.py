"""Keyframe culling of the port against the JAX package, on the CPU.

One JAX engine map at the tiny configuration, carried over with
utils/convert.map_state_from_numpy, goes through both packages'
redundancy_scores, cull_keyframe (every valid slot) and
cull_most_redundant (at the engine's 0.8 bar, at 0.0, its forced
eviction, and at 1.01, which nothing clears: both sides of the choice the
port makes on the device): integer and bool fields exact, inverse depths
to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.mapping import culling as j_cull
from slam_toolkit_tpu.mapping import map_state as j_ms
from slam_toolkit_tpu.pipeline.engine import SlamEngine
from slam_toolkit_tpu_torch.mapping import culling as t_cull
from slam_toolkit_tpu_torch.mapping import map_state as t_ms
from slam_toolkit_tpu_torch.utils import convert

torch.set_num_threads(1)

EXACT = ("kf_valid", "kf_frame_id", "kf_obs", "mp_valid", "mp_ref_kf",
         "mp_kpt", "mp_obs_count")


@pytest.fixture(scope="module")
def jmap():
    cfg = SlamConfig.tiny()
    _, _, frames = make_sequence(cfg, n_frames=24, seed=3, step=0.3)
    eng = SlamEngine(cfg)
    for left, right in frames:
        eng.process(left, right)
    m = jax.tree_util.tree_map(np.array, eng.map)
    assert m.kf_valid.sum() >= 3
    return m


def _assert_maps_equal(tm, jm):
    for f in EXACT:
        np.testing.assert_array_equal(convert.to_numpy(f, getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    live = np.asarray(jm.mp_valid)
    np.testing.assert_allclose(tm.mp_invd.numpy()[live],
                               np.asarray(jm.mp_invd)[live], rtol=1e-5)


def test_mappoint_positions_match_jax(jmap):
    ref = np.asarray(j_ms.mappoint_positions(jmap))
    out = t_ms.mappoint_positions(convert.map_state_from_numpy(
        jmap, device="cpu")).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("protect", [0, 1, 2, 8])
def test_redundancy_scores_match_jax(jmap, protect):
    ref = np.asarray(j_cull.redundancy_scores(jmap, protect))
    out = t_cull.redundancy_scores(
        convert.map_state_from_numpy(jmap, device="cpu"), protect).numpy()
    np.testing.assert_array_equal(out, ref)


def test_cull_keyframe_matches_jax(jmap):
    """Every valid slot in turn, each from the same map."""
    cull = jax.jit(j_cull.cull_keyframe)
    slots = np.flatnonzero(jmap.kf_valid)
    for s in slots:
        ref = cull(jmap, jnp.int32(s))
        out = t_cull.cull_keyframe(
            convert.map_state_from_numpy(jmap, device="cpu"), int(s))
        assert not bool(out.kf_valid[s])
        _assert_maps_equal(out, ref)


@pytest.mark.parametrize("min_fraction", [0.8, 0.0, 1.01])
def test_cull_most_redundant_matches_jax(jmap, min_fraction):
    """At the engine's two bars and at one nothing clears, protecting one
    keyframe (so several are candidates): the same slot (or -1, a device
    tensor the caller reads) and the same map; then again on the
    result."""
    j, t = jmap, convert.map_state_from_numpy(jmap, device="cpu")
    culled = []
    for _ in range(2):
        j, js = j_cull.cull_most_redundant(j, min_fraction, 1)
        t, ts = t_cull.cull_most_redundant(t, min_fraction, 1)
        assert ts == int(js)
        _assert_maps_equal(t, j)
        culled.append(ts)
    if min_fraction == 0.0:
        assert min(culled) >= 0, culled
    if min_fraction > 1.0:
        assert culled == [-1, -1]
        _assert_maps_equal(t, jax.tree_util.tree_map(jnp.asarray, jmap))
