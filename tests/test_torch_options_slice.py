"""The tiny slice under the option sets O1 and O2 (tools/bench.OPTIONS),
on the CPU: the port's ChunkedSlamEngine against the JAX package's, the
static-carry step against the eager one, and two lanes of
multi_sequence_chunk against the single step.

O1: steered BRIEF, bfloat16 descriptors, the poly pyramid, the fused
FAST+NMS detector and descriptor stereo with subpixel refinement. O2:
SAD stereo gated by one upright BRIEF per eye. O3: O1 with upright
descriptors (the path of the gather's bfloat16 entry). Bars as
tests/test_torch_engine.py holds the default slice: keyframe flags,
slots and ok flags exact, trajectory_refined within 5e-3 m; graphed
against eager and each lane against its single step, bit for bit.
"""

import numpy as np
import pytest
import torch

from slam_toolkit_tpu.config import SlamConfig as JaxConfig
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.pipeline.scan_engine import \
    ChunkedSlamEngine as JaxEngine
from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.parallel import mesh
from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
from slam_toolkit_tpu_torch.tools.bench import with_option

from test_torch_graph_step import HostOpGuard, guard  # noqa: F401

torch.set_num_threads(1)

CHUNKS = [(0, 5), (5, 9), (9, 10)]   # frame 0 bootstraps; then 4, 4, 1
OPTIONS = ("O1", "O2", "O3")


@pytest.fixture(scope="module")
def images():
    _, gt, frames = make_sequence(JaxConfig.tiny(), n_frames=10, seed=3,
                                  step=0.25)
    imgs = np.stack([np.stack([l, r]) for l, r in frames]).astype(np.float32)
    return imgs, gt


@pytest.fixture(scope="module")
def jax_runs(images):
    imgs, _ = images
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SLAM_SCAN_NO_BA", raising=False)
        for name in OPTIONS:
            eng = JaxEngine(with_option(JaxConfig.tiny(), name), chunk_size=4)
            rows = []
            for a, b in CHUNKS:
                eng.process_chunk(imgs[a:b])
                rows.append(eng.flush())
            out[name] = (eng, np.concatenate(rows))
    return out


def _port_run(name: str, imgs, graphs: bool):
    eng = ChunkedSlamEngine(with_option(SlamConfig.tiny(), name),
                            chunk_size=4, device="cpu", graphs=graphs)
    rows = np.concatenate([eng.process_chunk(imgs[a:b]) for a, b in CHUNKS])
    return eng, rows


@pytest.fixture(scope="module")
def port_runs(images):
    imgs, _ = images
    return {(name, g): _port_run(name, imgs, g) for name in OPTIONS
            for g in (True, False)}


@pytest.mark.parametrize("name", OPTIONS)
def test_slice_matches_jax(jax_runs, port_runs, images, name):
    """The chunked engine under the option set: keyframe flags, slots and
    ok flags of every frame equal JAX's, and trajectory_refined within
    5e-3 m (tests/test_torch_engine.py's bar)."""
    jeng, jrows = jax_runs[name]
    eng, rows = port_runs[(name, True)]
    assert eng.n_keyframes >= 2
    np.testing.assert_array_equal(rows[:, 32:35], jrows[:, 32:35])
    assert [s["kf"] for s in eng.frame_stats] == \
        [s["kf"] for s in jeng.frame_stats]
    np.testing.assert_allclose(np.stack(eng.trajectory_refined()),
                               np.stack(jeng.trajectory_refined()),
                               atol=5e-3)


@pytest.mark.parametrize("name", OPTIONS)
def test_graphed_step_is_the_eager_step(port_runs, name):
    """make_chunk_fn's static-carry step (captured as CUDA graphs on a
    card) against make_frame_body: rows, maps and trajectories
    bit-equal."""
    (graph, rows_g), (eager, rows_e) = port_runs[(name, True)], \
        port_runs[(name, False)]
    np.testing.assert_array_equal(rows_g, rows_e)
    assert (rows_e[:, 34] > 0.5).sum() >= 1
    for f in eager.map._fields:
        assert torch.equal(getattr(graph.map, f), getattr(eager.map, f)), f
    np.testing.assert_array_equal(np.stack(graph.trajectory_refined()),
                                  np.stack(eager.trajectory_refined()))


@pytest.mark.parametrize("name", OPTIONS)
def test_captured_functions_read_nothing_back(images, guard,  # noqa: F811
                                              name):
    """The frame graph's two halves under the option set (the keyframe
    event extracts the right image under O1) run with no host read or
    upload after the first chunk's warm-up."""
    imgs, _ = images
    eng = ChunkedSlamEngine(with_option(SlamConfig.tiny(), name),
                            chunk_size=4, device="cpu")
    eng.process_chunk(imgs[:5])
    run = eng._chunk
    run.left.copy_(torch.from_numpy(imgs[5, 0]))
    run.right.copy_(torch.from_numpy(imgs[5, 1]))
    with guard, HostOpGuard(guard):
        t = run._track_step(run.static)
        run._keyframe_step(run.static, t)
    assert guard.seen == []


@pytest.mark.parametrize("name", OPTIONS)
def test_lanes_are_the_single_step(images, name):
    """multi_sequence_chunk under each option set at B = 2 (the sequence
    and the same frames one step later): each lane's rows bit-equal to
    the single engine's step on its frames, graphed and eager alike."""
    imgs, _ = images
    cfg = with_option(SlamConfig.tiny(), name)
    cam = StereoCamera.from_config(cfg.camera, "cpu")
    seqs = np.stack([imgs[:9], imgs[1:]], axis=1)    # (9, 2, 2, H, W)
    lanes = torch.from_numpy(seqs)
    singles = []
    for b in range(2):
        eng = ChunkedSlamEngine(cfg, chunk_size=4, device="cpu")
        rows = [eng.process_chunk(seqs[a:c, b]) for a, c in ((0, 5),
                                                            (5, 9))]
        singles.append(np.concatenate(rows))
    for graphs in (True, False):
        carry = mesh.batched_bootstrap(cfg, cam)(
            mesh.batched_empty_map(cfg, 2, "cpu"), lanes[0, :, 0],
            lanes[0, :, 1])
        chunk = mesh.multi_sequence_chunk(cfg, cam, graphs=graphs)
        carry, p0 = chunk(carry, lanes[1:5])
        carry, p1 = chunk(carry, lanes[5:9])
        rows = torch.cat([p0, p1]).numpy()
        for b in range(2):
            np.testing.assert_array_equal(rows[:, b], singles[b],
                                          err_msg=f"lane {b}")
    assert (rows[..., 34] > 0.5).sum() >= 2    # one a lane at least
