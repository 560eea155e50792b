"""On the card: the control comes out not correct through the cell's own
verdict, where the program comes out correct.

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests

The control is the reference's tracking computed with TF32 matrix
products (the precision below the configuration's float32), put in the
program's place and judged against the float32 reference from the same
chunk-boundary states, at the cell's own widths; the window is short.
Skips without a CUDA card.
"""

import pytest

from benchmark import harness


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vo_circuit"])
def test_the_control_is_not_correct(card, cell):
    from benchmark.calibrate import readings
    parts = harness.resolve(harness.load_spec(), cell)
    setup = harness.Setup(parts, "cuda")
    r = readings(setup, 2 ** 32 + 101, 8.0, control=True)
    assert r["correct"], r["numbers"]
    assert not r["control_correct"], r["control"]
    limit = parts["limits"]["track_pose_gap"]["max"]
    assert r["control"]["track_pose_gap"] > limit, r["control"]
