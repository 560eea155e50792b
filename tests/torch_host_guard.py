"""A guard that records every host read or upload a block of torch code
makes: what a CUDA graph cannot capture. tests/test_torch_graph_step.py,
test_torch_cluster_masked.py and test_torch_engine_graphable.py run the
functions that the port captures as CUDA graphs under it, on the CPU.

On the card each kernel's plain twin in PLAIN_TWINS is one kernel launch
whose wrapper passes pointers; on the CPU it is plain torch code, outside
what a graph captures, so the guard stands aside while it runs
(stand_aside)."""

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from slam_toolkit_tpu_torch.ops import (ba_kernel, fast_kernel, match_kernel,
                                        patches, pose_lm_kernel, stereo_sad)

PLAIN_TWINS = (
    (patches, ("gather_blocks_plain", "gather_blocks_multi_plain",
               "gather_blocks_batched_plain")),
    (match_kernel, ("topk2_match_plain", "topk2_match_batched_plain")),
    (pose_lm_kernel, ("optimize_pose_plain", "optimize_pose_batched_plain")),
    (stereo_sad, ("sad_curve_plain", "sad_curve_batched_plain")),
    (ba_kernel, ("solve_ba_plain", "solve_ba_batched_plain")),
    (fast_kernel, ("detect_levels_plain", "detect_fused_plain")))
HOST_CALLS = {"__bool__", "item", "tolist", "numpy", "cpu", "nonzero",
              "tensor", "as_tensor", "__int__", "__float__", "__index__",
              # linear algebra that checks its result on the host on a
              # card (the _ex forms with check_errors=False do not)
              "linalg_solve", "linalg_inv", "linalg_cholesky", "inverse"}
# the aten operations behind a read-back (.item(), and the C++ callers of
# it such as indexing with a 0-dim tensor), a data-dependent shape, and a
# tensor made from host values
HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
            "_unique2", "unique_dim", "unique_consecutive"}


class HostReadGuard(TorchFunctionMode):
    """Records every host read or upload: the calls in HOST_CALLS,
    indexing with a boolean mask or a 0-dim integer tensor, and (through
    HostOpGuard) the aten operations in HOST_OPS."""

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        if not self.paused:
            if name in HOST_CALLS:
                self.seen.append(name)
            if name in ("__getitem__", "__setitem__"):
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                if any(torch.is_tensor(i) and (i.dtype == torch.bool or
                                               i.dim() == 0) for i in idx):
                    self.seen.append(f"{name} with a mask or 0-dim index")
        return func(*args, **(kwargs or {}))


class HostOpGuard(TorchDispatchMode):
    def __init__(self, guard: HostReadGuard):
        super().__init__()
        self.guard = guard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.guard.paused and \
                func.__name__.split(".")[0] in HOST_OPS:
            self.guard.seen.append(f"aten.{func.__name__}")
        return func(*args, **(kwargs or {}))


def stand_aside(monkeypatch, guard: HostReadGuard, mod, names) -> None:
    """Patch each function `names` of `mod` so that the guard records
    nothing while it runs."""
    for n in names:
        orig = getattr(mod, n)

        def twin(*a, _orig=orig, **k):
            guard.paused += 1
            try:
                return _orig(*a, **k)
            finally:
                guard.paused -= 1
        monkeypatch.setattr(mod, n, twin)
