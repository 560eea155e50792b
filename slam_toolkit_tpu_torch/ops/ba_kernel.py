"""Local bundle adjustment as one kernel launch.

Counterpart of slam_toolkit_tpu/ops/ba_kernel.py::solve_ba. For CUDA
tensors the wrapper launches the hand-written kernel (csrc/local_ba.cu,
replacing the Pallas _ba_pallas: the whole 10-iteration LM in one
cluster of 8 CTAs, each holding its share of the points in shared
memory); for CPU tensors it runs the plain version,
optim/local_ba.solve_ba, the solver the JAX engine uses wherever the
Pallas kernel does not run. solve_ba_batched solves B problems of the
same W and P in one launch, one cluster a problem (the JAX package's
vmapped call), with a lane mask that leaves out the lanes that need no
solve; each problem's result is the single launch's.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from slam_toolkit_tpu_torch.optim import local_ba
from slam_toolkit_tpu_torch.optim.local_ba import BAProblem, BAResult
from slam_toolkit_tpu_torch.utils import cuda_lib
from slam_toolkit_tpu_torch.utils.cuda_lib import (FLOAT, INT, PTR,
                                                   CudaKernel, check_cuda,
                                                   on_cuda)

KERNEL = CudaKernel("slam_local_ba", PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                    PTR, PTR, INT, INT, INT, FLOAT, FLOAT, FLOAT, FLOAT,
                    FLOAT, PTR, PTR, PTR, PTR, PTR)
BATCHED_KERNEL = CudaKernel("slam_local_ba_batched", PTR, PTR, PTR, PTR, PTR,
                            PTR, PTR, PTR, PTR, PTR, INT, INT, INT, FLOAT,
                            FLOAT, FLOAT, FLOAT, FLOAT, INT, PTR, PTR, PTR,
                            PTR, PTR, PTR)

MAX_WINDOW = 8        # the kernel's reduced system holds 6 * 8 rows
# the kernel's phases, in the order of csrc/local_ba.cu's Phase: set-up,
# nine per iteration, outputs
PHASES = ("setup", "edge pass", "point pass", "partials + sync", "reduce",
          "assemble", "solve", "back-substitution", "trial cost + sync",
          "accept", "outputs")

solve_ba_plain = local_ba.solve_ba


@functools.lru_cache(maxsize=None)
def max_points(W: int, device_index: int) -> int:
    """The most points one launch holds for a window of W poses on that
    device: the cluster's 8 CTAs keep every point's state in shared
    memory."""
    fn = cuda_lib.library().cdll.slam_local_ba_max_points
    fn.argtypes = [INT]
    fn.restype = INT
    with torch.cuda.device(device_index):
        n = int(fn(W))
    if n < 0:
        raise RuntimeError("slam_local_ba_max_points: CUDA error")
    return n


def _problem_lane(p: BAProblem, b: int) -> BAProblem:
    """Lane b of a batched problem (the baseline is shared)."""
    return BAProblem(*(f[b] if torch.is_tensor(f) and f.dim() and
                       name != "baseline" else f
                       for name, f in zip(BAProblem._fields, p)))


def solve_ba_batched_plain(p: BAProblem, lanes, iters: int = 10,
                           huber_delta: float = 2.4477468,
                           lambda0: float = 1e-4, lambda_up: float = 10.0,
                           lambda_down: float = 0.1,
                           trim_sigma: float = 1e9) -> BAResult:
    """Plain version of the batched call: solve_ba_plain lane by lane for
    the lanes the mask keeps, zeros for the others (the kernel leaves
    those outputs unwritten)."""
    B, W, P = p.z.shape[:3]
    dev = p.Xw.device
    out = BAResult(T_cw=torch.zeros((B, W, 4, 4), device=dev),
                   Xw=torch.zeros((B, P, 3), device=dev),
                   cost=torch.zeros((B,), device=dev),
                   edge_r2=torch.zeros((B, W, P), device=dev))
    for b, keep in enumerate(lanes.tolist()):
        if keep:
            one = solve_ba_plain(_problem_lane(p, b), iters=iters,
                                 huber_delta=huber_delta, lambda0=lambda0,
                                 lambda_up=lambda_up,
                                 lambda_down=lambda_down,
                                 trim_sigma=trim_sigma)
            for dst, src in zip(out, one):
                dst[b] = src
    return out


def _launch_ba(p: BAProblem, lanes, iters, huber_delta, lambda0, lambda_up,
               lambda_down, trim_sigma, phase_cycles=None) -> BAResult:
    """The single launch (lanes None) and the batched one (a leading lane
    axis on every field but the baseline, `lanes` the (B,) mask of the
    lanes to solve)."""
    W, P = p.z.shape[-3], p.z.shape[-2]
    lead = () if lanes is None else (p.z.shape[0],)
    if W > MAX_WINDOW:
        raise ValueError(f"local BA kernel: window of {W} poses > "
                         f"{MAX_WINDOW}")
    dev = p.Xw.device
    cap = max_points(W, dev.index if dev.index is not None
                     else torch.cuda.current_device())
    if P > cap:
        raise ValueError(f"local BA kernel: {P} points > the {cap} that fit "
                         f"in shared memory at W={W}")
    w_mask = p.obs_mask & p.pose_valid[..., :, None] & \
        p.point_valid[..., None, :]
    free_pt = p.point_valid if p.point_free is None \
        else (p.point_valid & p.point_free)
    args = {
        "T_cw": p.T_cw.float().reshape(lead + (W, 16)).contiguous(),
        "free_pose": ((~p.pose_fixed) & p.pose_valid).float().contiguous(),
        "Xw": p.Xw.float().contiguous(),
        "z": p.z.float().contiguous(),
        "inv_sigma": p.inv_sigma.float().contiguous(),
        "obs_w": w_mask.float().contiguous(),
        "stereo_w": (p.stereo_mask & w_mask).float().contiguous(),
        "point_valid": p.point_valid.float().contiguous(),
        "point_free": free_pt.float().contiguous(),
        # a tensor already: an upload here would synchronise
        "baseline": p.baseline.to(dev, torch.float32).reshape(1).contiguous(),
    }
    shapes = {"T_cw": (W, 16), "free_pose": (W,), "Xw": (P, 3),
              "z": (W, P, 3), "inv_sigma": (W, P), "obs_w": (W, P),
              "stereo_w": (W, P), "point_valid": (P,), "point_free": (P,)}
    for name, t in args.items():
        check_cuda(t, name, torch.float32,
                   (1,) if name == "baseline" else lead + shapes[name], dev)
    if phase_cycles is not None:
        check_cuda(phase_cycles, "phase_cycles", torch.int64, (len(PHASES),),
                   dev)
    # a masked lane's outputs are left unwritten: no caller reads them
    T_out = torch.empty(lead + (W, 16), dtype=torch.float32, device=dev)
    X_out = torch.empty(lead + (P, 3), dtype=torch.float32, device=dev)
    cost = torch.empty(lead + (1,) if lanes is None else lead,
                       dtype=torch.float32, device=dev)
    r2 = torch.empty(lead + (W, P), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in args.values()]
    scalars = (W, P, int(iters), float(huber_delta), float(lambda0),
               float(lambda_up), float(lambda_down), float(trim_sigma))
    outs = (T_out.data_ptr(), X_out.data_ptr(), cost.data_ptr(),
            r2.data_ptr(),
            None if phase_cycles is None else phase_cycles.data_ptr())
    if lanes is None:
        KERNEL(dev, *ptrs, *scalars, *outs)
        cost = cost[0]
    elif lead[0]:
        mask = lanes.to(torch.int32).contiguous()
        check_cuda(mask, "lanes", torch.int32, lead, dev)
        BATCHED_KERNEL(dev, *ptrs, *scalars, lead[0], mask.data_ptr(), *outs)
    return BAResult(T_cw=T_out.reshape(lead + (W, 4, 4)), Xw=X_out,
                    cost=cost, edge_r2=r2)


def solve_ba_cuda(p: BAProblem, iters: int = 10,
                  huber_delta: float = 2.4477468, lambda0: float = 1e-4,
                  lambda_up: float = 10.0, lambda_down: float = 0.1,
                  trim_sigma: float = 1e9,
                  phase_cycles: Optional[torch.Tensor] = None) -> BAResult:
    """phase_cycles: None, or an int64 CUDA tensor of len(PHASES) that
    receives the cycles the cluster's first CTA spent in each phase
    (a measurement; the solve is the same)."""
    return _launch_ba(p, None, iters, huber_delta, lambda0, lambda_up,
                      lambda_down, trim_sigma, phase_cycles)


def solve_ba_batched_cuda(p: BAProblem, lanes, iters: int = 10,
                          huber_delta: float = 2.4477468,
                          lambda0: float = 1e-4, lambda_up: float = 10.0,
                          lambda_down: float = 0.1,
                          trim_sigma: float = 1e9) -> BAResult:
    return _launch_ba(p, lanes, iters, huber_delta, lambda0, lambda_up,
                      lambda_down, trim_sigma)


def solve_ba(p: BAProblem, iters: int = 10, huber_delta: float = 2.4477468,
             lambda0: float = 1e-4, lambda_up: float = 10.0,
             lambda_down: float = 0.1, trim_sigma: float = 1e9) -> BAResult:
    """Same contract as optim.local_ba.solve_ba; dispatches on the
    device of the problem's tensors."""
    solver = solve_ba_cuda if on_cuda(p.Xw) else solve_ba_plain
    return solver(p, iters=iters, huber_delta=huber_delta, lambda0=lambda0,
                  lambda_up=lambda_up, lambda_down=lambda_down,
                  trim_sigma=trim_sigma)


def solve_ba_batched(p: BAProblem, lanes, iters: int = 10,
                     huber_delta: float = 2.4477468, lambda0: float = 1e-4,
                     lambda_up: float = 10.0, lambda_down: float = 0.1,
                     trim_sigma: float = 1e9) -> BAResult:
    """solve_ba for B problems of the same W and P: every field of `p`
    but the baseline with a leading lane axis B, `lanes` a (B,) bool or
    int mask on the problem's device -> BAResult of (B, W, 4, 4), (B, P,
    3), (B,) and (B, W, P). The outputs of a lane the mask leaves out are
    not defined (the kernel does not write them; the plain version gives
    zeros). At most max_points(W) points a problem."""
    solver = solve_ba_batched_cuda if on_cuda(p.Xw) else \
        solve_ba_batched_plain
    return solver(p, lanes, iters=iters, huber_delta=huber_delta,
                  lambda0=lambda0, lambda_up=lambda_up,
                  lambda_down=lambda_down, trim_sigma=trim_sigma)
