"""The motion-only pose LM as one kernel launch.

Counterpart of slam_toolkit_tpu/ops/pose_lm_kernel.py::optimize_pose.
For a CUDA tensor the wrapper launches the hand-written kernel
(csrc/pose_lm.cu, replacing the Pallas _pose_lm_pallas: the whole
10-iteration solve in one cluster of 8 CTAs, each holding N/8
observations in shared memory); for a CPU tensor it runs the plain
version, optim/pose_lm.optimize_pose — the solver the JAX tracker uses
wherever the Pallas kernel does not run.
"""

from __future__ import annotations

import functools

import torch

from slam_toolkit_tpu_torch.config import TrackerConfig
from slam_toolkit_tpu_torch.optim import pose_lm
from slam_toolkit_tpu_torch.optim.pose_lm import PoseLMResult
from slam_toolkit_tpu_torch.utils import cuda_lib
from slam_toolkit_tpu_torch.utils.cuda_lib import (FLOAT, INT, PTR,
                                                   CudaKernel, check_cuda,
                                                   on_cuda)

KERNEL = CudaKernel("slam_pose_lm", PTR, PTR, PTR, PTR, PTR, INT, INT, FLOAT,
                    FLOAT, FLOAT, FLOAT, PTR, PTR, PTR)

optimize_pose_plain = pose_lm.optimize_pose


@functools.lru_cache(maxsize=None)
def max_obs() -> int:
    """The most observations one launch holds: the cluster's 8 CTAs keep
    their shares in shared memory."""
    fn = cuda_lib.library().cdll.slam_pose_lm_max_obs
    fn.argtypes = []
    fn.restype = INT
    return int(fn())


def optimize_pose_cuda(T_init, Xw, z_norm, sigma2, weight_mask,
                       cfg: TrackerConfig) -> PoseLMResult:
    n = Xw.shape[0]
    T0 = T_init.float().contiguous()
    wv = weight_mask.float().contiguous()
    Xw, z_norm, sigma2 = (t.contiguous() for t in (Xw, z_norm, sigma2))
    dev = Xw.device
    check_cuda(Xw, "Xw", torch.float32, (n, 3))
    check_cuda(T0, "T_init", torch.float32, (4, 4), dev)
    check_cuda(z_norm, "z_norm", torch.float32, (n, 2), dev)
    check_cuda(sigma2, "sigma2", torch.float32, (n,), dev)
    check_cuda(wv, "weight_mask", torch.float32, (n,), dev)
    if n > max_obs():
        raise ValueError(f"pose LM kernel: {n} observations > {max_obs()}")
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    r2 = torch.empty((n,), dtype=torch.float32, device=dev)
    KERNEL(dev, T0.data_ptr(), Xw.data_ptr(), z_norm.data_ptr(),
           sigma2.data_ptr(), wv.data_ptr(), n, int(cfg.num_iterations),
           float(cfg.huber_delta), float(cfg.lm_lambda0),
           float(cfg.lm_lambda_up), float(cfg.lm_lambda_down),
           T_out.data_ptr(), cost.data_ptr(), r2.data_ptr())
    return PoseLMResult(T_cw=T_out, cost=cost, inlier_r2=r2)


def optimize_pose(T_init: torch.Tensor, Xw: torch.Tensor,
                  z_norm: torch.Tensor, sigma2: torch.Tensor,
                  weight_mask: torch.Tensor,
                  cfg: TrackerConfig) -> PoseLMResult:
    """Same contract as optim.pose_lm.optimize_pose."""
    if on_cuda(Xw):
        return optimize_pose_cuda(T_init, Xw, z_norm, sigma2, weight_mask,
                                  cfg)
    return optimize_pose_plain(T_init, Xw, z_norm, sigma2, weight_mask, cfg)
