"""Top-2 Hamming matches under two pixel-radius gates, r and 2r.

Counterpart of slam_toolkit_tpu/ops/match_kernel.py::topk2_match. For a
CUDA tensor the wrapper launches the hand-written kernel
(csrc/match_topk2.cu, replacing the Pallas _topk2_pallas: it bins the
keypoints into a grid, tests the gate only on the cells a query's 2r box
touches, and computes Hamming distances only for the pairs that pass);
for a CPU tensor it runs the plain version, which follows the JAX
package's _topk2_xla. Both give the same output, every column.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_toolkit_tpu_torch.ops import hamming
from slam_toolkit_tpu_torch.utils.cuda_lib import (FLOAT, INT, PTR,
                                                   CudaKernel, check_cuda,
                                                   on_cuda)

BIG = 1e9
MAX_TARGETS = 4096       # the kernel packs the column into 12 bits

KERNEL = CudaKernel("slam_topk2_match", PTR, PTR, INT, PTR, PTR, INT, FLOAT,
                    FLOAT, PTR)


def _gates(radius: float):
    """The two squared radii, rounded to float32 once, as the JAX package
    compares them against float32 distances."""
    return float(np.float32(radius * radius)), \
        float(np.float32(4.0 * radius * radius))


def topk2_match_plain(a_desc, b_desc, a_uv, b_xy, radius: float):
    """Plain version: the dense (M, N) distance matrix, masked per gate,
    then argmin (first minimum), best and second-best (the best column
    alone masked)."""
    dist = hamming.distance_matrix(a_desc, b_desc)
    du = a_uv[:, None, 0] - b_xy[None, :, 0]
    dv = a_uv[:, None, 1] - b_xy[None, :, 1]
    d2 = du * du + dv * dv
    rows = torch.arange(a_desc.shape[0], device=a_desc.device)
    big = torch.full_like(dist, BIG)
    cols = []
    for rsq in _gates(radius):
        md = torch.where(d2 <= rsq, dist, big)
        idx = torch.argmin(md, dim=1)
        best = md[rows, idx]
        sec = md.index_put((rows, idx), torch.full_like(best, BIG)).min(dim=1)
        cols += [best, sec.values, idx.float()]
    zero = torch.zeros_like(cols[0])
    return torch.stack(cols + [zero, zero], dim=1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, at a 16-byte aligned address (the kernel reads a
    descriptor row as two 16-byte words, a coordinate pair as 8 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def topk2_match_cuda(a_desc, b_desc, a_uv, b_xy, radius: float):
    a_desc, b_desc, a_uv, b_xy = (_aligned(t) for t in
                                  (a_desc, b_desc, a_uv, b_xy))
    m, n = a_desc.shape[0], b_desc.shape[0]
    dev = a_desc.device
    check_cuda(a_desc, "a_desc", torch.int32, (m, 8))
    check_cuda(b_desc, "b_desc", torch.int32, (n, 8), dev)
    check_cuda(a_uv, "a_uv", torch.float32, (m, 2), dev)
    check_cuda(b_xy, "b_xy", torch.float32, (n, 2), dev)
    if n > MAX_TARGETS:
        raise ValueError(f"{n} targets > {MAX_TARGETS}")
    r1sq, r2sq = _gates(radius)
    out = torch.empty((m, 8), dtype=torch.float32, device=a_desc.device)
    if m:
        KERNEL(a_desc.device, a_desc.data_ptr(), a_uv.data_ptr(), m,
               b_desc.data_ptr(), b_xy.data_ptr(), n, r1sq, r2sq,
               out.data_ptr())
    return out


def topk2_match(a_desc: torch.Tensor, b_desc: torch.Tensor,
                a_uv: torch.Tensor, b_xy: torch.Tensor, radius: float):
    """a_desc (M, 8) / a_uv (M, 2): query landmarks (invalid ones pushed
    far out of the image); b_desc (N, 8) / b_xy (N, 2): keypoints, same
    convention. Returns (M, 8) float32:
    [best_r, second_r, argbest_r, best_2r, second_2r, argbest_2r, 0, 0]."""
    if on_cuda(a_desc):
        return topk2_match_cuda(a_desc, b_desc, a_uv, b_xy, float(radius))
    return topk2_match_plain(a_desc, b_desc, a_uv, b_xy, float(radius))
