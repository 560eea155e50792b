"""Packed-binary Hamming distance and duplicate-match resolution.

Counterpart of the parts of slam_toolkit_tpu/ops/hamming.py that
projection matching and the loop closer's global match use. Descriptors
are (N, 8) int32 words; unpack_pm1, distance_matrix, masked_distance
and ratio_test_match also take leading lane axes (B, N, 8), each lane
on its own.
"""

from __future__ import annotations

import torch

BIG = 1e9  # distance of masked-out pairs


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) packed words -> (..., N, 256) float32 in {-1, +1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return 2.0 * bits.reshape(desc.shape[:-1] + (256,)).float() - 1.0


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """(M, 8) x (N, 8) -> (M, N) float32 Hamming distances.

    With bits as +-1, a.b = 256 - 2 * hamming; the float32 product of
    +-1 values sums integers below 2^24, so it is exact (TF32 must be
    off on the GPU, which the engine sets)."""
    return 0.5 * (256.0 - unpack_pm1(desc_a) @
                  unpack_pm1(desc_b).transpose(-1, -2))


def masked_distance(desc_a: torch.Tensor, desc_b: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Distance matrix with disallowed pairs pushed to BIG."""
    d = distance_matrix(desc_a, desc_b)
    return torch.where(mask, d, torch.full_like(d, BIG))


def ratio_test_match(dist: torch.Tensor, ratio: float, max_dist: float):
    """Row-wise best column (first minimum) and the ratio test
    d_best <= max_dist and d_best < ratio * d_second (ref
    src/matcher.cpp:112-128). Returns (idx (M,) int32, ok (M,))."""
    best_idx = torch.argmin(dist, dim=-1)
    d_best = torch.gather(dist, -1, best_idx[..., None])[..., 0]
    d_second = dist.scatter(-1, best_idx[..., None], BIG).min(dim=-1).values
    ok = (d_best <= max_dist) & (d_best < ratio * d_second)
    return best_idx.int(), ok


def keep_best_per_target(idx: torch.Tensor, ok: torch.Tensor,
                         dist_best: torch.Tensor, num_targets: int):
    """Resolve duplicate matches to one target keypoint: the smallest
    distance wins, ties to the lowest source (ref src/matcher.cpp:197-205).

    One scatter-amin on packed (distance * 4096 + source) keys, exact in
    float32 for distances <= 256 and sources < 4096; a min is order-free,
    so the scatter is deterministic on any device. A leading lane axis
    (idx, ok, dist_best (B, M)) resolves each lane on its own targets."""
    m = idx.shape[-1]
    src = torch.arange(m, dtype=torch.float32, device=idx.device)
    packed = torch.where(ok, dist_best * 4096.0 + src,
                         torch.full_like(src, BIG))
    per_target = torch.full(idx.shape[:-1] + (num_targets,), BIG,
                            dtype=torch.float32, device=idx.device)
    per_target = per_target.scatter_reduce(-1, idx.long(), packed,
                                           reduce="amin", include_self=True)
    return ok & (packed <= torch.gather(per_target, -1, idx.long()))
