"""Upright BRIEF descriptors from 31x31 patches.

Counterpart of slam_toolkit_tpu/ops/brief.py::upright_patch_descriptors.
The JAX package evaluates the 256 comparisons as a pick-matrix product
whose column k is e[a_k] - e[b_k]; the product is exactly va - vb, and
its sign is exactly (va < vb), so the comparisons are made directly and
the bits match.

The sampling pattern is generated here by a copy of the JAX package's
seeded generator (importing slam_toolkit_tpu.ops.brief would import
jax); a test checks the two patterns are equal.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from slam_toolkit_tpu_torch.ops.patches import (gather_blocks,
                                                gather_blocks_multi)

PATCH_RADIUS = 15
NUM_PAIRS = 256
DESC_WORDS = 8  # 256 bits as 8 x 32-bit words (int32 here, uint32 in JAX)


@functools.lru_cache(maxsize=1)
def sampling_pattern() -> np.ndarray:
    """Deterministic (2, 256, 2) float32 (x, y) offsets; the generator of
    slam_toolkit_tpu/ops/brief.py:28-38."""
    rng = np.random.default_rng(20260816)
    pts = []
    while len(pts) < NUM_PAIRS * 2:
        cand = rng.normal(0.0, PATCH_RADIUS / 2.4, size=(NUM_PAIRS, 2))
        keep = cand[np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 1.0]
        pts.extend(keep.tolist())
    arr = np.asarray(pts[:NUM_PAIRS * 2], dtype=np.float32)
    return arr.reshape(2, NUM_PAIRS, 2)


@functools.lru_cache(maxsize=8)
def _pick_indices(device: torch.device):
    """Flat in-patch indices (a_k, b_k) of the 256 upright comparisons,
    on `device` (built once per device)."""
    r = PATCH_RADIUS
    side = 2 * r + 1
    pat = np.round(sampling_pattern()).astype(np.int64)
    idx_a = (pat[0, :, 1] + r) * side + (pat[0, :, 0] + r)
    idx_b = (pat[1, :, 1] + r) * side + (pat[1, :, 0] + r)
    return (torch.as_tensor(idx_a, device=device),
            torch.as_tensor(idx_b, device=device))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) {0,1} -> (K, 8) int32 words, bit j of word i = bit 32i+j
    (the uint32 layout of the JAX package, viewed as int32)."""
    k = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(k, DESC_WORDS, 32).long() << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def upright_patch_descriptors(blurred: torch.Tensor,
                              centers_xy: torch.Tensor) -> torch.Tensor:
    """(K, 8) int32 upright BRIEF at K keypoints of a blurred level."""
    h, w = blurred.shape
    r = PATCH_RADIUS
    side = 2 * r + 1
    cx = torch.round(centers_xy[:, 0]).int()
    cy = torch.round(centers_xy[:, 1]).int()
    y0 = torch.clamp(cy - r, 0, h - side)
    x0 = torch.clamp(cx - r, 0, w - side)
    patches = gather_blocks(blurred, y0, x0, side, side)    # (K, 31, 31)
    return _pick_and_pack(patches)


def upright_patch_descriptors_levels(blurred_levels: Sequence[torch.Tensor],
                                     xy_levels: Sequence[torch.Tensor]
                                     ) -> torch.Tensor:
    """upright_patch_descriptors of every level, concatenated in level
    order: one gather of all levels' patches (the gather clamps each
    corner into its level, as upright_patch_descriptors clamps it), then
    one pick and pack."""
    r = PATCH_RADIUS
    side = 2 * r + 1
    corner = (torch.round(torch.cat(list(xy_levels))).int() - r).T \
        .contiguous()                                     # (2, K): x, y
    patches = gather_blocks_multi(blurred_levels, corner[1], corner[0],
                                  [xy.shape[0] for xy in xy_levels], side,
                                  side)
    return _pick_and_pack(patches)


def _pick_and_pack(patches: torch.Tensor) -> torch.Tensor:
    """(K, 31, 31) patches -> (K, 8) int32 words of the 256 comparisons."""
    flat = patches.reshape(patches.shape[0], -1)
    idx_a, idx_b = _pick_indices(patches.device)
    return pack_bits(flat[:, idx_a] < flat[:, idx_b])
