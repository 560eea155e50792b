"""Patch gather: (K, bh, bw) windows of one image, or of several images
in one call, at K corners.

Counterpart of slam_toolkit_tpu/ops/patches.py::gather_blocks. For CUDA
tensors the wrappers launch the hand-written kernel
(csrc/patch_gather.cu, replacing the Pallas _gather_blocks_pallas); for
CPU tensors they run the plain PyTorch versions below. Corners are
clamped into their image like lax.dynamic_slice. gather_blocks_multi
cuts the windows of several images (the levels of a pyramid) in one
launch; gather_blocks is the same kernel with one image.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from slam_toolkit_tpu_torch.utils.cuda_lib import (INT, PTR, CudaKernel,
                                                   check_cuda, on_cuda)

MAX_IMAGES = 16          # images one launch takes (csrc: kMaxImages)

KERNEL = CudaKernel("slam_gather_blocks", PTR, PTR, PTR, PTR, INT, PTR, PTR,
                    INT, INT, PTR)


def gather_blocks_plain(img: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """Plain version: corners clamped into the image (lax.dynamic_slice
    semantics), then one advanced-indexing gather."""
    h, w = img.shape
    dev = img.device
    y0 = ys.long().clamp(0, h - bh)
    x0 = xs.long().clamp(0, w - bw)
    rows = y0[:, None] + torch.arange(bh, device=dev)[None, :]
    cols = x0[:, None] + torch.arange(bw, device=dev)[None, :]
    return img[rows[:, :, None], cols[:, None, :]]


def gather_blocks_multi_plain(images: Sequence[torch.Tensor],
                              ys: torch.Tensor, xs: torch.Tensor,
                              counts: Sequence[int], bh: int,
                              bw: int) -> torch.Tensor:
    """Plain version: gather_blocks_plain on each image's share of the
    corners, concatenated."""
    outs, o = [], 0
    for img, k in zip(images, counts):
        outs.append(gather_blocks_plain(img, ys[o:o + k], xs[o:o + k], bh,
                                        bw))
        o += k
    return torch.cat(outs)


def gather_blocks_multi_cuda(images: Sequence[torch.Tensor],
                             ys: torch.Tensor, xs: torch.Tensor,
                             counts: Sequence[int], bh: int,
                             bw: int) -> torch.Tensor:
    images = [img.contiguous() for img in images]
    ys, xs = ys.contiguous(), xs.contiguous()
    dev = images[0].device
    total = sum(counts)
    check_cuda(ys, "ys", torch.int32, (total,), dev)
    check_cuda(xs, "xs", torch.int32, (total,), dev)
    for i, (img, k) in enumerate(zip(images, counts)):
        check_cuda(img, f"images[{i}]", torch.float32, (None, None), dev)
        h, w = img.shape
        if k and not (0 < bh <= h and 0 < bw <= w):
            raise ValueError(f"window {bh}x{bw} does not fit image {i}, "
                             f"{h}x{w}")
    n = len(images)
    ptrs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in images])
    hs = (ctypes.c_int * n)(*[img.shape[0] for img in images])
    ws = (ctypes.c_int * n)(*[img.shape[1] for img in images])
    first = (ctypes.c_int * (n + 1))(0)
    for i, k in enumerate(counts):
        first[i + 1] = first[i] + k
    out = torch.empty((total, bh, bw), dtype=torch.float32, device=dev)
    if total:
        KERNEL(dev, ctypes.addressof(ptrs), ctypes.addressof(hs),
               ctypes.addressof(ws), ctypes.addressof(first), n,
               ys.data_ptr(), xs.data_ptr(), bh, bw, out.data_ptr())
    return out


def gather_blocks_multi(images: Sequence[torch.Tensor], ys: torch.Tensor,
                        xs: torch.Tensor, counts: Sequence[int], bh: int,
                        bw: int) -> torch.Tensor:
    """Windows of several images in one call: images[i] gives counts[i]
    windows, at the next counts[i] of the flat (sum(counts),) corners
    ys, xs. Returns the (sum(counts), bh, bw) windows in that order. At
    most MAX_IMAGES images."""
    images = list(images)
    counts = [int(k) for k in counts]
    if not 1 <= len(images) <= MAX_IMAGES:
        raise ValueError(f"{len(images)} images: one call takes 1 to "
                         f"{MAX_IMAGES}")
    if len(counts) != len(images) or min(counts) < 0:
        raise ValueError(f"counts {counts} for {len(images)} images")
    if sum(counts) != ys.shape[0]:
        raise ValueError(f"counts sum to {sum(counts)}, {ys.shape[0]} "
                         "corners given")
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    if on_cuda(images[0]):
        return gather_blocks_multi_cuda(images, ys, xs, counts, bh, bw)
    return gather_blocks_multi_plain(images, ys, xs, counts, bh, bw)


def gather_blocks_cuda(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       bh: int, bw: int) -> torch.Tensor:
    return gather_blocks_multi_cuda([img], ys, xs, [ys.shape[0]], bh, bw)


def gather_blocks(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  bh: int, bw: int) -> torch.Tensor:
    """(K,) corners -> (K, bh, bw) windows of img."""
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    if on_cuda(img):
        return gather_blocks_cuda(img, ys, xs, bh, bw)
    return gather_blocks_plain(img, ys, xs, bh, bw)
