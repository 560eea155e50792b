"""Patch gather: (K, bh, bw) windows of one image, or of several images
in one call, at K corners.

Counterpart of slam_toolkit_tpu/ops/patches.py::gather_blocks. For CUDA
tensors the wrappers launch the hand-written kernel
(csrc/patch_gather.cu, replacing the Pallas _gather_blocks_pallas); for
CPU tensors they run the plain PyTorch versions below. Corners are
clamped into their image like lax.dynamic_slice. gather_blocks_multi
cuts the windows of several images (the levels of a pyramid) in one
launch; gather_blocks is the same kernel with one image;
gather_blocks_batched cuts them for B lanes of such images (a lane's
pyramid levels, B lanes of them) in one launch. Images are float32 or
bfloat16 (all of one call alike; the Pallas kernel takes both) and the
windows come back in the images' dtype: a bfloat16 call launches the
kernel's bfloat16 entry, counted apart (KERNEL_BF16,
BATCHED_KERNEL_BF16).
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
BATCHED_KERNEL = CudaKernel("slam_gather_blocks_batched", PTR, PTR, PTR, PTR,
                            INT, INT, PTR, PTR, INT, INT, PTR)
KERNEL_BF16 = CudaKernel("slam_gather_blocks_bf16", PTR, PTR, PTR, PTR, INT,
                         PTR, PTR, INT, INT, PTR)
BATCHED_KERNEL_BF16 = CudaKernel("slam_gather_blocks_batched_bf16", PTR, PTR,
                                 PTR, PTR, INT, INT, PTR, PTR, INT, INT, PTR)
DTYPES = (torch.float32, torch.bfloat16)


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


def gather_blocks_batched_plain(images: Sequence[torch.Tensor],
                                ys: torch.Tensor, xs: torch.Tensor,
                                counts: Sequence[int], bh: int,
                                bw: int) -> torch.Tensor:
    """Plain version: gather_blocks_multi_plain lane by lane."""
    return torch.stack([
        gather_blocks_multi_plain([img[b] for img in images], ys[b], xs[b],
                                  counts, bh, bw)
        for b in range(ys.shape[0])])


def _launch_gather(images, ys, xs, counts, bh, bw, lanes):
    """The multi-image and batched launches: images (lanes, h, w) blocks
    (lanes None: (h, w) images), corners (lanes, total) or (total,)."""
    images = [img.contiguous() for img in images]
    ys, xs = ys.contiguous(), xs.contiguous()
    dev, dtype = images[0].device, images[0].dtype
    if dtype not in DTYPES:
        raise ValueError(f"images: expected float32 or bfloat16, got {dtype}")
    total = sum(counts)
    lead = () if lanes is None else (lanes,)
    check_cuda(ys, "ys", torch.int32, lead + (total,), dev)
    check_cuda(xs, "xs", torch.int32, lead + (total,), dev)
    for i, (img, k) in enumerate(zip(images, counts)):
        check_cuda(img, f"images[{i}]", dtype, lead + (None, None), dev)
        h, w = img.shape[-2:]
        if k and not (0 < bh <= h and 0 < bw <= w):
            raise ValueError(f"window {bh}x{bw} does not fit image {i}, "
                             f"{h}x{w}")
    n = len(images)
    ptrs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in images])
    hs = (ctypes.c_int * n)(*[img.shape[-2] for img in images])
    ws = (ctypes.c_int * n)(*[img.shape[-1] for img in images])
    first = (ctypes.c_int * (n + 1))(0)
    for i, k in enumerate(counts):
        first[i + 1] = first[i] + k
    out = torch.empty(lead + (total, bh, bw), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    table = (ctypes.addressof(ptrs), ctypes.addressof(hs),
             ctypes.addressof(ws), ctypes.addressof(first), n)
    bf16 = dtype == torch.bfloat16
    if lanes is None:
        (KERNEL_BF16 if bf16 else KERNEL)(
            dev, *table, ys.data_ptr(), xs.data_ptr(), bh, bw,
            out.data_ptr())
    else:
        (BATCHED_KERNEL_BF16 if bf16 else BATCHED_KERNEL)(
            dev, *table, lanes, ys.data_ptr(), xs.data_ptr(), bh, bw,
            out.data_ptr())
    return out


def gather_blocks_multi_cuda(images: Sequence[torch.Tensor],
                             ys: torch.Tensor, xs: torch.Tensor,
                             counts: Sequence[int], bh: int,
                             bw: int) -> torch.Tensor:
    return _launch_gather(images, ys, xs, counts, bh, bw, None)


def gather_blocks_batched_cuda(images: Sequence[torch.Tensor],
                               ys: torch.Tensor, xs: torch.Tensor,
                               counts: Sequence[int], bh: int,
                               bw: int) -> torch.Tensor:
    return _launch_gather(images, ys, xs, counts, bh, bw, ys.shape[0])


def gather_blocks_multi(images: Sequence[torch.Tensor], ys: torch.Tensor,
                        xs: torch.Tensor, counts: Sequence[int], bh: int,
                        bw: int) -> torch.Tensor:
    """Windows of several images in one call: images[i] gives counts[i]
    windows, at the next counts[i] of the flat (sum(counts),) corners
    ys, xs. Returns the (sum(counts), bh, bw) windows in that order. At
    most MAX_IMAGES images."""
    images, counts = _check_table(images, ys, counts)
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    if on_cuda(images[0]):
        return gather_blocks_multi_cuda(images, ys, xs, counts, bh, bw)
    return gather_blocks_multi_plain(images, ys, xs, counts, bh, bw)


def gather_blocks_batched(images: Sequence[torch.Tensor], ys: torch.Tensor,
                          xs: torch.Tensor, counts: Sequence[int], bh: int,
                          bw: int) -> torch.Tensor:
    """gather_blocks_multi for B lanes in one call: images[i] is (B, h_i,
    w_i), the corners ys, xs are (B, sum(counts)); lane b's windows are
    cut from images[i][b] as gather_blocks_multi cuts them. Returns (B,
    sum(counts), bh, bw). At most MAX_IMAGES images a lane."""
    images, counts = _check_table(images, ys[0], counts)
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    if on_cuda(images[0]):
        return gather_blocks_batched_cuda(images, ys, xs, counts, bh, bw)
    return gather_blocks_batched_plain(images, ys, xs, counts, bh, bw)


def _check_table(images, ys, counts):
    images = list(images)
    counts = [int(k) for k in counts]
    if len({img.dtype for img in images}) > 1:
        raise ValueError(f"images of dtypes {[img.dtype for img in images]}: "
                         "one call takes one dtype")
    if not 1 <= len(images) <= MAX_IMAGES:
        raise ValueError(f"{len(images)} images: one call takes 1 to "
                         f"{MAX_IMAGES}")
    if len(counts) != len(images) or min(counts) < 0:
        raise ValueError(f"counts {counts} for {len(images)} images")
    if sum(counts) != ys.shape[0]:
        raise ValueError(f"counts sum to {sum(counts)}, {ys.shape[0]} "
                         "corners given")
    return images, counts


def gather_blocks_cuda(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       bh: int, bw: int) -> torch.Tensor:
    return gather_blocks_multi_cuda([img], ys, xs, [ys.shape[0]], bh, bw)


def gather_blocks(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  bh: int, bw: int) -> torch.Tensor:
    """(K,) corners -> (K, bh, bw) windows of img; corners of any shape
    (...) give (..., bh, bw). A (B, H, W) img takes (B, K) corners: lane
    b's windows of img[b], one launch of the batched entry
    (gather_blocks_batched)."""
    if img.dim() == 3:
        return gather_blocks_batched([img], ys, xs, [ys.shape[-1]], bh, bw)
    shape = ys.shape
    ys = ys.to(torch.int32).reshape(-1)
    xs = xs.to(torch.int32).reshape(-1)
    if on_cuda(img):
        out = gather_blocks_cuda(img, ys, xs, bh, bw)
    else:
        out = gather_blocks_plain(img, ys, xs, bh, bw)
    return out.reshape(shape + (bh, bw))
