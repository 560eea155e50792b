"""FAST + 3x3 NMS + rank boost + border mask of pyramid levels as one
kernel launch.

Counterpart of slam_toolkit_tpu/ops/fast_kernel.py::detect (the JAX
package's ExtractorConfig.fused_fast path). For CUDA tensors the
wrappers launch the hand-written kernel (csrc/fast_nms.cu, replacing
the Pallas _fast_nms_pallas); for CPU tensors they run the plain version,
fast.detect_dual, or fast.detect when thr_hi is None. detect_levels
takes every level of a frame in one launch; detect is the same kernel
with one level. The kernel is bit-exact against the plain version at
every border, and the extractor routes every frame here at every
border, whatever fused_fast says: in the port the flag selects
nothing, since both versions give the same responses bit for bit (it
only chose an implementation on the TPU).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from slam_toolkit_tpu_torch.ops import fast
from slam_toolkit_tpu_torch.utils.cuda_lib import (FLOAT, INT, PTR,
                                                   CudaKernel, check_cuda,
                                                   on_cuda)

MAX_LEVELS = 16          # levels one launch takes (csrc: kMaxLevels)

KERNEL = CudaKernel("slam_fast_nms_levels", PTR, PTR, PTR, PTR, INT, INT,
                    FLOAT, FLOAT, INT)


def detect_fused_plain(image: torch.Tensor, thr_hi: Optional[float],
                       thr_lo: float, border: int) -> torch.Tensor:
    if thr_hi is None:
        return fast.detect(image, thr_lo, border)
    return fast.detect_dual(image, thr_hi, thr_lo, border)


def detect_levels_plain(levels: Sequence[torch.Tensor],
                        thr_hi: Optional[float], thr_lo: float,
                        border: int) -> List[torch.Tensor]:
    """Plain version: detect_fused_plain level by level."""
    return [detect_fused_plain(img, thr_hi, thr_lo, border)
            for img in levels]


def detect_levels_cuda(levels: Sequence[torch.Tensor],
                       thr_hi: Optional[float], thr_lo: float,
                       border: int) -> List[torch.Tensor]:
    levels = [img.float().contiguous() for img in levels]
    dev = levels[0].device
    for i, img in enumerate(levels):
        check_cuda(img, f"levels[{i}]", torch.float32, (None, None), dev)
        if img.numel() == 0:
            raise ValueError(f"levels[{i}] is empty")
    outs = [torch.empty_like(img) for img in levels]
    n = len(levels)
    imgs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels])
    dsts = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    hs = (ctypes.c_int * n)(*[img.shape[0] for img in levels])
    ws = (ctypes.c_int * n)(*[img.shape[1] for img in levels])
    KERNEL(dev, ctypes.addressof(imgs), ctypes.addressof(dsts),
           ctypes.addressof(hs), ctypes.addressof(ws), n,
           int(thr_hi is not None), float(thr_hi or 0.0), float(thr_lo),
           int(border))
    return outs


def detect_levels(levels: Sequence[torch.Tensor], thr_hi: Optional[float],
                  thr_lo: float, border: int) -> List[torch.Tensor]:
    """detect on each of 1 to MAX_LEVELS levels (a frame's pyramid) in one
    call; dispatches on the first level's device."""
    levels = list(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels: one call takes 1 to "
                         f"{MAX_LEVELS}")
    if on_cuda(levels[0]):
        return detect_levels_cuda(levels, thr_hi, thr_lo, border)
    return detect_levels_plain(levels, thr_hi, thr_lo, border)


def detect_fused_cuda(image: torch.Tensor, thr_hi: Optional[float],
                      thr_lo: float, border: int) -> torch.Tensor:
    return detect_levels_cuda([image], thr_hi, thr_lo, border)[0]


def detect_fused(image: torch.Tensor, thr_hi: Optional[float],
                 thr_lo: float, border: int) -> torch.Tensor:
    """The kernel's entry under the JAX package's name: detect, which
    requires border >= 5 here as there (the kernel masks its halo by the
    border); dispatches on the image's device."""
    if border < 5:
        raise ValueError(f"border {border}: the fused FAST kernel needs "
                         "border >= 5")
    return detect(image, thr_hi, thr_lo, border)


def detect(image: torch.Tensor, thr_hi: Optional[float], thr_lo: float,
           border: int) -> torch.Tensor:
    """fast.detect_dual(image, thr_hi, thr_lo, border), or fast.detect
    when thr_hi is None; dispatches on the image's device."""
    if on_cuda(image):
        return detect_fused_cuda(image, thr_hi, thr_lo, border)
    return detect_fused_plain(image, thr_hi, thr_lo, border)
