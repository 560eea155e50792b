"""Left-anchored SAD stereo: per-keypoint correlation sweep.

Counterpart of slam_toolkit_tpu/ops/stereo_sad.py::match. The (K, NS)
cost curves come from the hand-written kernel (csrc/stereo_sad.cu,
replacing the Pallas _curve_pallas) for CUDA tensors and from the plain
version below for CPU tensors; argmin, parabola and uniqueness stay in
PyTorch for both. With a leading lane axis on the images and keypoints
(B lanes, the JAX package's vmapped match) the curves of every lane come
from one launch of the kernel's batched entry (sad_curve_batched), and
a lane mask leaves out the lanes that need no stereo; each lane's curves
are its single launch's.
"""

from __future__ import annotations

import torch

from slam_toolkit_tpu_torch.ops.patches import gather_blocks_plain
from slam_toolkit_tpu_torch.utils.cuda_lib import (INT, PTR, CudaKernel,
                                                   check_cuda, on_cuda)

WIN = 5                  # half window -> 11x11
PAD = 1                  # parabola neighbours beyond the disparity range
SIDE = 2 * WIN + 1

KERNEL = CudaKernel("slam_sad_curve", PTR, PTR, INT, INT, PTR, PTR, PTR, INT,
                    INT, PTR)
BATCHED_KERNEL = CudaKernel("slam_sad_curve_batched", PTR, PTR, INT, INT, PTR,
                            PTR, PTR, INT, INT, INT, PTR, PTR)


def _shifts(max_disp: int) -> int:
    return max_disp + 2 * PAD + 1      # s = 0 .. max_disp + 2


def _strip_w(max_disp: int) -> int:
    return SIDE + max_disp + 2 * PAD


def sad_curve_plain(img_l, img_r, ys0, xl0, xs0, max_disp: int):
    """Plain version: gather the patches and strips, then sum |diff| along
    each window row (column order) and over the rows, as the JAX
    package's _sad_from_blocks does."""
    ns = _shifts(max_disp)
    patch = gather_blocks_plain(img_l, ys0, xl0, SIDE, SIDE)
    strip = gather_blocks_plain(img_r, ys0, xs0, SIDE, _strip_w(max_disp))
    acc = None
    for c in range(SIDE):
        d = torch.abs(strip[:, :, c:c + ns] - patch[:, :, c:c + 1])
        acc = d if acc is None else acc + d
    return torch.sum(acc, dim=1)


def sad_curve_batched_plain(img_l, img_r, ys0, xl0, xs0, max_disp: int,
                            lanes):
    """Plain version of the batched call: sad_curve_plain for each lane
    the mask keeps, zeros for the others (the kernel leaves those rows
    unwritten)."""
    keep = lanes.tolist()
    out = torch.zeros(ys0.shape + (_shifts(max_disp),), dtype=torch.float32,
                      device=img_l.device)
    for b in range(ys0.shape[0]):
        if keep[b]:
            out[b] = sad_curve_plain(img_l[b], img_r[b], ys0[b], xl0[b],
                                     xs0[b], max_disp)
    return out


def _launch_sad(img_l, img_r, ys0, xl0, xs0, max_disp: int, lanes):
    """The single launch (lanes None) and the batched one (a leading lane
    axis on every input, `lanes` the (B,) mask of the lanes to compute)."""
    img_l, img_r, ys0, xl0, xs0 = (t.contiguous() for t in
                                   (img_l, img_r, ys0, xl0, xs0))
    h, w = img_l.shape[-2:]
    k = ys0.shape[-1]
    lead = () if lanes is None else (ys0.shape[0],)
    check_cuda(img_l, "img_l", torch.float32, lead + (h, w))
    check_cuda(img_r, "img_r", torch.float32, lead + (h, w), img_l.device)
    for name, t in (("ys0", ys0), ("xl0", xl0), ("xs0", xs0)):
        check_cuda(t, name, torch.int32, lead + (k,), img_l.device)
    if not (SIDE <= h and _strip_w(max_disp) <= w and max_disp >= 0):
        raise ValueError(f"max_disp {max_disp} does not fit image {h}x{w}")
    shape = lead + (k, _shifts(max_disp))
    if lanes is None:
        out = torch.empty(shape, dtype=torch.float32, device=img_l.device)
        if k:
            KERNEL(img_l.device, img_l.data_ptr(), img_r.data_ptr(), h, w,
                   ys0.data_ptr(), xl0.data_ptr(), xs0.data_ptr(), k,
                   max_disp, out.data_ptr())
        return out
    mask = lanes.to(torch.int32).contiguous()
    check_cuda(mask, "lanes", torch.int32, lead, img_l.device)
    # a masked lane's curves are left unwritten: no caller reads them
    out = torch.empty(shape, dtype=torch.float32, device=img_l.device)
    if k and lead[0]:
        BATCHED_KERNEL(img_l.device, img_l.data_ptr(), img_r.data_ptr(), h,
                       w, ys0.data_ptr(), xl0.data_ptr(), xs0.data_ptr(), k,
                       max_disp, lead[0], mask.data_ptr(), out.data_ptr())
    return out


def sad_curve_cuda(img_l, img_r, ys0, xl0, xs0, max_disp: int):
    return _launch_sad(img_l, img_r, ys0, xl0, xs0, max_disp, None)


def sad_curve_batched_cuda(img_l, img_r, ys0, xl0, xs0, max_disp: int,
                           lanes):
    return _launch_sad(img_l, img_r, ys0, xl0, xs0, max_disp, lanes)


def sad_curve(img_l, img_r, ys0, xl0, xs0, max_disp: int):
    """(K, NS) SAD of the 11x11 left window at (ys0, xl0) against the
    right strip starting at (ys0, xs0), over NS = max_disp + 3 shifts."""
    ys0, xl0, xs0 = (t.to(torch.int32) for t in (ys0, xl0, xs0))
    if on_cuda(img_l):
        return sad_curve_cuda(img_l, img_r, ys0, xl0, xs0, max_disp)
    return sad_curve_plain(img_l, img_r, ys0, xl0, xs0, max_disp)


def sad_curve_batched(img_l, img_r, ys0, xl0, xs0, max_disp: int, lanes):
    """sad_curve for B lanes in one call: img_l, img_r (B, H, W), ys0,
    xl0, xs0 (B, K), lanes a (B,) bool or int mask on the images' device
    -> (B, K, NS). The rows of a lane the mask leaves out are not
    defined (the kernel does not write them; the plain version gives
    zeros)."""
    ys0, xl0, xs0 = (t.to(torch.int32) for t in (ys0, xl0, xs0))
    if on_cuda(img_l):
        return sad_curve_batched_cuda(img_l, img_r, ys0, xl0, xs0, max_disp,
                                      lanes)
    return sad_curve_batched_plain(img_l, img_r, ys0, xl0, xs0, max_disp,
                                   lanes)


def match(img_left: torch.Tensor, img_right: torch.Tensor, xy: torch.Tensor,
          valid: torch.Tensor, max_disp: int = 100,
          uniqueness: float = 0.15, lanes=None):
    """Subpixel right-x for each left keypoint on rectified stereo.

    Returns (x_right (K,) float32, ok (K,) bool); ok needs a SAD minimum
    strictly inside the range, a uniqueness margin against the best SAD
    outside +-1 shift, positive disparity and an unclamped window. With a
    leading lane axis on the images (B, H, W), xy (B, K, 2) and valid (B,
    K), and `lanes` a (B,) mask (None: every lane), every lane the mask
    keeps is matched on its own (one launch of the batched curves for all
    of them) and gives the single call's result; the others give nothing
    matched (ok False; their x_right is not defined)."""
    h, w = img_left.shape[-2:]
    ns = _shifts(max_disp)
    xl = torch.round(xy[..., 0]).int()
    yl = torch.round(xy[..., 1]).int()
    ys0r = yl - WIN
    xl0r = xl - WIN
    xs0r = xl - (max_disp + WIN + PAD)
    ys0 = torch.clamp(ys0r, 0, h - SIDE)
    xl0 = torch.clamp(xl0r, 0, w - SIDE)
    xs0 = torch.clamp(xs0r, 0, w - _strip_w(max_disp))
    clamped = (ys0 != ys0r) | (xl0 != xl0r)

    if img_left.dim() == 2:
        sad = sad_curve(img_left, img_right, ys0, xl0, xs0, max_disp)
    else:
        if lanes is None:
            lanes = torch.ones(img_left.shape[:1], dtype=torch.bool,
                               device=img_left.device)
        sad = sad_curve_batched(img_left, img_right, ys0, xl0, xs0, max_disp,
                                lanes)
        valid = valid & lanes.bool()[:, None]

    col = torch.arange(ns, dtype=torch.float32, device=sad.device)
    inner = (col >= 1) & (col <= ns - 2)
    big = torch.full_like(sad, 1e12)
    best = torch.argmin(torch.where(inner, sad, big), dim=-1)   # first min
    bc = best.float()[..., None]

    def pick(off: int):
        idx = (best + off).clamp(0, ns - 1)[..., None]
        return torch.gather(sad, -1, idx)[..., 0]

    c0, c1, c2 = pick(-1), pick(0), pick(1)
    denom = c0 + c2 - 2.0 * c1
    delta = torch.where(denom > 1e-6,
                        0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)

    away = torch.abs(col - bc) > 1.0
    second = torch.min(torch.where(inner & away, sad, big), dim=-1).values
    uniq_ok = second > c1 * (1.0 + uniqueness) + 1e-3

    s_sub = bc[..., 0] + delta
    disp = (xl - xs0).float() - s_sub - WIN
    x_right = xl.float() - disp
    ok = (valid & uniq_ok & ~clamped & (disp > 0.25) &
          (disp <= float(max_disp)) & (best >= 1) & (best <= ns - 2))
    return torch.where(ok, x_right, torch.zeros_like(x_right)), ok
