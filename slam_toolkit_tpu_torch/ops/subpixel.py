"""Subpixel disparity refinement: an SAD sweep around the matched x and
a parabola through its minimum.

Counterpart of slam_toolkit_tpu/ops/subpixel.py::refine_disparity (the
descriptor stereo path's refinement; ref StereoMatch,
src/matcher.cpp:54-132, pairs integer keypoints only). Per keypoint, an
11x11 left patch and an 11 x 17 right strip come from the patch-gather
kernel (ops/patches: two launches on a card), the strip is scored at
the 7 integer shifts around the matched x, and a 3-point parabola gives
the subpixel minimum. On 8-bit images every SAD is an integer below
2^24, so the sums are exact in any order. Matches whose minimum sits at
the search edge, or whose windows were clamped at an image border, are
dropped. With a leading lane axis (B lanes: images (B, H, W), keypoints
(B, K, 2)) the patches and strips of all lanes are one batched gather
each, and every lane is refined as on its own.
"""

from __future__ import annotations

import torch

from slam_toolkit_tpu_torch.ops.patches import gather_blocks

WIN = 5        # half-width of the correlation window (11x11)
SEARCH = 3     # +/- integer shifts around the matched x


def refine_disparity(img_left: torch.Tensor, img_right: torch.Tensor,
                     xy_left: torch.Tensor, x_right: torch.Tensor,
                     valid: torch.Tensor):
    """(x_right refined (K,), ok (K,)) for K left keypoints xy_left (K, 2)
    matched at right x x_right (K,) on the same row; (B, K) for B lanes.
    ok clears matches whose SAD minimum is at the search edge or whose
    window was clamped (raw corners against the clipped ones); x_right
    is kept where not ok."""
    h, w = img_left.shape[-2:]
    n_shifts = 2 * SEARCH + 1
    side = 2 * WIN + 1
    strip_w = side + 2 * SEARCH

    xl = torch.round(xy_left[..., 0]).int()
    yl = torch.round(xy_left[..., 1]).int()
    xr = torch.round(x_right).int()
    yl0 = torch.clamp(yl - WIN, 0, h - side)
    xl0 = torch.clamp(xl - WIN, 0, w - side)
    patch_l = gather_blocks(img_left, yl0, xl0, side, side)
    xr0_raw = xr - WIN - SEARCH
    xr0 = torch.clamp(xr0_raw, 0, w - strip_w)
    clamped = (xr0 != xr0_raw) | (yl0 != yl - WIN) | (xl0 != xl - WIN)
    strip = gather_blocks(img_right, yl0, xr0, side, strip_w)

    patch_r = torch.stack([strip[..., s:s + side] for s in range(n_shifts)],
                          dim=-3)                       # (K, S, 11, 11)
    sad = torch.sum(torch.abs(patch_r - patch_l[..., None, :, :]),
                    dim=(-2, -1))

    best = torch.argmin(sad, dim=-1)
    at_edge = (best == 0) | (best == n_shifts - 1)
    bc = torch.clamp(best, 1, n_shifts - 2)
    c0, c1, c2 = (torch.gather(sad, -1, (bc + d)[..., None])[..., 0]
                  for d in (-1, 0, 1))
    denom = c0 + c2 - 2.0 * c1
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    x_ref = xr.float() + bc.float() - SEARCH + delta
    ok = valid & ~at_edge & ~clamped
    return torch.where(ok, x_ref, x_right), ok
