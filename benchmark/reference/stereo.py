"""Left-anchored SAD stereo of a keyframe's keypoints, plain PyTorch.

An 11x11 window swept along the rectified row over disparities 0 to
max_disp (one shift of margin each side for the parabola), the first
minimum strictly inside the range, a parabola through its neighbours,
and a uniqueness margin against the best SAD more than one shift away.
Frozen copy of the port's plain path.
"""

from __future__ import annotations

import torch

from benchmark.reference.extractor import gather_blocks
from benchmark.reference.geometry import Camera, stereo_depth

WIN = 5
PAD = 1
SIDE = 2 * WIN + 1


def sad_curves(img_l, img_r, ys0, xl0, xs0, max_disp: int):
    ns = max_disp + 2 * PAD + 1
    patch = gather_blocks(img_l, ys0, xl0, SIDE, SIDE)
    strip = gather_blocks(img_r, ys0, xs0, SIDE, SIDE + max_disp + 2 * PAD)
    acc = None
    for c in range(SIDE):
        d = torch.abs(strip[:, :, c:c + ns] - patch[:, :, c:c + 1])
        acc = d if acc is None else acc + d
    return torch.sum(acc, dim=1)


def match(img_left, img_right, xy, valid, max_disp: int, uniqueness: float):
    """(x_right (K,), ok (K,)): the subpixel right x of each keypoint."""
    h, w = img_left.shape[-2:]
    ns = max_disp + 2 * PAD + 1
    xl = torch.round(xy[:, 0]).int()
    yl = torch.round(xy[:, 1]).int()
    ys0r, xl0r = yl - WIN, xl - WIN
    xs0r = xl - (max_disp + WIN + PAD)
    ys0 = torch.clamp(ys0r, 0, h - SIDE)
    xl0 = torch.clamp(xl0r, 0, w - SIDE)
    xs0 = torch.clamp(xs0r, 0, w - (SIDE + max_disp + 2 * PAD))
    clamped = (ys0 != ys0r) | (xl0 != xl0r)
    sad = sad_curves(img_left, img_right, ys0, xl0, xs0, max_disp)
    col = torch.arange(ns, dtype=torch.float32, device=sad.device)
    inner = (col >= 1) & (col <= ns - 2)
    big = torch.full_like(sad, 1e12)
    best = torch.argmin(torch.where(inner, sad, big), dim=-1)
    bc = best.float()[:, None]

    def pick(off: int):
        idx = (best + off).clamp(0, ns - 1)[:, None]
        return torch.gather(sad, -1, idx)[:, 0]

    c0, c1, c2 = pick(-1), pick(0), pick(1)
    denom = c0 + c2 - 2.0 * c1
    delta = torch.where(denom > 1e-6,
                        0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    away = torch.abs(col - bc) > 1.0
    second = torch.min(torch.where(inner & away, sad, big), dim=-1).values
    uniq_ok = second > c1 * (1.0 + uniqueness) + 1e-3
    disp = (xl - xs0).float() - (bc[:, 0] + delta) - WIN
    x_right = xl.float() - disp
    ok = (valid & uniq_ok & ~clamped & (disp > 0.25) &
          (disp <= float(max_disp)) & (best >= 1) & (best <= ns - 2))
    return torch.where(ok, x_right, torch.zeros_like(x_right)), ok


def keyframe_stereo(img_left, img_right, xy, valid, cam: Camera,
                    matcher: dict):
    """(right_x_norm (K,), has_stereo (K,)) as a keyframe stores them."""
    if matcher["stereo_method"] != "sad" or matcher["stereo_brief_gate"]:
        raise NotImplementedError("reference stereo: SAD without the gate")
    right_x, ok = match(img_left, img_right, xy, valid,
                        int(matcher["stereo_max_dx"]),
                        matcher["stereo_uniqueness"])
    ok = ok & (stereo_depth(cam, xy[:, 0], right_x) > 0.0)
    rxn = (right_x - cam.cx) / cam.fx
    return torch.where(ok, rxn, torch.zeros_like(rxn)), ok
