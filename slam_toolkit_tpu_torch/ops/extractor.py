"""The ORB extractor: pyramid -> FAST -> select -> orient -> describe.

Counterpart of slam_toolkit_tpu/ops/extractor.py::extract, every option:
the matmul or poly pyramid; upright BRIEF, or steered BRIEF at the
intensity-centroid angle (steer_rotation); descriptors compared on the
float32 blurred levels, or on them rounded to bfloat16
(descriptor_dtype="bfloat16", the gather's bfloat16 entry; steered
descriptors sample by element and never reach the gather). FAST is
routed through ops/fast_kernel.detect_levels at every border (all
levels of the frame in one call: one launch of the fused FAST+NMS
kernel on the card, the dual- or single-threshold detector of ops/fast
level by level on the CPU). fused_fast selects nothing here: both
routes give the same responses bit for bit, so the flag only chose an
implementation on the TPU. Output is a fixed-shape
FrameFeatures; padded slots are flagged invalid. extract_batch runs B
lanes' images with a leading lane axis on every step (the JAX package's
vmapped extract): one op, or one kernel launch, for the B lanes, and
each lane's features those of extract on its image.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from slam_toolkit_tpu_torch.config import ExtractorConfig
from slam_toolkit_tpu_torch.ops import (brief, fast_kernel, pyramid,
                                        topk_grid)


class FrameFeatures(NamedTuple):
    xy: torch.Tensor        # (K, 2) float32, level-0 pixel coords
    response: torch.Tensor  # (K,) float32
    octave: torch.Tensor    # (K,) int32
    angle: torch.Tensor     # (K,) float32 radians (0: upright)
    sigma2: torch.Tensor    # (K,) float32 per-octave measurement variance
    desc: torch.Tensor      # (K, 8) int32 packed 256-bit BRIEF
    valid: torch.Tensor     # (K,) bool


def level_budgets(cfg: ExtractorConfig) -> List[int]:
    """Geometric per-level feature split
    (ref src/orb_extractor.cpp:435-446)."""
    q = 1.0 / cfg.scale_factor
    n0 = cfg.num_features * (1.0 - q) / (1.0 - q ** cfg.num_levels)
    budgets = [int(round(n0 * q ** i)) for i in range(cfg.num_levels - 1)]
    budgets.append(max(cfg.num_features - sum(budgets), 0))
    return budgets


def extract_batch(images: torch.Tensor,
                  cfg: ExtractorConfig) -> FrameFeatures:
    """(B, H, W) float32 -> FrameFeatures with a leading lane axis:
    lane b's are extract(images[b], cfg)."""
    return extract(images, cfg)


def _fused_levels(levels, used, thr_hi, cfg: ExtractorConfig, border: int):
    """The fused FAST+NMS kernel's responses of the levels `used`, at most
    fast_kernel.MAX_LEVELS (lane, level) images a launch."""
    lead = levels[0].shape[:-2]
    planes = [(lvl, b) for b in (range(lead[0]) if lead else [None])
              for lvl in used]
    out = {}
    for i in range(0, len(planes), fast_kernel.MAX_LEVELS):
        part = planes[i:i + fast_kernel.MAX_LEVELS]
        out.update(zip(part, fast_kernel.detect_levels(
            [levels[lvl] if b is None else levels[lvl][b]
             for lvl, b in part], thr_hi, float(cfg.fast_threshold_low),
            border)))
    if not lead:
        return {lvl: out[(lvl, None)] for lvl in used}
    return {lvl: torch.stack([out[(lvl, b)] for b in range(lead[0])])
            for lvl in used}


def extract(image: torch.Tensor, cfg: ExtractorConfig) -> FrameFeatures:
    """(H, W) float32 grayscale -> FrameFeatures with cfg.max_keypoints
    slots; (B, H, W) -> the same with a leading lane axis."""
    levels = pyramid.build_pyramid(image, cfg)
    lead = tuple(image.shape[:-2])
    border = cfg.patch_radius + 1
    dev = image.device
    budgets = level_budgets(cfg)
    # dual threshold: high-threshold corners outrank low-threshold
    # fallbacks through a +1e4 rank boost
    thr_hi = float(cfg.fast_threshold_high) if cfg.dual_threshold else None
    # the levels with a budget, up to MAX_LEVELS of them a launch
    fused = _fused_levels(levels, [lvl for lvl, n_l in enumerate(budgets)
                                   if n_l > 0], thr_hi, cfg, border)
    parts, raw_levels, blurred_levels, xy_levels = [], [], [], []
    for lvl, (img_l, n_l) in enumerate(zip(levels, budgets)):
        if n_l == 0:
            continue
        eff = fused[lvl]
        h_l, w_l = img_l.shape[-2:]
        ncells = ((h_l + cfg.cell_size - 1) // cfg.cell_size) * \
                 ((w_l + cfg.cell_size - 1) // cfg.cell_size)
        per_cell = min(4, max(1, -(-4 * n_l // ncells)))
        xy, _, valid = topk_grid.select_keypoints(eff, cfg.cell_size, n_l,
                                                  per_cell=per_cell)
        # the true (un-boosted) response, not the ranking value
        ix = xy.long()
        raw = torch.gather(eff.flatten(-2), -1, ix[..., 1] * w_l + ix[..., 0])
        resp = torch.where(valid, torch.where(raw >= 1e4, raw - 1e4, raw),
                           torch.zeros_like(raw))
        blurred = pyramid.gaussian_blur(img_l, 7, cfg.blur_sigma)
        if cfg.descriptor_dtype == "bfloat16":
            # the smoothed intensities rounded to nearest even, as XLA
            # converts them; the comparisons of bfloat16 values are
            # exactly the JAX package's bfloat16 pick product's signs
            blurred = blurred.to(torch.bfloat16)
        raw_levels.append(img_l)
        blurred_levels.append(blurred)
        xy_levels.append(xy)
        scale = cfg.scale_factor ** lvl
        parts.append((
            xy * scale,
            resp,
            torch.full(lead + (n_l,), lvl, dtype=torch.int32, device=dev),
            torch.zeros(lead + (n_l,), dtype=torch.float32, device=dev),
            torch.full(lead + (n_l,), scale * scale, dtype=torch.float32,
                       device=dev),
            valid,
        ))

    cols = list(zip(*parts))
    xy = torch.cat(cols[0], dim=-2)
    response, octave, angle, sigma2, valid = (torch.cat(f, dim=-1)
                                              for f in cols[1:])
    if cfg.steer_rotation:
        # every level's angles from one gather of the raw levels' patches,
        # then each level's steered samples of its blurred level
        angle = brief.ic_angle_levels(raw_levels, xy_levels)
        per_level = torch.split(angle, [a.shape[-2] for a in xy_levels],
                                dim=-1)
        desc = torch.cat([brief.compute_descriptors(b, xy_l, a)
                          for b, xy_l, a in zip(blurred_levels, xy_levels,
                                                per_level)], dim=-2)
    else:
        # the descriptors of all levels at once: one gather, one pick
        # and pack
        desc = brief.upright_patch_descriptors_levels(blurred_levels,
                                                      xy_levels)
    feats = FrameFeatures(
        xy=xy, response=response, octave=octave, angle=angle, sigma2=sigma2,
        desc=desc, valid=valid)
    pad = cfg.max_keypoints - feats.xy.shape[-2]
    if pad > 0:
        feats = FrameFeatures(
            xy=F.pad(feats.xy, (0, 0, 0, pad)),
            response=F.pad(feats.response, (0, pad)),
            octave=F.pad(feats.octave, (0, pad)),
            angle=F.pad(feats.angle, (0, pad)),
            sigma2=F.pad(feats.sigma2, (0, pad), value=1.0),
            desc=F.pad(feats.desc, (0, 0, 0, pad)),
            valid=F.pad(feats.valid, (0, pad)),
        )
    zero = torch.zeros_like(feats.response)
    return feats._replace(
        xy=torch.where(feats.valid[..., None], feats.xy, zero[..., None]),
        response=torch.where(feats.valid, feats.response, zero))
