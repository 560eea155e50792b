"""The ORB extractor: pyramid -> FAST -> select -> blur -> upright BRIEF.

Counterpart of slam_toolkit_tpu/ops/extractor.py::extract with the
matmul pyramid and upright float32 descriptors. FAST is routed as the
JAX package routes it: the fused FAST+NMS kernel (ops/fast_kernel, all
levels of the frame in one call) when fused_fast is set and the border
is at least 5, else the dual- or
single-threshold detector of ops/fast. Output is a fixed-shape
FrameFeatures; padded slots are flagged invalid.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from slam_toolkit_tpu_torch.config import ExtractorConfig
from slam_toolkit_tpu_torch.ops import (brief, fast, fast_kernel, pyramid,
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


def _check_supported(cfg: ExtractorConfig) -> None:
    unported = {"steer_rotation": cfg.steer_rotation,
                "bfloat16 descriptors": cfg.descriptor_dtype != "float32"}
    off = [k for k, v in unported.items() if v]
    if off:
        raise NotImplementedError(f"extractor options not ported: {off}")


def extract(image: torch.Tensor, cfg: ExtractorConfig) -> FrameFeatures:
    """(H, W) float32 grayscale -> FrameFeatures with cfg.max_keypoints
    slots."""
    _check_supported(cfg)
    levels = pyramid.build_pyramid(image, cfg)
    border = cfg.patch_radius + 1
    dev = image.device
    budgets = level_budgets(cfg)
    # dual threshold: high-threshold corners outrank low-threshold
    # fallbacks through a +1e4 rank boost
    thr_hi = float(cfg.fast_threshold_high) if cfg.dual_threshold else None
    use_fused = cfg.fused_fast and border >= 5
    fused = {}
    if use_fused:
        # the levels with a budget, up to MAX_LEVELS of them a launch
        used = [lvl for lvl, n_l in enumerate(budgets) if n_l > 0]
        for i in range(0, len(used), fast_kernel.MAX_LEVELS):
            part = used[i:i + fast_kernel.MAX_LEVELS]
            fused.update(zip(part, fast_kernel.detect_levels(
                [levels[lvl] for lvl in part], thr_hi,
                float(cfg.fast_threshold_low), border)))
    parts, blurred_levels, xy_levels = [], [], []
    for lvl, (img_l, n_l) in enumerate(zip(levels, budgets)):
        if n_l == 0:
            continue
        if use_fused:
            eff = fused[lvl]
        elif cfg.dual_threshold:
            eff = fast.detect_dual(img_l, thr_hi,
                                   float(cfg.fast_threshold_low), border)
        else:
            eff = fast.detect(img_l, float(cfg.fast_threshold_low), border)
        ncells = ((img_l.shape[0] + cfg.cell_size - 1) // cfg.cell_size) * \
                 ((img_l.shape[1] + cfg.cell_size - 1) // cfg.cell_size)
        per_cell = min(4, max(1, -(-4 * n_l // ncells)))
        xy, _, valid = topk_grid.select_keypoints(eff, cfg.cell_size, n_l,
                                                  per_cell=per_cell)
        # the true (un-boosted) response, not the ranking value
        ix = xy.long()
        raw = eff[ix[:, 1], ix[:, 0]]
        resp = torch.where(valid, torch.where(raw >= 1e4, raw - 1e4, raw),
                           torch.zeros_like(raw))
        blurred_levels.append(pyramid.gaussian_blur(img_l, 7, cfg.blur_sigma))
        xy_levels.append(xy)
        scale = cfg.scale_factor ** lvl
        parts.append((
            xy * scale,
            resp,
            torch.full((n_l,), lvl, dtype=torch.int32, device=dev),
            torch.zeros((n_l,), dtype=torch.float32, device=dev),
            torch.full((n_l,), scale * scale, dtype=torch.float32,
                       device=dev),
            valid,
        ))

    # the descriptors of all levels at once: one gather, one pick and pack
    xy, response, octave, angle, sigma2, valid = (
        torch.cat(f, dim=0) for f in zip(*parts))
    feats = FrameFeatures(
        xy=xy, response=response, octave=octave, angle=angle, sigma2=sigma2,
        desc=brief.upright_patch_descriptors_levels(blurred_levels,
                                                    xy_levels),
        valid=valid)
    pad = cfg.max_keypoints - feats.xy.shape[0]
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
        xy=torch.where(feats.valid[:, None], feats.xy, zero[:, None]),
        response=torch.where(feats.valid, feats.response, zero))
