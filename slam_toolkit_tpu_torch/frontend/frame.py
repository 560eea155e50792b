"""Per-frame state: extraction, normalization and stereo.

Counterpart of slam_toolkit_tpu/frontend/frame.py (ref
src/frame.cpp:33-69, 384-409): build_frame, add_stereo (both stereo
methods: "sad", the SAD sweep, optionally gated by one upright BRIEF
per eye; "descriptor", the right image extracted, matched along the
rows and refined to subpixel) and backproject. Slots without a keypoint
are feats.valid == False, never a shorter tensor. build_frame also
takes B lanes' images (B, H, W) and gives a FrameState with a leading
lane axis, and add_stereo takes such a frame with a lane mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.matching import stereo_match
from slam_toolkit_tpu_torch.geometry import camera as cam_mod
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.ops import brief, pyramid, stereo_sad
from slam_toolkit_tpu_torch.ops.extractor import FrameFeatures, extract
from slam_toolkit_tpu_torch.ops.subpixel import refine_disparity


class FrameState(NamedTuple):
    feats: FrameFeatures
    norm_xy: torch.Tensor        # (K, 2) undistorted normalized coords
    right_x_norm: torch.Tensor   # (K,) normalized right x of the stereo match
    depth: torch.Tensor          # (K,) stereo depth, 0 = none
    has_stereo: torch.Tensor     # (K,) bool


def build_frame(image_left: torch.Tensor, cam: StereoCamera,
                cfg: SlamConfig) -> FrameState:
    """Extract + normalize the left image (every frame); (H, W), or
    (B, H, W) for B lanes."""
    feats = extract(image_left, cfg.extractor)
    norm_xy = cam_mod.pixel_to_normalized(cam.left, feats.xy)
    shape = feats.valid.shape
    zeros = torch.zeros(shape, dtype=torch.float32, device=image_left.device)
    return FrameState(
        feats=feats,
        norm_xy=torch.where(feats.valid[..., None], norm_xy,
                            torch.zeros_like(norm_xy)),
        right_x_norm=zeros,
        depth=zeros,
        has_stereo=torch.zeros(shape, dtype=torch.bool,
                               device=image_left.device))


def _brief_gate(frame: FrameState, image_left: torch.Tensor,
                image_right: torch.Tensor, right_x: torch.Tensor,
                cfg: SlamConfig) -> torch.Tensor:
    """(K,) the SAD matches whose upright BRIEF at level 0 of the blurred
    left image, at xy, and of the blurred right image, at (right_x, y),
    differ in at most max_hamming bits; (B, K) for B lanes. Both eyes'
    patches are one gather launch."""
    sigma = cfg.extractor.blur_sigma
    xy_l = frame.feats.xy
    xy_r = torch.stack([right_x, xy_l[..., 1]], dim=-1)
    d = brief.upright_patch_descriptors_levels(
        [pyramid.gaussian_blur(image_left, 7, sigma),
         pyramid.gaussian_blur(image_right, 7, sigma)], [xy_l, xy_r])
    k = xy_l.shape[-2]
    diff = (d[..., :k, :] ^ d[..., k:, :]).long() & 0xFFFFFFFF
    shifts = torch.arange(32, device=diff.device)
    ham = torch.sum((diff[..., None] >> shifts) & 1, dim=(-2, -1))
    return ham <= cfg.matcher.max_hamming


def add_stereo(frame: FrameState, image_left: torch.Tensor,
               image_right: torch.Tensor, cam: StereoCamera,
               cfg: SlamConfig, lanes=None) -> FrameState:
    """Stereo for a keyframe -> subpixel right x and depth. "sad": the SAD
    sweep along the rectified row (with stereo_brief_gate, SAD proposes
    and one BRIEF per eye verifies); "descriptor": the right image
    extracted (ref ExtractRightKeypoints, src/frame.cpp:384-389),
    stereo_match, then refine_disparity.

    B lanes: a frame with a leading lane axis, images (B, H, W) and
    `lanes` a (B,) mask on their device (None: every lane). Each step
    runs once over the lanes: the SAD curves of the lanes the mask keeps
    in one batched launch; the BRIEF gate's patches, and descriptor
    stereo's right-image extraction and refinement, in batched gathers
    of every lane (the mask is applied to the result). Each kept lane
    gets the single call's stereo, a lane the mask leaves out none."""
    batched = image_left.dim() == 3
    if batched and lanes is None:
        lanes = torch.ones(image_left.shape[:1], dtype=torch.bool,
                           device=image_left.device)
    if cfg.matcher.stereo_method == "sad":
        right_x, ok = stereo_sad.match(
            image_left, image_right, frame.feats.xy, frame.feats.valid,
            max_disp=int(cfg.matcher.stereo_max_dx),
            uniqueness=cfg.matcher.stereo_uniqueness, lanes=lanes)
        if cfg.matcher.stereo_brief_gate:
            ok = ok & _brief_gate(frame, image_left, image_right, right_x,
                                  cfg)
    else:
        right = extract(image_right, cfg.extractor)
        right_x, _, ok = stereo_match(frame.feats, right, cam, cfg.matcher)
        right_x, ok = refine_disparity(image_left, image_right,
                                       frame.feats.xy, right_x, ok)
        if batched:
            ok = ok & lanes.bool()[:, None]
    depth = cam_mod.stereo_depth(cam, frame.feats.xy[..., 0], right_x)
    ok = ok & (depth > 0.0)
    right_x_norm = (right_x - cam.left.cx) / cam.left.fx
    zero = torch.zeros_like(depth)
    return frame._replace(right_x_norm=torch.where(ok, right_x_norm, zero),
                          depth=torch.where(ok, depth, zero),
                          has_stereo=ok)


def backproject(frame: FrameState, T_wc: torch.Tensor) -> torch.Tensor:
    """World points of the keypoints at their stereo depth: Xw = T_wc .
    (ray * z) (0 depth for keypoints without stereo)."""
    ray = torch.cat([frame.norm_xy, torch.ones_like(frame.depth)[:, None]],
                    dim=-1)
    return se3.transform(T_wc, ray * frame.depth[:, None])
