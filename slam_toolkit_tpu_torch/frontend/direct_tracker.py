"""Direct (photometric) pose tracker, coarse to fine over a pyramid.

Counterpart of slam_toolkit_tpu/frontend/direct_tracker.py (ref
BrightenDirectPoseTracker, src/posetracker.cpp:250-353; DirectPyramid
ratio 0.6, src/optimizer.cpp:15-37): SE3 pose plus affine brightness
(a, b) against landmarks with known anchor-frame intensities. With a
leading lane axis on the images, poses, landmarks and frame (B lanes,
the JAX package's vmapped tracker) each lane is tracked as its single
call tracks it (optim/direct_lm over lanes, one batched top-2 for the
binding, the pose algebra lane by lane).
"""

from __future__ import annotations

from typing import Tuple

import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.frame import FrameState
from slam_toolkit_tpu_torch.frontend.matching import projection_match
from slam_toolkit_tpu_torch.frontend.tracker import TrackResult, take
from slam_toolkit_tpu_torch.geometry import camera as cam_mod
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import Camera, StereoCamera
from slam_toolkit_tpu_torch.ops.pyramid import resize_bilinear
from slam_toolkit_tpu_torch.optim import direct_lm
from slam_toolkit_tpu_torch.optim.direct_lm import DirectResult, DirectState

PYRAMID_RATIO = 0.6
PYRAMID_LEVELS = 4


def build_direct_pyramid(image: torch.Tensor, levels: int = PYRAMID_LEVELS,
                         ratio: float = PYRAMID_RATIO):
    """[(image, scale)] from fine to coarse, each level resized from the
    full image ((H, W), or (B, H, W) for lanes)."""
    h, w = image.shape[-2:]
    out = []
    for lvl in range(levels):
        s = ratio ** lvl
        hh, ww = max(int(round(h * s)), 16), max(int(round(w * s)), 16)
        out.append((resize_bilinear(image, (hh, ww)), s))
    return out


def track_direct(ref_image: torch.Tensor, ref_state: DirectState,
                 image: torch.Tensor, T_pred: torch.Tensor, cam: Camera,
                 Xw: torch.Tensor, valid: torch.Tensor,
                 iters_per_level: int = 7) -> DirectResult:
    """The new frame's (pose, a, b) by photometric alignment against the
    anchor frame (ref_image at ref_state), coarse to fine: at each level
    the anchor's pattern intensities, then a damped LM."""
    pyr_ref = build_direct_pyramid(ref_image)
    pyr_new = build_direct_pyramid(image)
    state = DirectState(T_cw=T_pred, a=ref_state.a, b=ref_state.b)
    result = None
    for (img_r, s), (img_n, _) in zip(reversed(pyr_ref), reversed(pyr_new)):
        ref_vals = direct_lm.reference_values(ref_state, img_r, cam, Xw,
                                              valid, s)
        result = direct_lm.optimize_direct(state, img_n, cam, Xw, ref_vals,
                                           valid, s, iters=iters_per_level)
        state = result.state
    return result


def track_direct_bound(frame: FrameState, image: torch.Tensor,
                       T_pred: torch.Tensor, kf_img: torch.Tensor,
                       kf_T: torch.Tensor, kf_ab: torch.Tensor,
                       Xw: torch.Tensor, desc: torch.Tensor,
                       valid: torch.Tensor, cam: StereoCamera,
                       cfg: SlamConfig) -> Tuple[TrackResult, torch.Tensor]:
    """The direct method's frame: photometric pose against the anchor
    keyframe image (kf_img at pose kf_T, brightness kf_ab), then keypoint
    binding within direct_bind_px for the map's bookkeeping (ref
    src/posetracker.cpp:250-353, :278-317). Returns the tracking result
    and the frame's (a, b)."""
    ref = DirectState(T_cw=kf_T, a=kf_ab[..., 0], b=kf_ab[..., 1])
    dres = track_direct(kf_img, ref, image, T_pred, cam.left, Xw, valid)
    lanes = Xw.dim() == 3
    T_dir = se3.per_lane(se3.normalize, dres.state.T_cw) if lanes else \
        se3.normalize(dres.state.T_cw)
    mm = projection_match(Xw, desc, valid, frame.feats, T_dir, cam,
                          cfg.matcher, cfg.tracker.direct_bind_px)
    if lanes:
        Xc = se3.per_lane(se3.transform, T_dir, Xw)
        xy = take(frame.feats.xy, mm.kpt_idx.long())
        err_px = se3.per_lane(
            lambda a, b: torch.linalg.vector_norm(a - b, dim=-1),
            cam_mod.project(cam.left, Xc), xy)
    else:
        Xc = se3.transform(T_dir, Xw)
        xy = frame.feats.xy[mm.kpt_idx.long()]
        err_px = torch.linalg.vector_norm(cam_mod.project(cam.left, Xc) - xy,
                                          dim=-1)
    inlier = mm.ok & (Xc[..., 2] > 0.0) & \
        (err_px <= cfg.tracker.direct_bind_px)
    n_in = torch.sum(inlier, dim=-1)
    res = TrackResult(T_cw=T_dir, mp_kpt=mm.kpt_idx, mp_xy=xy,
                      mp_inlier=inlier, n_matches=mm.n_matches,
                      n_inliers=n_in, ok=n_in >= cfg.tracker.min_matches)
    return res, torch.stack([dres.state.a, dres.state.b], dim=-1)
