"""Stereo matching and projection matching of landmarks into a frame.

Counterpart of slam_toolkit_tpu/frontend/matching.py. stereo_match (ref
StereoMatch, src/matcher.cpp:54-132) pairs left and right keypoints
along the rectified rows through one masked dense Hamming matrix, the
ratio test and a mutual check. projection_match (ref ProjectionMatch,
src/matcher.cpp:134-209) runs with the doubled-radius
retry of ref src/posetracker.cpp:187-190 kept branch-free. With a
leading lane axis on every input (B lanes' landmarks, keypoints and
poses) it matches each lane on its own, with one batched top-2 launch
for the B lanes; the landmarks are moved into each lane's camera lane
by lane (se3.per_lane), so every lane's matches are its single call's
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_toolkit_tpu_torch.config import MatcherConfig
from slam_toolkit_tpu_torch.geometry import camera as cam_mod
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.ops import hamming
from slam_toolkit_tpu_torch.ops.extractor import FrameFeatures
from slam_toolkit_tpu_torch.ops.match_kernel import (topk2_match,
                                                     topk2_match_batched)


def stereo_match(left: FrameFeatures, right: FrameFeatures,
                 cam: StereoCamera, cfg: MatcherConfig):
    """Left keypoints matched to right keypoints on the same rectified
    row: |dy| <= stereo_max_dy, disparity in [stereo_min_dx,
    stereo_max_dx], octaves within 1, the ratio test, and the matched
    right keypoint's own best left keypoint this one (torch.argmin, as
    jnp.argmin, takes the first of equal minima). Returns (right_x (K,)
    the matched right x, depth (K,) 0 where not ok, ok (K,)); (B, K)
    each for B lanes' features (a leading lane axis on both)."""
    dy = torch.abs(left.xy[..., :, None, 1] - right.xy[..., None, :, 1])
    dx = left.xy[..., :, None, 0] - right.xy[..., None, :, 0]
    same_octave = torch.abs(left.octave[..., :, None] -
                            right.octave[..., None, :]) <= 1
    mask = (left.valid[..., :, None] & right.valid[..., None, :] &
            (dy <= cfg.stereo_max_dy) &
            (dx >= cfg.stereo_min_dx) & (dx <= cfg.stereo_max_dx) &
            same_octave)
    dist = hamming.masked_distance(left.desc, right.desc, mask)
    idx, ok = hamming.ratio_test_match(dist, cfg.ratio, cfg.max_hamming)
    back = torch.argmin(dist, dim=-2)
    ok = ok & (torch.gather(back, -1, idx.long()) ==
               torch.arange(idx.shape[-1], device=idx.device))
    right_x = torch.gather(right.xy[..., 0], -1, idx.long())
    depth = cam_mod.stereo_depth(cam, left.xy[..., 0], right_x)
    ok = ok & (depth > 0.0)
    return right_x, torch.where(ok, depth, torch.zeros_like(depth)), ok


class ProjectionMatches(NamedTuple):
    kpt_idx: torch.Tensor     # (L,) int32 matched keypoint per landmark
    ok: torch.Tensor          # (L,) bool
    uv_pred: torch.Tensor     # (L, 2) predicted pixel coords
    n_matches: torch.Tensor   # () int


def projection_match(Xw: torch.Tensor, mp_desc: torch.Tensor,
                     mp_valid: torch.Tensor, frame_feats: FrameFeatures,
                     T_cw: torch.Tensor, cam: StereoCamera,
                     cfg: MatcherConfig, radius: float) -> ProjectionMatches:
    """Match L landmarks into a frame by predicted projection; if fewer
    than 8 matches pass at `radius`, the 2 * radius results are used."""
    Xc = se3.transform(T_cw, Xw) if T_cw.dim() == 2 else \
        se3.per_lane(se3.transform, T_cw, Xw)
    in_front = Xc[..., 2] > 0.05
    uv = cam_mod.project(cam.left, Xc)
    visible = mp_valid & in_front & cam_mod.in_image(cam.left, uv)

    # validity folds into coordinates: invalid entries are pushed far
    # apart so the radius gates reject them
    a_uv = torch.where(visible[..., None], uv, torch.full_like(uv, 1e7))
    b_xy = torch.where(frame_feats.valid[..., None], frame_feats.xy,
                       torch.full_like(frame_feats.xy, -1e7))
    topk2 = topk2_match if Xw.dim() == 2 else topk2_match_batched
    t2 = topk2(mp_desc, frame_feats.desc, a_uv, b_xy, radius)

    def ratio_ok(best, second):
        return (best <= cfg.max_hamming) & (best < cfg.track_ratio * second)

    ok1 = ratio_ok(t2[..., 0], t2[..., 1])
    ok2 = ratio_ok(t2[..., 3], t2[..., 4])
    use_wide = torch.sum(ok1, dim=-1, keepdim=True) < 8
    idx = torch.where(use_wide, t2[..., 5], t2[..., 2]).int()
    ok = torch.where(use_wide, ok2, ok1)
    best = torch.where(use_wide, t2[..., 3], t2[..., 0])
    ok = hamming.keep_best_per_target(idx, ok, best,
                                      frame_feats.desc.shape[-2])
    return ProjectionMatches(kpt_idx=idx, ok=ok, uv_pred=uv,
                             n_matches=torch.sum(ok, dim=-1))
