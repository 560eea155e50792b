"""How `correct` is decided: the port's outputs against the plain
reference and the renderer's ground truth.

What the timed window produced is judged after it has closed, each
drive's outputs copied out of its engine and the engines freed. The
numbers (a cell's limits file says which of them are compared, and
against what):

- rows_missing: frames handed in whose pose row did not come back.
- track_*: the first frame of a sample of the window's chunks, drawn
  from the seed, tracked by the reference (reference/tracking.py:
  extraction, projection matching, pose LM, the reprojection filter and
  the keyframe rule) from the state the program tracked it from (the
  pose, velocity, landmark snapshot and inlier peak at the chunk
  boundary, copied before the chunk ran): the largest element gap
  between the program's pose row and the reference's pose
  (track_pose_gap, over the frames neither side made a keyframe, whose
  row is the pose after local BA: track_poses_compared of them), the
  largest inlier-count gap, and the frames whose ok or keyframe flag
  differs (track_flag_mismatch).
- kf_feature_mismatch, kf_stereo_mismatch: a sample of the keyframes the
  window inserted, re-extracted and matched by SAD stereo by the
  reference from the keyframe's own images, against the keypoints,
  descriptors and stereo the map holds: the share of keypoint slots that
  differ.
- mp_depth_err: the median relative gap between the z-depth of the
  mappoints anchored at those keyframes (stereo, insertion and local
  BA) and the rendered ground-truth depth at their keypoints.
- motion_err_m, motion_err_p50_m: over every window frame, the largest
  and the median translation gap between the program's frame-to-frame
  motion and the ground truth's; chunk_motion_err_p50_m the median over
  spans of one chunk.

`control=True` puts the reference's tracking computed with TF32 matrix
products, the precision below the configuration's float32, in the
program's place: its pose, inliers and flags are judged against the
float32 reference's from the same states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import extractor as ref_ext
from benchmark.reference import geometry as geo
from benchmark.reference import stereo as ref_stereo
from benchmark.reference import synthetic
from benchmark.reference.tracking import track_frame

STATE_FIELDS = ("T_cw", "velocity", "lm_Xw", "lm_desc", "lm_valid",
                "inlier_peak")


class Artifacts(NamedTuple):
    """What the check reads of one session (one drive through a fresh
    engine), copied out of the program. Frames are the drive's own,
    from 0; drive frame g is frame first + g of the run."""
    rows: Dict[int, np.ndarray]      # drive frame -> its (36,) pose row
    handed: int                      # frames handed in the window
    returned: int                    # rows returned in the window
    window: tuple                    # (first, last + 1) window frame
    first: int                       # the drive's frame 0 in the run
    states: Dict[int, dict]          # chunk's first frame -> state before
    keyframes: dict                  # the map's valid keyframes (numpy)
    mappoints: dict                  # the map's valid mappoints (numpy)


@contextlib.contextmanager
def matmul_precision(control: bool):
    """float32 matrix products, or TF32 ones for the control."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if control else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 63) - 1), 20261018])


def _pose(art: Artifacts, g: int) -> np.ndarray:
    if g == 0:
        return np.eye(4, dtype=np.float64)       # the bootstrap frame
    return art.rows[g][:16].reshape(4, 4).astype(np.float64)


def track_numbers(sessions: List[Artifacts], circuit, cfg: dict, seed: int,
                  n: int, control: bool) -> dict:
    cam = geo.Camera.from_config(cfg["camera"], circuit.device)
    starts = [(a, g) for a in sessions for g in sorted(a.states)
              if g in a.rows and a.window[0] <= g < a.window[1]]
    pick = sorted(_rng(seed).choice(len(starts), min(n, len(starts)),
                                    replace=False)) if starts else []
    gap, inl_gap, flags, compared = 0.0, 0, 0, 0
    with torch.no_grad():
        for i in pick:
            a, g = starts[i]
            st = {k: v.to(circuit.device) for k, v in a.states[g].items()}
            left = circuit.frame(seed, a.first + g)[0]
            with matmul_precision(False):
                ref = track_frame(left, st, cam, cfg)
            if control:         # the reference in TF32, in the program's place
                with matmul_precision(True):
                    c = track_frame(left, st, cam, cfg)
                T, inl = c.T_cw.double().cpu().numpy(), c.n_inliers
                kf, ok = c.needs_keyframe, c.ok
            else:
                row = a.rows[g]
                T, inl = row[:16].reshape(4, 4), int(row[35])
                kf, ok = bool(row[34] > 0.5), bool(row[33] > 0.5)
            inl_gap = max(inl_gap, abs(inl - ref.n_inliers))
            if kf != ref.needs_keyframe or ok != ref.ok:
                flags += 1
                continue
            if not kf:
                R = ref.T_cw.double().cpu().numpy()
                gap = max(gap, float(np.abs(T - R).max()))
                compared += 1
    return {"track_pose_gap": gap, "track_inlier_gap": inl_gap,
            "track_flag_mismatch": flags, "track_frames": len(pick),
            "track_poses_compared": compared}


def keyframe_numbers(sessions: List[Artifacts], circuit, cfg: dict,
                     seed: int, n: int) -> dict:
    inside = [(a, j) for a in sessions for j in np.flatnonzero(
        (a.keyframes["frame_id"] >= a.window[0]) &
        (a.keyframes["frame_id"] < a.window[1]))]
    if not inside:
        return {"kf_frames": 0}
    pick = [inside[i] for i in sorted(_rng(seed + 1).choice(
        len(inside), min(n, len(inside)), replace=False))]
    cam = geo.Camera.from_config(cfg["camera"], circuit.device)
    feat_bad = stereo_bad = slots = 0
    rel: List[np.ndarray] = []
    with torch.no_grad(), matmul_precision(False):
        for a, j in pick:
            kf, mp = a.keyframes, a.mappoints
            g = int(kf["frame_id"][j])
            left, right = circuit.frame(seed, a.first + g)
            f = ref_ext.extract(left, cfg["extractor"])
            rxn, has = ref_stereo.keyframe_stereo(
                left, right, f.xy, f.valid, cam, cfg["matcher"])
            valid = f.valid.cpu().numpy()
            xy, desc = f.xy.cpu().numpy(), f.desc.cpu().numpy()
            pv = kf["kpt_valid"][j]
            same = (valid == pv) & (~valid | (
                np.all(xy == kf["xy"][j], axis=1) &
                np.all(desc == kf["desc"][j].reshape(-1, 8), axis=1)))
            feat_bad += int(np.sum(~same))
            slots += len(valid)
            has_np, rxn_np = has.cpu().numpy(), rxn.cpu().numpy()
            st_same = (has_np == kf["has_stereo"][j]) & (
                ~has_np | (rxn_np == kf["right_x_norm"][j]))
            stereo_bad += int(np.sum(~st_same))
            # the z-depth of this keyframe's own mappoints against the
            # rendered depth at their keypoints
            mine = mp["ref_kf"] == kf["slot"][j]
            if np.any(mine):
                _, depth = synthetic.render_view(
                    circuit.world(), circuit.pose(g), return_depth=True)
                px = kf["xy"][j][mp["kpt"][mine]]
                x = np.clip(np.rint(px[:, 0]).astype(int), 0,
                            depth.shape[1] - 1)
                y = np.clip(np.rint(px[:, 1]).astype(int), 0,
                            depth.shape[0] - 1)
                z_gt = depth[y, x].astype(np.float64)
                z = 1.0 / np.maximum(mp["invd"][mine].astype(np.float64),
                                     1e-3)
                ok = z_gt > 0
                rel.append(np.abs(z[ok] - z_gt[ok]) / z_gt[ok])
    out = {"kf_frames": len(pick),
           "kf_feature_mismatch": feat_bad / max(slots, 1),
           "kf_stereo_mismatch": stereo_bad / max(slots, 1)}
    if rel:
        out["mp_depth_err"] = float(np.median(np.concatenate(rel)))
    return out


def relative_errors(art: Artifacts, circuit, span: int) -> List[float]:
    """For each window frame g of a session, the translation gap between
    the program's motion from frame g - span to g and the ground
    truth's."""
    g0, g1 = art.window
    errs = []
    for g in range(max(g0, span), g1):
        if g not in art.rows or (g > span and g - span not in art.rows):
            continue
        D = _pose(art, g) @ np.linalg.inv(_pose(art, g - span))
        D_gt = circuit.pose(g).astype(np.float64) @ np.linalg.inv(
            circuit.pose(g - span).astype(np.float64))
        errs.append(float(np.linalg.norm((D @ np.linalg.inv(D_gt))[:3, 3])))
    return errs


def motion_numbers(sessions: List[Artifacts], circuit, span: int) -> dict:
    step = [e for a in sessions for e in relative_errors(a, circuit, 1)]
    if not step:
        return {}
    out = {"motion_err_m": max(step),
           "motion_err_p50_m": float(np.median(step))}
    chunk = [e for a in sessions for e in relative_errors(a, circuit, span)]
    if chunk:
        out["chunk_motion_err_p50_m"] = float(np.median(chunk))
    return out


def judge(sessions: List[Artifacts], circuit, cfg_doc: dict, traffic: dict,
          seed: int, control: bool = False) -> dict:
    """Every number the cell compares, by name, over a run's sessions."""
    cfg = cfg_doc["slam"]
    n_track = int(traffic["check"]["track_frames"])
    n_kf = int(traffic["check"]["keyframes"])
    out = {"rows_missing": sum(a.handed - a.returned for a in sessions),
           "drives": len(sessions)}
    out.update(track_numbers(sessions, circuit, cfg, seed, n_track, control))
    out.update(keyframe_numbers(sessions, circuit, cfg, seed, n_kf))
    out.update(motion_numbers(sessions, circuit,
                              int(cfg_doc["engine"]["chunk_size"])))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, op, limit)]): every limited number within
    its limit ("max": at most, "min": at least); a limited number the
    run did not produce fails."""
    lines, correct = [], True
    for name, lim in limits.items():
        v = numbers.get(name)
        op, bound = ("<=", lim["max"]) if "max" in lim else (">=", lim["min"])
        good = v is not None and not (isinstance(v, float) and math.isnan(v))\
            and (v <= bound if op == "<=" else v >= bound)
        correct &= bool(good)
        lines.append((name, v, op, bound))
    return correct, lines
