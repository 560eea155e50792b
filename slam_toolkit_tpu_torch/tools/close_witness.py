"""The loop bench's first closure, re-run by the port from the JAX
engine's state.

    python -m slam_toolkit_tpu_torch.tools.close_witness DUMP.npz \
        --cache DIR [--device cpu]

DUMP.npz is what `port_reference/jax_f32_loop.py --dump` writes at the
fold where the JAX engine applies its first closure: the carry and map
before it, the closure's inputs (slot, candidate, relative pose, scale,
inliers, the pose graph's loop edges and tier), the corrected map, the
carry the next chunk starts from and that chunk's packed rows. DIR is
the loop bench's cache (tools/bench.stage_loop_frames) whose frames and
vocabulary the JAX run read.

From the JAX engine's state before the closure, the port runs its own
close (pose graph, merge: pipeline/engine.SlamEngine._dispatch_close),
rebuilds the carry as its chunked engine does after a closure, and runs
the next chunk with its frame body. It compares:

- the corrected keyframe poses (valid slots), against the JAX map's;
- the merged landmarks: the mappoint validity mask, and the world
  positions of the mappoints both maps keep;
- the re-driven rows: slot, ok and keyframe flags, inliers and pose.

As a control it also runs the same chunk from the JAX engine's own
post-closure carry, so a difference in the rows can be told apart from
a difference in the close. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import types

import numpy as np
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.loop import vocab as V
from slam_toolkit_tpu_torch.loop.closer import RelPoseResult
from slam_toolkit_tpu_torch.mapping.map_state import MapState
from slam_toolkit_tpu_torch.pipeline import scan_engine
from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine, full_float32
from slam_toolkit_tpu_torch.tools import bench
from slam_toolkit_tpu_torch.utils import convert


def _group(d, prefix: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{k[len(prefix):]: d[k] for k in d.files
                                    if k.startswith(prefix)})


def _carry(m, c, device):
    """The port's ChunkCarry from a dumped map and carry fields (the
    photometric fields the indirect tracker leaves out stay None)."""
    fields = {f: getattr(c, f, None) for f in scan_engine.ChunkCarry._fields
              if f != "m"}
    return convert.carry_from_numpy(types.SimpleNamespace(m=m, **fields),
                                    device)


def mappoints_world(m) -> np.ndarray:
    """(M, 3) world positions of the anchored inverse-depth mappoints
    (ref src/mappoint.cpp:128-138), in float64 from the map's arrays."""
    T = np.asarray(m.kf_T_cw, np.float64)[np.asarray(m.mp_ref_kf)]
    uv = np.asarray(m.kf_norm, np.float64)[np.asarray(m.mp_ref_kf),
                                           np.asarray(m.mp_kpt)]
    Xc = np.concatenate([uv, np.ones_like(uv[:, :1])], axis=1) \
        / np.asarray(m.mp_invd, np.float64)[:, None]
    R, t = T[:, :3, :3], T[:, :3, 3]
    return np.einsum("nji,nj->ni", R, Xc - t)


def _numpy_map(m: MapState) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{f: convert.to_numpy(f, getattr(m, f))
                                    for f in MapState._fields})


def compare_maps(port, jax_m) -> dict:
    """Keyframe poses on the slots valid in both; mappoint masks; world
    positions of the mappoints valid in both."""
    kv = np.asarray(port.kf_valid) & np.asarray(jax_m.kf_valid)
    Tp = np.asarray(port.kf_T_cw)[kv]
    Tj = np.asarray(jax_m.kf_T_cw)[kv]
    dc = np.linalg.norm(scan_centres(Tp) - scan_centres(Tj), axis=1)
    mv_p, mv_j = np.asarray(port.mp_valid), np.asarray(jax_m.mp_valid)
    both = mv_p & mv_j
    dX = np.linalg.norm(mappoints_world(port)[both]
                        - mappoints_world(jax_m)[both], axis=1)
    return {"kf_valid_equal": bool(np.array_equal(port.kf_valid,
                                                  jax_m.kf_valid)),
            "kf_compared": int(kv.sum()),
            "kf_centre_diff_max_m": float(dc.max()),
            "kf_centre_diff_median_m": float(np.median(dc)),
            "kf_T_diff_max": float(np.abs(Tp - Tj).max()),
            "mp_valid_port": int(mv_p.sum()), "mp_valid_jax": int(mv_j.sum()),
            "mp_valid_differ": int((mv_p != mv_j).sum()),
            "mp_X_diff_max_m": float(dX.max()) if len(dX) else 0.0,
            "mp_X_diff_p99_m": float(np.percentile(dX, 99))
            if len(dX) else 0.0,
            "mp_X_diff_median_m": float(np.median(dX)) if len(dX) else 0.0}


def scan_centres(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def compare_rows(port: np.ndarray, jax_rows: np.ndarray) -> dict:
    """The re-driven rows held to slot, ok and keyframe flags exactly,
    inliers to 2 and camera centres to 2e-3 m."""
    n = min(len(port), len(jax_rows))
    p, j = port[:n], jax_rows[:n]
    dc = np.linalg.norm(scan_centres(p[:, :16].reshape(-1, 4, 4))
                        - scan_centres(j[:, :16].reshape(-1, 4, 4)), axis=1)
    flags = np.array_equal(p[:, 32:35], j[:, 32:35])
    dinl = np.abs(p[:, 35] - j[:, 35])
    first = np.flatnonzero((np.abs(p[:, 32:35] - j[:, 32:35]).sum(1) > 0)
                           | (dinl > 2) | (dc > 2e-3))
    return {"frames": n, "flags_equal": bool(flags),
            "inliers_diff_max": int(dinl.max()),
            "centre_diff_max_m": float(dc.max()),
            "within_bars": bool(flags and dinl.max() <= 2
                                and dc.max() <= 2e-3),
            "first_apart": int(first[0]) if len(first) else None,
            "port_inliers": p[:, 35].astype(int).tolist(),
            "jax_inliers": j[:, 35].astype(int).tolist(),
            "port_kf": p[:, 34].astype(int).tolist(),
            "jax_kf": j[:, 34].astype(int).tolist()}


def _run_chunk(carry, frames: torch.Tensor, cfg, cam) -> np.ndarray:
    body = scan_engine.make_frame_body(cfg, cam)
    rows = []
    for i in range(frames.shape[0]):
        carry, packed = body(carry, frames[i, 0], frames[i, 1])
        rows.append(packed)
    return torch.stack(rows).cpu().numpy()


@full_float32()
def witness(dump: str, cache: str, device="cuda") -> dict:
    device = torch.device(device)
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera, device)
    d = np.load(dump)
    pre_m, post_m = _group(d, "pre_m_"), _group(d, "post_m_")
    pre_c, post_c = _group(d, "pre_c_"), _group(d, "post_c_")
    base = bench.loop_cache_base(cfg, 320, 16, "clothoid", cache)
    voc = V.load_dbow2_text(base + ".vocab.txt")

    # the port's close from the JAX engine's state before it
    h = SlamEngine(cfg, cam, voc, device, own_map=False)
    h.map = convert.map_state_from_numpy(pre_m, device)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    h.closed_i, h.closed_j = t(d["closed_i"]), t(d["closed_j"])
    h.closed_T, h.closed_valid = t(d["closed_T"]), t(d["closed_valid"])
    h.closed_w = t(d["closed_w"])
    h.n_closed = int(d["n_closed"])
    h.n_keyframes = int(d["n_keyframes"])
    h._n_kf_valid_host = int(d["n_kf_valid"])
    tier = h._close_tier()
    rel = RelPoseResult(T_cw=t(d["rel_T"]), n_inliers=t(d["rel_n"]),
                        ok=t(True), scale=t(d["rel_scale"]),
                        n_near=t(d["vals"][19]))
    slot, cand = int(d["slot"]), int(d["cand"])
    h._dispatch_close(slot, cand, rel, int(d["fid"]), int(d["fid_cand"]),
                      np.asarray(d["vals"]), h.n_keyframes)
    closed = compare_maps(_numpy_map(h.map), post_m)

    # the carry as the port's chunked engine rebuilds it after a closure
    pre = _carry(pre_m, pre_c, device)
    lm, latest_T, counts = h._snapshot(h.map)
    carry = pre._replace(
        m=h.map, lm_Xw=lm[0], lm_desc=lm[1], lm_ids=lm[2], lm_valid=lm[3],
        latest_slot=counts[0], latest_T=latest_T,
        T_cw=se3.compose(se3.compose(pre.T_cw, se3.inv(pre.latest_T)),
                         latest_T),
        inlier_peak=torch.zeros_like(pre.inlier_peak))
    jax_post = _carry(post_m, post_c, device)
    f0 = int(post_c.frame_id)
    rows_j = np.asarray(d["rows"])
    stacked = np.load(base + ".npy", mmap_mode="r")
    frames = torch.from_numpy(np.array(stacked[f0:f0 + len(rows_j)])).to(
        device, torch.float32)
    carry_diff = {
        "T_cw_diff_max": float((carry.T_cw - jax_post.T_cw).abs().max()),
        "latest_slot_equal": int(carry.latest_slot) ==
        int(jax_post.latest_slot),
        "lm_ids_equal": bool(torch.equal(carry.lm_ids, jax_post.lm_ids)),
        "lm_valid_equal": bool(torch.equal(carry.lm_valid,
                                           jax_post.lm_valid)),
        "frame_id_equal": carry.frame_id == jax_post.frame_id}
    rows_port = _run_chunk(carry, frames, cfg, cam)
    rows_ctrl = _run_chunk(_carry(post_m, post_c, device), frames, cfg,
                           cam)
    return {"dump": os.path.basename(dump), "device": str(device),
            "closure": {"frame": int(d["fid"]), "fid_cand": int(d["fid_cand"]),
                        "slot": slot, "cand": cand,
                        "inliers": int(d["rel_n"]),
                        "tier_port": tier, "tier_jax": int(d["tier"])},
            "close": closed, "carry": carry_diff,
            "rows_from_port_close": compare_rows(rows_port, rows_j),
            "rows_from_jax_carry": compare_rows(rows_ctrl, rows_j),
            "first_frame": f0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump", help="port_reference/jax_f32_loop.py --dump")
    ap.add_argument("--cache", required=True,
                    help="the loop bench's cache directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = witness(args.dump, args.cache, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
