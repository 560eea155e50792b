"""Checkpoint / resume of the per-frame engine's whole state.

Counterpart of slam_toolkit_tpu/pipeline/checkpoint.py (the reference
designed but disabled a memento pattern, ref src/pipeline.cpp:231-241).
The layout is the JAX package's, so either package reads the other's
files: <path>.npz holds the map's fields as map_<field>, T_cw, velocity,
the trajectory and its anchors, and with a vocabulary the BoW database
(bow_db, or bow_db_words and bow_db_weights for the top-w backend) and
the ring of closed loops; the <path>.json sidecar holds the host
counters, frame_stats and loop_events. Descriptor words are written as
uint32 and the top-w word ids as int32, the JAX types; loading views
them back as the port's int32 words (utils/convert, no bit changes) and
int64 ids. The photometric anchor of the direct tracker and the
consistency tracker's groups are not saved, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from slam_toolkit_tpu_torch.mapping.map_state import MapState
from slam_toolkit_tpu_torch.utils import convert

if TYPE_CHECKING:
    from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine

_CLOSED = ("closed_i", "closed_j", "closed_T", "closed_valid", "closed_w")


def save(engine: "SlamEngine", path: str) -> None:
    """Write the full engine state to <path>.npz (+ .json sidecar)."""
    arrays = {f"map_{k}": convert.to_numpy(k, v)
              for k, v in engine.map._asdict().items()}
    arrays["T_cw"] = engine.T_cw.cpu().numpy()
    arrays["velocity"] = engine.velocity.cpu().numpy()
    arrays["trajectory"] = np.stack(engine.trajectory) if engine.trajectory \
        else np.zeros((0, 4, 4), np.float32)
    if engine._traj_anchor:
        arrays["anchor_slots"] = np.asarray(
            [s for s, _ in engine._traj_anchor], np.int32)
        arrays["anchor_rel"] = np.stack(
            [r for _, r in engine._traj_anchor]).astype(np.float32)
    if engine.vocab is not None:
        if engine._bow_sparse:
            arrays["bow_db_words"] = engine.bow_db.words.cpu().numpy() \
                .astype(np.int32)
            arrays["bow_db_weights"] = engine.bow_db.weights.cpu().numpy()
        else:
            arrays["bow_db"] = engine.bow_db.cpu().numpy()
        for k in _CLOSED:
            arrays[k] = getattr(engine, k).cpu().numpy()
    np.savez_compressed(path, **arrays)
    meta = {"frame_id": engine.frame_id,
            "n_keyframes": engine.n_keyframes,
            "n_closed": getattr(engine, "n_closed", 0),
            "last_closure_nkf": getattr(engine, "_last_closure_nkf",
                                        -(10 ** 9)),
            "closed_pairs": getattr(engine, "_closed_pairs", []),
            "inlier_peak": engine._inlier_peak,
            "frame_stats": engine.frame_stats,
            "loop_events": engine.loop_events}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load(engine: "SlamEngine", path: str) -> "SlamEngine":
    """Restore state saved by save() (this package's or the JAX
    package's) into a compatible engine in place, on its device. The map
    and the ring of closed loops are copied into the engine's own tensors
    (its programs' CUDA graphs read them at their addresses)."""
    path_npz = path if path.endswith(".npz") or not os.path.exists(
        path + ".npz") else path + ".npz"
    dev = engine.device
    z = np.load(path_npz, allow_pickle=False)
    loaded = convert.map_state_from_numpy(
        MapState(**{k[len("map_"):]: z[k] for k in z.files
                    if k.startswith("map_")}), dev)
    if engine.map is None:
        engine.map = loaded
    else:
        for dst, src in zip(engine.map, loaded):
            dst.copy_(src)
    engine.T_cw = torch.from_numpy(z["T_cw"]).to(dev)
    engine.velocity = torch.from_numpy(z["velocity"]).to(dev)
    engine.trajectory = [t for t in z["trajectory"]]
    if "anchor_slots" in z.files:
        engine._traj_anchor = [
            (int(s), r) for s, r in zip(z["anchor_slots"], z["anchor_rel"])]
    if engine.vocab is not None and ("bow_db" in z.files
                                     or "bow_db_words" in z.files):
        # a db of the other backend fails deep inside scoring with an
        # opaque error: name the mismatch instead
        ckpt_sparse = "bow_db_words" in z.files
        if ckpt_sparse != engine._bow_sparse:
            kind = {True: "topw-sparse", False: "dense"}
            raise ValueError(
                f"checkpoint BoW backend mismatch: checkpoint is "
                f"{kind[ckpt_sparse]} but the engine is configured "
                f"{kind[engine._bow_sparse]} (cfg.loop.bow_mode) — load "
                f"with a matching config")
        if ckpt_sparse:
            from slam_toolkit_tpu_torch.loop.vocab import TopWBow
            engine.bow_db = TopWBow(
                words=torch.from_numpy(z["bow_db_words"]).to(dev,
                                                             torch.int64),
                weights=torch.from_numpy(z["bow_db_weights"]).to(dev))
        else:
            engine.bow_db = torch.from_numpy(z["bow_db"]).to(dev)
        for k in _CLOSED:
            if k in z.files:          # older checkpoints lack closed_w
                getattr(engine, k).copy_(torch.from_numpy(z[k]))
    meta_path = (path_npz[:-4] if path_npz.endswith(".npz") else path_npz) \
        + ".json"
    if not os.path.exists(meta_path):
        meta_path = path_npz + ".json"
    with open(meta_path) as f:
        meta = json.load(f)
    engine.frame_id = meta["frame_id"]
    engine.n_keyframes = meta["n_keyframes"]
    engine._inlier_peak = meta.get("inlier_peak", 0.0)
    engine.frame_stats = meta["frame_stats"]
    engine.loop_events = meta["loop_events"]
    if engine.vocab is not None:
        engine.n_closed = meta.get("n_closed", 0)
        engine._last_closure_nkf = meta.get("last_closure_nkf", -(10 ** 9))
        engine._closed_pairs = [tuple(p)
                                for p in meta.get("closed_pairs", [])]
    if engine.n_keyframes > 0:
        engine._refresh_kf_mirrors()
    return engine
