"""Run the port's SLAM engine over a KITTI odometry sequence.

    python -m slam_toolkit_tpu_torch.run_kitti --root /data/kitti --seq 00 \\
        --out /tmp/kitti00 [--vocab voc.txt | --train-vocab] [--classic] \\
        [--device cpu]

Counterpart of slam_toolkit_tpu/run_kitti.py (the reference's
examples/kitti entry point: dataset scan -> Pipeline::Track per stereo
pair -> viewer, ref examples/kitti/src/main.cpp) as a headless CLI. It
drives the chunked engine (pipeline/scan_engine.py), or with --classic
the per-frame engine (pipeline/engine.py SlamEngine.process), on
--device (default the card, which must exist), with BoW loop closing
when a vocabulary is given. It prints one JSON line of stats (frames,
fps, ATE, RPE, keyframes, mappoints, closures) and with --out writes the
trajectory in the KITTI poses format (<seq>.txt, 3x4 T_wc rows),
stats.json (the stats with the last 200 frame_stats and the loop
events), and the plots trajectory.png and map.png where matplotlib is
installed. The fps counts the whole loop, image decoding included:
through OpenCV in the loop, or with --native-loader on the native
prefetch ring's background thread (data/native_loader.py, built at
first use; it raises where it cannot be built).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch


def _auto_config(shape):
    """The SlamConfig matching the sequence's image size."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.data.kitti import kitti_config
    h, w = shape
    if (h, w) == (376, 1241):
        return kitti_config()
    if (h, w) == (96, 128):
        return SlamConfig.tiny()
    raise SystemExit(
        f"no builtin config for {w}x{h} images; standard KITTI is "
        f"1241x376 — pass frames at that size or extend _auto_config")


def vocab_frames(n: int) -> range:
    """The frames of an n-frame sequence whose left images make the
    vocabulary's training corpus: every (n // 40)-th, as the JAX
    runner samples."""
    return range(0, n, max(1, n // 40))


class VocabExtract:
    """The corpus's extract(image, cfg) on a static image buffer: the JAX
    runner's jax.jit(lambda im: extract(im, cfg.extractor)). On a card
    the program is one CUDA graph (utils/cuda_graphs.StepGraphs),
    captured at the first image after a warm-up and replayed for each
    later one; a capture failure raises. graphs=False, and the CPU, run
    the same program eagerly. A call copies the image into the buffer,
    runs the program, reads the descriptors and their validity back in
    one packed copy (as the JAX runner's np.asarray of both) and returns
    the valid descriptors, (n, 8) int32, picked on the host."""

    def __init__(self, cfg, device="cuda", graphs: bool = True):
        from slam_toolkit_tpu_torch.utils.cuda_graphs import StepGraphs
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.graphs = StepGraphs(self.device) \
            if graphs and self.device.type == "cuda" else None
        self._img: Optional[torch.Tensor] = None
        self._packed: Optional[torch.Tensor] = None

    def _program(self) -> torch.Tensor:
        """extract on the image buffer: (K, 9) int32, the packed
        descriptor words and the validity."""
        from slam_toolkit_tpu_torch.ops.extractor import extract
        f = extract(self._img, self.cfg)
        return torch.cat([f.desc, f.valid[:, None].int()], dim=1)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        from slam_toolkit_tpu_torch.pipeline.engine import full_float32
        from slam_toolkit_tpu_torch.utils.device import upload
        with torch.no_grad(), full_float32():
            img = upload(np.asarray(image, np.float32), self.device)
            if self._img is None:
                self._img = torch.empty_like(img)
            self._img.copy_(img)
            if self.graphs is None:
                packed = self._program()
            else:
                if self._packed is None:
                    self.graphs.warm_up(self._program)
                    self._packed = self.graphs.capture("extract",
                                                       self._program)
                self.graphs.replay("extract")
                packed = self._packed
            v = packed.to("cpu", copy=True).numpy()
        return v[v[:, 8] != 0, :8]

    def graph_stats(self) -> Optional[dict]:
        """Captures, capture seconds, pool bytes; None where nothing was
        captured."""
        return None if self.graphs is None or not self.graphs.captures \
            else self.graphs.stats()


def _get_vocab(args, ds, cfg):
    from slam_toolkit_tpu_torch.loop import vocab as V
    if args.vocab:
        return V.load_dbow2_text(args.vocab)
    if not args.train_vocab:
        return None
    ex = VocabExtract(cfg.extractor, args.device)
    corpus = [ex(ds[i][0]) for i in vocab_frames(len(ds))]
    voc = V.train(np.concatenate(corpus), k=10, levels=3, seed=args.seed)
    sys.stderr.write(f"[run_kitti] trained {voc.num_words}-word vocab "
                     f"from {len(corpus)} frames\n")
    return voc


def _save_kitti_poses(path, T_cw_list):
    """The trajectory in the KITTI poses format: 3x4 T_wc rows, the
    inverse of the engine's camera-from-world poses (ref
    src/dataset.cpp:65-85)."""
    rows = []
    for T in T_cw_list:
        T_wc = np.linalg.inv(np.asarray(T, np.float64))
        rows.append(T_wc[:3, :].reshape(-1))
    np.savetxt(path, np.stack(rows), fmt="%.9e")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="KITTI odometry root (default: $KITTI_ROOT)")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=0,
                    help="limit frame count (0 = whole sequence)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per chunk (chunked engine)")
    ap.add_argument("--classic", action="store_true",
                    help="per-frame host-driven engine instead of the "
                         "chunked engine")
    ap.add_argument("--vocab", default=None,
                    help="DBoW2 text vocabulary -> enables loop closing")
    ap.add_argument("--train-vocab", action="store_true",
                    help="train a vocabulary from this sequence")
    ap.add_argument("--native-loader", action="store_true",
                    help="decode PNGs through the native prefetch ring")
    ap.add_argument("--out", default=None,
                    help="output dir (poses txt, plots, stats json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on")
    return ap


def main(argv=None) -> dict:
    """Run the CLI on `argv`; returns the stats it prints."""
    args = parser().parse_args(argv)

    from slam_toolkit_tpu_torch.data.kitti import KittiDataset
    ds = KittiDataset(args.seq, root=args.root)
    n = min(len(ds), args.frames) if args.frames else len(ds)
    cfg = _auto_config(ds[0][0].shape)
    voc = _get_vocab(args, ds, cfg)
    if args.classic:
        from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine
        eng = SlamEngine(cfg, vocab=voc, device=args.device)
    else:
        from slam_toolkit_tpu_torch.pipeline.scan_engine import \
            ChunkedSlamEngine
        eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=args.chunk,
                                device=args.device)
    loader = ds.prefetch_loader(height=cfg.camera.height,
                                width=cfg.camera.width) \
        if args.native_loader else None
    frames = (ds[i] for i in range(n)) if loader is None else \
        (pair for _, pair in zip(range(n), loader))

    t0 = time.perf_counter()
    if args.classic:
        for i, (left, right) in enumerate(frames):
            eng.process(left, right)
            if (i + 1) % 100 == 0:
                sys.stderr.write(f"[run_kitti] {i + 1}/{n}\n")
    else:
        buf, done = [], 0
        for left, right in frames:
            buf.append(np.stack([left, right]))
            if len(buf) == args.chunk:
                eng.process_chunk(np.stack(buf))
                done += len(buf)
                buf = []
                if done % (args.chunk * 8) == 0:
                    sys.stderr.write(f"[run_kitti] {done}/{n}\n")
        if buf:
            eng.process_chunk(np.stack(buf))
        eng.flush()
    dt = time.perf_counter() - t0
    if loader is not None:
        loader.close()

    traj = eng.trajectory_refined()
    closures = [e for e in eng.loop_events if "cand" in e]
    stats = {
        "sequence": args.seq, "frames": len(traj),
        "fps": round(len(traj) / dt, 2),
        "keyframes": eng.n_keyframes,
        "mappoints": int(eng.map.mp_valid.sum()),
        "loop_closures": len(closures),
    }
    gt = ds.ground_truth()
    if gt:
        from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse, rpe
        gt = gt[:len(traj)]
        stats["ate_rmse_m"] = round(float(ate_rmse(traj, gt,
                                                   align=True)), 4)
        rt, rr = rpe(traj, gt)
        stats["rpe_trans_m"] = round(float(rt), 4)
        stats["rpe_rot_deg"] = round(float(rr) * 57.29578, 4)
    print(json.dumps(stats))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        _save_kitti_poses(os.path.join(args.out, f"{args.seq}.txt"), traj)
        with open(os.path.join(args.out, "stats.json"), "w") as f:
            json.dump({**stats, "frame_stats": eng.frame_stats[-200:],
                       "loop_events": eng.loop_events}, f, indent=2)
        if importlib.util.find_spec("matplotlib") is None:
            sys.stderr.write("[run_kitti] matplotlib is not installed: "
                             "trajectory.png and map.png not written\n")
        else:
            from slam_toolkit_tpu_torch.evaluation import viz
            viz.plot_trajectory(traj, gt or None,
                                path=os.path.join(args.out,
                                                  "trajectory.png"))
            viz.plot_map_topdown(eng.map,
                                 path=os.path.join(args.out, "map.png"))
        sys.stderr.write(f"[run_kitti] wrote {args.out}\n")
    return stats


if __name__ == "__main__":
    main()
