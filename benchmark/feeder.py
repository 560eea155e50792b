"""The camera: one lap of a closed circuit, replayed lap after lap.

The lap is rendered once (reference/synthetic.py, in spawned worker
processes) into uint8 stereo pairs and cached under the benchmark's
cache directory, under a name made from the camera and the traffic's
track and world. A run reads the cache, moves the lap to the device,
and hands the engine chunks of consecutive frames taken cyclically:
run frame G is lap frame G % n of lap G // n (a drive of whole laps
starts at lap frame 0). Every lap gets fresh sensor noise, uniform
integers in [-noise_levels, noise_levels] grey levels added and clipped
to 0..255, drawn on the device from (seed, lap, frame) with a generator
of its own, so revisits are never pixel-identical and the seed changes
the inputs, not the work.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference import synthetic

_MASK64 = (1 << 64) - 1
_RENDER_WORLD = None


def frame_seed(seed: int, lap: int, index: int) -> int:
    """A 63-bit generator seed from (seed, lap, frame of the lap)
    (splitmix64 steps: any seed up to 64 bits)."""
    h = 0x9E3779B97F4A7C15
    for v in (seed, lap, index):
        h = ((h ^ (v & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h & ((1 << 63) - 1)


def _init_worker(world_kw: dict) -> None:
    global _RENDER_WORLD
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"
    _RENDER_WORLD = synthetic.make_world(**world_kw)


def _render_one(T: np.ndarray) -> np.ndarray:
    return synthetic.render_uint8(_RENDER_WORLD, T)


def render_lap(world_kw: dict, poses: List[np.ndarray],
               workers: int) -> np.ndarray:
    """(n, 2, H, W) uint8 frames of `poses`; in this process when
    workers <= 1, else in a pool of spawned workers, closed before
    returning."""
    if workers <= 1:
        _init_worker(world_kw)
        return np.stack([_render_one(T) for T in poses])
    with mp.get_context("spawn").Pool(
            workers, initializer=_init_worker, initargs=(world_kw,)) as pool:
        return np.stack(pool.map(_render_one, poses, chunksize=1))


class Circuit:
    """The lap's frames on `device` and its ground truth, from a
    configuration's "camera" section and a traffic file."""

    def __init__(self, cam: dict, traffic: dict, cache_dir: Path, device,
                 log=lambda msg: None):
        self.cam = cam
        self.device = torch.device(device)
        track = traffic["track"]
        self.n = int(track["frames_per_lap"])
        self.noise = int(traffic["noise_levels"])
        self.world_kw = dict(cam=cam, **traffic["world"])
        key = json.dumps({"cam": cam, "track": track,
                          "world": traffic["world"]}, sort_keys=True)
        self.name = "lap_" + hashlib.sha256(key.encode()).hexdigest()[:16]
        base = Path(cache_dir) / self.name
        self.poses = synthetic.loop_track(self.n, float(track["step_m"]),
                                          int(track["ramp"]))
        t0 = time.perf_counter()
        if not (base.with_suffix(".npy")).exists():
            workers = min(self.n, os.cpu_count() or 1) \
                if cam["width"] * cam["height"] * self.n >= 2 ** 22 else 1
            frames = render_lap(self.world_kw, self.poses, workers)
            base.parent.mkdir(parents=True, exist_ok=True)
            tmp = base.with_name(f"{self.name}.{os.getpid()}.tmp.npy")
            np.save(tmp, frames)
            os.replace(tmp, base.with_suffix(".npy"))
            log(f"rendered {self.n} frames in "
                f"{time.perf_counter() - t0:.1f} s into {base}.npy")
        self.frames = torch.from_numpy(np.load(base.with_suffix(".npy"))).to(
            self.device)
        self._gen = torch.Generator(device=self.device)
        self._world = None

    def world(self) -> synthetic.PlaneWorld:
        """The rendered world (built at the first call)."""
        if self._world is None:
            self._world = synthetic.make_world(**self.world_kw)
        return self._world

    def _noisy(self, seed: int, g: int) -> torch.Tensor:
        """Drive frame g as int16 on the device."""
        lap, i = divmod(g, self.n)
        base = self.frames[i].to(torch.int16)
        if self.noise == 0:
            return base
        self._gen.manual_seed(frame_seed(seed, lap, i))
        return base + torch.randint(-self.noise, self.noise + 1, base.shape,
                                    generator=self._gen, device=self.device,
                                    dtype=torch.int16)

    def chunk(self, seed: int, g0: int, n: int) -> torch.Tensor:
        """(n, 2, H, W) float32 frames g0 .. g0 + n - 1 of the drive."""
        return torch.stack([self._noisy(seed, g) for g in range(g0, g0 + n)]
                           ).clamp_(0, 255).to(torch.float32)

    def frame(self, seed: int, g: int) -> torch.Tensor:
        """(2, H, W) float32 drive frame g, as the engine was handed it."""
        return self._noisy(seed, g).clamp_(0, 255).to(torch.float32)

    def pose(self, g: int) -> np.ndarray:
        """Ground-truth T_cw (world to camera) of drive frame g."""
        return self.poses[g % self.n]

    def lap_left(self, i: int, device: Optional[str] = None) -> torch.Tensor:
        """The noise-free left image of lap frame i, float32."""
        return self.frames[i, 0].to(device or self.device, torch.float32)
