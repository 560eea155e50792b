"""The benchmark's stereo world, renderer and closed track (numpy).

Textured planes (two walls, the ground, and for a box room two end
walls), each with its own mip-mapped block texture, raycast per pixel:
left, right and consecutive frames are exact projections of one static
world, and `render_view(..., return_depth=True)` gives the ground-truth
z-depth of every pixel. `loop_track` is a closed track of four clothoid
corners whose closure error is spread along it, so that pose n lands on
pose 0 and replaying its frames cyclically is a continuous drive.
Frozen copy of the port's data/synthetic.py (make_world, render_view,
render_stereo, loop_track and their helpers), with the camera taken
from a configuration file's "camera" section.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference import geometry as geo


class PlaneWorld(NamedTuple):
    cam: dict                # a configuration's "camera" section
    plane_mips: tuple        # one mip pyramid per plane
    texels_per_m: float
    half_width: float        # walls at x = +/- half_width
    ground_y: float          # ground plane at y = ground_y (y points down)
    half_length: float = 0.0  # > 0: end walls at z = +/- half_length


def _smooth_noise(size: int, cells: int, amp: float, rng) -> np.ndarray:
    g = rng.uniform(-amp, amp, (cells + 1, cells + 1)).astype(np.float32)
    idx = np.linspace(0, cells - 1e-6, size)
    i0 = idx.astype(np.int64)
    f = (idx - i0).astype(np.float32)
    rows = g[i0, :] * (1 - f)[:, None] + g[i0 + 1, :] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]


def _block_texture(size: int, cell: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(30.0, 220.0, (size // cell, size // cell))
    tex = np.kron(coarse, np.ones((cell, cell))).astype(np.float32)
    fine = rng.uniform(-20.0, 20.0, (size // 2, size // 2))
    tex += np.kron(fine, np.ones((2, 2))).astype(np.float32)[:size, :size]
    tex += _smooth_noise(size, 16, 35.0, rng)
    return np.clip(tex, 0.0, 255.0)


def _mip_pyramid(tex: np.ndarray, levels: int = 8) -> tuple:
    mips = [tex]
    t = tex
    for _ in range(levels - 1):
        if t.shape[0] < 2:
            break
        t = 0.25 * (t[0::2, 0::2] + t[1::2, 0::2] + t[0::2, 1::2]
                    + t[1::2, 1::2])
        mips.append(t.astype(np.float32))
    return tuple(mips)


def make_world(cam: dict, seed: int, half_width: float, ground_y: float,
               tex_size: int, texels_per_m: float,
               half_length: float = 0.0) -> PlaneWorld:
    mips = tuple(_mip_pyramid(_block_texture(tex_size, 8, seed * 31 + i))
                 for i in range(5))
    return PlaneWorld(cam=cam, plane_mips=mips, texels_per_m=texels_per_m,
                      half_width=half_width, ground_y=ground_y,
                      half_length=half_length)


def _sample_bilinear(tex, u, v):
    t = tex.shape[0]
    u = np.mod(u, t)
    v = np.mod(v, t)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0).astype(np.float32)
    fv = (v - v0).astype(np.float32)
    u1 = (u0 + 1) % t
    v1 = (v0 + 1) % t
    return ((tex[v0, u0] * (1 - fu) + tex[v0, u1] * fu) * (1 - fv) +
            (tex[v1, u0] * (1 - fu) + tex[v1, u1] * fu) * fv)


def _sample_tex(mips, u, v, footprint):
    """Trilinear mip-mapped lookup; footprint = base texels a pixel
    covers."""
    lod = np.clip(np.log2(np.maximum(footprint, 1e-6)), 0.0,
                  len(mips) - 1.001)
    l0 = np.floor(lod).astype(np.int64)
    fl = (lod - l0).astype(np.float32)
    out = np.empty(u.shape, np.float32)
    for lev in range(len(mips) - 1):
        sel = l0 == lev
        if not sel.any():
            continue
        scale = 0.5 ** lev
        a = _sample_bilinear(mips[lev], u[sel] * scale, v[sel] * scale)
        b = _sample_bilinear(mips[lev + 1], u[sel] * scale * 0.5,
                             v[sel] * scale * 0.5)
        out[sel] = a * (1 - fl[sel]) + b * fl[sel]
    return out


def render_view(world: PlaneWorld, T_cw: np.ndarray,
                return_depth: bool = False):
    """Raycast one camera with pose T_cw (world to camera): the grey
    image, and with return_depth the z-depth of every pixel (0: sky)."""
    cam = world.cam
    h, w = int(cam["height"]), int(cam["width"])
    R = T_cw[:3, :3].astype(np.float64)
    t = T_cw[:3, 3].astype(np.float64)
    origin = -R.T @ t
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    d_cam = np.stack([(uu - cam["cx"]) / cam["fx"],
                      (vv - cam["cy"]) / cam["fy"],
                      np.ones_like(uu, np.float64)], axis=-1)
    d_w = d_cam @ R
    tpm = world.texels_per_m
    best_t = np.full((h, w), np.inf)
    img = np.full((h, w), 30.0, np.float32)               # sky
    planes = [(0, -world.half_width, 2, 1), (0, world.half_width, 2, 1),
              (1, world.ground_y, 2, 0)]
    if world.half_length > 0.0:
        planes += [(2, -world.half_length, 0, 1),
                   (2, world.half_length, 0, 1)]
    d_norm = np.linalg.norm(d_w, axis=-1)
    for plane_idx, (axis, off, ua, va) in enumerate(planes):
        dn = d_w[..., axis]
        with np.errstate(divide='ignore', invalid='ignore'):
            ti = (off - origin[axis]) / dn
            hit = (ti > 0.1) & np.isfinite(ti) & (ti < best_t)
            if not hit.any():
                continue
            pt = origin[None, None, :] + np.where(
                np.isfinite(ti), ti, 0.0)[..., None] * d_w
        cosi = np.abs(dn[hit]) / d_norm[hit]
        rng = ti[hit] * d_norm[hit]
        footprint = tpm * rng / (cam["fx"] * np.maximum(cosi, 0.05))
        val = _sample_tex(world.plane_mips[plane_idx], pt[..., ua][hit] * tpm,
                          pt[..., va][hit] * tpm, footprint)
        img[hit] = np.clip(val, 0.0, 255.0)
        best_t[hit] = ti[hit]
    if return_depth:
        depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
        return img, depth
    return img


def right_pose(T_cw: np.ndarray, baseline: float) -> np.ndarray:
    T = T_cw.copy()
    T[0, 3] -= baseline
    return T


def render_stereo(world: PlaneWorld,
                  T_cw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (render_view(world, T_cw),
            render_view(world, right_pose(T_cw, world.cam["baseline"])))


def render_uint8(world: PlaneWorld, T_cw: np.ndarray) -> np.ndarray:
    """(2, H, W) uint8 stereo pair, rounded to the nearest grey level as
    an 8-bit camera stores it."""
    pair = np.stack(render_stereo(world, T_cw))
    return np.clip(np.rint(pair), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (lib.sinf, lib.cosf):
        fn.argtypes = [ctypes.c_float]
        fn.restype = ctypes.c_float
    return lib


def _step_transform(step: float, yaw_rate: float) -> np.ndarray:
    """SE3 exponential of the twist [0, 0, step, 0, yaw_rate, 0] in
    float32."""
    f = np.float32
    phi = np.array([0.0, yaw_rate, 0.0], f)
    rho = np.array([0.0, 0.0, step], f)
    theta2 = np.sum(phi * phi, dtype=f)
    theta = np.sqrt(np.maximum(theta2, f(1e-8) * f(1e-8)))
    if theta2 < 1e-8:
        a = f(1.0) - theta2 / f(6.0)
        b = f(0.5) - theta2 / f(24.0)
        c = f(1.0) / f(6.0) - theta2 / f(120.0)
    else:
        lib = _libm()
        a = f(lib.sinf(theta)) / theta
        b = (f(1.0) - f(lib.cosf(theta))) / theta2
        c = (f(1.0) - a) / theta2
    W = np.array([[0.0, -phi[2], phi[1]], [phi[2], 0.0, -phi[0]],
                  [-phi[1], phi[0], 0.0]], f)
    WW = W @ W
    eye = np.eye(3, dtype=f)
    T = np.eye(4, dtype=f)
    T[:3, :3] = eye + a * W + b * WW
    T[:3, 3] = (eye + b * W + c * WW) @ rho
    return T


def _close_track(raw: List[np.ndarray], T_wc_end: np.ndarray
                 ) -> List[np.ndarray]:
    """T'_t = normalize(T_t . exp(-(t/N) log(T_N))): pose N lands on
    pose 0."""
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    xi = geo.log(f32(np.linalg.inv(T_wc_end))).numpy()
    n = len(raw)
    return [geo.normalize(f32(T @ geo.exp(f32(-xi * (t / n))).numpy()))
            .numpy() for t, T in enumerate(raw)]


def loop_track(n_track: int, step: float, ramp: int) -> List[np.ndarray]:
    """T_cw of each frame of a closed track of n_track frames: four pi/2
    corners with linearly ramped yaw rate, straights between, centred on
    the world origin."""
    per_corner = n_track // 4
    hold = max(per_corner - 2 * ramp - 8, 4)
    straight = per_corner - 2 * ramp - hold
    prof = ([0.0] * straight + list(np.linspace(0, 1, ramp, endpoint=False))
            + [1.0] * hold + list(np.linspace(1, 0, ramp, endpoint=False)))
    dyaw = np.array((prof * 4)[:n_track], np.float64)
    dyaw = dyaw * (2.0 * np.pi / dyaw.sum())
    T_wc = np.eye(4, dtype=np.float32)
    raw = []
    for t in range(n_track):
        raw.append(np.linalg.inv(T_wc).astype(np.float32))
        T_wc = (T_wc @ _step_transform(step, float(dyaw[t]))) \
            .astype(np.float32)
    out = _close_track(raw, T_wc)
    c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in out])
    mid = (c.min(axis=0) + c.max(axis=0)) / 2.0
    mid[1] = 0.0
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = mid
    return [(T @ shift).astype(np.float32) for T in out]
