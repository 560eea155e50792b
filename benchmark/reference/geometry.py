"""SE(3) and the pinhole camera, plain PyTorch.

Poses are (..., 4, 4) float32 world-to-camera matrices, twists (..., 6)
are [rho, phi], updates multiply on the left (T_new = exp(xi) @ T). The
camera holds 0-dim float32 intrinsics, so products of them round in
float32. Frozen copy of the port's geometry at the benchmark's start.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_coeffs(theta2: torch.Tensor):
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / t2_safe)
    return a, b, c


def so3_log(R: torch.Tensor) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    small = theta < 1e-4
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(small, torch.ones_like(theta),
                                            torch.sin(theta)))
    return w * scale[..., None]


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    rho, phi = xi[..., :3], xi[..., 3:]
    a, b, c = _so3_coeffs(torch.sum(phi * phi, dim=-1))
    W = hat(phi)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return make(R, (V @ rho[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(T[..., :3, :3])
    theta2 = torch.sum(phi * phi, dim=-1)
    W = hat(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    small = theta2 < 1e-2
    half = 0.5 * torch.sqrt(torch.where(small, torch.ones_like(theta2),
                                        theta2))
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - half / torch.tan(half)) / torch.where(
            small, torch.ones_like(theta2), theta2))
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    rho = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One (4, 4) pose applied to (N, 3) points: X @ R^T + t."""
    return X @ T[:3, :3].T + T[:3, 3]


def normalize(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)
    y = R[..., :, 1]
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + _EPS)
    z = torch.linalg.cross(x, y, dim=-1)
    return make(torch.stack([x, y, z], dim=-1), T[..., :3, 3])


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor      # (4,) [k1, k2, p1, p2]
    baseline: torch.Tensor
    width: int
    height: int

    @staticmethod
    def from_config(c: dict, device) -> "Camera":
        """From a configuration file's "camera" section."""
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        return Camera(fx=f32(c["fx"]), fy=f32(c["fy"]), cx=f32(c["cx"]),
                      cy=f32(c["cy"]),
                      dist=f32([c["k1"], c["k2"], c["p1"], c["p2"]]),
                      baseline=f32(c["baseline"]), width=int(c["width"]),
                      height=int(c["height"]))


def distort(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = cam.dist[0], cam.dist[1], cam.dist[2], cam.dist[3]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: Camera, xd: torch.Tensor,
                         iters: int = 5) -> torch.Tensor:
    k1, k2, p1, p2 = cam.dist[0], cam.dist[1], cam.dist[2], cam.dist[3]
    x0, y0 = xd[..., 0], xd[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def pixel_to_normalized(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    return undistort_normalized(cam, xd)


def project(cam: Camera, Xc: torch.Tensor) -> torch.Tensor:
    z = Xc[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    xn = torch.stack([Xc[..., 0] / zsafe, Xc[..., 1] / zsafe], dim=-1)
    xd = distort(cam, xn)
    return torch.stack([cam.fx * xd[..., 0] + cam.cx,
                        cam.fy * xd[..., 1] + cam.cy], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return ((uv[..., 0] >= 0.0) & (uv[..., 0] < cam.width) &
            (uv[..., 1] >= 0.0) & (uv[..., 1] < cam.height))


def stereo_depth(cam: Camera, x_left: torch.Tensor,
                 x_right: torch.Tensor) -> torch.Tensor:
    disp = x_left - x_right
    valid = disp > 1e-3
    z = cam.fx * cam.baseline / torch.where(valid, disp,
                                            torch.ones_like(disp))
    return torch.where(valid, z, torch.zeros_like(z))
