"""Direct photometric pose alignment: 8-DoF (SE3 + affine brightness) LM.

Counterpart of slam_toolkit_tpu/optim/direct_lm.py (ref
BrightenDirectPoseTracker, src/posetracker.cpp:250-353; the 8-point
pattern of src/optimizer.cpp:39-57). State (T_cw, a, b) with the
brightness model e^-a (I - b); the residual per landmark and pattern
offset is r = e^-a (I(pi(T Xw) + d_k) - b) - ref_k.

Every sample a landmark needs lies in one 8x8 window around its
projection, cut by ops/patches.gather_blocks: on the card that launch is
the hand-written gather kernel (csrc/patch_gather.cu), on the CPU its
plain version. The window is resampled into shifted 7x7 bilinear grids
from which the pattern intensities and their +-0.5 px central
differences are read at fixed taps. The LM runs a fixed number of
iterations with accept/reject as device-side selects, so it never waits
on the host.

Every function here computes over a leading lane axis (B lanes: images
(B, H, W), landmarks (B, N, 3), a DirectState of (B, 4, 4), (B,) and
(B,); the JAX package's vmapped calls); one sequence's call is the batch
of one lane (utils/lanes.with_lane) on its (H, W) image. The windows of
all lanes come from one batched gather launch (patches.gather_blocks;
one image's from its single launch) and the per-landmark arithmetic runs
once over the lanes, while the pose algebra, every sum over the
landmarks (the normal equations, the cost) and the 8x8 solve run lane
by lane, so each lane rounds as its single call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from slam_toolkit_tpu_torch.geometry import camera as cam_mod
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import Camera
from slam_toolkit_tpu_torch.ops import patches
from slam_toolkit_tpu_torch.optim import robust
from slam_toolkit_tpu_torch.utils.lanes import lane, with_lane

# 8-point residual pattern (x, y) offsets around the projection
PATTERN = ((0.0, 0.0), (-2.0, 0.0), (2.0, 0.0), (0.0, -2.0),
           (0.0, 2.0), (-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0))
WIN = 8                  # the window side every sample of a landmark needs


class DirectState(NamedTuple):
    # with a leading lane axis (B, ...) for B lanes
    T_cw: torch.Tensor   # (4, 4)
    a: torch.Tensor      # () brightness gain (log scale)
    b: torch.Tensor      # () brightness offset


class DirectResult(NamedTuple):
    state: DirectState
    cost: torch.Tensor
    res_norm: torch.Tensor   # (N,) final per-landmark photometric rms


@functools.lru_cache(maxsize=8)
def _taps(device: torch.device):
    """Flat indices into a 7x7 grid: the pattern taps, one column left
    and right of them, one row above and below (device constants, built
    once per device)."""
    pat = np.asarray(PATTERN, np.int64)
    rows, cols = 3 + pat[:, 1], 3 + pat[:, 0]            # in [1, 5]
    flat = [rows * 7 + cols, rows * 7 + cols - 1, rows * 7 + cols + 1,
            (rows - 1) * 7 + cols, (rows + 1) * 7 + cols]
    return torch.as_tensor(np.stack(flat), device=device)


def _pattern_samples(image: torch.Tensor, uv: torch.Tensor):
    """(ival, gx, gy), each (..., N, 8): the pattern intensities at uv
    and their bilinear +-0.5 px central differences, from one 8x8 window
    a landmark (one gather launch: a (B, H, W) image's windows lane by
    lane, an (H, W) image's for uv of any leading shape)."""
    h, w = image.shape[-2:]
    u0 = torch.floor(uv[..., 0])
    v0 = torch.floor(uv[..., 1])
    # corners clipped in float: only landmarks the caller masks out lie
    # outside, and the gather clamps into the image again
    xs = torch.clamp(u0 - 3, 0, max(w - WIN, 0)).to(torch.int32)
    ys = torch.clamp(v0 - 3, 0, max(h - WIN, 0)).to(torch.int32)
    win = patches.gather_blocks(image, ys, xs, WIN, WIN)    # (..., N, 8, 8)
    fu = (uv[..., 0] - u0)[..., None, None]
    fv = (uv[..., 1] - v0)[..., None, None]

    def grid(fx, fy):
        return ((1.0 - fy) * (1.0 - fx) * win[..., :-1, :-1] +
                (1.0 - fy) * fx * win[..., :-1, 1:] +
                fy * (1.0 - fx) * win[..., 1:, :-1] +
                fy * fx * win[..., 1:, 1:]).reshape(
                    win.shape[:-2] + (49,))                 # (..., N, 7*7)

    fm_u = torch.where(fu >= 0.5, fu - 0.5, fu + 0.5)
    fm_v = torch.where(fv >= 0.5, fv - 0.5, fv + 0.5)
    tap, left, right, up, down = _taps(image.device)
    ival = grid(fu, fv)[..., tap]
    Gx = grid(fm_u, fv)
    Gy = grid(fu, fm_v)
    # I(p + 0.5) - I(p - 0.5): taps 1 px apart on the shifted grid; which
    # pair depends only on whether the fraction wrapped
    gx = torch.where(fu[..., 0] >= 0.5, Gx[..., right] - Gx[..., tap],
                     Gx[..., tap] - Gx[..., left])
    gy = torch.where(fv[..., 0] >= 0.5, Gy[..., down] - Gy[..., tap],
                     Gy[..., tap] - Gy[..., up])
    return ival, gx, gy


def _lanes(x: torch.Tensor, n: int) -> torch.Tensor:
    """B lanes' (B,) shaped to broadcast against tensors with n trailing
    axes."""
    return x.reshape(x.shape + (1,) * n)


def _gain(a: torch.Tensor) -> torch.Tensor:
    """e^-a, lane by lane."""
    return se3.per_lane(lambda x: torch.exp(-x), a)


def photometric_residuals(state: DirectState, image: torch.Tensor,
                          cam: Camera, Xw: torch.Tensor,
                          ref_vals: torch.Tensor, valid: torch.Tensor,
                          scale: float):
    """Residuals r (N, 8), Jacobian J (N, 8, 8) over [rho, phi, a, b],
    validity (N,). ref_vals: (N, 8) brightness-corrected reference
    intensities; `scale` maps full-resolution pixels to this level. B
    lanes: a leading lane axis on every input and output."""
    if Xw.dim() == 2:
        return lane(photometric_residuals(
            with_lane(state), image, cam, Xw[None], ref_vals[None],
            valid[None], scale), 0)
    Xc = se3.per_lane(se3.transform, state.T_cw, Xw)
    good = (Xc[..., 2] > 0.1) & valid
    uv = cam_mod.project(cam, Xc) * scale
    h, w = image.shape[-2:]
    good = good & ((uv[..., 0] > 3) & (uv[..., 0] < w - 4) &
                   (uv[..., 1] > 3) & (uv[..., 1] < h - 4))

    ival, gx, gy = _pattern_samples(image, uv)
    ea = _gain(state.a)
    b = _lanes(state.b, 2)
    r = _lanes(ea, 2) * (ival - b) - ref_vals

    # chain rule: dr/d(uv_full) = ea * grad * scale; duv/dXc; dXc/dxi
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(good, z, torch.ones_like(z))
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(x)
    du = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2,
                      fx * (1 + x * x * iz2), -fx * y * iz], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1 + y * y * iz2),
                      fy * x * y * iz2, fy * x * iz], dim=-1)
    J_geo = (gx[..., None] * du[..., None, :] +
             gy[..., None] * dv[..., None, :]) * _lanes(ea * scale, 3)
    J_a = (_lanes(-ea, 2) * (ival - b))[..., None]
    J_b = _lanes(-ea, 2).expand(r.shape)[..., None]
    return r, torch.cat([J_geo, J_a, J_b], dim=-1), good


def optimize_direct(state0: DirectState, image: torch.Tensor, cam: Camera,
                    Xw: torch.Tensor, ref_vals: torch.Tensor,
                    valid: torch.Tensor, scale: float, iters: int = 10,
                    huber_delta: float = 9.0,
                    prior_ab: float = 1e-2) -> DirectResult:
    """Damped LM over (xi, a, b) at one pyramid level; prior_ab pins the
    brightness parameters (ref EdgeBrightenessPrior,
    src/optimizer.cpp:75-95). B lanes: each lane's LM as its single call,
    the residuals and Jacobians of all lanes at once, the sums, the solve
    and the pose update lane by lane."""
    if Xw.dim() == 2:
        return lane(optimize_direct(
            with_lane(state0), image, cam, Xw[None], ref_vals[None],
            valid[None], scale, iters, huber_delta, prior_ab), 0)
    B = Xw.shape[0]

    def cost_at(st):
        r, _, good = photometric_residuals(st, image, cam, Xw, ref_vals,
                                           valid, scale)
        return torch.stack([_cost(r[b], good[b], st.a[b], st.b[b],
                                  huber_delta, prior_ab) for b in range(B)])

    st = state0
    lam = torch.full((B,), 1e-4, dtype=torch.float32, device=image.device)
    cost = cost_at(st)
    for _ in range(iters):
        r, J, good = photometric_residuals(st, image, cam, Xw, ref_vals,
                                           valid, scale)
        steps = [_lm_step(lane(st, b), r[b], J[b], good[b], lam[b],
                          huber_delta, prior_ab) for b in range(B)]
        st_try = DirectState(*(torch.stack(f) for f in
                               zip(*[s for s, _ in steps])))
        dx = torch.stack([d for _, d in steps])
        c_try = cost_at(st_try)
        accept = (c_try < cost) & torch.all(torch.isfinite(dx), dim=-1)
        st = DirectState(*(torch.where(_lanes(accept, n.dim() - 1), n, o)
                           for n, o in zip(st_try, st)))
        lam = torch.where(accept, torch.clamp(lam * 0.1, min=1e-7), lam * 10.0)
        cost = torch.where(accept, c_try, cost)
    r, _, good = photometric_residuals(st, image, cam, Xw, ref_vals, valid,
                                       scale)
    rms = torch.stack([torch.sqrt(torch.mean(r[b] * r[b], dim=-1))
                       for b in range(B)])
    return DirectResult(state=st, cost=cost,
                        res_norm=torch.where(good, rms,
                                             torch.full_like(rms, np.inf)))


def _cost(r, good, a, b, huber_delta: float, prior_ab: float):
    """One lane's robust photometric cost plus the brightness prior."""
    rn = torch.linalg.vector_norm(r, dim=-1)
    return torch.sum(robust.huber_cost(rn, huber_delta) * good) + \
        0.5 * prior_ab * (a ** 2 + b ** 2)


def _lm_step(st: DirectState, r, J, good, lam, huber_delta: float,
             prior_ab: float):
    """One lane's damped Gauss-Newton step: (the trial state, dx)."""
    dev = r.device
    eye = torch.eye(8, dtype=torch.float32, device=dev)
    rn = torch.linalg.vector_norm(r, dim=-1)
    wt = good * robust.huber_weight(rn, huber_delta)
    H = torch.einsum('npi,n,npj->ij', J, wt, J)
    g = -torch.einsum('npi,n,np->i', J, wt, r)
    H = H + prior_ab * eye * (torch.arange(8, device=dev) >= 6)
    g = g - prior_ab * torch.cat([g.new_zeros(6), torch.stack(
        [st.a, st.b])])
    Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye
    # solve_ex: no error check, which would wait on the device; a
    # singular system gives a non-finite step, rejected below
    dx = torch.linalg.solve_ex(Hd, g)[0]
    return DirectState(
        T_cw=se3.normalize(se3.compose(se3.exp(dx[:6]), st.T_cw)),
        a=st.a + dx[6], b=st.b + dx[7]), dx


def reference_values(state: DirectState, image: torch.Tensor, cam: Camera,
                     Xw: torch.Tensor, valid: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Brightness-corrected pattern intensities in the anchor frame; (B,
    N, 8) for B lanes."""
    if Xw.dim() == 2:
        return reference_values(with_lane(state), image, cam, Xw[None],
                                valid[None], scale)[0]
    Xc = se3.per_lane(se3.transform, state.T_cw, Xw)
    uv = cam_mod.project(cam, Xc) * scale
    vals, _, _ = _pattern_samples(image, uv)
    return _lanes(_gain(state.a), 2) * (vals - _lanes(state.b, 2))
