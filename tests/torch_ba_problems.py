"""Seeded local-BA problems for the port's tests (no jax).

tests/test_torch_cuda.py holds the CUDA kernel against the plain solver
on them; tests/test_torch_local_ba.py holds the plain solver's float32
run against its float64 run.
"""

import numpy as np
import torch

from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.optim.local_ba import BAProblem


def ba_problem(dev, W=3, P=100, seed=4, noise=5e-4, one_outlier=False):
    """A ragged local-BA problem: pose 0 fixed, pose 2 (where W > 2) an
    invalid slot, every 7th point fixed (not free), the last 10 points
    empty; 5% of the edges are 30-sigma outliers. one_outlier keeps at
    most one outlier edge per point: a point whose edges are mostly
    outliers has, without the trim, so flat an optimum that float32
    rounding alone moves it by more than 2e-2 (W=8, P=1000;
    tests/test_torch_local_ba.py shows it against a float64 run)."""
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-10, 10, P), rng.uniform(-3, 3, P),
                   rng.uniform(5, 40, P)], -1).astype(np.float32)
    T_true = se3.exp(torch.from_numpy(np.stack(
        [[0, 0, -0.5 * w, 0, 0, 0] for w in range(W)]).astype(np.float32)))
    dxi = rng.uniform(-1e-3, 1e-3, (W, 6)).astype(np.float32)
    dxi[0] = 0.0
    T_init = se3.exp(torch.from_numpy(dxi)) @ T_true
    Xc = (T_true[:, None, :3, :3] @ torch.from_numpy(Xw)[None, :, :, None]
          )[..., 0] + T_true[:, None, :3, 3]
    Xc = Xc.numpy()
    z = np.stack([Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2],
                  (Xc[..., 0] - 0.5) / Xc[..., 2]], -1).astype(np.float32)
    z += rng.normal(0, noise, z.shape).astype(np.float32)
    bad = rng.uniform(size=(W, P)) < 0.05
    if one_outlier:
        bad &= np.cumsum(bad, axis=0) <= 1
    z[bad, :2] += 0.015                                 # 30-sigma outliers
    obs = (Xc[..., 2] > 1.0) & (rng.uniform(size=(W, P)) < 0.9)
    pv = np.ones(P, bool)
    pv[-10:] = False
    obs[:, -10:] = False
    free = np.ones(P, bool)
    free[::7] = False

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return BAProblem(
        T_cw=T_init.to(dev), pose_fixed=t(np.arange(W) == 0),
        pose_valid=t(np.arange(W) != 2),
        Xw=t(Xw + rng.normal(0, 5e-3, Xw.shape).astype(np.float32)),
        point_valid=t(pv), z=t(z),
        inv_sigma=t(np.full((W, P), 1 / noise / 3, np.float32)),
        obs_mask=t(obs), stereo_mask=t(obs),
        baseline=torch.tensor(0.5, device=dev), point_free=t(free))


def as_float64(p):
    """The same problem in float64 (poses, points, observations)."""
    return p._replace(**{k: getattr(p, k).double() for k in
                         ("T_cw", "Xw", "z", "inv_sigma", "baseline")})
