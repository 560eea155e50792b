"""Pose-graph optimization for loop closing: SE(3) and Sim(3).

Counterpart of slam_toolkit_tpu/optim/pose_graph.py (ref
LoopCloser::CloseLoop, src/loopcloser.cpp:104-220): odometry chain
edges and loop edges with diagonal information, the oldest keyframe
fixed, a fixed number of damped Gauss-Newton steps with accept/reject.
The edge residual is r = log(T_j . T_i^-1 . C^-1). Both groups share one
masked dense LM; the (D*N, D*N) normal system is solved with
torch.linalg.solve_ex in float32 (LU, as XLA's solve).

The JAX package assembles H with .at[].add over repeated block indices.
Here the scatter is a fixed-order segment sum: the contributions are
sorted once per solve by target block (stable, so equal blocks keep the
JAX package's contribution order), laid out in a (segments, width)
table and summed along it; every write then hits a distinct cell, so
the result is the same on every run and on every device. The table's
shape is static, fixed by the edge structure (segment_widths), so a
solve reads nothing back and a CUDA graph can hold it; the normal
system is solved with solve_ex, whose error check stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_toolkit_tpu_torch.geometry import se3, sim3
from slam_toolkit_tpu_torch.optim import robust


class PoseGraphProblem(NamedTuple):
    T_cw: torch.Tensor       # (N, 4, 4) initial poses (SE3, or Sim3 mats)
    pose_valid: torch.Tensor  # (N,) bool
    pose_fixed: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor     # (E,) source pose index
    edge_j: torch.Tensor     # (E,) target pose index
    edge_T_ji: torch.Tensor  # (E, 4, 4) measured T_j . T_i^-1
    edge_info: torch.Tensor  # (E, D) diagonal information [rho, phi(, sigma)]
    edge_valid: torch.Tensor  # (E,) bool


def _se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Ad = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    Ad[..., :3, :3] = R
    Ad[..., :3, 3:] = se3.hat(t) @ R
    Ad[..., 3:, 3:] = R
    return Ad


class _Group(NamedTuple):
    dim: int
    log: object
    inv: object
    exp: object
    normalize: object
    adjoint: object


SE3 = _Group(6, se3.log, se3.inv, se3.exp, se3.normalize, _se3_adjoint)
SIM3 = _Group(7, sim3.log, sim3.inv, sim3.exp, sim3.normalize, sim3.adjoint)


class SegmentSum:
    """A fixed-order scatter-add of (C, ...) rows into `n` slots by
    `keys` (C,): contributions are sorted by key (stable), placed in a
    (C segments, width) table and summed along it. `width` must bound
    every key's multiplicity (segment_widths gives the pose graph's).
    The layout has static shapes, is built
    on the device with no host read and is reused; the sums of the
    segments past the last used one go to dump slots of their own, past
    the n real ones."""

    def __init__(self, keys: torch.Tensor, n: int, width: int):
        keys = keys.long()
        c = keys.shape[0]
        dev = keys.device
        self.order = torch.sort(keys, stable=True).indices
        sk = keys[self.order]
        head = torch.ones_like(sk, dtype=torch.bool)
        head[1:] = sk[1:] != sk[:-1]
        seg = torch.cumsum(head.long(), 0) - 1
        idx = torch.arange(c, device=dev)
        start = torch.zeros_like(idx).scatter_reduce(
            0, seg, idx, reduce="amin", include_self=False)
        self.cell = seg * width + idx - start.index_select(0, seg)
        # each segment's key (order-free: one value per segment), unused
        # segments to dump slots n, n + 1, ...
        ukey = torch.full((c,), -1, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, seg, sk, reduce="amax")
        self.target = torch.where(ukey >= 0, ukey, n + idx)
        self.n, self.c, self.width = n, c, width

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        tail = rows.shape[1:]
        table = rows.new_zeros((self.c * self.width,) + tail)
        table.index_copy_(0, self.cell, rows.index_select(0, self.order))
        out = rows.new_zeros((self.n + self.c,) + tail)
        out.index_copy_(0, self.target,
                        table.reshape((self.c, self.width) + tail).sum(1))
        return out[:self.n]


def segment_widths(n_edges: int, chain_edges: int = 0) -> tuple:
    """The most contributions one block of H and one row of b take, for a
    graph whose first `chain_edges` edges are the chain (i, i + 1): a
    chain edge adds at most one to a block and one to a row, and each
    node is an end of two chain edges at most; any other edge adds up to
    four to one diagonal block (an edge from a node to itself, as an
    invalid loop edge clamped to the last node is) and up to two to one
    row. Returns (H's width, b's width)."""
    other = n_edges - chain_edges
    chain = 2 if chain_edges else 0
    return max(chain + 4 * other, 1), max(chain + 2 * other, 1)


def _solve_graph(prob: PoseGraphProblem, g: _Group, iters: int,
                 lambda0: float, lambda_up: float, lambda_down: float,
                 huber_delta: float, chain_edges: int) -> torch.Tensor:
    """Masked dense LM over the graph on group g. For r = log(Tj Ti^-1
    C^-1) with left updates, dr/ddj ~= I and dr/ddi ~= -Ad(Tj Ti^-1)."""
    N = prob.T_cw.shape[0]
    E = prob.edge_i.shape[0]
    D = g.dim
    dev = prob.T_cw.device
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    ew = (prob.edge_valid & prob.pose_valid[ei] & prob.pose_valid[ej]).float()
    free = ((~prob.pose_fixed) & prob.pose_valid).float()
    C_inv = g.inv(prob.edge_T_ji)
    eye = torch.eye(D, dtype=torch.float32, device=dev)
    # H blocks: ii, jj, ij, ji contributions in the JAX package's order
    w_h, w_b = segment_widths(E, chain_edges)
    h_sum = SegmentSum(torch.cat([ei * N + ei, ej * N + ej, ei * N + ej,
                                  ej * N + ei]), N * N, w_h)
    b_sum = SegmentSum(torch.cat([ei, ej]), N, w_b)
    diag_idx = torch.arange(N, device=dev)

    def residuals(T):
        return g.log(T[ej] @ g.inv(T[ei]) @ C_inv)

    def cost_at(T):
        r = residuals(T)
        rw = torch.sqrt(torch.sum(r * r * prob.edge_info, dim=-1) + 1e-12)
        return torch.sum(robust.huber_cost(rw, huber_delta) * ew)

    T = prob.T_cw
    lam = torch.full((), lambda0, dtype=torch.float32, device=dev)
    cost = cost_at(T)
    for _ in range(iters):
        r = residuals(T)
        rw = torch.sqrt(torch.sum(r * r * prob.edge_info, dim=-1) + 1e-12)
        info_w = prob.edge_info * (robust.huber_weight(rw, huber_delta)
                                   * ew)[:, None]               # (E, D)
        Ji = -g.adjoint(T[ej] @ g.inv(T[ei]))
        JiW = Ji * info_w[:, :, None]
        Hii = Ji.transpose(1, 2) @ JiW
        Hjj = torch.diag_embed(info_w)
        Hij = JiW.transpose(1, 2)                 # Ji^T W Jj, Jj = I
        bi = -(JiW.transpose(1, 2) @ r[:, :, None])[..., 0]
        bj = -(info_w * r)
        H = h_sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)])) \
            .reshape(N, N, D, D)
        b = b_sum(torch.cat([bi, bj]))
        diag = H[diag_idx, diag_idx]
        H[diag_idx, diag_idx] = diag + lam * diag * eye + 1e-6 * eye
        H = H * free[:, None, None, None] * free[None, :, None, None]
        H[diag_idx, diag_idx] += (1.0 - free)[:, None, None] * eye
        b = b * free[:, None]
        Hd = H.permute(0, 2, 1, 3).reshape(D * N, D * N)
        dx = torch.linalg.solve_ex(Hd, b.reshape(-1, 1),
                                   check_errors=False)[0].reshape(N, D)
        dx = dx * free[:, None]
        T_try = torch.where((free > 0)[:, None, None],
                            g.normalize(g.exp(dx) @ T), T)
        cost_try = cost_at(T_try)
        accept = cost_try < cost
        T = torch.where(accept, T_try, T)
        lam = torch.where(accept, lam * lambda_down, lam * lambda_up)
        cost = torch.where(accept, cost_try, cost)
    return T


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                     lambda0: float = 1e-4, lambda_up: float = 10.0,
                     lambda_down: float = 0.1, huber_delta: float = 1e9,
                     chain_edges: int = 0) -> torch.Tensor:
    """SE(3) pose graph; edge_info is (E, 6). Returns (N, 4, 4) poses.
    chain_edges: how many of the first edges are the chain (i, i + 1),
    which narrows the assembly's table (segment_widths)."""
    return _solve_graph(prob, SE3, iters, lambda0, lambda_up, lambda_down,
                        huber_delta, chain_edges)


def solve_pose_graph_sim3(prob: PoseGraphProblem, iters: int = 20,
                          lambda0: float = 1e-4, lambda_up: float = 10.0,
                          lambda_down: float = 0.1,
                          huber_delta: float = 1e9,
                          chain_edges: int = 0) -> torch.Tensor:
    """Sim(3) pose graph; similarity matrices in, edge_info (E, 7) [rho,
    phi, sigma]; returns (N, 4, 4) similarities. chain_edges as in
    solve_pose_graph."""
    return _solve_graph(prob, SIM3, iters, lambda0, lambda_up, lambda_down,
                        huber_delta, chain_edges)
