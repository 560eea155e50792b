"""Dense motion clustering: the epip_cluster workload.

Counterpart of slam_toolkit_tpu/cluster/tracker.py (ref
examples/epip_cluster/src/tracker.cpp). Per stereo pair: a Sobel edge
mask (:76-87), dense block-matching disparity (:106-128), dense flow
against the previous frame (:130-145), a p95 flow-magnitude skip gate
(:147-164,722-724), stride-5 point sampling with disparity gates
(:166-200), then temporal motion clustering:

  1. `track_clusters` (TrackCluster, ref :518-693): previous labels
     propagated through the flow, PnP-RANSAC per cluster slot (all slots
     at once), re-absorption by ground-cluster reprojection and by the
     nearest tracked 3-D neighbour, and the drift split (EuclideanFilter,
     ref :411-516).
  2. `ransac_round` (RansacCluster, ref :202-392): rigid RANSAC on the
     residual points, the disparity-consistency gate, Euclidean
     components of the inliers; components of >= 50 points become new
     clusters.

Radius queries are stencils over the regular sample grid (the grid is
the label mask of ref MakeMask :394-409). Two trackers: `DenseTracker`,
stepwise with host-side slot allocation (what run_cluster uses), its
three programs (frame, track, round: the JAX tracker's jitted _frame,
_track, _round) run on static buffers, a CUDA graph each on a card, one
packed row read back a run; and `FusedDenseTracker`, which allocates
slots on the device by rank over the free slots and reads back one
packed row a frame; both give the same labels. The fused step
(`fused_step`) branches as the JAX program's lax.cond and lax.scan do:
the skip gate's two sides and each RANSAC round are
utils/cuda_graphs.run_if bodies on device flags, writing the state in
place; every PnP-RANSAC draws from uniforms uploaded ahead
(`frame_draws`), and optim/pose_lm.optimize_pose's damping is a device
fill. With fixed shapes, FusedDenseTracker captures the step as one CUDA
graph on a card, the branches as IF nodes, and replays it; the one host
synchronisation a frame is the wait for its packed row. Every entry
point runs with TF32 off (pipeline/engine.full_float32) and on the card
unless asked for the CPU.
"""

from __future__ import annotations

import functools
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from slam_toolkit_tpu_torch.cluster import flow as flow_mod
from slam_toolkit_tpu_torch.cluster import ransac as ransac_mod
from slam_toolkit_tpu_torch.cluster import stereo_bm
from slam_toolkit_tpu_torch.config import CameraConfig
from slam_toolkit_tpu_torch.pipeline.engine import full_float32
from slam_toolkit_tpu_torch.utils import threefry
from slam_toolkit_tpu_torch.utils.cuda_graphs import StepGraphs, run_if
from slam_toolkit_tpu_torch.utils.device import upload


class DenseConfig(NamedTuple):
    num_disparities: int = 128
    block_size: int = 19
    flow_levels: int = 5
    flow_win: int = 13
    max_flow_x: int = 64               # full-res flow bound [px] — the
    max_flow_y: int = 24               # warp saturates beyond (flow.py)
    sample_stride: int = 5
    min_disparity: float = 2.0
    max_disparity: float = 50.0
    min_flow_p95: float = 20.0
    cluster_radius_3d: float = 0.5     # object clustering / absorption radius [m] (ref :317,:655)
    ground_radius_px: float = 20.0     # ground clustering radius [px] (ref :317)
    min_cluster_size: int = 50         # new-cluster component minimum (ref :297,:352)
    max_points: int = 8192             # padded sample capacity
    max_clusters: int = 16             # cluster-id slot capacity
    track_capacity: int = 2048         # per-cluster gathered member capacity
    min_track_points: int = 20         # candidate-cluster minimum (ref :554)
    min_track_inliers: int = 20        # per-cluster PnP acceptance (ref :581)
    max_rprj_px: float = 2.0           # RANSAC inlier gate [px] (ref :209,:525)
    disp_consistency_px: float = 3.0   # disparity-error gate [px] (ref :280)
    near_z: float = 50.0               # "near" depth for drift splits [m] (ref :481)
    min_near_points: int = 20          # sub-cluster survival count (ref :495)
    max_ransac_rounds: int = 6         # bounded form of ref's while(true) (:238)
    max_window_cells: int = 12         # stencil cap (see _window_cells)


class DenseFrame(NamedTuple):
    """Per-frame device outputs."""
    disparity: torch.Tensor     # (H, W)
    depth: torch.Tensor         # (H, W)  fx*b/disp, 0 where invalid (ref :63-74)
    flow: torch.Tensor          # (H, W, 2)
    edge_mask: torch.Tensor     # (H, W) bool
    pts_uv: torch.Tensor        # (P, 2) sampled pixel coords
    pts_xyz: torch.Tensor       # (P, 3) camera-frame 3D points
    pts_valid: torch.Tensor     # (P,) bool
    flow_p95: torch.Tensor      # ()


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    return device


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x elementwise as a float32 division (torch's `c / x` is
    x.reciprocal() * c, one more rounding)."""
    return torch.full_like(x, c) / x


def _patches(x2d: torch.Tensor, c: int, fill: float) -> torch.Tensor:
    """All (2c+1)^2 window-shifted copies of a (ny, nx) grid plane as one
    (W^2, ny, nx) float32 tensor, padded with `fill`: channel k holds the
    neighbour at offset (k // W - c, k % W - c). Integer planes ride as
    float32 (exact below 2^24)."""
    W = 2 * c + 1
    ny, nx = x2d.shape
    xp = F.pad(x2d.float()[None, None], (c, c, c, c), value=fill)
    return F.unfold(xp, (W, W))[0].reshape(W * W, ny, nx)


def _window_cells(cam: CameraConfig, cfg: DenseConfig) -> int:
    """Stencil half-width in grid cells covering the clustering radii:
    the ground radius is ground_radius_px / stride cells, and two 3-D
    points within cluster_radius_3d at depth >= fx*b/max_disparity
    project within fx*r/(z_min*stride) cells; capped at
    cfg.max_window_cells (with a warning: beyond the cap the 3-D
    absorption misses pixel-distant neighbours)."""
    z_min = cam.fx * cam.baseline / cfg.max_disparity
    c3d = int(np.ceil(cam.fx * cfg.cluster_radius_3d
                      / (z_min * cfg.sample_stride)))
    cpx = int(np.ceil(cfg.ground_radius_px / cfg.sample_stride))
    if max(c3d, cpx) > cfg.max_window_cells:
        sys.stderr.write(
            f"[cluster] window stencil capped: need {max(c3d, cpx)} "
            f"cells (c3d={c3d}, cpx={cpx}) > max_window_cells="
            f"{cfg.max_window_cells}; 3D absorption may miss "
            f"pixel-distant neighbors\n")
    return min(max(c3d, cpx, 1), cfg.max_window_cells)


def _sq_dist_patches(X: torch.Tensor, c: int) -> torch.Tensor:
    """(W^2, ny, nx) squared 3-D distance to each stencil neighbour
    (neighbours off the grid at 1e9)."""
    return sum((_patches(X[..., i], c, 1e9) - X[..., i]) ** 2
               for i in range(3))


def _grid_cc(member: torch.Tensor, xyz: torch.Tensor, grid_shape, c: int,
             r3d: float, point_label=None, is_ground_round=None,
             rpx: float = None, stride: int = None,
             n_iter: int = 8) -> torch.Tensor:
    """Connected components over the sample grid by stencil min-label
    propagation with pointer jumping (n_iter sweeps). Adjacency: both
    points members and within r3d in 3-D, or, where is_ground_round (a
    bool tensor) holds, within rpx pixels on the grid; with point_label
    also equal labels. Returns (P,) int32 component roots (the lowest
    grid index of the component), P for non-members and padding."""
    P = member.shape[0]
    ny, nx = grid_shape
    G = ny * nx
    W = 2 * c + 1
    dev = member.device
    mem = member[:G].reshape(ny, nx)
    X = xyz[:G].reshape(ny, nx, 3)

    nm = _patches(mem, c, 0.0) > 0.5
    ok = _sq_dist_patches(X, c) <= r3d * r3d
    if is_ground_round is not None:
        k = torch.arange(W * W, device=dev)
        dy, dx = k // W, k % W
        okg = ((stride * stride) * ((dy - c) ** 2 + (dx - c) ** 2)
               ) <= rpx * rpx
        ok = torch.where(is_ground_round, okg[:, None, None], ok)
    adj = ok & nm & mem
    if point_label is not None:
        labid = point_label[:G].reshape(ny, nx)
        nid = _patches(labid, c, -7.0).int()
        adj = adj & (nid == labid)

    lab = torch.where(mem, torch.arange(G, dtype=torch.int32, device=dev
                                        ).reshape(ny, nx), G)
    for _ in range(n_iter):
        nl = _patches(lab, c, float(G)).int()
        best = torch.amin(torch.where(adj, nl, G), dim=0)
        bf = torch.minimum(lab, best).reshape(-1)
        jump = bf[torch.clamp(bf, 0, G - 1).long()]
        bf = torch.minimum(bf, torch.where(bf < G, jump, G))
        lab = bf.reshape(ny, nx)
    lab = lab.reshape(-1)
    comp = torch.full((P,), P, dtype=torch.int32, device=dev)
    comp[:G] = torch.where(lab < G, lab, P)
    return comp


def _grid_absorb(point_label: torch.Tensor, tracked_ok: torch.Tensor,
                 xyz: torch.Tensor, grid_shape, c: int):
    """Nearest tracked neighbour within the stencil window (the 3-D kNN
    absorption of ref tracker.cpp:627-662). Returns (best_d2 (P,),
    best_label (P,)): inf and -1 where no tracked neighbour."""
    P = point_label.shape[0]
    ny, nx = grid_shape
    G = ny * nx
    X = xyz[:G].reshape(ny, nx, 3)
    nt = _patches(tracked_ok[:G].reshape(ny, nx), c, 0.0) > 0.5
    nl = _patches(point_label[:G].reshape(ny, nx), c, -1.0).int()
    d3 = torch.where(nt, _sq_dist_patches(X, c), float("inf"))
    kbest = torch.argmin(d3, dim=0)                  # first min
    best_d2 = torch.amin(d3, dim=0)
    best_lab = torch.gather(nl, 0, kbest[None])[0]
    best_lab = torch.where(torch.isfinite(best_d2), best_lab, -1)
    out_d2 = torch.full((P,), float("inf"), device=xyz.device)
    out_lab = torch.full((P,), -1, dtype=torch.int32, device=xyz.device)
    out_d2[:G] = best_d2.reshape(-1)
    out_lab[:G] = best_lab.reshape(-1)
    return out_d2, out_lab


def _sample_grid(h: int, w: int, stride: int, max_points: int):
    ys = np.arange(stride // 2, h, stride)
    xs = np.arange(stride // 2, w, stride)
    uu, vv = np.meshgrid(xs, ys)
    pts = np.stack([uu.ravel(), vv.ravel()], axis=-1).astype(np.int32)
    if pts.shape[0] > max_points:
        raise ValueError(
            f"sample grid {len(ys)}x{len(xs)}={pts.shape[0]} exceeds "
            f"max_points={max_points}; raise max_points or the stride "
            "(label propagation needs the full grid resident)")
    pad = max_points - pts.shape[0]
    mask = np.ones(pts.shape[0], bool)
    if pad > 0:
        pts = np.pad(pts, ((0, pad), (0, 0)))
        mask = np.pad(mask, (0, pad))
    return pts, mask, (len(ys), len(xs))


@functools.lru_cache(maxsize=8)
def _grid_on(h: int, w: int, stride: int, max_points: int, device: str):
    """_sample_grid's points (int32) and mask on `device`, uploaded once."""
    grid, gmask, _ = _sample_grid(h, w, stride, max_points)
    return (upload(grid, device), upload(gmask, device))


def dense_frame(gray_l: torch.Tensor, gray_r: torch.Tensor,
                prev_gray: torch.Tensor, cam: CameraConfig,
                cfg: DenseConfig) -> DenseFrame:
    """One pass over a pair: edges, disparity, flow against prev_gray,
    the sample grid's 3-D points."""
    h, w = gray_l.shape
    dev = gray_l.device
    fb = cam.fx * cam.baseline
    edge = stereo_bm.sobel_edge_mask(gray_l)
    disp = stereo_bm.disparity(gray_l, gray_r, cfg.num_disparities,
                               cfg.block_size)
    zero = torch.zeros_like(disp)
    disp = torch.where(edge, disp, zero)
    depth = torch.where(disp > 0, _rdiv(fb, torch.clamp(disp, min=1e-3)),
                        zero)
    flw = flow_mod.farneback_flow(prev_gray, gray_l,
                                  levels=cfg.flow_levels, win=cfg.flow_win,
                                  max_flow_x=cfg.max_flow_x,
                                  max_flow_y=cfg.max_flow_y)
    mag = torch.sqrt(flw[..., 0] * flw[..., 0] + flw[..., 1] * flw[..., 1])
    p95 = torch.quantile(mag.reshape(-1), 0.95)

    grid_t, gmask = _grid_on(h, w, cfg.sample_stride, cfg.max_points,
                             str(dev))
    d = disp[grid_t[:, 1].long(), grid_t[:, 0].long()]
    ok = gmask & (d > cfg.min_disparity) & (d < cfg.max_disparity)
    z = _rdiv(fb, torch.clamp(d, min=1e-3))
    x = (grid_t[:, 0] - cam.cx) / cam.fx * z
    y = (grid_t[:, 1] - cam.cy) / cam.fy * z
    xyz = torch.stack([x, y, z], dim=-1)
    return DenseFrame(disparity=disp, depth=depth, flow=flw, edge_mask=edge,
                      pts_uv=grid_t.float(),
                      pts_xyz=torch.where(ok[:, None], xyz,
                                          torch.zeros_like(xyz)),
                      pts_valid=ok, flow_p95=p95)


def frame_parity(got, want) -> dict:
    """dense_frame's bars between two DenseFrames (of tensors on any
    device, or of arrays): validity masks equal on >= 99.9% of pixels,
    |d disparity| <= 1e-3 px on >= 99.9% of the pixels valid in both,
    the Sobel mask equal on >= 99.9%, the flow within 1e-3 px on
    >= 99.9% of pixels and flow_p95 within 1e-3, the sample validity
    equal on >= 99.9%. Returns the measured shares; raises
    AssertionError with them where a bar fails."""
    a, b = ({k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in fr._asdict().items()} for fr in (got, want))
    dg, dw = a["disparity"], b["disparity"]
    both = (dg > 0) & (dw > 0)
    out = {"valid_equal": float(np.mean((dg > 0) == (dw > 0))),
           "disp_close": float(np.mean(np.abs(dg[both] - dw[both]) <= 1e-3)),
           "edge_equal": float(np.mean(a["edge_mask"] == b["edge_mask"])),
           "flow_close": float(np.mean(np.abs(a["flow"] - b["flow"]).max(
               axis=-1) <= 1e-3)),
           "p95_diff": abs(float(a["flow_p95"]) - float(b["flow_p95"])),
           "pts_equal": float(np.mean(a["pts_valid"] == b["pts_valid"])),
           "valid_share": float(np.mean(both))}
    if out["valid_share"] <= 0.02 or out["p95_diff"] > 1e-3 or any(
            out[k] < 0.999 for k in ("valid_equal", "disp_close",
                                     "edge_equal", "flow_close",
                                     "pts_equal")):
        raise AssertionError(f"dense_frame parity: {out}")
    return out


# PnP-RANSAC hypotheses of track_clusters (a cluster slot each) and of a
# RANSAC round, and the points a hypothesis is solved from
TRACK_HYPOTHESES = 64
ROUND_HYPOTHESES = 100
SAMPLE = 4


class TrackOut(NamedTuple):
    labels: torch.Tensor        # (P,) int32, -1 untracked
    cluster_T: torch.Tensor     # (C, 4, 4) accepted rigid motions
    cluster_ok: torch.Tensor    # (C,) bool PnP accepted
    cluster_inl: torch.Tensor   # (C,) int32 inlier counts
    cand_counts: torch.Tensor   # (C,) int32 propagated-candidate counts


def _grid_cell_index(uv: torch.Tensor, stride: int, ny: int, nx: int):
    """Pixel coords -> nearest sample-grid point index (each grid point
    owns its stride-sized cell). Returns (idx (P,), in_grid (P,))."""
    ix = torch.round((uv[:, 0] - stride // 2) / stride).int()
    iy = torch.round((uv[:, 1] - stride // 2) / stride).int()
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    idx = torch.clamp(iy, 0, ny - 1) * nx + torch.clamp(ix, 0, nx - 1)
    return idx, ok


def _prev_pixels(f: DenseFrame, cam: CameraConfig):
    """Each sample's pixel in the previous frame (through the flow), its
    in-image flag and its normalised coordinates."""
    h, w = f.depth.shape
    iy = torch.clamp(f.pts_uv[:, 1].long(), 0, h - 1)
    ix = torch.clamp(f.pts_uv[:, 0].long(), 0, w - 1)
    img0 = f.pts_uv - f.flow[iy, ix]
    in_img = ((img0[:, 0] >= 0) & (img0[:, 0] < w)
              & (img0[:, 1] >= 0) & (img0[:, 1] < h))
    img0_norm = torch.stack([(img0[:, 0] - cam.cx) / cam.fx,
                             (img0[:, 1] - cam.cy) / cam.fy], dim=-1)
    return img0, in_img, img0_norm


def track_clusters(f: DenseFrame, prev_labels: torch.Tensor,
                   prev_depth: torch.Tensor, is_ground: torch.Tensor,
                   alive: torch.Tensor, key, cam: CameraConfig,
                   cfg: DenseConfig, grid_shape, draws=None) -> TrackOut:
    """TrackCluster (ref tracker.cpp:518-693) over every cluster slot at
    once; `key` a threefry key, or None with `draws`, its uniforms on the
    device ((C, TRACK_HYPOTHESES * 4), frame_draws). No host
    synchronisation; with `draws` nothing is uploaded either."""
    P = f.pts_uv.shape[0]
    C = cfg.max_clusters
    ny, nx = grid_shape
    dev = f.pts_uv.device
    fx, fy = cam.fx, cam.fy
    crange = torch.arange(C, device=dev)

    # -- step 1 (ref :529-544): flow-propagated candidate labels -------
    img0, in_img, img0_norm = _prev_pixels(f, cam)
    cell, cell_ok = _grid_cell_index(img0, cfg.sample_stride, ny, nx)
    cand = torch.where(f.pts_valid & in_img & cell_ok,
                       prev_labels[cell.long()], -1)
    member = (cand[None, :] == crange[:, None]) & alive[:, None]
    counts = member.sum(dim=1)
    active = alive & (counts >= cfg.min_track_points)           # ref :554

    # -- step 2 (ref :567-592): per-cluster PnP-RANSAC, one batch -------
    M = min(cfg.track_capacity, P)
    order = torch.argsort((~member).to(torch.uint8), dim=1,
                          stable=True)[:, :M]                   # members first
    memb_ok = torch.gather(member, 1, order)
    res = ransac_mod.pnp_ransac_rows(
        f.pts_xyz[order], img0_norm[order], memb_ok,
        None if draws is not None else threefry.split(key, C),
        n_hypotheses=TRACK_HYPOTHESES, sample_size=SAMPLE,
        inlier_norm=cfg.max_rprj_px / fx,
        min_inliers=cfg.min_track_inliers, u=draws)
    cluster_ok = active & res.ok

    # accepted inliers back to point labels (members are disjoint across
    # clusters, so the max-combine is exact)
    inl = res.inliers & memb_ok & cluster_ok[:, None]
    lab_rows = torch.where(inl, crange[:, None], -1).int()
    point_label = torch.full((P,), -1, dtype=torch.int32, device=dev)
    point_label = point_label.scatter_reduce(0, order.reshape(-1),
                                             lab_rows.reshape(-1), "amax")
    tracked = point_label >= 0

    # -- step 3 (ref :595-625): reprojection re-absorption under the
    # ground cluster's motion
    Xc = torch.einsum('cij,pj->cpi', res.T_cw[:, :3, :3], f.pts_xyz) \
        + res.T_cw[:, None, :3, 3]
    front = Xc[..., 2] > 1e-3
    zc = torch.where(front, Xc[..., 2], torch.ones_like(Xc[..., 2]))
    dpx = Xc[..., :2] / zc[..., None] - img0_norm[None]
    rprj_px = torch.linalg.vector_norm(
        torch.stack([dpx[..., 0] * fx, dpx[..., 1] * fy], dim=-1), dim=-1)
    absorb = (cluster_ok & is_ground)[:, None] & front \
        & (rprj_px < cfg.max_rprj_px) \
        & (~tracked & f.pts_valid & in_img)[None, :]
    ground_lab = torch.amax(torch.where(absorb, crange[:, None], -1), dim=0)
    point_label = torch.where((point_label < 0) & (ground_lab >= 0),
                              ground_lab.int(), point_label)
    tracked = point_label >= 0

    # -- steps 4-5 (ref :627-662): nearest tracked 3-D neighbour --------
    wc = _window_cells(cam, cfg)
    nn_d2, nn_lab = _grid_absorb(point_label, tracked & f.pts_valid,
                                 f.pts_xyz, grid_shape, wc)
    adopt = ~tracked & f.pts_valid & (nn_d2 <= cfg.cluster_radius_3d ** 2)
    point_label = torch.where(adopt, nn_lab, point_label)
    tracked = point_label >= 0

    # -- step 6 (ref :411-516): EuclideanFilter drift split ------------
    lab_ground = torch.where(point_label >= 0, is_ground[
        torch.clamp(point_label, 0, C - 1).long()], False)
    filt = tracked & ~lab_ground & f.pts_valid
    comp = _grid_cc(filt, f.pts_xyz, grid_shape, wc,
                    cfg.cluster_radius_3d, point_label=point_label)
    near = filt & (f.pts_xyz[:, 2] < cfg.near_z)
    near_count = torch.zeros(P + 1, dtype=torch.int32, device=dev
                             ).index_add_(0, comp.long(), near.int())
    keep = ~filt | (near_count[comp.long()] >= cfg.min_near_points)
    point_label = torch.where(keep, point_label, -1)

    return TrackOut(labels=point_label, cluster_T=res.T_cw,
                    cluster_ok=cluster_ok,
                    cluster_inl=res.n_inliers.int(),
                    cand_counts=counts.int())


class RansacRoundOut(NamedTuple):
    comp: torch.Tensor          # (P,) int32 component root per inlier, -1 else
    comp_size: torch.Tensor     # (P,) int32 component size at each point
    n_step1: torch.Tensor       # () inliers surviving both gates
    T_cw: torch.Tensor          # (4, 4)


def ransac_round(f: DenseFrame, residual: torch.Tensor,
                 prev_depth: torch.Tensor, is_ground_round: torch.Tensor,
                 key, cam: CameraConfig, cfg: DenseConfig,
                 grid_shape=None, draws=None) -> RansacRoundOut:
    """One RansacCluster iteration (ref tracker.cpp:238-389): rigid
    RANSAC over the residual pool, the disparity-consistency gate (ref
    :274-282), then Euclidean components of the surviving inliers with
    the ground-2D(px)/object-3D(m) metric (ref :315-323). `key` a
    threefry key, or None with `draws`, its (ROUND_HYPOTHESES * 4,)
    uniforms on the device. No host synchronisation; slots are
    allocated by the caller."""
    P = f.pts_uv.shape[0]
    h, w = f.depth.shape
    fx = cam.fx
    img0, in_img, img0_norm = _prev_pixels(f, cam)
    pool = residual & f.pts_valid & in_img
    res = ransac_mod.pnp_ransac(
        f.pts_xyz, img0_norm, pool, key, n_hypotheses=ROUND_HYPOTHESES,
        sample_size=SAMPLE, inlier_norm=cfg.max_rprj_px / fx,
        min_inliers=cfg.min_cluster_size, u=draws)

    # predicted inverse depth in the previous camera against the previous
    # frame's depth at the warped pixel, in disparity pixels
    i0y = torch.clamp(torch.round(img0[:, 1]).long(), 0, h - 1)
    i0x = torch.clamp(torch.round(img0[:, 0]).long(), 0, w - 1)
    d0 = prev_depth[i0y, i0x]
    Xc = torch.einsum('ij,pj->pi', res.T_cw[:3, :3], f.pts_xyz) \
        + res.T_cw[:3, 3]
    zc = torch.clamp(Xc[:, 2], min=1e-3)
    disp_err = fx * cam.baseline * torch.abs(
        _rdiv(1.0, torch.clamp(d0, min=1e-3)) - _rdiv(1.0, zc))
    gate = (d0 <= 0.0) | (disp_err <= cfg.disp_consistency_px)
    step1 = res.inliers & pool & gate
    n_step1 = torch.sum(step1)

    comp = _grid_cc(step1, f.pts_xyz, grid_shape, _window_cells(cam, cfg),
                    cfg.cluster_radius_3d, is_ground_round=is_ground_round,
                    rpx=cfg.ground_radius_px, stride=cfg.sample_stride)
    size = torch.zeros(P + 1, dtype=torch.int32, device=comp.device
                       ).index_add_(0, comp.long(), step1.int())[comp.long()]
    return RansacRoundOut(comp=torch.where(step1, comp, -1),
                          comp_size=torch.where(step1, size, 0),
                          n_step1=n_step1, T_cw=res.T_cw)


class FusedState(NamedTuple):
    """Device-resident inter-frame state of the fused dense tracker."""
    labels: torch.Tensor        # (P,) int32, -1 untracked
    is_ground: torch.Tensor     # (C,) bool
    alive: torch.Tensor         # (C,) bool
    ever_created: torch.Tensor  # () bool (ref's clusters_.empty() test)
    prev_gray: torch.Tensor     # (H, W)
    prev_depth: torch.Tensor    # (H, W)


class FusedOut(NamedTuple):
    labels: torch.Tensor        # (P,) int32
    skipped: torch.Tensor       # () bool (low-motion gate)
    flow_p95: torch.Tensor      # ()
    n_points: torch.Tensor      # () valid samples
    n_tracked: torch.Tensor     # () labeled samples, -1 when skipped
    n_new: torch.Tensor         # () clusters created this frame
    cluster_T: torch.Tensor     # (C, 4, 4) tracked rigid motions
    cluster_ok: torch.Tensor    # (C,) bool PnP accepted
    sizes: torch.Tensor         # (C,) member counts
    is_ground: torch.Tensor     # (C,) bool


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bincount(idx, minlength=n) for indices < n, without the host read
    of idx.max() that torch.bincount makes on a card."""
    idx = idx.long()
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


def _new_clusters(rout: RansacRoundOut, labels, alive, is_ground, ever,
                  ground_round, cfg: DenseConfig):
    """One round's slot allocation on the device: component roots (the
    points with comp[p] == p) of >= min_cluster_size points, ranked by
    index, take the free slots in ascending order (the stepwise tracker's
    first-free allocator). Returns (labels, alive, is_ground, ever, done,
    n_created)."""
    C, P = cfg.max_clusters, labels.shape[0]
    comp, size = rout.comp, rout.comp_size
    root = (comp == torch.arange(P, device=comp.device)) \
        & (size >= cfg.min_cluster_size) \
        & (rout.n_step1 >= cfg.min_cluster_size)
    rank = torch.cumsum(root.int(), dim=0) - 1
    free_order = torch.argsort(alive.to(torch.uint8), stable=True)
    n_free = C - torch.sum(alive)
    ok_root = root & (rank < n_free)
    cid_root = torch.where(ok_root,
                           free_order[torch.clamp(rank, 0, C - 1)], -1)
    cid_pt = torch.where(comp >= 0,
                         cid_root[torch.clamp(comp, 0, P - 1).long()], -1)
    assign = cid_pt >= 0
    hit = _counts(torch.where(ok_root, cid_root, C), C + 1)[:C] > 0
    labels2 = torch.where(assign, cid_pt.int(), labels)
    assigned = torch.sum(assign)
    done = (rout.n_step1 < cfg.min_cluster_size) \
        | (assigned < cfg.min_cluster_size)                     # ref :381-383
    return (labels2, alive | hit, torch.where(hit, ground_round, is_ground),
            ever | (assigned > 0), done, torch.sum(ok_root))


def _pack(res: FusedOut) -> torch.Tensor:
    """One flat float32 row a frame (labels are cluster ids < 2^24, exact
    in float32), read back with one copy."""
    return torch.cat([
        res.labels.float(),
        torch.stack([res.skipped.float(), res.flow_p95.float(),
                     res.n_points.float(), res.n_tracked.float(),
                     res.n_new.float()]),
        res.sizes.float(), res.is_ground.float(), res.cluster_ok.float(),
        res.cluster_T.reshape(-1).float()])


def frame_draws(key, cfg: DenseConfig) -> np.ndarray:
    """The uniforms fused_step's PnP-RANSACs draw under the frame's
    threefry key, as one float32 row: track_clusters' C problems x
    (TRACK_HYPOTHESES, SAMPLE) (keys split(key, C)), then each of the
    cfg.max_ransac_rounds rounds' (ROUND_HYPOTHESES, SAMPLE) (key
    fold_in(key, 100 + round)), every round's drawn whether it runs or
    not."""
    rounds = [threefry.fold_in(key, 100 + r)
              for r in range(cfg.max_ransac_rounds)]
    return np.concatenate([
        threefry.uniform_rows(threefry.split(key, cfg.max_clusters),
                              (TRACK_HYPOTHESES, SAMPLE)).reshape(-1),
        threefry.uniform_rows(rounds, (ROUND_HYPOTHESES, SAMPLE)
                              ).reshape(-1)])


def _row_width(cfg: DenseConfig) -> int:
    """The packed row's length: labels, 5 scalars, sizes, ground flags,
    accepted flags, poses."""
    return cfg.max_points + 5 + 3 * cfg.max_clusters + 16 * cfg.max_clusters


def _skipped_side(S: FusedState, f: DenseFrame, row: torch.Tensor,
                  cfg: DenseConfig) -> None:
    """lax.cond's skipped branch: the state stays as it was, the previous
    frame included, so motion accumulates (ref :722-724); the skipped
    row."""
    C, dev = cfg.max_clusters, row.device
    row.copy_(_pack(FusedOut(
        labels=S.labels, skipped=torch.ones((), dtype=torch.bool,
                                            device=dev),
        flow_p95=f.flow_p95, n_points=torch.sum(f.pts_valid),
        n_tracked=torch.full((), -1, dtype=torch.int64, device=dev),
        n_new=torch.zeros((), dtype=torch.int64, device=dev),
        cluster_T=torch.zeros((C, 4, 4), device=dev),
        cluster_ok=torch.zeros(C, dtype=torch.bool, device=dev),
        sizes=torch.zeros(C, dtype=torch.int64, device=dev),
        is_ground=S.is_ground)))


def _round(S: FusedState, f: DenseFrame, n_new: torch.Tensor,
           done: torch.Tensor, u: torch.Tensor, cam: CameraConfig,
           cfg: DenseConfig, grid_shape) -> None:
    """One RansacCluster round and its slot allocation, the round carry
    written in place: labels, alive, ground flags and ever_created into
    the state, the clusters made added to n_new, the stop into done."""
    ground_round = ~S.ever_created                               # ref :315
    rout = ransac_round(f, S.labels < 0, S.prev_depth, ground_round, None,
                        cam, cfg, grid_shape, draws=u)
    *carry, stop, made = _new_clusters(rout, S.labels, S.alive,
                                       S.is_ground, S.ever_created,
                                       ground_round, cfg)
    for dst, src in zip((S.labels, S.alive, S.is_ground, S.ever_created),
                        carry):
        dst.copy_(src)
    n_new.add_(made)
    done.copy_(stop)


def _run_side(S: FusedState, f: DenseFrame, gl: torch.Tensor,
              row: torch.Tensor, draws: torch.Tensor, cam: CameraConfig,
              cfg: DenseConfig, grid_shape) -> None:
    """lax.cond's run branch: TrackCluster, then the rounds, each under
    run_if on its device flag (lax.cond(do, do_round, skip_round) in the
    JAX lax.scan: a round after the stop does not run); the state and
    the row written in place."""
    C, R = cfg.max_clusters, cfg.max_ransac_rounds
    nt = C * TRACK_HYPOTHESES * SAMPLE
    out = track_clusters(f, S.labels, S.prev_depth, S.is_ground, S.alive,
                         None, cam, cfg, grid_shape,
                         draws=draws[:nt].reshape(C, -1))
    S.labels.copy_(out.labels)
    n_new = torch.zeros((), dtype=torch.int64, device=row.device)
    done = torch.zeros((), dtype=torch.bool, device=row.device)
    round_draws = draws[nt:].reshape(R, -1)
    for rnd in range(R):
        do = ~done & (torch.sum(S.labels < 0) >= 10)             # ref :239
        run_if(do, _round, S, f, n_new, done, round_draws[rnd], cam, cfg,
               grid_shape, name="round")
    # alive <- labels actually present (ref: mask0_ rebuild :747)
    cnt = _counts(torch.where(S.labels >= 0, S.labels, C), C + 1)[:C]
    row.copy_(_pack(FusedOut(
        labels=S.labels, skipped=torch.zeros((), dtype=torch.bool,
                                             device=row.device),
        flow_p95=f.flow_p95, n_points=torch.sum(f.pts_valid),
        n_tracked=torch.sum(S.labels >= 0), n_new=n_new,
        cluster_T=out.cluster_T, cluster_ok=out.cluster_ok, sizes=cnt,
        is_ground=S.is_ground)))
    S.alive.copy_(cnt > 0)
    S.prev_gray.copy_(gl)
    S.prev_depth.copy_(f.depth)


def fused_step(state: FusedState, gl: torch.Tensor, gr: torch.Tensor,
               draws: torch.Tensor, cam: CameraConfig, cfg: DenseConfig,
               grid_shape):
    """dense_frame, TrackCluster and the residual RansacCluster rounds
    with slot allocation on the device, branching as the JAX program
    does: lax.cond(skip, skipped, run) is two run_if sides, on the p95
    gate and on its negation (the torch binding has no ELSE), and each
    of the cfg.max_ransac_rounds rounds runs under run_if on its stop
    flag. `state`'s tensors are the carry, written in place; returns
    (state, the packed row), the row allocated before the branches and
    written by the side that runs. `draws` is frame_draws' row on the
    device. Fixed shapes, no upload, and under a capture no host read:
    the step is what FusedDenseTracker captures as one CUDA graph with
    IF nodes. Its plain version (the CPU, graphs=False) reads each flag
    on the host: the host-gated step."""
    f = dense_frame(gl, gr, state.prev_gray, cam, cfg)
    skip = f.flow_p95 < cfg.min_flow_p95
    row = gl.new_empty(_row_width(cfg))
    run_if(skip, _skipped_side, state, f, row, cfg, name="skip")
    run_if(~skip, _run_side, state, f, gl, row, draws, cam, cfg, grid_shape,
           name="run")
    return state, row


def _as_image(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return upload(np.asarray(x, np.float32), device)


class FusedDenseTracker:
    """The production tracker over fused_step: one packed row a frame,
    read back `queue_depth` frames after its dispatch (process returns
    None while the queue fills; flush returns the rest).

    graphs=True (the default) on a CUDA device: the step runs on a
    static state (FusedState's tensors at fixed addresses, written in
    place) and is captured once, at the first frame after the seed, as a
    CUDA graph (utils/cuda_graphs.StepGraphs), then replayed; a frame
    is two image copies and one upload of frame_draws' row into static
    buffers, one replay, and the row copied to pinned host memory
    without waiting. The fold waits for that copy alone (`waits`
    counts): the one host synchronisation a frame. A capture failure
    raises. graphs=False, and the CPU, run the same step eagerly."""

    def __init__(self, cam: CameraConfig, cfg: Optional[DenseConfig] = None,
                 queue_depth: int = 2, device="cuda", graphs: bool = True):
        self.cam = cam
        self.cfg = cfg or DenseConfig()
        self.device = _check_device(device)
        _, _, self._grid_shape = _sample_grid(
            cam.height, cam.width, self.cfg.sample_stride,
            self.cfg.max_points)
        self.graphed = graphs and self.device.type == "cuda"
        self.graphs: Optional[StepGraphs] = None
        self._state: Optional[FusedState] = None
        self._queue = []
        self._queue_depth = queue_depth
        self.frame_idx = 0
        self.waits = 0

    def _seed(self, gl, gr) -> FusedState:
        cfg, dev = self.cfg, self.device
        f0 = dense_frame(gl, gr, gl, self.cam, cfg)
        return FusedState(
            labels=torch.full((cfg.max_points,), -1, dtype=torch.int32,
                              device=dev),
            is_ground=torch.zeros(cfg.max_clusters, dtype=torch.bool,
                                  device=dev),
            alive=torch.zeros(cfg.max_clusters, dtype=torch.bool,
                              device=dev),
            ever_created=torch.zeros((), dtype=torch.bool, device=dev),
            prev_gray=gl.clone(), prev_depth=f0.depth)

    def _static_step(self, S: FusedState) -> torch.Tensor:
        """fused_step on the static buffers, S written in place; returns
        the packed row."""
        return fused_step(S, self._gl, self._gr, self._draws, self.cam,
                          self.cfg, self._grid_shape)[1]

    def _replay(self, gl, gr, draws: np.ndarray) -> torch.Tensor:
        if self.graphs is None:
            # the static state is the seed's, written in place
            self._gl = torch.empty_like(gl)
            self._gr = torch.empty_like(gr)
            self._draws = torch.empty(draws.shape, dtype=torch.float32,
                                      device=self.device)
        self._gl.copy_(gl)
        self._gr.copy_(gr)
        self._draws.copy_(torch.from_numpy(draws).pin_memory(),
                          non_blocking=True)
        if self.graphs is None:
            g = StepGraphs(self.device)
            g.warm_up(self._static_step,
                      FusedState(*(t.clone() for t in self._state)))
            self._packed = g.capture("step", self._static_step, self._state)
            self.graphs = g
        self.graphs.replay("step")
        return self._packed

    def _post(self, packed: torch.Tensor) -> None:
        """Queue the frame's row: on a card a copy to pinned host memory
        that nothing waits for yet, and its event."""
        if not packed.is_cuda:
            self._queue.append((packed, None))
            return
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._queue.append((host, done))

    def _fold(self) -> dict:
        row, done = self._queue.pop(0)
        if done is not None:
            done.synchronize()                # one readback a frame
            self.waits += 1
        v = row.numpy()
        P, C = self.cfg.max_points, self.cfg.max_clusters
        s = P
        scalars = v[s:s + 5]
        return {"skipped": bool(scalars[0] > 0.5),
                "flow_p95": float(scalars[1]),
                "n_points": int(scalars[2]),
                "n_tracked": int(scalars[3]),
                "n_new_clusters": int(scalars[4]),
                "labels": v[:P].astype(np.int32),
                "sizes": v[s + 5:s + 5 + C].astype(np.int32),
                "is_ground": v[s + 5 + C:s + 5 + 2 * C] > 0.5,
                "cluster_T": v[s + 5 + 3 * C:].reshape(C, 4, 4),
                "cluster_ok": v[s + 5 + 2 * C:s + 5 + 3 * C] > 0.5}

    def process(self, gray_l, gray_r) -> Optional[dict]:
        """Run one pair; returns the result of the pair run queue_depth
        calls earlier (None while the queue fills)."""
        with torch.no_grad(), full_float32():
            gl = _as_image(gray_l, self.device)
            gr = _as_image(gray_r, self.device)
            self.frame_idx += 1
            if self._state is None:
                self._state = self._seed(gl, gr)
                return None
            draws = frame_draws(threefry.prng_key(self.frame_idx), self.cfg)
            if self.graphed:
                packed = self._replay(gl, gr, draws)
            else:
                _, packed = fused_step(
                    self._state, gl, gr, upload(draws, self.device),
                    self.cam, self.cfg, self._grid_shape)
            self._post(packed)
            if len(self._queue) > self._queue_depth:
                return self._fold()
            return None

    def flush(self) -> list:
        outs = []
        while self._queue:
            outs.append(self._fold())
        return outs

    def graph_stats(self) -> Optional[dict]:
        """Captures, capture seconds, pool bytes; None where nothing was
        captured."""
        return None if self.graphs is None else self.graphs.stats()


def _read(row: torch.Tensor) -> np.ndarray:
    """A static row's values on the host, copied (the next run overwrites
    the row): on a card one synchronising readback."""
    return row.to("cpu", copy=True).numpy()


class DenseTracker:
    """Stepwise host loop holding the previous frame and the cluster
    labels: `labels` is the sample-grid form of mask0_ (ref
    tracker.cpp:747), `is_ground`/`alive` the cluster_ground_/clusters_
    maps, `prev_depth` depth0_ (:750) and `prev_gray` gray0_ (:751).
    Cluster ids are slots bounded at cfg.max_clusters; dead ids are
    recycled.

    The device work is the JAX tracker's three jitted programs, on
    static buffers allocated at the first frame, host inputs copied in
    through pinned memory without a wait (utils/device.upload):
    - frame: dense_frame of the image buffers against `prev_gray` into a
      static DenseFrame, and (flow_p95, valid samples) into a small row;
      the seed frame is the same program with `prev_gray` a copy of its
      left image;
    - track: track_clusters on the static frame; the host's labels,
      ground and alive flags copied in as one int32 row, the uniforms the
      track part of frame_draws' row, uploaded once a live frame; out
      one packed row (labels, accepted flags, inliers, motions);
    - round: ransac_round on the static frame; the residual mask and the
      round's ground flag copied in as one row, round r's uniforms copied
      from the frame's row; out one packed row (components, their sizes,
      surviving inliers, the motion).
    Each packed row is read back once: the host syncs a live frame are
    the frame's, the track's (when a cluster is alive) and one a round
    run, as the JAX tracker's host loop reads back. The host gates the
    rounds and allocates the slots (_alloc_cluster). `prev_gray` and `prev_depth`
    are static device buffers copied in from the frame's only when a
    frame is not skipped (ref :722-724, :750-752); `prev_frame` is a
    device copy of the last live frame. graphs=True (the default) on a
    CUDA device: each program is a CUDA graph (utils/cuda_graphs
    .StepGraphs, one pool: every output is a static buffer outside it),
    captured at its first run after a warm-up, then replayed; a capture
    failure raises. graphs=False, and the CPU, run the same programs
    eagerly on the same buffers. `runs` counts each program's runs."""

    PROGRAMS = ("frame", "track", "round")

    def __init__(self, cam: CameraConfig, cfg: Optional[DenseConfig] = None,
                 device="cuda", graphs: bool = True):
        self.cam = cam
        self.cfg = cfg or DenseConfig()
        self.device = _check_device(device)
        self.prev_gray: Optional[torch.Tensor] = None
        self.prev_frame: Optional[DenseFrame] = None
        self.prev_depth: Optional[torch.Tensor] = None
        self.frame_idx = 0
        self.labels: Optional[np.ndarray] = None          # (P,) int32
        self.is_ground = np.zeros(self.cfg.max_clusters, bool)
        self.alive = np.zeros(self.cfg.max_clusters, bool)
        self.ever_created = False
        self._grid_shape = None
        self.graphed = graphs and self.device.type == "cuda"
        self.graphs = StepGraphs(self.device) if self.graphed else None
        self.runs = {n: 0 for n in self.PROGRAMS}

    def _alloc(self, h: int, w: int) -> None:
        """The programs' static buffers, and prev_gray / prev_depth."""
        cfg, dev = self.cfg, self.device
        P, C = cfg.max_points, cfg.max_clusters

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self._gl, self._gr = z(h, w), z(h, w)
        self.prev_gray, self.prev_depth = z(h, w), z(h, w)
        self._f = DenseFrame(
            disparity=z(h, w), depth=z(h, w), flow=z(h, w, 2),
            edge_mask=z(h, w, dtype=torch.bool), pts_uv=z(P, 2),
            pts_xyz=z(P, 3), pts_valid=z(P, dtype=torch.bool), flow_p95=z())
        self._frame_row = z(2)
        self._draws = z(C * TRACK_HYPOTHESES * SAMPLE + cfg.max_ransac_rounds
                        * ROUND_HYPOTHESES * SAMPLE)
        self._track_in = z(P + 2 * C, dtype=torch.int32)
        self._track_row = z(P + 2 * C + 16 * C)
        self._round_in = z(P + 1, dtype=torch.bool)
        self._round_u = z(ROUND_HYPOTHESES * SAMPLE)
        self._round_row = z(2 * P + 17)
        self._pts_uv = _sample_grid(h, w, cfg.sample_stride,
                                    cfg.max_points)[0].astype(np.float32)

    def _frame_program(self) -> None:
        """dense_frame of the image buffers against prev_gray, written
        into the static frame; (flow_p95, valid samples) into its row."""
        f = dense_frame(self._gl, self._gr, self.prev_gray, self.cam,
                        self.cfg)
        for dst, src in zip(self._f, f):
            dst.copy_(src)
        self._frame_row.copy_(torch.stack([f.flow_p95.float(),
                                           torch.sum(f.pts_valid).float()]))

    def _track_program(self) -> None:
        """track_clusters on the static frame, its row written."""
        cfg = self.cfg
        P, C = cfg.max_points, cfg.max_clusters
        st = self._track_in
        out = track_clusters(
            self._f, st[:P], self.prev_depth, st[P:P + C] != 0,
            st[P + C:] != 0, None, self.cam, cfg, self._grid_shape,
            draws=self._draws[:C * TRACK_HYPOTHESES * SAMPLE].reshape(C, -1))
        self._track_row.copy_(torch.cat([
            out.labels.float(), out.cluster_ok.float(),
            out.cluster_inl.float(), out.cluster_T.reshape(-1)]))

    def _round_program(self) -> None:
        """ransac_round on the static frame, its row written."""
        P = self.cfg.max_points
        rout = ransac_round(self._f, self._round_in[:P], self.prev_depth,
                            self._round_in[P], None, self.cam, self.cfg,
                            self._grid_shape, draws=self._round_u)
        self._round_row.copy_(torch.cat([
            rout.comp.float(), rout.comp_size.float(),
            rout.n_step1.float().reshape(1), rout.T_cw.reshape(-1)]))

    def _run(self, name: str, fn) -> None:
        """Program `name`: eagerly, or its graph (captured at first run)."""
        self.runs[name] += 1
        if self.graphs is None:
            fn()
            return
        if name not in self.graphs:
            self.graphs.warm_up(fn)
            self.graphs.capture(name, fn)
        self.graphs.replay(name)

    def _alloc_cluster(self, ground: bool) -> int:
        """Allocate a cluster id slot; -1 when capacity is exhausted."""
        free = np.flatnonzero(~self.alive)
        if free.size == 0:
            return -1
        cid = int(free[0])
        self.alive[cid] = True
        self.is_ground[cid] = ground
        return cid

    def track(self, gray_l, gray_r) -> dict:
        """Process one stereo pair; returns the cluster summary (host
        dict). The first frame only seeds depth and gray; low-motion
        frames are skipped without advancing the previous frame (ref
        DenseTracker::Track, tracker.cpp:695-784)."""
        with torch.no_grad(), full_float32():
            return self._track(_as_image(gray_l, self.device),
                               _as_image(gray_r, self.device))

    def _track(self, gl: torch.Tensor, gr: torch.Tensor) -> dict:
        cfg = self.cfg
        P, C = cfg.max_points, cfg.max_clusters
        self.frame_idx += 1
        if self._grid_shape is None:
            _, _, self._grid_shape = _sample_grid(
                gl.shape[0], gl.shape[1], cfg.sample_stride, cfg.max_points)
        seed = self.prev_gray is None
        if seed:
            self._alloc(*gl.shape)
        self._gl.copy_(gl)
        self._gr.copy_(gr)
        if seed:                                          # ref :710-714
            self.prev_gray.copy_(self._gl)
            self._run("frame", self._frame_program)
            self.prev_depth.copy_(self._f.depth)
            return {"skipped": True, "reason": "first frame"}

        self._run("frame", self._frame_program)
        p95, n_points = _read(self._frame_row)
        p95 = float(p95)
        if p95 < cfg.min_flow_p95:
            return {"skipped": True, "reason": "low motion",
                    "flow_p95": p95}

        self._draws.copy_(upload(frame_draws(
            threefry.prng_key(self.frame_idx), cfg), self.device))
        clusters = []

        # ---- 1) TrackCluster: propagate previous labels (ref :740-741)
        if self.labels is not None and self.alive.any():
            self._track_in.copy_(upload(np.concatenate(
                [self.labels, self.is_ground, self.alive]).astype(np.int32),
                self.device))
            self._run("track", self._track_program)
            v = _read(self._track_row)
            labels = v[:P].astype(np.int32)
            ok = v[P:P + C] > 0.5
            inl = v[P + C:P + 2 * C].astype(np.int32)
            Ts = v[P + 2 * C:].reshape(C, 4, 4)
            for cid in np.flatnonzero(ok):
                clusters.append({
                    "id": int(cid), "tracked": True,
                    "is_ground": bool(self.is_ground[cid]),
                    "size": int((labels == cid).sum()),
                    "rigid_inliers": int(inl[cid]), "ok": True,
                    "T": Ts[cid]})
        else:
            labels = np.full(P, -1, np.int32)

        # ---- 2) RansacCluster on the residual pool (ref :743-744) ----
        residual = labels < 0
        n_new = 0
        nt, nr = C * TRACK_HYPOTHESES * SAMPLE, ROUND_HYPOTHESES * SAMPLE
        for rnd in range(cfg.max_ransac_rounds):
            if int(residual.sum()) < 10:                  # ref :239
                break
            ground_round = not self.ever_created          # ref :315
            self._round_in.copy_(upload(np.append(residual, ground_round),
                                        self.device))
            self._round_u.copy_(self._draws[nt + rnd * nr:nt + (rnd + 1) * nr])
            self._run("round", self._round_program)
            v = _read(self._round_row)
            comp = v[:P].astype(np.int32)
            size = v[P:2 * P].astype(np.int32)
            if int(v[2 * P]) < cfg.min_cluster_size:      # ref :297
                break
            big_roots = np.unique(comp[(comp >= 0)
                                       & (size >= cfg.min_cluster_size)])
            assigned = 0
            T_round = v[2 * P + 1:].reshape(4, 4)
            for root in big_roots:
                cid = self._alloc_cluster(ground_round)
                if cid < 0:
                    break                                 # capacity full
                members = comp == root
                labels[members] = cid
                residual[members] = False
                assigned += int(members.sum())
                n_new += 1
                clusters.append({
                    "id": cid, "tracked": False,
                    "is_ground": bool(self.is_ground[cid]),
                    "size": int(members.sum()),
                    "rigid_inliers": int(members.sum()), "ok": True,
                    "T": T_round})
                self.ever_created = True
            if assigned < cfg.min_cluster_size:           # ref :381-383
                break

        # ---- 3) persist state: the label grid is the new mask0_ ------
        self.alive = np.isin(np.arange(C), labels)
        self.labels = labels
        self.prev_gray.copy_(self._gl)
        self.prev_depth.copy_(self._f.depth)
        self.prev_frame = DenseFrame(*(t.clone() for t in self._f))
        return {"skipped": False, "flow_p95": p95,
                "n_points": int(n_points),
                "n_tracked": int((labels >= 0).sum()),
                "n_new_clusters": n_new,
                "labels": labels,
                "pts_uv": self._pts_uv.copy(),
                "clusters": clusters}

    def graph_stats(self) -> Optional[dict]:
        """Captures, capture seconds, pool bytes; None where nothing was
        captured."""
        return None if self.graphs is None or not self.graphs.captures \
            else self.graphs.stats()
