"""The ORB extractor's default path, plain PyTorch.

Two-tap bilinear pyramid at the cvRound level shapes ("matmul" mode),
dual-threshold FAST-9 with 3x3 non-max suppression per threshold,
per-cell top-k and a stable global top-n, the 7-tap reflect-101 Gaussian
blur, and upright 256-bit BRIEF from 31x31 patches (corners clamped into
the level). Full float32; ties break in index order. Frozen copy of the
port's plain path (the fused FAST+NMS kernel gives the same responses,
so `fused_fast` does not change the result); other options raise.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Features(NamedTuple):
    xy: torch.Tensor        # (K, 2) float32, level-0 pixel coords
    octave: torch.Tensor    # (K,) int32
    sigma2: torch.Tensor    # (K,) float32
    desc: torch.Tensor      # (K, 8) int32 packed 256-bit BRIEF
    valid: torch.Tensor     # (K,) bool


def max_keypoints(ex: dict) -> int:
    return -(-int(ex["num_features"]) // 128) * 128


def level_budgets(ex: dict) -> List[int]:
    q = 1.0 / ex["scale_factor"]
    n_levels = int(ex["num_levels"])
    n0 = ex["num_features"] * (1.0 - q) / (1.0 - q ** n_levels)
    budgets = [int(round(n0 * q ** i)) for i in range(n_levels - 1)]
    budgets.append(max(int(ex["num_features"]) - sum(budgets), 0))
    return budgets


def _check(ex: dict) -> None:
    wanted = {"pyramid_mode": "matmul", "dual_threshold": True,
              "steer_rotation": False, "descriptor_dtype": "float32"}
    for k, v in wanted.items():
        if ex[k] != v:
            raise NotImplementedError(f"reference extractor: {k}={ex[k]!r}")


# ---- pyramid ------------------------------------------------------------
@functools.lru_cache(maxsize=128)
def _resize_taps(n_in: int, n_out: int, device: torch.device):
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0.0, n_in - 1.0)
    x0 = np.floor(x).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    f = x - x0
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), x0] += (1.0 - f)
    M[np.arange(n_out), x1] += f
    nz = M != 0
    i0 = np.argmax(nz, axis=1)
    i1 = n_in - 1 - np.argmax(nz[:, ::-1], axis=1)
    rows = np.arange(n_out)
    w0 = M[rows, i0]
    w1 = np.where(i1 != i0, M[rows, i1], 0.0).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (i0, w0, i1, w1))


def resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int]):
    h, w = image.shape[-2:]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image
    i0, w0, i1, w1 = _resize_taps(h, oh, image.device)
    rows = w0[:, None] * image[..., i0, :] + w1[:, None] * image[..., i1, :]
    i0, w0, i1, w1 = _resize_taps(w, ow, image.device)
    return rows[..., i0] * w0[None, :] + rows[..., i1] * w1[None, :]


def build_pyramid(image: torch.Tensor, ex: dict) -> List[torch.Tensor]:
    h, w = image.shape[-2:]
    out = [image]
    for i in range(1, int(ex["num_levels"])):
        s = ex["scale_factor"] ** i
        out.append(resize_bilinear(out[-1], (int(round(h / s)),
                                             int(round(w / s)))))
    return out


def pad_planes(image: torch.Tensor, p: int, mode: str,
               value: float = 0.0) -> torch.Tensor:
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    kw = {"value": value} if mode == "constant" else {}
    out = F.pad(image.reshape(-1, 1, h, w), (p, p, p, p), mode=mode, **kw)
    return out.reshape(*lead, h + 2 * p, w + 2 * p)


@functools.lru_cache(maxsize=8)
def _gaussian_kernel1d(size: int, sigma: float) -> tuple:
    half = size // 2
    vals = [math.exp(-(i - half) ** 2 / (2.0 * sigma * sigma))
            for i in range(size)]
    s = sum(vals)
    return tuple(v / s for v in vals)


def _weighted_taps(views, k):
    """sum_i k[i] * views[i] as fma(k0, v0, k1 * v1), then fma(k_i, v_i,
    acc): torch.add with alpha fuses the multiply-add."""
    kf = [float(np.float32(v)) for v in k]
    acc = torch.add(views[1] * kf[1], views[0], alpha=kf[0])
    for i in range(2, len(views)):
        acc = torch.add(acc, views[i], alpha=kf[i])
    return acc


def gaussian_blur(image: torch.Tensor, size: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    k = _gaussian_kernel1d(size, sigma)
    half = size // 2
    padded = pad_planes(image, half, "reflect")
    h, w = image.shape[-2:]
    rows = _weighted_taps([padded[..., i:i + h, :] for i in range(size)], k)
    return _weighted_taps([rows[..., i:i + w] for i in range(size)], k)


# ---- FAST ---------------------------------------------------------------
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9


def _arc_from_mask(m: torch.Tensor) -> torch.Tensor:
    m2 = m | (m << 16)
    r = m2
    for k in range(1, ARC_LENGTH):
        r = r & (m2 >> k)
    return (r & 0xFFFF) != 0


def dual_response(image: torch.Tensor, thr_hi: float, thr_lo: float):
    h, w = image.shape[-2:]
    padded = pad_planes(image, 3, "replicate")
    zi = torch.zeros(image.shape, dtype=torch.int32, device=image.device)
    zf = torch.zeros_like(image)
    mb_hi, md_hi, mb_lo, md_lo = zi, zi, zi, zi
    sb_hi, sd_hi, sb_lo, sd_lo = zf, zf, zf, zf
    for k, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        diff = padded[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - image
        b_hi, d_hi = diff > thr_hi, diff < -thr_hi
        b_lo, d_lo = diff > thr_lo, diff < -thr_lo
        mb_hi = mb_hi | (b_hi.int() << k)
        md_hi = md_hi | (d_hi.int() << k)
        mb_lo = mb_lo | (b_lo.int() << k)
        md_lo = md_lo | (d_lo.int() << k)
        sb_hi = sb_hi + torch.where(b_hi, diff - thr_hi, zf)
        sd_hi = sd_hi + torch.where(d_hi, -diff - thr_hi, zf)
        sb_lo = sb_lo + torch.where(b_lo, diff - thr_lo, zf)
        sd_lo = sd_lo + torch.where(d_lo, -diff - thr_lo, zf)
    hi = torch.maximum(torch.where(_arc_from_mask(mb_hi), sb_hi, zf),
                       torch.where(_arc_from_mask(md_hi), sd_hi, zf))
    lo = torch.maximum(torch.where(_arc_from_mask(mb_lo), sb_lo, zf),
                       torch.where(_arc_from_mask(md_lo), sd_lo, zf))
    return hi, lo


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 local maxima; ties go to the earliest neighbour in row-major
    order."""
    padded = pad_planes(score, 1, "constant", -1.0)
    h, w = score.shape[-2:]
    maxval = None
    earlier = None
    for i, (dy, dx) in enumerate([(dy, dx) for dy in range(3)
                                  for dx in range(3)]):
        v = padded[..., dy:dy + h, dx:dx + w]
        maxval = v if maxval is None else torch.maximum(maxval, v)
        if i < 4:
            e = v >= score
            earlier = e if earlier is None else (earlier | e)
    is_max = (score >= maxval) & (score > 0.0)
    return torch.where(is_max & ~earlier, score, torch.zeros_like(score))


def detect_dual(image: torch.Tensor, thr_hi: float, thr_lo: float,
                border: int) -> torch.Tensor:
    """NMS per threshold, +1e4 rank boost for high-threshold survivors,
    border masked."""
    resp_hi, resp_lo = dual_response(image, thr_hi, thr_lo)
    hi = nms3x3(resp_hi)
    lo = nms3x3(resp_lo)
    h, w = image.shape[-2:]
    eff = torch.where(hi > 0.0, lo + 1e4, lo)
    ys = torch.arange(h, device=image.device)[:, None]
    xs = torch.arange(w, device=image.device)[None, :]
    inside = ((ys >= border) & (ys < h - border) &
              (xs >= border) & (xs < w - border))
    return torch.where(inside, eff, torch.zeros_like(eff))


# ---- selection ----------------------------------------------------------
def _topk_rows(cells: torch.Tensor, k: int):
    s = cells.shape[-1]
    col = torch.arange(s, dtype=torch.int32, device=cells.device)
    cur = cells
    vals, idxs = [], []
    neg_inf = torch.full_like(cells, -float("inf"))
    for _ in range(k):
        m = cur.max(dim=-1, keepdim=True).values
        first = torch.where(cur >= m, col, s).min(dim=-1, keepdim=True).values
        vals.append(m)
        idxs.append(first)
        cur = torch.where(col == first, neg_inf, cur)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def select_keypoints(score: torch.Tensor, cell_size: int, num_out: int,
                     per_cell: int):
    """(xy (num_out, 2), valid (num_out,)): the per-cell top-k, every
    non-empty cell's winner first, then a stable descending sort."""
    h, w = score.shape[-2:]
    ph, pw = (-h) % cell_size, (-w) % cell_size
    padded = F.pad(score, (0, pw, 0, ph)) if (ph or pw) else score
    ncy, ncx = padded.shape[-2] // cell_size, padded.shape[-1] // cell_size
    cells = padded.reshape(ncy, cell_size, ncx, cell_size)
    cells = cells.transpose(-3, -2).reshape(ncy * ncx, cell_size * cell_size)
    k = min(per_cell, cell_size * cell_size)
    top_vals, top_idx = _topk_rows(cells, k)
    rank0 = torch.arange(k, device=score.device) == 0
    zero = torch.zeros_like(top_vals)
    boost = torch.where(rank0, torch.where(top_vals > 0.0,
                                           torch.full_like(top_vals, 1e6),
                                           zero), zero)
    ranked = torch.where(top_vals > 0.0, top_vals + boost,
                         torch.full_like(top_vals, -1.0))
    flat_vals = ranked.flatten(-2)
    cell_ids = torch.arange(ncy * ncx,
                            device=score.device).repeat_interleave(k)
    inner = top_idx.flatten(-2).long()
    n = min(num_out, flat_vals.shape[-1])
    sel_vals, sel = torch.sort(flat_vals, dim=-1, descending=True,
                               stable=True)
    sel_vals, sel = sel_vals[:n], sel[:n]
    sel_cell = cell_ids[sel]
    sel_inner = inner[sel]
    ys = (sel_cell // ncx) * cell_size + sel_inner // cell_size
    xs = (sel_cell % ncx) * cell_size + sel_inner % cell_size
    valid = sel_vals > 0.0
    xy = torch.stack([xs, ys], dim=-1).float()
    if n < num_out:
        xy = F.pad(xy, (0, 0, 0, num_out - n))
        valid = F.pad(valid, (0, num_out - n))
    return xy, valid


# ---- upright BRIEF ------------------------------------------------------
PATCH_RADIUS = 15
NUM_PAIRS = 256


@functools.lru_cache(maxsize=1)
def sampling_pattern() -> np.ndarray:
    """(2, 256, 2) float32 (x, y) offsets from a seeded generator."""
    rng = np.random.default_rng(20260816)
    pts = []
    while len(pts) < NUM_PAIRS * 2:
        cand = rng.normal(0.0, PATCH_RADIUS / 2.4, size=(NUM_PAIRS, 2))
        keep = cand[np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 1.0]
        pts.extend(keep.tolist())
    arr = np.asarray(pts[:NUM_PAIRS * 2], dtype=np.float32)
    return arr.reshape(2, NUM_PAIRS, 2)


@functools.lru_cache(maxsize=8)
def _pick_indices(device: torch.device):
    r = PATCH_RADIUS
    side = 2 * r + 1
    pat = np.round(sampling_pattern()).astype(np.int64)
    idx_a = (pat[0, :, 1] + r) * side + (pat[0, :, 0] + r)
    idx_b = (pat[1, :, 1] + r) * side + (pat[1, :, 0] + r)
    return (torch.as_tensor(idx_a, device=device),
            torch.as_tensor(idx_b, device=device))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32 words, bit j of word i = bit
    32i+j."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(*bits.shape[:-1], 8, 32).long() << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def gather_blocks(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  bh: int, bw: int) -> torch.Tensor:
    """(K, bh, bw) windows at corners (ys, xs), clamped into the image."""
    h, w = img.shape
    dev = img.device
    y0 = ys.long().clamp(0, h - bh)
    x0 = xs.long().clamp(0, w - bw)
    rows = y0[:, None] + torch.arange(bh, device=dev)[None, :]
    cols = x0[:, None] + torch.arange(bw, device=dev)[None, :]
    return img[rows[:, :, None], cols[:, None, :]]


def upright_descriptors(blurred: torch.Tensor,
                        xy: torch.Tensor) -> torch.Tensor:
    side = 2 * PATCH_RADIUS + 1
    corner = torch.round(xy).int() - PATCH_RADIUS
    patches = gather_blocks(blurred, corner[:, 1], corner[:, 0], side, side)
    flat = patches.flatten(-2)
    idx_a, idx_b = _pick_indices(patches.device)
    return pack_bits(flat[..., idx_a] < flat[..., idx_b])


def extract(image: torch.Tensor, ex: dict) -> Features:
    """(H, W) float32 grey image -> Features with max_keypoints slots
    (invalid slots zeroed), from a configuration's "extractor" section."""
    _check(ex)
    levels = build_pyramid(image, ex)
    border = int(ex["patch_radius"]) + 1
    dev = image.device
    cell = int(ex["cell_size"])
    xys, octs, sig, descs, valids = [], [], [], [], []
    for lvl, (img_l, n_l) in enumerate(zip(levels, level_budgets(ex))):
        if n_l == 0:
            continue
        eff = detect_dual(img_l, float(ex["fast_threshold_high"]),
                          float(ex["fast_threshold_low"]), border)
        h_l, w_l = img_l.shape[-2:]
        ncells = ((h_l + cell - 1) // cell) * ((w_l + cell - 1) // cell)
        per_cell = min(4, max(1, -(-4 * n_l // ncells)))
        xy, valid = select_keypoints(eff, cell, n_l, per_cell)
        blurred = gaussian_blur(img_l, 7, ex["blur_sigma"])
        scale = ex["scale_factor"] ** lvl
        xys.append(xy * scale)
        octs.append(torch.full((n_l,), lvl, dtype=torch.int32, device=dev))
        sig.append(torch.full((n_l,), scale * scale, dtype=torch.float32,
                              device=dev))
        descs.append(upright_descriptors(blurred, xy))
        valids.append(valid)
    xy, octave, sigma2 = torch.cat(xys), torch.cat(octs), torch.cat(sig)
    desc, valid = torch.cat(descs), torch.cat(valids)
    pad = max_keypoints(ex) - xy.shape[0]
    if pad > 0:
        xy = F.pad(xy, (0, 0, 0, pad))
        octave = F.pad(octave, (0, pad))
        sigma2 = F.pad(sigma2, (0, pad), value=1.0)
        desc = F.pad(desc, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    return Features(xy=xy, octave=octave, sigma2=sigma2, desc=desc,
                    valid=valid)
