#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (slam_toolkit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: require CUDA, print the card's name and power limit,
   build the CUDA kernels from csrc/ (one nvcc per source, in parallel)
   and print the build time.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with its stated tolerance, and its
   times:
   - `ms`: device time of one wrapper call, host work out of the window
     (device_ms: the call captured once in a CUDA graph, 50 replays
     queued behind a torch.cuda._sleep that outlasts their enqueue,
     CUDA events around the replays; median of 5 rounds). The same timer
     gives `library_ms`, one PyTorch call computing the same function,
     where there is one.
   - `host_ms`: host-clock time of one wrapper call with no synchronise,
     median of 50 calls (the port is host-bound, so this matters too).
   - `plain_ms`: CUDA events around single calls of the plain version,
     host work included (median of 30; 10 for local BA): no yardstick.
   - `bound_ms`: the larger of its bytes over 3.35 TB/s and its
     operations over 67 TFLOP/s (the H100's published HBM rate and
     float32 peak). The gather's and the stereo SAD's bytes count the
     images' 32-byte sectors that their windows (SAD: the left windows
     and the right strips) cover, not the whole images. The top-2's
     operations count what its output needs on this run's inputs: the
     float32 pixel gate on every pair, and the Hamming distance and
     running top-2 only for the pairs inside 2r, in integer operations
     at the rates of their type (__popc at 16 a clock per SM); its dense
     count of earlier commits, 36 float32 operations a pair, is printed
     beside it.
   The gather is timed as the main path launches it, a frame's 31x31
   windows at every pyramid level's budget in one launch (its bound and
   its library time, one unfold call a level, summed over the levels),
   and level 0's 434 windows alone. The top-2 matcher is exact in every
   column, with the share of its pairs inside r and 2r. FAST+NMS is
   timed as the fused path launches it, a frame's 8 levels in one launch
   (frame 0 of the track; its level 0 alone and a textured-noise frame
   beside it), bit-exact on every level in both modes; its bound counts
   the work its outputs need on the run's input (a response only for the
   (pixel, threshold, side) triples that pass the cardinal test, the NMS
   only for the positive centres), the dense count of earlier commits
   printed beside it. Local BA is also timed at 0 and 1 iterations.
   Local BA and the pose LM are cluster kernels (8 CTAs holding their
   share of the points / observations in shared memory); for local BA
   the script also prints where a solve's time goes, phase by phase,
   from the kernel's own clock64() counts on its first CTA, what those
   clocks cost, and each cluster kernel's capacity (points,
   observations).
3. The main path at full width: SlamConfig() (1241x376, 2000 features,
   3072 tracked landmarks, local BA over 8 keyframes x 1024 points), 48
   synthetic frames on a +0.8 m/frame track,
   ChunkedSlamEngine(chunk_size=16, device="cuda"), 3 chunks, then
   trajectory_refined(). Every kernel's launch count is reset just
   before and read just after; kernels 1-5 must have launched, the
   gather once a frame, local BA once per keyframe after the bootstrap;
   ATE must stay <= 0.138 m. The inputs projection_match hands to the
   top-2 matcher on one mid-run frame are kept on the card; after the
   run the kernel must be exact against the plain version on them, and
   its device time there is printed beside the synthetic case's.
4. The same 48 frames with extractor.fused_fast=True: counts reset
   before and read after; FAST launches once a frame (all levels in one
   launch), keyframe flags equal phase 3's, translations within 1e-4 m
   of it.
5. The first 8 frames again through the port's CPU path (plain
   versions, local BA included); fails on a frame whose translation
   differs by > 0.25 m.
6. The kernel table as one JSON line, then the result line.

It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 50, rounds: int = 5) -> float:
    """Device time of one fn() call in ms, with the host's work out of the
    event window.

    fn() runs once to warm up, then is captured once in a CUDA graph
    (the ctypes launch goes to the current stream, the capture stream).
    Each round enqueues a torch.cuda._sleep, the start event, n replays
    of the graph and the end event. The sleep is doubled until it
    outlasts the host's enqueue of the n replays, so the device runs them
    back to back. The result is the median over rounds of elapsed / n:
    the kernel with whatever device work its wrapper enqueues (dtype
    casts of the inputs), and no host time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    cycles, times = 1 << 20, []
    while len(times) < rounds:
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            graph.replay()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if slept.elapsed_time(start) < 1.5 * enqueue_ms:
            cycles *= 2                    # the device caught up: again
            continue
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times))


def host_ms(fn, n: int = 50) -> float:
    """Median host-clock time of one fn() call in ms, with no synchronise
    inside the timed call (the queue is drained every 10 calls, outside
    the window, so that it never fills)."""
    fn()
    times = []
    for i in range(n):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def call_ms(fn, reps: int = 30) -> float:
    """Median CUDA-event time of single fn() calls in ms, host work
    included: the plain versions' timer (they are no yardstick of speed)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def row_times(kernel_fn, plain_fn, plain_reps: int = 30) -> dict:
    """The timing columns of a kernel row with no library call."""
    return {"ms": device_ms(kernel_fn), "host_ms": host_ms(kernel_fn),
            "plain_ms": call_ms(plain_fn, plain_reps), "library_ms": None}


def to_dev(a, dev) -> torch.Tensor:
    """numpy -> tensor on `dev`; uint32 descriptor words as int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def random_words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _textured(h, w, rng):
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) * 0.25 + base * 0.5 +
                np.roll(base, -1, ax) * 0.25)
    return np.round(base).astype(np.float32)


HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak (an FMA counts 2)
# The float32 peak is 128 FMA lanes a clock on each of 132 SMs, so the
# clock it assumes is 67e12 / (2 * 128 * 132) = 1.98 GHz. At that clock,
# by the CUDA programming guide's throughput table for compute capability
# 9.0, 32-bit integer add, compare and logic run at 64 lanes a clock per
# SM, and __popc at 16.
SM_CLOCK_HZ = F32_OPS_PER_S / (2 * 128 * 132)
INT32_OPS_PER_S = 64 * 132 * SM_CLOCK_HZ
POPC_OPS_PER_S = 16 * 132 * SM_CLOCK_HZ


def bound(n_bytes: float, n_ops: float, int_ops: float = 0,
          popc_ops: float = 0) -> dict:
    """Least time for the work: bytes moved once over the memory rate, or
    operations over their type's peak rate (float32, 32-bit integer,
    __popc; the types share the SMs' issue slots, so their times add),
    whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S +
             popc_ops / POPC_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def window_bytes(img, ys, xs, rows: int, cols: int) -> int:
    """Bytes of img that rows x cols windows at corners (ys, xs) must read:
    the 32-byte sectors (the unit the memory system moves) that hold a
    pixel of their union, marked in a mask of the image, its rows laid
    end to end from an aligned start."""
    h, w = img.shape
    mask = torch.zeros(h, w, dtype=torch.bool, device=img.device)
    ry = torch.arange(rows, device=img.device)
    rx = torch.arange(cols, device=img.device)
    mask[(ys.long()[:, None] + ry)[:, :, None],
         (xs.long()[:, None] + rx)[:, None, :]] = True
    per = 32 // img.element_size()
    flat = torch.nn.functional.pad(mask.flatten(), (0, -mask.numel() % per))
    return int(flat.view(-1, per).any(1).sum()) * 32


# ---------------------------------------------------------------- phase 2
def _gather_case(img, k: int, side: int, rng):
    """k random window corners inside img, the kernel's and the plain
    version's calls, and one PyTorch call for the same function: an
    advanced-index gather of the image's window view (unfold)."""
    from slam_toolkit_tpu_torch.ops import patches
    h, w = img.shape
    ys = to_dev(rng.integers(0, h - side + 1, k).astype(np.int32), img.device)
    xs = to_dev(rng.integers(0, w - side + 1, k).astype(np.int32), img.device)
    win = img.unfold(0, side, 1).unfold(1, side, 1)
    yl, xl = ys.long(), xs.long()
    return (ys, xs,
            lambda: patches.gather_blocks_cuda(img, ys, xs, side, side),
            lambda: patches.gather_blocks_plain(img, ys, xs, side, side),
            lambda: win[yl, xl])


def check_gather(dev, rng):
    """Exact at 2048 windows of 31x31 and 37x37 on one image; then the
    main path's launch: a frame's 31x31 BRIEF windows at each pyramid
    level's budget (434 at level 0), all levels in one launch, exact
    against the per-level plain gather. Level 0's one-image launch is
    timed too. The row's bound sums the levels' bounds, its library time
    the levels' unfold calls (one a level)."""
    from slam_toolkit_tpu_torch.config import ExtractorConfig
    from slam_toolkit_tpu_torch.ops import patches, pyramid
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    h, w, side = 376, 1241, 31
    img = to_dev(rng.uniform(0, 255, (h, w)).astype(np.float32), dev)
    err = 0.0
    for s in (31, 37):
        _, _, kern, plain, lib = _gather_case(img, 2048, s, rng)
        out, ref = kern(), plain()
        e = float((out - ref).abs().max())
        print(f"[phase2] gather 2048x{s}x{s}: max_abs_err {e}")
        if not (torch.equal(out, ref) and torch.equal(lib(), ref)):
            raise AssertionError(f"gather {s}x{s}: kernel, plain and unfold "
                                 "disagree")
        err = max(err, e)
        if s == side:
            print(f"[phase2] gather 2048x31x31: kernel {device_ms(kern):.4f}"
                  f" ms, unfold {device_ms(lib):.4f} ms (device)")
    cfg = ExtractorConfig()
    imgs, ys, xs, counts, libs, read = [], [], [], [], [], 0
    for (lh, lw), k in zip(pyramid.level_shapes(h, w, cfg),
                           level_budgets(cfg)):
        if k == 0:
            continue
        img_l = to_dev(rng.uniform(0, 255, (lh, lw)).astype(np.float32), dev)
        y, x, kern, _, lib = _gather_case(img_l, k, side, rng)
        # the image sectors the windows cover
        cover = window_bytes(img_l, y, x, side, side)
        if not imgs:                               # level 0, one image
            print(f"[phase2] gather level 0 alone, {k}x31x31 of {lh}x{lw}: "
                  f"kernel {device_ms(kern):.4f} ms, unfold "
                  f"{device_ms(lib):.4f} ms (device); the windows cover "
                  f"{cover} of the image's {nbytes(img_l)} bytes")
        imgs.append(img_l)
        ys.append(y)
        xs.append(x)
        counts.append(k)
        libs.append(lib)
        read += cover
    ys, xs = torch.cat(ys), torch.cat(xs)

    def kern():
        return patches.gather_blocks_multi_cuda(imgs, ys, xs, counts, side,
                                                side)

    def plain():
        offs = np.cumsum([0] + counts)
        return torch.cat([patches.gather_blocks_plain(
            img, ys[a:b], xs[a:b], side, side)
            for img, a, b in zip(imgs, offs[:-1], offs[1:])])
    out, ref = kern(), plain()
    if not torch.equal(out, ref):
        raise AssertionError(f"gather of a frame's {len(counts)} levels "
                             "differs from the per-level plain gather")
    # the image sectors, the corners, the output
    b = bound(read + nbytes(ys, xs, out), 0)
    row = {"ms": device_ms(kern), "host_ms": host_ms(kern),
           "plain_ms": call_ms(plain),
           "library_ms": sum(device_ms(lib) for lib in libs), **b}
    print(f"[phase2] gather, a frame's {len(counts)} levels ({sum(counts)} "
          f"windows 31x31, budgets {counts}) in one launch: kernel "
          f"{row['ms']:.4f} ms (device), wrapper {row['host_ms']:.4f} ms "
          f"(host), unfold {row['library_ms']:.4f} ms ({len(counts)} calls, "
          f"summed), bound {row['bound_ms']:.6f} ms (summed), exact")
    return {"name": "patch_gather",
            "source": "slam_toolkit_tpu_torch/csrc/patch_gather.cu",
            "replaces": "slam_toolkit_tpu/ops/patches.py:113",
            "kernel": patches.KERNEL, "max_abs_err": err, **row}


def check_topk2(dev, rng):
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    m, n, r, w, h = 3072, 2048, 50.0, 1241, 376
    a_desc, b_desc = random_words(rng, m), random_words(rng, n)
    b_desc[: n // 2] = a_desc[: n // 2] ^ (rng.random((n // 2, 8)) < 0.05) \
        .astype(np.uint32)                 # near-duplicates: real matches
    a_uv = rng.uniform(0, [w, h], (m, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [w, h], (n, 2)).astype(np.float32)
    b_xy[: n // 2] = a_uv[: n // 2] + rng.normal(0, 20, (n // 2, 2))
    a_uv[m - 256:] = 1e7                   # invisible landmarks
    t = [to_dev(x, dev) for x in (a_desc, b_desc, a_uv, b_xy)]
    err = topk2_exact(t, r, "synthetic")
    row = row_times(lambda: mk.topk2_match_cuda(*t, r),
                    lambda: mk.topk2_match_plain(*t, r))
    b, dense_ms = topk2_bound(t, r)
    print(f"[phase2] top-2 M={m} N={n} r={r}: exact, {gate_shares(t, r)}, "
          f"rows with a match in r: "
          f"{int((mk.topk2_match_plain(*t, r)[:, 0] < 1e8).sum())}; bound "
          f"{b['bound_ms']:.6f} ms from the pairs inside 2r, "
          f"{dense_ms:.6f} ms counted dense (36 float32 operations a pair, "
          "the bound before the gate-first design)")
    return {"name": "topk2_match",
            "source": "slam_toolkit_tpu_torch/csrc/match_topk2.cu",
            "replaces": "slam_toolkit_tpu/ops/match_kernel.py:139",
            "kernel": mk.KERNEL, "max_abs_err": err, **row, **b}


def topk2_bound(t, r: float):
    """The top-2's bound from the work its output needs, and the dense
    count of the earlier bound (ms). Every pair needs the pixel gate: 2
    sub, 2 mul, 1 add and 2 compares in float32. Only a pair inside 2r
    needs its Hamming distance (8 __popc; 8 xor and 7 adds) and the
    running top-2 (~6 integer compares and selects). The dense count
    gives every pair all of it, 36 operations at the float32 rate."""
    m, n = t[0].shape[0], t[1].shape[0]
    _, in_2r = gate_counts(t, r)
    n_bytes = nbytes(*t) + m * 8 * 4                  # inputs, (M, 8) out
    return (bound(n_bytes, m * n * 7, int_ops=in_2r * 21,
                  popc_ops=in_2r * 8),
            bound(n_bytes, m * n * 36)["bound_ms"])


def topk2_exact(t, r: float, what: str) -> float:
    """The kernel against the plain version, every column exact (empty
    rows included: BIG and argbest 0); returns the max abs error (0)."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    out = mk.topk2_match_cuda(*t, r)
    ref = mk.topk2_match_plain(*t, r)
    if not torch.equal(out, ref):
        bad = sorted({int(c) for c in torch.nonzero(out != ref)[:, 1]})
        raise AssertionError(f"top-2 on the {what} case: columns {bad} "
                             "differ from the plain version")
    return float((out - ref).abs().max())


def gate_counts(t, r: float):
    """The number of (M, N) pairs inside r and inside 2r."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    _, _, a_uv, b_xy = t
    du = a_uv[:, None, 0] - b_xy[None, :, 0]
    dv = a_uv[:, None, 1] - b_xy[None, :, 1]
    d2 = du * du + dv * dv
    r1sq, r2sq = mk._gates(r)
    return int((d2 <= r1sq).sum()), int((d2 <= r2sq).sum())


def gate_shares(t, r: float) -> str:
    """The share of the (M, N) pairs inside r and inside 2r, and of the
    rows (landmarks) that are visible (u below 1e6)."""
    a_uv, pairs = t[2], t[0].shape[0] * t[1].shape[0]
    in_r, in_2r = gate_counts(t, r)
    return (f"pairs inside r {100 * in_r / pairs:.3f}%, inside 2r "
            f"{100 * in_2r / pairs:.3f}%, visible rows "
            f"{int((a_uv[:, 0] < 1e6).sum())} of {a_uv.shape[0]}")


class MatchCapture:
    """Keeps, on the card, the inputs that projection_match hands to the
    top-2 matcher on its `call`-th call (one mid-run frame); the matcher
    itself runs as before, once a call."""

    def __init__(self, call: int):
        from slam_toolkit_tpu_torch.frontend import matching
        self.matching, self.orig = matching, matching.topk2_match
        self.call, self.calls, self.args = call, 0, None
        matching.topk2_match = self

    def __call__(self, *args):
        self.calls += 1
        if self.calls == self.call:
            self.args = [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args]
        return self.orig(*args)

    def close(self):
        self.matching.topk2_match = self.orig


def check_topk2_frame(cap: MatchCapture, synthetic_ms: float, label: str):
    """The top-2 kernel on the captured main-path frame: exact against
    the plain version, the gate shares there, and its device time beside
    the synthetic case's."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    if cap.args is None:
        raise AssertionError(f"the matcher was called {cap.calls} times, "
                             f"no call {cap.call} to capture")
    *t, r = cap.args
    m, n = t[0].shape[0], t[1].shape[0]
    topk2_exact(t, r, f"main-path frame (call {cap.call})")
    ms = device_ms(lambda: mk.topk2_match_cuda(*t, r))
    b, dense_ms = topk2_bound(t, r)
    print(f"[phase3] {label} top-2 on the main path's call {cap.call} "
          f"(M={m} N={n} r={r}): exact, {gate_shares(t, r)}; kernel "
          f"{ms:.4f} ms (device) there, {synthetic_ms:.4f} ms on the "
          f"synthetic case; bound there {b['bound_ms']:.6f} ms "
          f"({b['bound_by']}), {dense_ms:.6f} ms counted dense")


def check_pose_lm(dev, rng):
    from slam_toolkit_tpu_torch.config import TrackerConfig
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.ops import pose_lm_kernel as plk
    n = 3072
    Xw = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                   rng.uniform(4, 60, n)], -1).astype(np.float32)
    xi = torch.from_numpy(rng.uniform(-0.2, 0.2, 6).astype(np.float32))
    T_true = se3.exp(xi).numpy()
    Xc = (T_true[:3, :3] @ Xw.T).T + T_true[:3, 3]
    z = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    z += rng.normal(0, 1e-3, z.shape).astype(np.float32)
    out_idx = rng.random(n) < 0.2                         # 20% outliers
    z[out_idx] += rng.normal(0, 0.3, (int(out_idx.sum()), 2)) \
        .astype(np.float32)
    mask = np.ones(n, bool)
    mask[::13] = False
    args = [torch.eye(4, device=dev)] + [
        to_dev(a, dev) for a in (Xw, z, np.full(n, 1e-6, np.float32), mask)]
    cfg = TrackerConfig()
    out = plk.optimize_pose_cuda(*args, cfg)
    ref = plk.optimize_pose_plain(*args, cfg)
    err = float((out.T_cw - ref.T_cw).abs().max())
    gt_err = float((out.T_cw.cpu() - torch.from_numpy(T_true)).abs().max())
    print(f"[phase2] pose LM N={n}, 20% outliers: max |T - T_plain| {err} "
          f"(bound 2e-3), max |T - T_true| {gt_err}")
    if not err <= 2e-3:
        raise AssertionError(f"pose LM differs from the plain solver: {err}")
    return {"name": "pose_lm",
            "source": "slam_toolkit_tpu_torch/csrc/pose_lm.cu",
            "replaces": "slam_toolkit_tpu/ops/pose_lm_kernel.py:224",
            "kernel": plk.KERNEL, "max_abs_err": err,
            **row_times(lambda: plk.optimize_pose_cuda(*args, cfg),
                        lambda: plk.optimize_pose_plain(*args, cfg)),
            # per observation and iteration: ~186 operations for the
            # normal equations, ~40 for the trial cost; 80 for the first
            # cost and the final r2
            **bound(nbytes(*args, out.T_cw, out.cost, out.inlier_r2),
                    n * (cfg.num_iterations * 226 + 80))}


def check_sad(dev, rng):
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    h, w, k, max_disp, d = 376, 1241, 2048, 100, 23
    base = _textured(h, w + d, rng)
    left, right = to_dev(base[:, :w], dev), to_dev(base[:, d:d + w], dev)
    xl = rng.integers(0, w, k)
    yl = rng.integers(0, h, k)
    side, sw = 2 * sad.WIN + 1, sad._strip_w(max_disp)

    def i32(a):
        return to_dev(a.astype(np.int32), dev)
    ys0 = i32(np.clip(yl - sad.WIN, 0, h - side))
    xl0 = i32(np.clip(xl - sad.WIN, 0, w - side))
    xs0 = i32(np.clip(xl - (max_disp + sad.WIN + sad.PAD), 0, w - sw))
    args = (left, right, ys0, xl0, xs0, max_disp)
    out = sad.sad_curve_cuda(*args)
    ref = sad.sad_curve_plain(*args)
    err = float((out - ref).abs().max())
    # the sectors the left windows and the right strips cover, the
    # corners, the curves; per output and window pixel a subtract and an
    # add (the absolute value is an operand modifier of the add)
    left_b = window_bytes(left, ys0, xl0, side, side)
    right_b = window_bytes(right, ys0, xs0, side, sw)
    b = bound(left_b + right_b + nbytes(ys0, xl0, xs0, out),
              out.numel() * side * side * 2)
    print(f"[phase2] SAD K={k} max_disp={max_disp}: max_abs_err {err} "
          f"(rtol 1e-5, atol 1e-3); the windows cover {left_b} of the left "
          f"image's {nbytes(left)} bytes, the strips {right_b} of the "
          f"right's; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    return {"name": "stereo_sad",
            "source": "slam_toolkit_tpu_torch/csrc/stereo_sad.cu",
            "replaces": "slam_toolkit_tpu/ops/stereo_sad.py:128",
            "kernel": sad.KERNEL, "max_abs_err": err,
            **row_times(lambda: sad.sad_curve_cuda(*args),
                        lambda: sad.sad_curve_plain(*args)), **b}


def _ba_problem(dev, rng, W=8, P=1024, noise=5e-4):
    """A production-shape local-BA problem: W = 8 poses along +z (slot 0
    the fixed gauge, slot 5 an invalid pose), P = 1024 points, every
    edge stereo, 5% of the edges 30-sigma outliers; every 9th point fixed
    (anchored outside the window), the last 24 points empty."""
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.optim.local_ba import BAProblem
    Xw = np.stack([rng.uniform(-15, 15, P), rng.uniform(-3, 3, P),
                   rng.uniform(6, 60, P)], -1).astype(np.float32)
    xi = np.zeros((W, 6), np.float32)
    xi[:, 2] = -0.8 * np.arange(W)
    T_true = se3.exp(torch.from_numpy(xi))
    dxi = rng.uniform(-1e-3, 1e-3, (W, 6)).astype(np.float32)
    dxi[0] = 0.0
    T_init = se3.exp(torch.from_numpy(dxi)) @ T_true
    Xc = (Xw[None] @ T_true[:, :3, :3].numpy().transpose(0, 2, 1)
          + T_true[:, None, :3, 3].numpy())
    z = np.stack([Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2],
                  (Xc[..., 0] - 0.537) / Xc[..., 2]], -1).astype(np.float32)
    z += rng.normal(0, noise, z.shape).astype(np.float32)
    bad = rng.uniform(size=(W, P)) < 0.05
    z[bad, :2] += 30 * noise
    obs = (Xc[..., 2] > 1.0) & (rng.uniform(size=(W, P)) < 0.6)
    pose_valid = np.ones(W, bool)
    pose_valid[5] = False
    pv = np.ones(P, bool)
    pv[-24:] = False
    free = np.ones(P, bool)
    free[::9] = False

    def t(a):
        return to_dev(a, dev)
    return BAProblem(
        T_cw=T_init.to(dev), pose_fixed=t(np.arange(W) == 0),
        pose_valid=t(pose_valid),
        Xw=t(Xw + rng.normal(0, 5e-3, Xw.shape).astype(np.float32)),
        point_valid=t(pv), z=t(z),
        inv_sigma=t(np.full((W, P), 1 / noise / 3, np.float32)),
        obs_mask=t(obs), stereo_mask=t(obs),
        baseline=torch.tensor(0.537, device=dev), point_free=t(free))


def ba_ops(W: int, P: int, iters: int) -> int:
    """Operations of the local-BA solve, counted from the algorithm: per
    edge and iteration ~327 for residual, Jacobians and the Hpp, bp,
    Hll, bl and Hpl terms, 144 for A = Hpl Hll^-1 and its rhs term, 33
    for the pose sums, 40 for the trial cost; per point ~40 for the 3x3
    inverse and 36 W + 18 for back-substitution; the S_off product
    2 (6W)^2 3P and the Gauss-Jordan 2 (6W)^2 (6W+1); the first cost and
    the final r2 ~70 per edge."""
    n6 = 6 * W
    per_iter = (W * P * (327 + 144 + 33 + 40) + P * (40 + 36 * W + 18) +
                2 * n6 * n6 * 3 * P + 2 * n6 * n6 * (n6 + 1))
    return iters * per_iter + W * P * 70


def _ba_kw(lb) -> dict:
    return dict(iters=lb.num_iterations, huber_delta=lb.huber_delta,
                lambda0=lb.lm_lambda0, lambda_up=lb.lm_lambda_up,
                lambda_down=lb.lm_lambda_down, trim_sigma=lb.trim_sigma)


def check_local_ba(dev, rng):
    from slam_toolkit_tpu_torch.config import LocalBAConfig
    from slam_toolkit_tpu_torch.ops import ba_kernel
    lb = LocalBAConfig()                  # trim_sigma 5.0, 10 iterations
    W, P = lb.window_keyframes, lb.max_points
    p = _ba_problem(dev, rng, W, P)
    kw = _ba_kw(lb)
    out = ba_kernel.solve_ba_cuda(p, **kw)
    ref = ba_kernel.solve_ba_plain(p, **kw)
    start = ba_kernel.solve_ba_plain(p, **dict(kw, iters=0))
    pv = p.point_valid
    act = p.obs_mask & p.pose_valid[:, None] & pv[None, :]
    err_T = float((out.T_cw - ref.T_cw).abs().max())
    err_X = float((out.Xw[pv] - ref.Xw[pv]).abs().max())
    print(f"[phase2] local BA W={W} P={P} trim {lb.trim_sigma}: "
          f"max |T - T_plain| {err_T} (bound 3e-3), max |X - X_plain| "
          f"{err_X} (bound 2e-2), cost {float(start.cost):.3f} -> "
          f"{float(out.cost):.3f} (plain {float(ref.cost):.3f})")
    if not (err_T <= 3e-3 and err_X <= 2e-2):
        raise AssertionError("local BA differs from the plain solver")
    torch.testing.assert_close(out.edge_r2[act], ref.edge_r2[act], rtol=0.2,
                               atol=0.5)
    if not (torch.equal(out.T_cw[5], p.T_cw[5]) and
            torch.equal(out.Xw[~pv], p.Xw[~pv]) and
            torch.equal(out.Xw[~p.point_free], p.Xw[~p.point_free])):
        raise AssertionError("local BA moved a masked or fixed slot")
    if not float(out.cost) < float(start.cost):
        raise AssertionError("local BA did not lower the cost")
    ins = [p.T_cw, p.pose_fixed, p.Xw, p.z, p.inv_sigma, p.obs_mask,
           p.stereo_mask, p.point_valid, p.point_free]
    # the fixed cost (set-up, first cost, outputs) against the cost of an
    # iteration: the same solve at 0, 1 and 10 iterations
    split = {n: device_ms(lambda n=n: ba_kernel.solve_ba_cuda(
        p, **dict(kw, iters=n)), n=20) for n in (0, 1, lb.num_iterations)}
    print(f"[phase2] local BA device ms at iters 0 / 1 / "
          f"{lb.num_iterations}: " + " / ".join(
              f"{split[n]:.4f}" for n in sorted(split)))
    return {"name": "local_ba",
            "source": "slam_toolkit_tpu_torch/csrc/local_ba.cu",
            "replaces": "slam_toolkit_tpu/ops/ba_kernel.py:408",
            "kernel": ba_kernel.KERNEL, "max_abs_err": max(err_T, err_X),
            "split_ms": split,
            **row_times(lambda: ba_kernel.solve_ba_cuda(p, **kw),
                        lambda: ba_kernel.solve_ba_plain(p, **kw),
                        plain_reps=10),
            **bound(nbytes(*ins, out.T_cw, out.Xw, out.edge_r2) + 8,
                    ba_ops(W, P, lb.num_iterations))}


def ba_phases(dev, ba_ms: float) -> None:
    """Where a local-BA solve's time goes: the kernel's clock64() cycles
    per phase on the cluster's first CTA, as shares of the solve and
    scaled to ba_ms (its device time) in microseconds; and what the
    clocks cost, the solve's device time with them on and off."""
    from slam_toolkit_tpu_torch.config import LocalBAConfig
    from slam_toolkit_tpu_torch.ops import ba_kernel
    lb = LocalBAConfig()
    p = _ba_problem(dev, np.random.default_rng(0), lb.window_keyframes,
                    lb.max_points)
    cyc = torch.zeros(len(ba_kernel.PHASES), dtype=torch.int64, device=dev)
    kw = _ba_kw(lb)
    ba_kernel.solve_ba_cuda(p, **kw, phase_cycles=cyc)
    c = cyc.cpu().numpy().astype(np.float64)
    on, off = (device_ms(lambda buf=buf: ba_kernel.solve_ba_cuda(
        p, **kw, phase_cycles=buf), n=20) for buf in (cyc, None))
    print(f"[phase2] local BA device ms with the phase clocks on {on:.4f}, "
          f"off {off:.4f}")
    us = c / c.sum() * ba_ms * 1e3
    per_it = [1 <= i <= 9 for i in range(len(c))]
    print(f"[phase2] local BA phases ({int(c.sum())} cycles; us of the "
          f"{ba_ms:.4f} ms solve, 'per it.' over {lb.num_iterations} "
          "iterations): " + ", ".join(
              f"{n} {u / lb.num_iterations if it else u:.2f} us"
              f"{' per it.' if it else ''} ({100 * u / us.sum():.1f}%)"
              for n, u, it in zip(ba_kernel.PHASES, us, per_it)))


def fast_ops(h: int, w: int, dual: bool) -> int:
    """The dense count of earlier commits, per pixel of the level: 16
    circle differences; per threshold 16 x (2 compares, 2 for the excess
    sum, 1 mask bit), the 9-of-16 arc test (18) and the 3x3 NMS (13); the
    boost and the border mask (2)."""
    per_thr = 16 * 5 + 18 + 13
    return h * w * (16 + per_thr * (2 if dual else 1) + 2)


def _span(n: int, lo: int, hi: int) -> int:
    """The length of [lo, hi) inside [0, n)."""
    return max(0, min(n, hi) - max(0, lo))


def fast_work(img, thr_hi, thr_lo: float, border: int) -> dict:
    """What one level's outputs need, counted on its pixels with the
    kernel's own tests. `ring`: the response ring [border - 1, h - border]
    (both axes), whose responses the NMS reads. `triples`: its (pixel,
    threshold, side) triples with one of taps 0 and 8 and one of taps 4
    and 12 beyond the threshold on that side (a 9-arc covers two
    neighbouring cardinal taps, so no other triple has a response);
    `passing`: its pixels with at least one. `inner`: the valid interior
    [border, h - border); `positive`: its pixels with a positive response
    at some threshold, the only ones the NMS can keep."""
    from slam_toolkit_tpu_torch.ops import fast
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None], (3, 3, 3, 3),
                                mode="replicate")[0, 0]
    d0, d4, d8, d12 = (p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
                       for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3)))
    hi08, hi412 = torch.maximum(d0, d8), torch.maximum(d4, d12)
    lo08, lo412 = torch.minimum(d0, d8), torch.minimum(d4, d12)
    thrs = [thr_lo] if thr_hi is None else [thr_lo, thr_hi]
    cand = torch.stack([c for t in thrs for c in (
        (hi08 > t) & (hi412 > t), (lo08 < -t) & (lo412 < -t))])
    y0, x0 = max(0, border - 1), max(0, border - 1)
    cand = cand[:, y0:max(y0, h - border + 1), x0:max(x0, w - border + 1)]
    resp = ([fast.fast_response(img, thr_lo)] if thr_hi is None
            else list(fast.dual_response(img, thr_hi, thr_lo)))
    y0, x0 = max(0, border), max(0, border)
    pos = torch.stack(resp)[:, y0:max(y0, h - border),
                            x0:max(x0, w - border)] > 0
    return {"ring": _span(h, border - 1, h - border + 1) *
            _span(w, border - 1, w - border + 1),
            "passing": int(cand.any(0).sum()), "triples": int(cand.sum()),
            "inner": _span(h, border, h - border) *
            _span(w, border, w - border),
            "positive": int(pos.any(0).sum())}


def fast_bound(levels, thr_hi, thr_lo: float, border: int):
    """The FAST row's bound from the work its outputs need, summed over
    the levels; the dense count of earlier commits (ms); and the levels'
    summed fast_work counts it was made from. Bytes: every output pixel
    written once, and the input pixels within 4 of the valid interior
    [border, h - border) read once. Operations, with n_thr thresholds:
    on each ring pixel the cardinal test (4 differences, 4 max / min and
    4 n_thr compares in float32; an and per (threshold, side)); on each
    passing pixel the other 12 differences; on each passing triple, per
    tap a compare, a subtract and an add for the excess sum (float32) and
    a mask bit (integer), then one log-step arc test (12 integer
    operations) and the select and the max of the sides (2 float32); on
    each interior pixel n_thr compares of the centre with 0; on each
    positive one the 3x3 NMS per threshold (13), the boost and the mask
    (2)."""
    n_thr = 1 if thr_hi is None else 2
    n_bytes = f32 = i32 = 0
    counts = dict.fromkeys(("ring", "passing", "triples", "inner",
                            "positive"), 0)
    for img in levels:
        h, w = img.shape
        c = fast_work(img, thr_hi, thr_lo, border)
        for key in counts:
            counts[key] += c[key]
        n_bytes += 4 * (h * w + _span(h, border - 4, h - border + 4) *
                        _span(w, border - 4, w - border + 4))
        f32 += (c["ring"] * (8 + 4 * n_thr) + c["passing"] * 12 +
                c["triples"] * (16 * 3 + 2) + c["inner"] * n_thr +
                c["positive"] * (13 * n_thr + 2))
        i32 += c["ring"] * 2 * n_thr + c["triples"] * (16 + 12)
    dense = bound(2 * sum(nbytes(lv) for lv in levels),
                  sum(fast_ops(*lv.shape, thr_hi is not None)
                      for lv in levels))["bound_ms"]
    return bound(n_bytes, f32, int_ops=i32), dense, counts


def check_fast_nms(dev, rng):
    """FAST+NMS as the fused path launches it: every level of a frame in
    one launch (detect_levels), bit-exact against the plain detector on
    all 8 levels in both modes. The row is frame 0 of the synthetic track
    (the fused path's input), its bound counted from the work its outputs
    need; level 0 alone and a textured-noise frame (more corner
    candidates) are timed beside it."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.ops import fast_kernel, pyramid
    cfg = SlamConfig()
    ecfg = cfg.extractor
    border = ecfg.patch_radius + 1
    thr = (float(ecfg.fast_threshold_high), float(ecfg.fast_threshold_low))
    frame = to_dev(render_frames(cfg, 1, 0.8)[0][0, 0].astype(np.float32),
                   dev)
    noise = to_dev(_textured(376, 1241, rng), dev)
    cases = {name: pyramid.build_pyramid(img, ecfg)
             for name, img in (("frame 0", frame), ("textured", noise))}
    cases_ms, bounds = {}, {}
    for name, levels in cases.items():
        n_corners = 0
        for thr_hi in (thr[0], None):
            outs = fast_kernel.detect_levels_cuda(levels, thr_hi, thr[1],
                                                  border)
            refs = fast_kernel.detect_levels_plain(levels, thr_hi, thr[1],
                                                   border)
            for lv, out, ref in zip(levels, outs, refs):
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"FAST+NMS differs on {name} at level "
                        f"{tuple(lv.shape)}, thr_hi={thr_hi}")
                n_corners += int((ref > 0).sum())
        b, dense_ms, c = fast_bound(levels, thr[0], thr[1], border)
        bounds[name] = b
        ms = device_ms(lambda lv=levels: fast_kernel.detect_levels_cuda(
            lv, thr[0], thr[1], border))
        lv0_ms = device_ms(lambda lv=levels[0]: fast_kernel.detect_fused_cuda(
            lv, thr[0], thr[1], border))
        cases_ms[name] = ms
        cases_ms[f"{name} level 0"] = lv0_ms
        print(f"[phase2] FAST+NMS on {name}: exact at all {len(levels)} "
              f"level shapes {[tuple(lv.shape) for lv in levels]}, both "
              f"modes ({n_corners} corners); {c['passing']} of the "
              f"{c['ring']} ring pixels ({100 * c['passing'] / c['ring']:.1f}"
              f"%) pass the cardinal test, {c['triples']} (threshold, side) "
              f"triples ({c['triples'] / max(c['passing'], 1):.2f} a passing "
              f"pixel), {c['positive']} of the {c['inner']} interior pixels "
              f"positive; the frame's one launch {ms:.4f} ms, level 0 alone "
              f"{lv0_ms:.4f} ms (device); bound {b['bound_ms']:.6f} ms "
              f"({b['bound_by']}) from the work the outputs need, "
              f"{dense_ms:.6f} ms counted dense (every pixel of every level, "
              "the bound before the one-launch design)")
    levels = cases["frame 0"]
    args = (levels, thr[0], thr[1], border)
    return {"name": "fast_nms",
            "source": "slam_toolkit_tpu_torch/csrc/fast_nms.cu",
            "replaces": "slam_toolkit_tpu/ops/fast_kernel.py:149",
            "kernel": fast_kernel.KERNEL, "max_abs_err": 0.0,
            "cases_ms": cases_ms,
            **row_times(lambda: fast_kernel.detect_levels_cuda(*args),
                        lambda: fast_kernel.detect_levels_plain(*args)),
            **bounds["frame 0"]}


def phase2(dev) -> list:
    """Every kernel against its plain version, with its times: one row
    each, on inputs made from seed 0."""
    rng = np.random.default_rng(0)
    return [check_gather(dev, rng), check_topk2(dev, rng),
            check_pose_lm(dev, rng), check_sad(dev, rng),
            check_local_ba(dev, rng), check_fast_nms(dev, rng)]


# ---------------------------------------------------------------- phase 3
def render_frames(cfg, n_frames: int, step: float):
    from slam_toolkit_tpu_torch.data.synthetic import (forward_trajectory,
                                                       make_world,
                                                       render_stereo)
    world = make_world(cfg, seed=7)
    gt = forward_trajectory(n_frames, step)
    frames = np.stack([np.stack([np.clip(l, 0, 255), np.clip(r, 0, 255)])
                       for l, r in (render_stereo(world, T) for T in gt)])
    return frames.astype(np.uint8), gt


def run_engine(cfg, frames, chunk: int, device: str):
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    eng = ChunkedSlamEngine(cfg, chunk_size=chunk, device=device)
    chunk_s = []
    for i in range(0, len(frames), chunk):
        t0 = time.perf_counter()
        eng.process_chunk(frames[i:i + chunk])
        if device == "cuda":
            torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    eng.flush()
    return eng, chunk_s


def translations_m(eng_a, eng_b, n: int):
    return [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
            for a, b in zip(eng_a.trajectory[:n], eng_b.trajectory[:n])]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # ---- phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from slam_toolkit_tpu_torch.utils import cuda_lib
    card = card_line()
    label = f"[{card}]"
    print(f"[phase1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"[phase1] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    print(lib.build_log)

    # ---- phase 2
    rows = phase2(torch.device("cuda"))
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"[phase2] {label} {r['name']}: kernel {r['ms']:.4f} ms "
              f"(device), wrapper {r['host_ms']:.4f} ms (host), plain "
              f"{r['plain_ms']:.4f} ms (one call), library {lib_ms}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    kernels = {r["name"]: r["kernel"] for r in rows}
    ba_phases(torch.device("cuda"),
              next(r["ms"] for r in rows if r["name"] == "local_ba"))
    from slam_toolkit_tpu_torch.ops import ba_kernel, pose_lm_kernel
    print(f"[phase2] one launch holds: local BA "
          f"{ba_kernel.max_points(8, torch.cuda.current_device())} points "
          f"at W=8, pose LM {pose_lm_kernel.max_obs()} observations")

    # ---- phase 3: the main path (fused_fast off, as SlamConfig())
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    cfg = SlamConfig()
    t0 = time.perf_counter()
    frames, gt = render_frames(cfg, 48, 0.8)
    print(f"[phase3] rendered {len(frames)} stereo pairs "
          f"{frames.shape[-1]}x{frames.shape[-2]} in "
          f"{time.perf_counter() - t0:.1f} s")
    cap = MatchCapture(call=len(frames) // 2)
    for k in kernels.values():
        k.launches = 0
    eng, chunk_s = run_engine(cfg, frames, 16, "cuda")
    launches = {n: k.launches for n, k in kernels.items()}
    cap.close()
    traj = eng.trajectory_refined()
    if len(traj) != len(frames) or not all(np.isfinite(T).all() for T in traj):
        raise AssertionError("trajectory missing frames or not finite")
    ok = [s["ok"] for s in eng.frame_stats[1:]]
    ok_frac = float(np.mean(ok))
    n_kf = eng.n_keyframes
    n_lm = int(eng.map.mp_valid.sum())
    ate = ate_rmse(traj, gt, align=True)
    steady = sum(chunk_s[1:])
    print(f"[phase3] {label} frames/s {len(frames) / sum(chunk_s):.2f} over "
          f"all 3 chunks, {32 / steady:.2f} over chunks 2-3 "
          f"(chunk seconds {[round(c, 3) for c in chunk_s]})")
    print(f"[phase3] {label} ATE {ate:.4f} m (bound 0.138), keyframes "
          f"{n_kf}, landmarks {n_lm}, tracking ok on {ok_frac * 100:.1f}% "
          f"of frames")
    print(f"[phase3] {label} launches {launches}")
    if n_kf < 2:
        raise AssertionError(f"only {n_kf} keyframes")
    if ok_frac < 0.9:
        raise AssertionError(f"tracking ok on only {ok_frac:.2f} of frames")
    missing = [n for n, v in launches.items() if v == 0 and n != "fast_nms"]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if launches["local_ba"] != n_kf - 1:
        raise AssertionError(f"local BA launched {launches['local_ba']} "
                             f"times for {n_kf - 1} keyframes after the "
                             "bootstrap")
    if launches["patch_gather"] != len(frames):
        raise AssertionError(f"the gather launched "
                             f"{launches['patch_gather']} times for "
                             f"{len(frames)} frames, expected one a frame")
    if not ate <= 0.138:
        raise AssertionError(f"ATE {ate:.4f} m above 0.138 m")
    check_topk2_frame(cap, next(r["ms"] for r in rows
                                if r["name"] == "topk2_match"), label)

    # ---- phase 4: the same frames with the fused FAST+NMS kernel
    cfg_f = cfg.replace(extractor=dataclasses.replace(cfg.extractor,
                                                      fused_fast=True))
    for k in kernels.values():
        k.launches = 0
    eng_f, chunk_f = run_engine(cfg_f, frames, 16, "cuda")
    launches_f = {n: k.launches for n, k in kernels.items()}
    n_levels = sum(1 for b in level_budgets(cfg.extractor) if b > 0)
    kf_main = [s["kf"] for s in eng.frame_stats]
    kf_fused = [s["kf"] for s in eng_f.frame_stats]
    dt_f = translations_m(eng, eng_f, len(frames))
    print(f"[phase4] {label} fused_fast: frames/s "
          f"{32 / sum(chunk_f[1:]):.2f} over chunks 2-3, launches "
          f"{launches_f}, max |t_fused - t_main| {max(dt_f)} m")
    if launches_f["fast_nms"] != len(frames):
        raise AssertionError(f"FAST launched {launches_f['fast_nms']} "
                             f"times for {len(frames)} frames of "
                             f"{n_levels} levels, expected one a frame")
    if launches_f["patch_gather"] != len(frames):
        raise AssertionError(f"the gather launched "
                             f"{launches_f['patch_gather']} times for "
                             f"{len(frames)} frames, expected one a frame")
    if [n for n, v in launches_f.items() if v == 0]:
        raise AssertionError(f"kernels not launched on the fused path: "
                             f"{launches_f}")
    if kf_fused != kf_main:
        raise AssertionError("fused_fast changed the keyframe decisions")
    if max(dt_f) > 1e-4:
        raise AssertionError(f"fused_fast moved a frame by {max(dt_f)} m")
    launches["fast_nms"] = launches_f["fast_nms"]

    # ---- phase 5: the CPU path
    cpu_eng, _ = run_engine(cfg, frames[:8], 8, "cpu")
    kf_gpu = [s["kf"] for s in eng.frame_stats[:8]]
    kf_cpu = [s["kf"] for s in cpu_eng.frame_stats[:8]]
    dt = translations_m(eng, cpu_eng, 8)
    print(f"[phase5] keyframe flags cuda {kf_gpu} cpu {kf_cpu}")
    print(f"[phase5] |t_cuda - t_cpu| per frame (m): "
          f"{[round(d, 6) for d in dt]}")
    if max(dt) > 0.25:
        raise AssertionError(f"CUDA and CPU paths diverge: {max(dt):.3f} m")

    # ---- phase 6
    keys = ("max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    table = [{"name": r["name"], "route": "cuda", "source": r["source"],
              "replaces": r["replaces"], "launches": launches[r["name"]],
              **{k: r[k] for k in keys}} for r in rows]
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
