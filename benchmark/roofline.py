"""The yardstick's peaks and the work of the port's hand-written kernels.

The least time a kernel's work could take on one card: its bytes, each
input read once and each output written once, over the memory rate, or
its operations over the float32 peak, whichever is larger. The counts
are worked out from the algorithm's shapes (copied from chip_smoke.py's
bound arithmetic), not from what the kernel happens to do.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_ops_per_s": 67e12},
}


def peaks(card: str) -> dict:
    """The peaks of `card` (torch.cuda.get_device_name()); KeyError for
    a card the table lacks."""
    return PEAKS[card]


def bound_s(n_bytes: float, n_ops: float, card: str) -> float:
    p = peaks(card)
    return max(n_bytes / p["hbm_bytes_per_s"], n_ops / p["f32_ops_per_s"])


def pose_lm_work(n: int, iters: int) -> tuple:
    """(bytes, operations) of one motion-only LM solve over n
    observations: T, Xw, z, sigma2 and the mask in, T, the cost and the
    n squared residuals out; per observation and iteration ~186
    operations for the normal equations and ~40 for the trial cost, and
    80 for the first cost and the final r2."""
    n_bytes = 64 + n * (12 + 8 + 4 + 1) + 64 + 4 + n * 4
    return n_bytes, n * (iters * 226 + 80)


def local_ba_work(w: int, p: int, iters: int) -> tuple:
    """(bytes, operations) of one local-BA solve over w poses and p
    points with an observation slot for each (pose, point): poses, the
    fixed flags, points, the (w, p, 3) observations, their inverse
    sigmas, observation and stereo masks, point validity and freedom in;
    poses, points and the (w, p) squared residuals out, and 8 bytes of
    scalars. Per edge and iteration ~327 operations for the residual,
    Jacobians and the Hpp, bp, Hll, bl, Hpl terms, 144 for Hpl Hll^-1
    and its rhs, 33 for the pose sums, 40 for the trial cost; per point
    ~40 for the 3x3 inverse and 36 w + 18 for back-substitution; the
    reduced system's product 2 (6w)^2 3p and its Gauss-Jordan 2 (6w)^2
    (6w + 1); ~70 per edge for the first cost and the final r2."""
    n_in = (w * 64 + w + p * 12 + w * p * 12 + w * p * 4 + w * p + w * p +
            p + p)
    n_out = w * 64 + p * 12 + w * p * 4
    n6 = 6 * w
    per_iter = (w * p * (327 + 144 + 33 + 40) + p * (40 + 36 * w + 18) +
                2 * n6 * n6 * 3 * p + 2 * n6 * n6 * (n6 + 1))
    return n_in + n_out + 8, iters * per_iter + w * p * 70
