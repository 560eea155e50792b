"""The threefry2x32 counter-based generator, as jax.random draws from it.

The loop closer seeds its RANSAC hypotheses the way the JAX package
does: PRNGKey(7), fold_in by slot pair and salt, then
choice(key, L, (64, 4), replace=True, p=probs). The same keys must give
the same hypotheses here, so this module reproduces those draws bit for
bit (the "partitionable" threefry layout): the 20-round Threefry-2x32
hash in int64 arithmetic masked to 32 bits, key derivation, 32-bit
random bits, float32 uniforms in [0, 1), and the weighted choice as a
left searchsorted of (1 - u) * total in the float32 cumulative sum,
summed in XLA's order (rows of 16 summed in sequence, their totals
prefix-summed the same way, recursively).

A key is a pair of host ints, or a pair of 0-dim int64 tensors on a
device (fold_in with a device count): then the hash, the uniforms and
the choice run on that device in the same int64 arithmetic, with no
host read, so that a CUDA graph can hold the draw (the loop closer's
relative pose takes its slot pair on the device).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_toolkit_tpu_torch.utils.device import upload

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 of the count pairs (x1, x2) under key (k1, k2):
    two uint32 arrays as int64 arrays."""
    return _hash(k1, k2, np.asarray(x1, np.int64), np.asarray(x2, np.int64))


def _hash(k1, k2, x1, x2):
    """threefry2x32's rounds on int64 numpy arrays or tensors (keys ints
    or 0-dim int64 tensors): the same operators on both."""
    x = [x1 & _M32, x2 & _M32]
    ks = [k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32]
    x[0] = (x[0] + ks[0]) & _M32
    x[1] = (x[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) for a 32-bit seed: (0, seed)."""
    return (0, int(seed) & _M32)


def _on_device(key) -> bool:
    return torch.is_tensor(key[0])


def fold_in(key, data):
    """jax.random.fold_in: the hash of the count pair (0, data). With a
    device key or a 0-dim int tensor `data`, a device key (two 0-dim
    int64 tensors)."""
    if _on_device(key) or torch.is_tensor(data):
        dev = (key[0] if _on_device(key) else data).device
        d = data.reshape(1).long() if torch.is_tensor(data) else \
            torch.full((1,), int(data), dtype=torch.int64, device=dev)
        a, b = _hash(key[0], key[1], torch.zeros_like(d), d)
        return (a[0], b[0])
    a, b = threefry2x32(key[0], key[1], np.array([0]), np.array([data]))
    return (int(a[0]), int(b[0]))


def random_bits(key, shape) -> np.ndarray:
    """32-bit random words of `shape` (counts hi = 0, lo = flat index)."""
    n = int(np.prod(shape))
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(n, np.int64),
                          np.arange(n, dtype=np.int64))
    return (b1 ^ b2).astype(np.uint32).reshape(shape)


def uniform_device(key, shape) -> torch.Tensor:
    """uniform(key, shape) for a device key, on its device: the same
    float32 bits. The mantissa word is below 2**31, so it passes through
    int32 unchanged."""
    n = int(np.prod(shape))
    lo = torch.arange(n, dtype=torch.int64, device=key[0].device)
    b1, b2 = _hash(key[0], key[1], torch.zeros_like(lo), lo)
    word = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp(word.view(torch.float32) - 1.0, min=0.0).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """jax.random.uniform float32 in [0, 1): 23 random mantissa bits
    under the exponent of 1.0, minus 1."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


def xla_cumsum(p: torch.Tensor, base: int = 16) -> torch.Tensor:
    """The float32 cumulative sum of a 1-D tensor in the order XLA's CPU
    backend sums it: rows of `base` summed in sequence, each row offset
    by the (recursively summed) totals of the rows before it."""
    return xla_cumsum_rows(p[None], base)[0]


def xla_cumsum_rows(p: torch.Tensor, base: int = 16) -> torch.Tensor:
    """xla_cumsum of each row of p (R, n), in the same order: XLA sums
    the rows of a batched cumsum alike."""
    R, n = p.shape
    if n <= base:
        cols = [p[:, 0]]
        for i in range(1, n):
            cols.append(cols[-1] + p[:, i])
        return torch.stack(cols, dim=1)
    rows = -(-n // base)
    x = torch.cat([p, p.new_zeros(R, rows * base - n)], dim=1
                  ).reshape(R, rows, base)
    cols = [x[..., 0]]
    for i in range(1, base):
        cols.append(cols[-1] + x[..., i])
    s = torch.stack(cols, dim=-1)                        # (R, rows, base)
    prefix = xla_cumsum_rows(s[..., -1].contiguous(), base)
    s = torch.cat([s[:, :1], prefix[:, :-1, None] + s[:, 1:]], dim=1)
    return s.reshape(R, -1)[:, :n]


def choice_p(key, p: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.choice(key, len(p), shape, replace=True, p=p): indices
    (int64, on p's device; a device key draws there, uploading
    nothing)."""
    cum = xla_cumsum(p)
    u = uniform_device(key, shape) if _on_device(key) else \
        upload(uniform(key, shape), p.device)
    r = cum[-1] * (1.0 - u)
    return torch.searchsorted(cum, r.reshape(-1)).reshape(shape)


def split(key, num: int = 2):
    """jax.random.split(key, num) as a list of keys: key i is the hash
    of the count pair (0, i), the same as fold_in(key, i)."""
    a, b = threefry2x32(key[0], key[1], np.zeros(num, np.int64),
                        np.arange(num, dtype=np.int64))
    return [(int(x), int(y)) for x, y in zip(a, b)]


def uniform_rows(keys, shape) -> np.ndarray:
    """uniform(k, shape) for each key of `keys`, flattened, in one hash
    over every key: (len(keys), prod(shape)) float32."""
    n = int(np.prod(shape))
    k = np.asarray(keys, np.int64).reshape(-1, 2, 1)
    b1, b2 = threefry2x32(k[:, 0], k[:, 1], np.zeros((1, n), np.int64),
                          np.arange(n, dtype=np.int64)[None])
    bits = ((b1 ^ b2).astype(np.uint32) >> np.uint32(9)) \
        | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32)
                      - np.float32(1.0))


def choice_p_rows(keys, p: torch.Tensor, shape, u=None) -> torch.Tensor:
    """choice_p for each row of p (R, n) under its own key of `keys`
    (jax.vmap of jax.random.choice over keys and p): (R, *shape) int64
    indices on p's device. `u`, where given, holds the keys' uniforms
    drawn ahead (uniform_rows, (R, prod(shape)) on p's device), and
    `keys` is not read: the draw then uploads nothing."""
    cum = xla_cumsum_rows(p)
    if u is None:
        u = upload(uniform_rows(keys, shape), p.device)
    R = p.shape[0]
    r = cum[:, -1:] * (1.0 - u.reshape(R, -1))
    return torch.searchsorted(cum, r).reshape(R, *shape)
