"""A leading lane axis on (nested) tuples of tensors.

A batched value (carry, map, frame, track result) holds B lanes on a
leading axis of every tensor. One sequence's value goes through the same
code as one lane: with_lane adds the axis, lane(t, 0) takes it off, both
as views, so in-place writes reach the original.
"""

from __future__ import annotations

import torch


def _rebuild(t: tuple, fields):
    return type(t)(*fields) if hasattr(t, "_fields") else type(t)(fields)


def lane(t, b: int):
    """Lane b of a batched (Named)tuple: views t[b] of every tensor field
    with a lane axis (in-place writes reach the batch); ints, None and
    0-dim tensors (a frame id all lanes share) stay as they are."""
    return _rebuild(t, [f[b] if torch.is_tensor(f) and f.dim() else
                        lane(f, b) if isinstance(f, tuple) else f
                        for f in t])


def with_lane(t):
    """t as a batch of one lane: views t[None] of every tensor field
    (0-dim ones too), recursively through tuples; ints, floats and None
    stay as they are."""
    if torch.is_tensor(t):
        return t[None]
    if isinstance(t, tuple):
        return _rebuild(t, [with_lane(f) for f in t])
    return t
