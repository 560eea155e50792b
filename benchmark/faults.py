"""Faults planted under the timed path, to show that `correct` catches
them: each wraps the engine so that its process_chunk is broken.

- state_unchanged: the chunk runs, then the pose and velocity it
  advanced are put back, so the next chunk starts where this one did;
- half_left_out: the engine is handed the first half of each chunk, and
  its rows are what comes back;
- row_altered: one pose row a chunk moved 50 m along x where it is
  produced;
- descriptor_altered: a bit of each new keyframe's first descriptor
  flipped in the map.

The exchange between cards does not exist in a one-card cell. Used by
benchmark/tests/test_bench_faults.py on the CPU and by
`calibrate --fault` on the card.
"""

from __future__ import annotations


class Wrapped:
    """The engine, its process_chunk replaced by step(engine, images)."""

    def __init__(self, eng, step):
        self._eng, self._step = eng, step

    def process_chunk(self, images):
        return self._step(self._eng, images)

    def __getattr__(self, name):
        return getattr(self._eng, name)


def state_unchanged(eng, images):
    if eng.carry is None:                 # the bootstrap chunk
        return eng.process_chunk(images)
    keep = {f: getattr(eng.carry, f).clone() for f in ("T_cw", "velocity")}
    rows = eng.process_chunk(images)
    for f, v in keep.items():
        getattr(eng.carry, f).copy_(v)
    return rows


def half_left_out(eng, images):
    return eng.process_chunk(images[:max(len(images) // 2, 2)])


def row_altered(eng, images):
    rows = eng.process_chunk(images).copy()
    rows[len(rows) // 2, 3] += 50.0       # T[0, 3]: 50 m along x
    return rows


def descriptor_altered(eng, images):
    first = int(eng.carry.frame_id) if eng.carry is not None else 0
    rows = eng.process_chunk(images)
    m = eng.map
    new = m.kf_valid & (m.kf_frame_id >= first)
    m.kf_desc[new, 0] ^= 1
    return rows


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out,
                                  row_altered, descriptor_altered)}


def hook(name: str):
    """An engine_hook for harness.run that plants fault `name`."""
    step = FAULTS[name]
    return lambda eng: Wrapped(eng, step)
