"""The per-frame SLAM engine, and the host half of loop closing.

Counterpart of slam_toolkit_tpu/pipeline/engine.py's SlamEngine (ref
Pipeline, src/pipeline.cpp:95-141), under the JAX package's names:

- the per-frame programs: _build, _stereo, _track (indirect; its packed
  (35,) row [T(16), T_rel(16), ok, needs_kf, n_inliers]), _track_direct
  (a (37,) row, with the frame's brightness a, b), _insert (insert and
  weak-mappoint cull), _ba, _cull, _cull_any and _snapshot;
- the per-frame host steps: process (one image upload, one _track and
  one packed readback a frame; relocalization when lost with a
  vocabulary; the decay-ratio keyframe rule), _make_keyframe (capacity
  culls with trajectory re-anchoring, stereo, insert, the loop step,
  local BA from the third keyframe), _finish_frame, trajectory_refined,
  num_mappoints and keyframe_poses;
- the loop programs: _bow, _loop_score, _covis, _relpose (with its
  packed (20,) row: [T(16), n_inliers, ok, scale, n_near]), _reloc,
  _close (pose graph + mappoint merge + ring update), _bow_register,
  _bow_register_only and _seam_ba;
- the loop host steps: _loop_step, _loop_kf_detect, _detect_accept,
  _closure_is_dup, _dispatch_close, _consume_scores, _try_relocalize,
  _refresh_kf_mirrors and _close_tier.

The JAX package jits each program. Here every one of them runs on static
buffers and, on a card, as a CUDA graph captured once and replayed
(graphs=True, the default); graphs=False runs them eagerly, bit-equal.
The per-frame programs, _build and _track (or _track_direct), are
_StaticTrack's two graphs, captured at the bootstrap frame. The keyframe
programs (_stereo, _insert, _ba, _snapshot, _cull, _cull_any) and the
loop programs (the BoW register and score, covisibility, relative pose,
relocalization, seam BA, and _close, one program per pose-graph tier)
are _LoopPrograms: a set of static buffers and graphs for each map
they read; _kf_row is folded into them. The map's tensors keep their
addresses from the bootstrap on: every program writes the map in place.
The chunked engine (pipeline/scan_engine.py) owns the map and the
per-frame step when it drives this class for its loop phases and its
keyframe culls (own_map=False): it sets `map` and the mirrors, and no
second map is allocated. The pose-graph tiers are kept; the JAX
package's compiles of them ahead of time (warmup_loop_programs and its
background thread) are not ported: they exist for XLA compile time.
Checkpointing is pipeline/checkpoint.py.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from slam_toolkit_tpu_torch.config import SlamConfig
from slam_toolkit_tpu_torch.frontend.direct_tracker import track_direct_bound
from slam_toolkit_tpu_torch.frontend.frame import (FrameState, add_stereo,
                                                   build_frame)
from slam_toolkit_tpu_torch.frontend.tracker import track_pose
from slam_toolkit_tpu_torch.geometry import se3
from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
from slam_toolkit_tpu_torch.loop import closer as closer_mod
from slam_toolkit_tpu_torch.loop import detector as det_mod
from slam_toolkit_tpu_torch.loop import vocab as vocab_mod
from slam_toolkit_tpu_torch.mapping import keyframe as kf_rule
from slam_toolkit_tpu_torch.mapping.ba_adapter import (local_ba_step,
                                                       seam_ba_step)
from slam_toolkit_tpu_torch.mapping.culling import (cull_most_redundant,
                                                    cull_weak_mappoints)
from slam_toolkit_tpu_torch.mapping.map_state import (MapState, at,
                                                      camera_frustum,
                                                      covisibility_counts,
                                                      covisibility_rows,
                                                      empty_map,
                                                      gather_local_landmarks,
                                                      insert_keyframe, row)
from slam_toolkit_tpu_torch.ops.extractor import FrameFeatures
from slam_toolkit_tpu_torch.utils.cuda_graphs import StepGraphs, merged_stats
from slam_toolkit_tpu_torch.utils.device import upload

MAX_CLOSED_LOOPS = 16
# keyframe rows per chunk that _bow_register processes at once (the rest
# go through _bow_register_only)
BOW_ROWS = 4
# covisibility rows one run of the covisibility program computes; n
# candidate slots take ceil(n / COVIS_ROWS) runs
COVIS_ROWS = 8
# the packed chunk row's width and its slot and keyframe-flag columns
# (pipeline/scan_engine.PACK_WIDTH)
_PACK_WIDTH, _PACK_SLOT, _PACK_KF = 36, 32, 34
# compact pose-graph problem sizes (close_loop's `tier`)
_PG_TIERS = (32, 64, 128, 256, 512, 1024)


class _Float32Blocks:
    """The open full_float32 blocks of the process, on every thread. The
    TF32 flags are global to the process, so the first block to open
    saves the caller's flags and turns TF32 off, and the last to close
    restores them: a block that closes on one thread never turns TF32
    back on under a block still open on another (the chunked engine's
    mapping worker)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.open = 0
        self.saved = None

    def enter(self) -> None:
        with self.lock:
            if self.open == 0:
                self.saved = (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            self.open += 1

    def exit(self) -> None:
        with self.lock:
            self.open -= 1
            if self.open == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = self.saved


_FLOAT32_BLOCKS = _Float32Blocks()


@contextlib.contextmanager
def full_float32():
    """Run the block with TF32 off for matmuls and cuDNN (the pyramid,
    blur and pose math are specified in full float32), then restore the
    caller's flags once no block is open on any thread."""
    _FLOAT32_BLOCKS.enter()
    try:
        yield
    finally:
        _FLOAT32_BLOCKS.exit()


def _stack_scores(rows: List[det_mod.LoopScores]) -> det_mod.LoopScores:
    return det_mod.LoopScores(*(torch.stack(f) for f in zip(*rows)))


class _StaticTrack:
    """SlamEngine.process's per-frame programs on static buffers: _build
    on the left image, then _track (or, for tracker.method "direct",
    _track_direct) on the frame it built, the landmark snapshot, the
    pose, velocity and latest keyframe pose (and the photometric
    anchor). A frame copies the image in (the one upload) and the pose
    state, the snapshot and anchor only when the engine holds new ones
    (a keyframe, a checkpoint restore); a relocalization's re-track
    copies its pose and velocity in and runs the tracking program again.
    The bootstrap frame runs _build alone. The keyframe program `stereo`
    reads the frame and image here by address, and the right image from
    `right`.

    On a CUDA device the two programs are captured once as CUDA graphs
    (utils/cuda_graphs.StepGraphs), at the bootstrap frame, and
    replayed; their outputs are the graphs' and every replay writes them
    anew. On the CPU the same programs run eagerly on the same buffers
    (the frame copied into the first one built). A capture failure
    raises."""

    def __init__(self, eng: "SlamEngine", img: torch.Tensor):
        self.direct = eng.cfg.tracker.method == "direct"
        dev = eng.device
        self.img = torch.empty(img.shape, dtype=torch.float32, device=dev)
        self.right = torch.empty_like(self.img)
        # the snapshot tracked against, ids included: insert_keyframe
        # takes the ids the tracking result indexes, while the engine's
        # snapshot may be refreshed by a cull first
        self.Xw, self.desc, self.ids, self.valid = (torch.empty_like(t)
                                                    for t in eng._lm)
        self.T_prev, self.velocity, self.kf_T = (
            torch.empty((4, 4), dtype=torch.float32, device=dev)
            for _ in range(3))
        if self.direct:
            self.kf_img = torch.zeros_like(self.img)
            self.kf_ab = torch.empty((2,), dtype=torch.float32, device=dev)
        self._lm_src = self._anchor_src = None
        self.frame: Optional[FrameState] = None
        self.graphs: Optional[StepGraphs] = None

    def _load(self, eng: "SlamEngine") -> None:
        self.T_prev.copy_(eng.T_cw)
        self.velocity.copy_(eng.velocity)
        self.kf_T.copy_(eng._latest_kf_T_dev)
        if eng._lm_serial != self._lm_src:
            for dst, src in zip((self.Xw, self.desc, self.ids, self.valid),
                                eng._lm):
                dst.copy_(src)
            self._lm_src = eng._lm_serial
        if self.direct and eng._kf_img is not None:
            if eng._kf_img is not self._anchor_src:
                self.kf_img.copy_(eng._kf_img)
                self._anchor_src = eng._kf_img
            self.kf_ab.copy_(eng._kf_ab)

    def _track(self, eng: "SlamEngine", frame: FrameState) -> tuple:
        if self.direct:
            return eng._track_direct(frame, self.img, self.Xw, self.desc,
                                     self.valid, self.T_prev, self.velocity,
                                     self.kf_T, self.kf_img, self.kf_ab)
        return eng._track(frame, self.Xw, self.desc, self.valid, self.T_prev,
                          self.velocity, self.kf_T)

    def _capture(self, eng: "SlamEngine") -> None:
        g = StepGraphs(self.img.device)
        g.warm_up(lambda: self._track(eng, eng._build(self.img)))
        self.frame = g.capture("build", eng._build, self.img)
        self.tracked = g.capture("track", self._track, eng, self.frame)
        self.graphs = g

    def build(self, eng: "SlamEngine", left) -> tuple:
        """(the left image on the device, the frame) of `left`; both are
        overwritten by the next frame. Captures both graphs on a card the
        first time, and defines the engine's stereo program on these
        buffers."""
        self.img.copy_(torch.as_tensor(left))
        self._load(eng)
        if self.img.is_cuda and self.graphs is None:
            self._capture(eng)
        if self.graphs is None:
            frame = eng._build(self.img)
            if self.frame is None:
                self.frame = frame
            else:
                _tree_copy(self.frame, frame)
        else:
            self.graphs.replay("build")
        eng._kf.program("stereo", None,
                        inputs=(self.frame, self.img, self.right))
        return self.img, self.frame

    def step(self, eng: "SlamEngine", left) -> tuple:
        """(the left image on the device, the frame, _track's outputs)
        for one frame; the image and the outputs are overwritten by the
        next step."""
        self.build(eng, left)
        if self.graphs is None:
            self.tracked = self._track(eng, self.frame)
        else:
            self.graphs.replay("track")
        return self.img, self.frame, self.tracked

    def retrack(self, eng: "SlamEngine", T_prev, velocity) -> tuple:
        """The tracking program again on the last frame from another pose
        and velocity (a relocalization): _track's outputs."""
        self.T_prev.copy_(T_prev)
        self.velocity.copy_(velocity)
        if self.graphs is None:
            self.tracked = self._track(eng, self.frame)
        else:
            self.graphs.replay("track")
        return self.tracked


def _tree_map(fn, x):
    """fn over every tensor of a nest of (named) tuples; None stays."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return fn(x)
    vals = [_tree_map(fn, v) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)


def _tree_copy(dst, src) -> None:
    """Copy every tensor of `src` into the same place of `dst` (a tensor
    that is its own destination is left)."""
    if dst is None or dst is src:
        return
    if torch.is_tensor(dst):
        dst.copy_(src)
        return
    for d, s_ in zip(dst, src):
        _tree_copy(d, s_)


def _copy_in(buf, value) -> None:
    """A program input into its static buffer: a host number is filled
    in, a host array uploaded without waiting, a tensor (or a nest of
    them) copied on the current stream."""
    if isinstance(value, (int, np.integer)):
        buf.fill_(int(value))
    elif isinstance(value, (float, np.floating)):
        buf.fill_(float(value))
    elif isinstance(value, np.ndarray):
        buf.copy_(upload(value, buf.device))
    else:
        _tree_copy(buf, value)


def _buffer_like(value, device):
    """A static buffer for a program input first given as `value`: a
    tensor's like, a 0-dim int64 for a host int, a 0-dim float32 for a
    host float (nests alike; None stays)."""
    if value is None:
        return None
    if torch.is_tensor(value):
        return torch.empty_like(value, memory_format=torch.contiguous_format)
    if isinstance(value, (int, np.integer)):
        return torch.zeros((), dtype=torch.int64, device=device)
    if isinstance(value, (float, np.floating)):
        return torch.zeros((), dtype=torch.float32, device=device)
    vals = [_buffer_like(v, device) for v in value]
    return type(value)(*vals) if hasattr(value, "_fields") \
        else type(value)(vals)


def store_map(dst_map: MapState, m: MapState) -> None:
    """Store the map `m` a program returned into `dst_map`: the fields it
    replaced are copied, those it updated in place (the same tensors) are
    already there."""
    for dst, src in zip(dst_map, m):
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


class _LoopProgram(NamedTuple):
    name: str
    fn: Callable          # fn(engine, map, *inputs)
    inputs: tuple         # (map, static input buffers...)
    gname: str            # its graph's name in _LoopPrograms.graphs
    mutates_map: bool     # warm it up on a throwaway copy of the map
    late: bool            # may be captured after the freeze (the close)


class _LoopPrograms:
    """SlamEngine's programs, the ones the JAX engine jits, on static
    buffers: for each program and each map it reads, the inputs are
    copied into static buffers and the program runs on them, its outputs
    landing in static buffers that the next run overwrites. On a card each
    (program, map) pair is a CUDA graph, captured once, with a memory pool
    of its own (they replay in any order), and replayed; on the CPU the
    same code runs eagerly on the same buffers. A graph records fixed
    addresses, so a map is known by its tensors' addresses, and the
    engines keep those in place: the per-frame engine's map from its
    bootstrap on; the chunked engine reads its static carry's map and,
    under its mapping worker, two published copies, and copies every
    change into them. An engine holds two sets: the keyframe programs
    (KEYFRAME_NAMES) and the loop programs (NAMES and the close).

    The loop programs (JAX names in brackets):
    - register [_bow_register_only, and _loop_step's one row]: the BoW of
      BOW_ROWS keyframe rows of a map, one descent over all their
      descriptors, written into the database in place (rows left out go
      to the dump row) and scored against it at once (score_queries);
    - register_packed [_bow_register]: register on the first BOW_ROWS
      keyframe rows of a chunk's packed rows, picked by a stable sort on
      the device (lax.top_k's order), rows_capacity rows at most;
    - covis [_covis]: COVIS_ROWS covisibility rows of device slots, a
      valid mask for the padding;
    - relpose [_relpose]: the closer's relative pose and its packed (20,)
      row, the slot pair and the RANSAC key on the device;
    - reloc [_reloc]: relocalize_frame of a frame's features against a
      device slot;
    - seam [_seam_ba]: seam BA over the window of a device slot pair, the
      map updated in place;
    - close@<tier> [_close, one program per static tier]: close_loop,
      merge_mappoints and the closed-loop ring's update, the map written
      in place, the slots, ring index and measurement on the device, the
      new ring returned.
    The keyframe programs:
    - stereo [_stereo]: add_stereo on _StaticTrack's frame and image, the
      right image copied into its buffer;
    - insert [_insert]: insert_keyframe and cull_weak_mappoints, the map
      in place, the frame id and quality device scalars; the new slot;
    - ba [_ba]: local_ba_step, the map in place;
    - snapshot [_snapshot]: the landmark snapshot, the latest keyframe's
      pose and (slot, valid keyframes);
    - cull, cull_any [_cull, _cull_any]: cull_most_redundant, decided on
      the device, the map in place; the culled slot or -1.
    [_kf_row] is folded into its callers: each program gathers a slot's
    rows on the device (map_state.row), the host steps index with host
    ints. An input that is another program's output of the same set is
    read at its address, not copied (the frame from stereo into insert,
    the snapshot into insert).

    Outputs a caller keeps past the next run are copied out (relpose,
    reloc, register: a measurement pending across folds, scores waiting
    for their fold). A capture runs only on the thread that made the
    engine and, once `frozen` is set, not at all, the close aside: the
    chunked engine captures every other graph before its mapping
    worker's first job (a capture in global mode fails while another
    thread uses the card) and then freezes; a missing graph then raises.
    A close is captured the first time its tier is used, on that thread,
    in thread_local mode: a closure lands on it while the worker is
    drained or waits for that closure (scan_engine's _apply_close).
    Nothing falls back to eager."""

    NAMES = ("register", "register_packed", "covis", "relpose", "reloc",
             "seam")
    KEYFRAME_NAMES = ("stereo", "insert", "ba", "snapshot", "cull",
                      "cull_any")
    # the programs that write the map in place
    _MUTATE = {"seam", "insert", "ba", "cull", "cull_any"}

    def __init__(self, eng: "SlamEngine", names: tuple = NAMES):
        # a weak reference: the engine holds this object, and a cycle would
        # leave the engine (and its graphs) to the cyclic collector
        self._eng = weakref.ref(eng)
        self.device = eng.device
        self.cuda = self.device.type == "cuda"
        self.names = names
        self.graphs = StepGraphs(self.device, shared_pool=False) \
            if self.cuda else None
        self.rows_capacity = BOW_ROWS     # register_packed's chunk rows
        self.frozen = False
        self.owner = threading.current_thread()
        self._progs: dict = {}            # (name, map key) -> _LoopProgram
        self._out: dict = {}              # graph name -> static outputs
        self._out_ptrs: set = set()       # their tensors' addresses
        self.runs: dict = {n: 0 for n in names}

    @staticmethod
    def _key(m: Optional[MapState]) -> tuple:
        return () if m is None else tuple(t.data_ptr() for t in m)

    def _inputs(self, name: str, m: MapState) -> tuple:
        dev = self.device

        def i64(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        def flag(n):
            return torch.zeros((n,), dtype=torch.bool, device=dev)
        if name == "register":
            return i64(BOW_ROWS), flag(BOW_ROWS)
        if name == "register_packed":
            return (torch.zeros((self.rows_capacity, _PACK_WIDTH),
                                dtype=torch.float32, device=dev),)
        if name == "covis":
            return i64(COVIS_ROWS), flag(COVIS_ROWS)
        if name == "reloc":
            k = m.kf_xy.shape[1]

            def f32(*shape):
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            feats = FrameFeatures(
                xy=f32(k, 2), response=f32(k),
                octave=torch.zeros((k,), dtype=torch.int32, device=dev),
                angle=f32(k), sigma2=f32(k),
                desc=torch.zeros((k, 8), dtype=torch.int32, device=dev),
                valid=flag(k))
            return feats, f32(k, 2), i64()
        return i64(), i64()                       # relpose, seam

    def _held_or_buffer(self, value):
        """An input's static buffer: another program's output is read at
        its address; anything else gets a buffer of its own."""
        if torch.is_tensor(value) and value.data_ptr() in self._out_ptrs:
            return value
        if value is None or torch.is_tensor(value) or \
                not isinstance(value, (tuple, list)):
            return _buffer_like(value, self.device)
        vals = [self._held_or_buffer(v) for v in value]
        return type(value)(*vals) if hasattr(value, "_fields") \
            else type(value)(vals)

    @staticmethod
    def _fn(name: str) -> Callable:
        if name.startswith("close@"):
            tier = int(name[len("close@"):])
            return lambda eng, m, *a: eng._close_program(m, *a, tier=tier)
        return {"register": SlamEngine._register_static,
                "register_packed": SlamEngine._register_packed_static,
                "covis": lambda eng, m, s, v: covisibility_rows(m, s, v),
                "relpose": SlamEngine._relpose_program,
                "reloc": SlamEngine._reloc_program,
                "seam": SlamEngine._seam_program,
                "stereo": lambda eng, m, *a: eng._stereo(*a),
                "insert": SlamEngine._insert_program,
                "ba": SlamEngine._ba_program,
                "snapshot": SlamEngine._snapshot,
                "cull": lambda eng, m: eng._cull(m)[1],
                "cull_any": lambda eng, m: eng._cull_any(m)[1]}[name]

    def program(self, name: str, m: Optional[MapState], values=(),
                inputs=None) -> _LoopProgram:
        """Program `name` on map `m`, defined the first time with
        `inputs` (static buffers), or buffers like `values`."""
        key = (name, self._key(m))
        prog = self._progs.get(key)
        if prog is None:
            if inputs is None:
                inputs = self._inputs(name, m) if name in self.NAMES else \
                    tuple(self._held_or_buffer(v) for v in values)
            late = name.startswith("close@")
            prog = _LoopProgram(name, self._fn(name), (m,) + tuple(inputs),
                                f"{name}#{len(self._progs)}",
                                late or name in self._MUTATE, late)
            self._progs[key] = prog
        return prog

    def _capture(self, prog: _LoopProgram) -> None:
        if (self.frozen and not prog.late) or \
                threading.current_thread() is not self.owner:
            raise RuntimeError(
                f"program {prog.name!r} has no CUDA graph for this map "
                f"and may not be captured here (graphs are captured on the "
                f"thread that made the engine, before any mapping job)")
        g, eng = self.graphs, self._eng()
        if prog.mutates_map:
            warm = (MapState(*(t.clone() for t in prog.inputs[0])),) + \
                prog.inputs[1:]
            g.warm_up(prog.fn, eng, *warm)
        else:
            g.warm_up(prog.fn, eng, *prog.inputs)
        out = g.capture(prog.gname, prog.fn, eng, *prog.inputs,
                        error_mode="thread_local" if prog.late
                        else "global")
        self._keep(prog.gname, out)

    def _keep(self, gname: str, out) -> None:
        self._out[gname] = out
        _tree_map(lambda t: self._out_ptrs.add(t.data_ptr()), out)

    def prepare(self, maps, names=None) -> None:
        """Capture (on a card) every program of `names` (default all of
        this set's) for each map in `maps`, now, on this thread."""
        for m in maps:
            for name in names or self.names:
                prog = self.program(name, m)
                if self.cuda and prog.gname not in self.graphs:
                    self._capture(prog)

    def run(self, name: str, m: Optional[MapState], *values,
            copy_out: bool = False):
        """The program on map `m` with these inputs: its outputs, static
        buffers the next run overwrites (copies with copy_out)."""
        prog = self.program(name, m, values)
        for buf, v in zip(prog.inputs[1:], values):
            _copy_in(buf, v)
        if self.cuda:
            if prog.gname not in self.graphs:
                self._capture(prog)
            self.graphs.replay(prog.gname)
            out = self._out[prog.gname]
        else:
            res = prog.fn(self._eng(), *prog.inputs)
            out = self._out.get(prog.gname)
            if out is None:
                self._keep(prog.gname, _tree_map(torch.clone, res))
                out = self._out[prog.gname]
            else:
                _tree_copy(out, res)
        self.runs[name] = self.runs.get(name, 0) + 1
        return _tree_map(torch.clone, out) if copy_out else out

    def stats(self) -> Optional[dict]:
        """The graphs' captures, capture seconds, pool bytes and capturing
        threads, the runs by program, and each close tier's capture
        seconds and pool bytes (None off a card)."""
        if self.graphs is None:
            return None
        g = self.graphs
        closes = {prog.name: {"capture_s": g.graph_s[prog.gname],
                              "pool_bytes": g.pool_bytes([prog.gname])}
                  for prog in self._progs.values()
                  if prog.late and prog.gname in g}
        return dict(g.stats(), runs=dict(self.runs), closes=closes)


class SlamEngine:
    """Stereo visual odometry / SLAM over a fixed-capacity device map.

    `vocab` (a loop.vocab.Vocabulary, on any device) enables loop
    detection, closing and relocalization; it is moved to `device`.
    Entry points run on `device` (default the card, which must exist).
    graphs=True (the default) runs process's per-frame programs on
    static buffers, as CUDA graphs on a card (_StaticTrack), and the
    keyframe and loop programs the same way (_LoopPrograms: stereo,
    insert, BA, snapshot and the two culls; register, covisibility,
    relative pose, relocalization, seam BA and the close a tier);
    graphs=False runs them all eagerly, with the same results bit for
    bit. The `graphs` attribute is read at each keyframe and loop
    program's call, so setting it to False on the chunked engine's host
    turns its graphs alone off.
    own_map=False is the chunked engine's host: no map is allocated, and
    the caller sets `map` and the mirrors before any program runs.
    `stages`, a utils.timing.StreamStages, times the loop's stages
    (register, scores readback, covis, detect, relpose, relpose
    readback, close, seam BA, snapshot, reloc) while set."""

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 cam: Optional[StereoCamera] = None, vocab=None,
                 device="cuda", own_map: bool = True, graphs: bool = True):
        self.cfg = cfg or SlamConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.cam = cam if cam is not None else \
            StereoCamera.from_config(self.cfg.camera, self.device)
        self.vocab = None if vocab is None else \
            vocab_mod.to_device(vocab, self.device)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.T_cw = eye.clone()
        self.velocity = eye.clone()     # dT: T_cur = dT @ T_prev
        self.frame_id = 0
        self.n_keyframes = 0
        self._tier_margin = 2           # see _close_tier
        self.trajectory: List[np.ndarray] = []      # poses as processed
        # keyframe-anchored trajectory: (kf_slot, T_frame . T_kf^-1) per
        # frame, so corrections to keyframes carry to every frame (ref
        # src/loopcloser.cpp:195-208)
        self._traj_anchor: List[tuple] = []
        self.frame_stats: List[dict] = []
        self._loop_events: List[dict] = []
        self.graphs = graphs
        self._static: Optional[_StaticTrack] = None
        self._kf = _LoopPrograms(self, _LoopPrograms.KEYFRAME_NAMES)
        self.stages = None              # a StreamStages while timed
        # the photometric anchor ("direct" and "hybrid")
        self._kf_img: Optional[torch.Tensor] = None
        self._kf_ab = torch.zeros((2,), dtype=torch.float32,
                                  device=self.device)
        # the landmark snapshot and host mirrors of slow-moving state,
        # refreshed at keyframe events
        self.map: Optional[MapState] = None
        self._lm = None
        self._lm_serial = 0             # snapshots taken (a new one: +1)
        self._latest_kf_T_dev = eye.clone()
        self._latest_kf_T_host = np.eye(4, dtype=np.float32)
        self._latest_slot_host = 0
        self._n_kf_valid_host = 0
        self._inlier_peak = 0.0
        if own_map:
            self.map = empty_map(self.cfg, self.device)
            self._lm, self._latest_kf_T_dev, _ = self._snapshot(self.map)
        if self.vocab is not None:
            loop = self.cfg.loop
            f = self.cfg.map.max_keyframes
            self._bow_sparse = vocab_mod.use_sparse(self.vocab, loop)
            # the database in place, with a dump row (bow_db is its view)
            self._db_buf = vocab_mod.make_bow_db_buffer(
                self.vocab, f, self._bow_sparse, loop.bow_top_words)
            self._loop = _LoopPrograms(self)
            self.consistency = det_mod.ConsistencyTracker(
                loop.consistency_threshold)
            z = torch.zeros(MAX_CLOSED_LOOPS, dtype=torch.int32,
                            device=self.device)
            self.closed_i, self.closed_j = z, z.clone()
            self.closed_T = eye.repeat(MAX_CLOSED_LOOPS, 1, 1)
            self.closed_valid = torch.zeros(MAX_CLOSED_LOOPS,
                                            dtype=torch.bool,
                                            device=self.device)
            self.closed_w = torch.ones(MAX_CLOSED_LOOPS, device=self.device)
            self.n_closed = 0
            self.close_tiers: List[int] = []     # pose-graph tier per closure
            # (frame_cur, frame_cand, inliers) per closure (dedup gate)
            self._closed_pairs: list = []
            # post-closure detection cooldown (ORB-SLAM2 mLastLoopKFid+10)
            self._last_closure_nkf = -(10 ** 9)

    @property
    def loop_events(self) -> List[dict]:
        """Closure events (frame, kf_slot, cand, inliers, fid_cand, n_near,
        scale, T_meas, T_cand_pre) and relocalizations (frame, reloc_to,
        inliers): plain lists, JSON-serialisable."""
        return self._loop_events

    @property
    def bow_db(self):
        """The keyframe BoW database: (F, num_words) rows, or a TopWBow of
        (F, w) rows; a view of a buffer written in place. Assigning a
        database copies it into that buffer."""
        return vocab_mod.db_rows(self._db_buf)

    @bow_db.setter
    def bow_db(self, db) -> None:
        cur = self.bow_db
        pairs = zip(cur, db) if isinstance(cur, vocab_mod.TopWBow) else \
            ((cur, db),)
        for dst, src in pairs:
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)

    @loop_events.setter
    def loop_events(self, v) -> None:        # checkpoint restore
        self._loop_events = list(v)

    def graph_stats(self) -> Optional[dict]:
        """Captures, capture seconds, pool bytes and set-up launches of
        process's CUDA graphs and the keyframe programs' (the culls' of
        the chunked engine's host too); None where nothing was
        captured."""
        return merged_stats([None if self._static is None
                             else self._static.graphs, self._kf.graphs])

    def loop_graph_stats(self) -> Optional[dict]:
        """The loop programs' graphs: captures, capture seconds, pool
        bytes, set-up launches, the capturing threads and the runs by
        program; None without a vocabulary or off a card."""
        return None if self.vocab is None else self._loop.stats()

    def _stage(self, name: str):
        """A block timed as loop stage `name` while `stages` is set."""
        if self.stages is None:
            return contextlib.nullcontext()
        return self.stages.stage(name, self.device)

    # ----- device programs ----------------------------------------------
    def _build(self, img: torch.Tensor) -> FrameState:
        return build_frame(img, self.cam, self.cfg)

    def _stereo(self, frame: FrameState, img_l: torch.Tensor,
                img_r: torch.Tensor) -> FrameState:
        return add_stereo(frame, img_l, img_r, self.cam, self.cfg)

    def _snapshot(self, m: MapState):
        """Landmark snapshot, the latest keyframe's pose (a copy: the map
        changes in place), and (latest slot, valid keyframes) as a (2,)
        device tensor."""
        cfg = self.cfg
        lm = gather_local_landmarks(
            m, cfg.map.track_landmarks, cfg.map.track_recent_kfs,
            cfg.map.track_covis_kfs, cfg.map.track_covis_min,
            camera_frustum(cfg.camera))
        fid = torch.where(m.kf_valid, m.kf_frame_id,
                          torch.full_like(m.kf_frame_id, -1))
        slot = torch.argmax(fid)
        return lm, row(m.kf_T_cw, slot), \
            torch.stack([slot, torch.sum(m.kf_valid)])

    def _packed(self, T_prev, velocity, kf_T_latest, T_pred, res,
                *extra) -> tuple:
        """The keyframe rule and the frame's packed row [T(16),
        T_rel(16), ok, needs_kf, n_inliers, *extra], the one host read."""
        cfg = self.cfg
        needs = kf_rule.needs_keyframe(res.mp_xy, res.mp_inlier,
                                       cfg.camera.width, cfg.camera.height,
                                       cfg.keyframe)
        T_new = torch.where(res.ok, res.T_cw, T_pred)
        vel_new = se3.normalize(se3.compose(T_new, se3.inv(T_prev)))
        T_rel = se3.compose(T_new, se3.inv(kf_T_latest))
        packed = torch.cat([T_new.reshape(-1), T_rel.reshape(-1),
                            torch.stack([res.ok.float(), needs.float(),
                                         res.n_inliers.float(), *extra])])
        return res, T_new, vel_new, packed

    def _track(self, frame: FrameState, Xw, desc, valid, T_prev, velocity,
               kf_T_latest):
        """The per-frame hot path: (TrackResult, T_new, velocity, the
        packed (35,) row)."""
        T_pred = se3.compose(velocity, T_prev)
        res = track_pose(frame, Xw, desc, valid, T_pred, self.cam, self.cfg)
        return self._packed(T_prev, velocity, kf_T_latest, T_pred, res)

    def _track_direct(self, frame: FrameState, img, Xw, desc, valid, T_prev,
                      velocity, kf_T_latest, kf_img, kf_ab):
        """The direct method's hot path against the latest keyframe image:
        the packed row is (37,), with the frame's (a, b) last."""
        T_pred = se3.compose(velocity, T_prev)
        res, ab = track_direct_bound(frame, img, T_pred, kf_img, kf_T_latest,
                                     kf_ab, Xw, desc, valid, self.cam,
                                     self.cfg)
        return self._packed(T_prev, velocity, kf_T_latest, T_pred, res,
                            ab[0], ab[1])

    def _insert(self, m: MapState, frame: FrameState, T_cw, frame_id,
                ids, kpts, inliers, lm_Xw, lm_valid, quality):
        """Insert the keyframe, then cull the weak mappoints, in place:
        (m, the new slot). frame_id and quality: host numbers or 0-dim
        device tensors."""
        m, slot = insert_keyframe(m, frame, T_cw, frame_id, ids, kpts,
                                  inliers, self.cfg, quality=quality,
                                  lm_snapshot=(lm_Xw, lm_valid))
        mc = self.cfg.map
        return cull_weak_mappoints(m, frame_id, mc.mp_cull_grace_frames,
                                   mc.mp_cull_min_obs), slot

    def _insert_program(self, m: MapState, *inputs) -> torch.Tensor:
        return self._insert(m, *inputs)[1]

    def _ba(self, m: MapState) -> MapState:
        return local_ba_step(m, self.cam, self.cfg)

    def _ba_program(self, m: MapState) -> None:
        self._ba(m)

    def _cull(self, m: MapState):
        """The most redundant unprotected keyframe, if it clears 0.8."""
        return cull_most_redundant(m, 0.8,
                                   self.cfg.local_ba.window_keyframes)

    def _cull_any(self, m: MapState):
        """Forced eviction at capacity: the most redundant unprotected
        keyframe at any score (ref CullingOldFrames,
        src/pipeline_map.cpp:100-129)."""
        return cull_most_redundant(m, 0.0,
                                   self.cfg.local_ba.window_keyframes)

    def _bow(self, desc: torch.Tensor, valid: torch.Tensor):
        return vocab_mod.bow_query(self.vocab, desc, valid, self._bow_sparse,
                                   self.cfg.loop.bow_top_words)

    def _loop_score(self, m, bow_db, query, slot) -> det_mod.LoopScores:
        """One query's scores (the register program scores its rows at
        once, det_mod.score_queries)."""
        return det_mod.score_query(m, bow_db, query, slot, self.cfg.loop)

    # the loop programs' bodies: the eager path calls them with host ints
    # and fresh tensors, _LoopPrograms with its static buffers
    def _register_core(self, m: MapState, slots, valid, write):
        """The BoW of keyframe rows `slots` (K,) of m, one descent over all
        their descriptors; write(safe slots, queries) registers them (a
        slot `valid` leaves out is F, the dump row) and returns the
        database they are then all scored against (score_queries)."""
        F = m.kf_valid.shape[0]
        sl = slots.long()
        desc = m.kf_desc.index_select(0, sl).reshape(sl.shape[0], -1, 8)
        qs = self._bow(desc, m.kf_kpt_valid.index_select(0, sl))
        safe = torch.where(valid, sl, torch.full_like(sl, F))
        return det_mod.score_queries(m, write(safe, qs), qs, sl,
                                     self.cfg.loop)

    def _register_static(self, m: MapState, slots, valid):
        """_register_core writing the database in place (no new database
        is allocated, so a CUDA graph can hold it)."""
        def write(safe, qs):
            vocab_mod.db_write_(self._db_buf, safe, qs)
            return self.bow_db
        return self._register_core(m, slots, valid, write)

    @staticmethod
    def _pick_rows(packed: torch.Tensor):
        """The slots of a chunk's first BOW_ROWS keyframe rows (C, 36) and
        which are keyframes: a priority that ranks keyframe rows by
        position, stably sorted (lax.top_k's order on ties), so row i is
        the chunk's i-th keyframe; non-keyframe rows fill the rest."""
        slots = packed[:, _PACK_SLOT].long()
        slot_valid = packed[:, _PACK_KF] > 0.5
        C = packed.shape[0]
        prio = torch.where(slot_valid,
                           C - torch.arange(C, device=packed.device),
                           torch.zeros(C, dtype=torch.int64,
                                       device=packed.device))
        vals, rows = torch.sort(prio, descending=True, stable=True)
        K = min(BOW_ROWS, C)
        return slots[rows[:K]], vals[:K] > 0

    def _register_packed_static(self, m: MapState, packed):
        return self._register_static(m, *self._pick_rows(packed))

    def _relpose_program(self, m: MapState, cur, cand):
        """(RelPoseResult, packed (20,) [T(16), n_inliers, ok, scale,
        n_near]): one device->host read for the host's consumers."""
        rel = closer_mod.relative_pose(m, cur, cand, self.cam, self.cfg)
        packed = torch.cat([rel.T_cw.reshape(-1), torch.stack([
            rel.n_inliers.float(), rel.ok.float(), rel.scale.float(),
            rel.n_near.float()])])
        return rel, packed

    def _reloc_program(self, m: MapState, feats, norm, cand):
        return closer_mod.relocalize_frame(m, feats, norm, cand, self.cam,
                                           self.cfg)

    def _seam_program(self, m: MapState, cur, cand) -> None:
        seam_ba_step(m, cur, cand, self.cam, self.cfg)

    # the loop programs the host steps call (the JAX names)
    def _covis(self, m: MapState, slots) -> torch.Tensor:
        """(len(slots), F) covisibility rows, one per candidate slot (host
        ints): COVIS_ROWS a run of the covisibility program, padded."""
        slots = np.asarray(slots, np.int64).reshape(-1)
        with self._stage("covis"):
            if not self.graphs:
                return torch.stack([covisibility_counts(m, int(s))
                                    for s in slots])
            out = []
            for j in range(0, len(slots), COVIS_ROWS):
                batch = slots[j:j + COVIS_ROWS]
                pad = np.zeros(COVIS_ROWS, np.int64)
                pad[:len(batch)] = batch
                rows = self._loop.run("covis", m, pad,
                                      np.arange(COVIS_ROWS) < len(batch))
                out.append(rows[:len(batch)].clone())
            return torch.cat(out)

    def _relpose(self, m: MapState, cur, cand):
        """(RelPoseResult, packed (20,)) of keyframe cur against cand; with
        graphs, copies the program's outputs own (a measurement waits
        across folds while later ones run)."""
        with self._stage("relpose"):
            if not self.graphs:
                return self._relpose_program(m, int(cur), int(cand))
            return self._loop.run("relpose", m, cur, cand, copy_out=True)

    def _reloc(self, m: MapState, feats, norm, cand):
        with self._stage("reloc"):
            if not self.graphs:
                return self._reloc_program(m, feats, norm, int(cand))
            return self._loop.run("reloc", m, feats, norm, cand,
                                  copy_out=True)

    def _seam_ba(self, m: MapState, cur, cand) -> MapState:
        """Seam BA on m in place; returns m."""
        with self._stage("seam BA"):
            if not self.graphs:
                seam_ba_step(m, int(cur), int(cand), self.cam, self.cfg)
            else:
                self._loop.run("seam", m, cur, cand)
        return m

    def _close_body(self, m, cur, cand, T_loop, ci, cj, cT, cv, cw, k, scale,
                    q, tier: int):
        """Close + merge + ring update: (the map, ci, cj, cT, cv, cw). The
        loop edge's weight is the relative pose's inlier count over 2
        min_matches, clipped; the ring records the edge relative to the
        pre-correction candidate (SE3), or post-correction at unit scale
        (Sim3: close_loop has rescaled the anchored depths, so the map is
        metric again). cur, cand and the ring index k: host ints or 0-dim
        device tensors; the returned map's replaced fields and the ring
        are new tensors."""
        cfg = self.cfg
        w = torch.clamp(q / (2.0 * cfg.loop.min_matches),
                        cfg.loop.loop_edge_min_weight, 1.0)
        loop_T_se3 = T_loop @ se3.inv(at(m.kf_T_cw, cand))
        m = closer_mod.close_loop(m, cur, cand, T_loop, ci, cj, cT, cv, cfg,
                                  tier=tier, loop_scale=scale,
                                  loop_weight=w, prev_loops_w=cw)
        if cfg.loop.pose_graph_group == "sim3":
            loop_T = at(m.kf_T_cw, cur) @ se3.inv(at(m.kf_T_cw, cand))
        else:
            loop_T = loop_T_se3
        m = closer_mod.merge_mappoints(m, cur, cand, self.cam, cfg)
        dev = ci.device
        hit = torch.arange(ci.shape[0], device=dev) == (
            k if torch.is_tensor(k) else int(k))
        return (m, torch.where(hit, closer_mod._slot(cand, dev).int(), ci),
                torch.where(hit, closer_mod._slot(cur, dev).int(), cj),
                torch.where(hit[:, None, None], loop_T, cT), cv | hit,
                torch.where(hit, w, cw))

    def _close_program(self, m: MapState, cur, cand, T_loop, scale, q, k, ci,
                       cj, cT, cv, cw, tier: int) -> tuple:
        """_close_body on m in place: the new ring (ci, cj, cT, cv, cw)."""
        m2, *ring = self._close_body(m, cur, cand, T_loop, ci, cj, cT, cv,
                                     cw, k, scale, q, tier)
        store_map(m, m2)
        return tuple(ring)

    def _close(self, cur: int, cand: int, rel, k: int, tier: int) -> None:
        """The close of keyframe cur onto cand with relative pose `rel`
        into ring entry k, on the map and the ring in place (the
        programs' graphs read them at their addresses): the close@tier
        program with graphs, else its body."""
        ring = (self.closed_i, self.closed_j, self.closed_T,
                self.closed_valid, self.closed_w)
        q = rel.n_inliers.float()
        if self.graphs:
            new = self._loop.run(f"close@{tier}", self.map, cur, cand,
                                 rel.T_cw, rel.scale, q, k, *ring)
        else:
            m, *new = self._close_body(self.map, cur, cand, rel.T_cw, *ring,
                                       k, rel.scale, q, tier)
            store_map(self.map, m)
        for dst, src in zip(ring, new):
            dst.copy_(src)

    def _register(self, m: MapState, slots, valid):
        """Register and score keyframe rows (BOW_ROWS slots and their mask,
        host arrays or device tensors): the register program, replayed
        with graphs, else its body run eagerly."""
        with self._stage("register"):
            if self.graphs:
                return self._loop.run("register", m, slots, valid,
                                      copy_out=True)
            if isinstance(slots, np.ndarray):
                slots, valid = (upload(a, self.device) for a in (slots, valid))
            return self._register_static(m, slots, valid)

    def _bow_register(self, m: MapState, bow_db, packed: torch.Tensor):
        """BoW of a chunk's first BOW_ROWS keyframe rows, registered in the
        database and scored against it, from the chunk's (C, 36) packed
        rows on the device (_pick_rows over the rows padded with
        non-keyframe rows to at least BOW_ROWS, so that every path scores
        BOW_ROWS rows): (the database, the scores, row i the chunk's i-th
        keyframe). With graphs a chunk has at most
        _LoopPrograms.rows_capacity rows (the chunked engine's
        chunk_size)."""
        C = packed.shape[0]
        if not self.graphs:
            if C < BOW_ROWS:
                packed = torch.cat([packed, packed.new_zeros(
                    (BOW_ROWS - C, packed.shape[1]))])
            with self._stage("register"):
                return self.bow_db, self._register_packed_static(m, packed)
        cap = self._loop.rows_capacity
        if C > cap:
            raise ValueError(f"a chunk of {C} rows: the graphed BoW "
                             f"register takes at most {cap} (chunk_size)")
        with self._stage("register"):
            buf = self._loop.program("register_packed", m).inputs[1]
            buf.zero_()
            buf[:C].copy_(packed)
            sc = self._loop.run("register_packed", m, copy_out=True)
        return self.bow_db, sc

    def _bow_register_only(self, m: MapState, bow_db, slots, valid):
        """Register and score keyframe rows beyond a chunk's first
        BOW_ROWS (host arrays or device tensors of BOW_ROWS): an
        unregistered dense row is all zero and scores 0.5 against every
        normalized query, a standing false candidate."""
        return self.bow_db, self._register(m, slots, valid)

    # the keyframe programs the host steps call
    def _take_snapshot(self, m: MapState) -> tuple:
        """_snapshot of m: the snapshot program's outputs with graphs (the
        buffers its next run overwrites), else its body's."""
        if not self.graphs:
            return self._snapshot(m)
        return self._kf.run("snapshot", m)

    def _cull_slot(self, m: MapState, name: str) -> int:
        """Program `name` ("cull" or "cull_any") on m in place: the culled
        slot or -1, read back here (the cull's one host read)."""
        if self.graphs:
            s = self._kf.run(name, m)
        else:
            s = (self._cull if name == "cull" else self._cull_any)(m)[1]
        return int(s)

    # ----- per-frame driver ---------------------------------------------
    def _upload(self, img) -> torch.Tensor:
        return torch.as_tensor(img).to(self.device, torch.float32)

    @full_float32()
    def process(self, left, right) -> np.ndarray:
        """Track one stereo pair (numpy or tensor images); returns the
        estimated T_cw (4, 4). A frame that is no keyframe costs one image
        upload, _build and _track (two CUDA graph replays on a card, see
        _StaticTrack) and one packed readback; stereo, insertion, BA, the
        loop step and the snapshot refresh run at keyframes. The work
        runs in full float32 (TF32 off, the caller's flags restored on
        return)."""
        self._t_frame0 = time.perf_counter()
        direct = self.cfg.tracker.method == "direct"
        if self.graphs and self._static is None:
            self._static = _StaticTrack(self, torch.as_tensor(left))
        if self.n_keyframes == 0:
            if self.graphs:
                img_l, frame = self._static.build(self, left)
                img_r = right              # copied into the stereo program
            else:
                img_l, img_r = self._upload(left), self._upload(right)
                frame = self._build(img_l)
            self._make_keyframe(frame, img_l, img_r, self.T_cw, ids=None,
                                kpts=None, inliers=None, run_ba=False)
            eye = np.eye(4, dtype=np.float32)
            self._finish_frame(eye, eye, 0, True)
            return self.T_cw.cpu().numpy()

        Xw, desc, ids, valid = self._lm
        if self.graphs:
            img_l, frame, (res, T_new, vel_new, packed) = \
                self._static.step(self, left)
            ids = self._static.ids
        else:
            img_l = self._upload(left)
            frame = self._build(img_l)
            if direct:
                res, T_new, vel_new, packed = self._track_direct(
                    frame, img_l, Xw, desc, valid, self.T_cw, self.velocity,
                    self._latest_kf_T_dev, self._kf_img, self._kf_ab)
            else:
                res, T_new, vel_new, packed = self._track(
                    frame, Xw, desc, valid, self.T_cw, self.velocity,
                    self._latest_kf_T_dev)
        if direct:
            self._kf_ab = packed[35:37]
        packed_np = packed.cpu().numpy()             # the one readback
        if not packed_np[32] > 0.5 and self.vocab is not None:
            # relocalization (absent from the reference, which always
            # trusts constant velocity, ref src/pipeline.cpp:154-166)
            reloc = self._try_relocalize(frame)
            if reloc is not None:
                eye = torch.eye(4, dtype=torch.float32, device=self.device)
                if self.graphs and not direct:
                    res, T_new, vel_new, packed = self._static.retrack(
                        self, reloc, eye)
                else:
                    res, T_new, vel_new, packed = self._track(
                        frame, Xw, desc, valid, reloc, eye,
                        self._latest_kf_T_dev)
                packed_np = packed.cpu().numpy()
        tracked_ok = packed_np[32] > 0.5
        needs_kf = packed_np[33] > 0.5
        n_inliers = int(packed_np[34])
        T_np = packed_np[:16].reshape(4, 4)
        T_rel_np = packed_np[16:32].reshape(4, 4)
        self.T_cw, self.velocity = T_new, vel_new

        # relative decay rule (cfg.keyframe.decay_ratio): fire when the
        # inliers fall below a fraction of their peak since the last
        # keyframe; the grid rule alone under-fires on dense maps
        if n_inliers < self.cfg.keyframe.decay_ratio * self._inlier_peak:
            needs_kf = True
        self._inlier_peak = 0.0 if (needs_kf or not tracked_ok) else \
            max(self._inlier_peak, float(n_inliers))

        if needs_kf or not tracked_ok:
            self._make_keyframe(frame, img_l, right if self.graphs
                                else self._upload(right), T_new,
                                ids=ids, kpts=res.mp_kpt,
                                inliers=res.mp_inlier, run_ba=True)
            # BA may have moved the keyframe: the frame takes its pose
            T_np = self._latest_kf_T_host
            T_rel_np = np.eye(4, dtype=np.float32)
            self.T_cw = self._latest_kf_T_dev
        self._finish_frame(T_np, T_rel_np, n_inliers, bool(needs_kf))
        return T_np

    def _latest_slot(self) -> int:
        fid = torch.where(self.map.kf_valid, self.map.kf_frame_id,
                          torch.full_like(self.map.kf_frame_id, -1))
        return int(torch.argmax(fid))

    def _refresh_kf_mirrors(self) -> None:
        """Landmark snapshot and host mirrors after a map mutation: one
        small readback."""
        self._lm, self._latest_kf_T_dev, counts = \
            self._take_snapshot(self.map)
        self._lm_serial += 1
        vals = torch.cat([counts.float(),
                          self._latest_kf_T_dev.reshape(-1)]).cpu().numpy()
        self._latest_slot_host, self._n_kf_valid_host = \
            int(vals[0]), int(vals[1])
        self._latest_kf_T_host = vals[2:].reshape(4, 4).copy()

    def _make_keyframe(self, frame: FrameState, img_l, img_r, T_cw, ids,
                       kpts, inliers, run_ba: bool) -> None:
        cap = self.cfg.map.max_keyframes
        if self._n_kf_valid_host >= cap - 2:
            # near capacity: cull redundant keyframes (mapping/culling);
            # if nothing is redundant enough, evict the most redundant
            for _ in range(4):
                kf_T_pre = self.map.kf_T_cw.cpu().numpy().copy()
                s = self._cull_slot(self.map, "cull")
                if s < 0:
                    s = self._cull_slot(self.map, "cull_any")
                if s < 0:
                    break
                # frames anchored on the culled slot move to a surviving
                # keyframe before the slot is reused
                self._refresh_kf_mirrors()
                new_anchor = self._latest_slot_host
                T_new_inv = np.linalg.inv(kf_T_pre[new_anchor])
                for i, (sl, rel) in enumerate(self._traj_anchor):
                    if sl == s:
                        self._traj_anchor[i] = (
                            new_anchor, (rel @ kf_T_pre[s]) @ T_new_inv)
            self._refresh_kf_mirrors()
            if self._n_kf_valid_host >= cap - 2:
                raise RuntimeError(f"keyframe capacity {cap} exhausted "
                                   f"(nothing redundant to cull)")
        frame = self._kf.run("stereo", None, frame, img_l, img_r) \
            if self.graphs else self._stereo(frame, img_l, img_r)
        if self.cfg.tracker.method in ("direct", "hybrid"):
            # the new keyframe becomes the photometric anchor (a copy:
            # process's static image buffer is overwritten); its (a, b)
            # are whatever tracking last estimated (bootstrap: 0, 0)
            self._kf_img = img_l.clone()
        if ids is None:
            # bootstrap: nothing was tracked, so the tracked-inlier
            # quality would be 0 and close_loop's de-weighting would dump
            # a whole loop correction into this keyframe's chain edge;
            # full weight instead (unmeasured, not bad)
            L = self.cfg.map.track_landmarks
            ids = kpts = torch.zeros((L,), dtype=torch.int32,
                                     device=self.device)
            inliers = torch.zeros((L,), dtype=torch.bool, device=self.device)
            quality = float(2 * self.cfg.tracker.min_matches)
        else:
            quality = torch.sum(inliers.float())
        args = (frame, T_cw, self.frame_id, ids, kpts, inliers, self._lm[0],
                self._lm[3], quality)
        if self.graphs:
            slot = self._kf.run("insert", self.map, *args)
        else:
            slot = self._insert(self.map, *args)[1]
        self.n_keyframes += 1
        if self.vocab is not None:
            self._loop_step(slot)
        if run_ba and self.n_keyframes >= 3:
            if self.graphs:
                self._kf.run("ba", self.map)
            else:
                self._ba(self.map)
        self._refresh_kf_mirrors()

    def _finish_frame(self, T_np: np.ndarray, T_rel_np: np.ndarray,
                      n_inliers: int, is_kf: bool) -> None:
        self.trajectory.append(T_np)
        self._traj_anchor.append((self._latest_slot_host, T_rel_np))
        # per-frame wall clock, the reference's FrameInfo::elapsed_ms_
        # (ref src/pipeline.cpp:144,209-212)
        elapsed_ms = 1000.0 * (time.perf_counter() - getattr(
            self, "_t_frame0", time.perf_counter()))
        self.frame_stats.append({"frame": self.frame_id,
                                 "inliers": n_inliers, "kf": is_kf,
                                 "elapsed_ms": round(elapsed_ms, 2)})
        self.frame_id += 1

    def trajectory_refined(self) -> List[np.ndarray]:
        """Per-frame poses re-expressed against the current keyframe
        poses, so BA and pose-graph corrections reach every frame."""
        kf_T = self.map.kf_T_cw.cpu().numpy()
        return [rel @ kf_T[slot] for slot, rel in self._traj_anchor]

    def num_mappoints(self) -> int:
        return int(self.map.mp_valid.sum())

    def keyframe_poses(self) -> np.ndarray:
        valid = self.map.kf_valid.cpu().numpy()
        return self.map.kf_T_cw.cpu().numpy()[valid]

    # ----- loop closing -------------------------------------------------
    def _loop_step(self, slot: torch.Tensor) -> None:
        """The new keyframe's BoW row (slot, a 0-dim device tensor: the row
        insert just wrote) registered and scored, as the register program's
        one row, then its detection."""
        sl = slot.reshape(1).long()
        slots = torch.cat([sl, sl.new_zeros(BOW_ROWS - 1)])
        valid = torch.arange(BOW_ROWS, device=self.device) == 0
        sc = self._register(self.map, slots, valid)
        self._loop_kf_detect(int(slot), sc)

    def _loop_kf_detect(self, slot: int, sc: det_mod.LoopScores) -> None:
        """Detection, consistency and closure for one new keyframe from
        its scores (row 0 of sc)."""
        if self.n_keyframes < 3:
            return
        with self._stage("scores readback"):
            cand, scores = (t.cpu().numpy() for t in (sc.candidates[0],
                                                     sc.scores[0]))
        self._consume_scores(slot, cand, scores)

    # ----- loop host steps ----------------------------------------------

    def _close_tier(self) -> int:
        """Smallest pose-graph tier covering the live keyframes plus
        _tier_margin (the mirror may lag the newest insert)."""
        F = self.cfg.map.max_keyframes
        need = min(self._n_kf_valid_host + self._tier_margin, F)
        for t in _PG_TIERS:
            if need <= t <= F:
                return t
        return F

    def _try_relocalize(self, frame):
        """BoW-rank the keyframes against a lost frame and re-track the
        best three in turn; the first accepted pose, or None."""
        q = self._bow(frame.feats.desc, frame.feats.valid)
        scores = vocab_mod.bow_score(q, self.bow_db).cpu().numpy().copy()
        scores[~self.map.kf_valid.cpu().numpy()] = -1.0
        for cand in np.argsort(-scores)[:3]:
            if scores[cand] <= 0.0:
                break
            rel = self._reloc(self.map, frame.feats, frame.norm_xy,
                              int(cand))
            ok, n = (int(v) for v in torch.stack(
                [rel.ok.long(), rel.n_inliers.long()]).cpu())
            if ok:
                self._loop_events.append({"frame": self.frame_id,
                                          "reloc_to": int(cand),
                                          "inliers": n})
                return rel.T_cw
        return None

    def _detect_accept(self, slot: int, cand_mask: np.ndarray,
                       scores: np.ndarray, covis_of: Optional[dict],
                       fid: int, n_keyframes: int,
                       m: Optional[MapState] = None) -> list:
        """accScore groups + consistency for one new keyframe: the
        accepted candidate slots, strongest first ([] = none), gated on
        the keyframe count n_keyframes. Missing covisibility rows are
        read from `m` (default the engine's map)."""
        loop = self.cfg.loop
        if n_keyframes < 3:
            return []
        if n_keyframes - self._last_closure_nkf \
                < loop.closure_cooldown_kfs or not cand_mask.any():
            self.consistency.update([])
            return []
        raw_slots = np.flatnonzero(cand_mask)
        if covis_of is not None and all(int(s) in covis_of
                                        for s in raw_slots):
            covis_rows = np.stack([covis_of[int(s)] for s in raw_slots])
        else:
            covis_rows = self._covis(self.map if m is None else m,
                                     raw_slots).cpu().numpy()
        with self._stage("detect"):
            cand_slots, _ = det_mod.acc_score_retrieval(
                scores, raw_slots, covis_rows, loop.acc_score_ratio,
                loop.acc_group_size)
            if len(cand_slots) == 0:
                self.consistency.update([])
                return []
            row_of = {int(c): i for i, c in enumerate(raw_slots)}
            groups = []
            for cs in cand_slots:
                cov = covis_rows[row_of[int(cs)]]
                grp = set(np.flatnonzero(
                    cov >= loop.min_covisibility).tolist())
                grp.add(int(cs))
                groups.append(grp)
            accepted = self.consistency.update(groups)
        if not accepted:
            return []
        accepted.sort(key=lambda ci: -scores[cand_slots[ci]])
        return [int(cand_slots[ci]) for ci in accepted]

    def _closure_is_dup(self, fid: int, fid_cand: int, n_new: int) -> bool:
        """Same-seam dedup: a pair within closure_dedup_frames of a closed
        one may only refine it with more inliers."""
        W = self.cfg.loop.closure_dedup_frames
        return any(abs(fid - fj) <= W and abs(fid_cand - fi) <= W
                   and n_new <= n_old for fj, fi, n_old in self._closed_pairs)

    def _dispatch_close(self, slot: int, cand: int, rel, fid: int,
                        fid_cand: int, vals: np.ndarray,
                        n_keyframes: int) -> None:
        """Close an accepted, measured loop: the close program (and seam
        BA when on and the closure moved the current keyframe by at
        least seam_ba_min_corr_m), the ring, the bookkeeping and the
        event. vals: the host copy of _relpose's packed row; n_keyframes:
        the keyframe count the cooldown starts from."""
        n_new = int(vals[16])
        k = self.n_closed % MAX_CLOSED_LOOPS
        tier = self._close_tier()
        T_cand_pre = self.map.kf_T_cw[cand].cpu().numpy()
        corr_m = None
        if self.cfg.loop.seam_ba:
            T_pre = self.map.kf_T_cw[slot].cpu().numpy()
            T_meas = vals[:16].reshape(4, 4)
            corr_m = float(np.linalg.norm(
                T_pre[:3, :3].T @ T_pre[:3, 3]
                - T_meas[:3, :3].T @ T_meas[:3, 3]))
        with self._stage("close"):
            self._close(slot, cand, rel, k, tier)
        if self.cfg.loop.seam_ba and \
                corr_m >= self.cfg.loop.seam_ba_min_corr_m:
            self.map = self._seam_ba(self.map, slot, cand)
        self.n_closed += 1
        self.close_tiers.append(tier)
        self._last_closure_nkf = n_keyframes
        self._closed_pairs.append((fid, fid_cand, n_new))
        self.consistency.reset()
        self._loop_events.append({
            "frame": fid, "kf_slot": slot, "cand": cand, "inliers": n_new,
            "fid_cand": fid_cand, "n_near": int(vals[19]),
            "scale": round(float(vals[18]), 5),
            "T_meas": vals[:16].reshape(4, 4).tolist(),
            "T_cand_pre": T_cand_pre.tolist()})

    def _consume_scores(self, slot: int, cand_mask: np.ndarray,
                        scores: np.ndarray, covis_of: Optional[dict] = None,
                        frame_id: Optional[int] = None) -> None:
        """Detection and, for the first accepted candidate that measures
        ok and is no duplicate, the closure, synchronously."""
        fid = self.frame_id if frame_id is None else frame_id
        for cand in self._detect_accept(slot, cand_mask, scores, covis_of,
                                        fid, self.n_keyframes):
            rel, pk = self._relpose(self.map, slot, cand)
            with self._stage("relpose readback"):
                vals = pk.cpu().numpy()
            if not vals[17] > 0.5:
                continue
            fid_cand = int(self.map.kf_frame_id[cand])
            if self._closure_is_dup(fid, fid_cand, int(vals[16])):
                continue
            self._dispatch_close(slot, cand, rel, fid, fid_cand, vals,
                                 self.n_keyframes)
            break
