"""Build, load and launch the package's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, and linked into one shared
library with a plain C interface, at first use, into ``_build/`` beside
them (listed in ``.gitignore``). The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. It is bound with ``ctypes``.

Every C entry point takes the CUDA stream as its last argument, launches
on it without synchronising, and returns ``cudaGetLastError()``;
:class:`CudaKernel` raises when that is not 0 and otherwise counts the
launch. Nothing here falls back to another implementation. Every launch
count (:class:`LaunchCount`: each kernel's own, and any a caller keeps
beside them) is listed in :func:`launch_counts`, so that a CUDA graph
(utils/cuda_graphs) can add on each replay what its capture recorded. A
graph's conditional bodies run on some replays only: each counts its
executions on the device, and their launches are added when a count is
read (:func:`settle`), never inside the replays.

The chunked engine's mapping worker launches kernels on a thread of its
own while the main thread replays graphs, so counts are added under a
lock (:meth:`LaunchCount.add`), and :func:`counting` and
:func:`counts_apart` see only the launches of the thread that opened
them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import NamedTuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


class Library(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an existing build was loaded
    build_log: str            # nvcc's output per source (registers, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))     # the toolkit default
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                       "CUDA_HOME")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (if needed) and load the kernel library; once per process."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    so = BUILD_DIR / f"libslam_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = so.with_name(f"{tag}.so.tmp")
        res = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]],
            capture_output=True, text=True)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)              # atomic: concurrent builds agree
    cdll = ctypes.CDLL(str(so))
    cdll.slam_cuda_error_string.argtypes = [INT]
    cdll.slam_cuda_error_string.restype = ctypes.c_char_p
    return Library(cdll, so, seconds, log)


_COUNTS: "weakref.WeakSet[LaunchCount]" = weakref.WeakSet()
_COUNT_LOCK = threading.Lock()
_COUNTING = threading.local()      # .blocks: the thread's open counting()s
# the launches of conditional bodies, counted once per execution when read:
# [owner (weak), executions (a device int64), {LaunchCount: n}, executions
# counted so far]
_DEFERRED: list = []
_SETTLE_LOCK = threading.RLock()
_UNSETTLED: dict = {}   # thread -> ids of owners it replayed since


class LaunchCount:
    """A count of kernel launches, `launches`, that callers reset by
    assigning 0. Every live one is listed by launch_counts(). Reading or
    assigning `launches` first settles the conditional bodies' launches
    (settle)."""

    def __init__(self):
        self._n = 0
        _COUNTS.add(self)

    @property
    def launches(self) -> int:
        settle()
        return self._n

    @launches.setter
    def launches(self, n: int) -> None:
        settle()
        with _COUNT_LOCK:
            self._n = n

    def add(self, n: int = 1) -> None:
        """Count n launches made by this thread: under a lock (an
        increment from another thread is never lost), and into the
        thread's innermost open counting() or counts_apart() block."""
        with _COUNT_LOCK:
            self._n += n
        blocks = getattr(_COUNTING, "blocks", None)
        if blocks:
            blocks[-1][self] = blocks[-1].get(self, 0) + n


def defer(owner, executions: torch.Tensor, delta: dict) -> None:
    """Count `delta`'s launches once for every execution of a conditional
    body (utils/cuda_graphs.run_if): `executions` is the device int64
    that the body adds one to. They are added when counts are read
    (settle), while `owner` (the body's StepGraphs) lives and once after."""
    with _SETTLE_LOCK:
        _DEFERRED.append([weakref.ref(owner), executions, dict(delta), 0])


def mark_unsettled(owner) -> None:
    """This thread replayed a graph of `owner` that has conditional
    bodies: its next read of a count settles them."""
    with _SETTLE_LOCK:
        _UNSETTLED.setdefault(threading.get_ident(), set()).add(id(owner))


def settle() -> None:
    """Add the launches of the conditional bodies this thread replayed,
    for their executions since the last settle, into this thread's open
    blocks: one synchronise and one readback of their executions, made
    only after such a replay and never while this thread's stream
    captures. Bodies whose graphs are gone are dropped after their last
    reading."""
    me = threading.get_ident()
    if me not in _UNSETTLED or (torch.cuda.is_available() and
                                torch.cuda.is_current_stream_capturing()):
        return
    with _SETTLE_LOCK:
        owners = _UNSETTLED.pop(me, set())
        by_dev: dict = {}
        for e in _DEFERRED:
            o = e[0]()
            if o is None or id(o) in owners:
                by_dev.setdefault(e[1].device, []).append(e)
        for dev, entries in by_dev.items():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            got = torch.stack([e[1] for e in entries]).tolist()
            for e, n in zip(entries, got):
                k, e[3] = n - e[3], n
                for c, m in e[2].items():
                    if m * k:       # a block sees no body that did not run
                        c.add(m * k)
        _DEFERRED[:] = [e for e in _DEFERRED if e[0]() is not None]


@contextlib.contextmanager
def _block(merge: bool):
    settle()                       # what ran before is not the block's
    blocks = _COUNTING.__dict__.setdefault("blocks", [])
    delta: dict = {}
    blocks.append(delta)
    try:
        yield delta
        if merge:
            settle()
    finally:
        blocks.pop()
        if merge and blocks:
            for c, n in delta.items():
                blocks[-1][c] = blocks[-1].get(c, 0) + n


def counting():
    """A block whose yielded dict receives {LaunchCount: launches} made by
    this thread inside it (those of nested blocks, and of conditional
    bodies replayed in it, too). Launches another thread makes meanwhile
    are not in it."""
    return _block(merge=True)


@contextlib.contextmanager
def counts_apart():
    """Launches this thread counts inside the block are taken back on
    exit (an enclosing counting() block does not see them); the yielded
    dict receives {LaunchCount: launches} of the block. Another thread's
    launches meanwhile (the mapping worker's) stay counted."""
    with _block(merge=False) as delta:
        try:
            yield delta
        finally:
            for c, n in delta.items():
                with _COUNT_LOCK:
                    c._n -= n


def launch_counts() -> list:
    """Every live LaunchCount: each CudaKernel's, and those callers made
    (a count by window shape, say), the conditional bodies' launches
    settled."""
    settle()
    return list(_COUNTS)


class CudaKernel(LaunchCount):
    """One C entry point of the library, with a count of its launches.

    ``launches`` is incremented only after the entry point returned
    success, i.e. once per kernel launch; under a CUDA graph the capture's
    increments are taken back and each replay adds them
    (utils/cuda_graphs).
    """

    def __init__(self, symbol: str, *argtypes):
        super().__init__()
        self.symbol = symbol
        self.argtypes = [*argtypes, PTR]          # + the stream
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream (the tensors' device)."""
        lib = library().cdll
        if self._fn is None:
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = INT
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = lib.slam_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.add()


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple, device: torch.device = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of dtype and shape
    (None in `shape` matches any extent), on `device` if one is given."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cuda(t: torch.Tensor) -> bool:
    """The wrappers' one dispatch rule: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (run the plain version); any other
    device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no implementation for device {t.device}")
    return False
