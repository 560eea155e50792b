"""ctypes bindings for the native prefetching stereo loader.

Counterpart of slam_toolkit_tpu/data/native_loader.py. The native side
(native/loader.cpp) decodes PNG stereo pairs on a background thread into
a ring buffer, keeping host decoding off the critical path while the
device computes (the role of the reference's dataset layer, ref
src/dataset.cpp:108-124). The library is built at first use with
native/build.sh's flags (g++ -O2 -shared -fPIC -std=c++17 ... -lpng
-lpthread; libpng's headers needed) into slam_toolkit_tpu_torch/_build/,
named by a hash of the source, and bound with ctypes. Where it cannot be
built, library() raises with the compiler's output: nothing here
decodes with cv2 instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "loader.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-lpthread")

_FLOATS = ctypes.POINTER(ctypes.c_float)
# name -> (restype, argtypes) of each C entry point
SIGNATURES = {
    "loader_open": (ctypes.c_void_p, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "loader_next": (ctypes.c_int, [ctypes.c_void_p, _FLOATS, _FLOATS]),
    "loader_close": (None, [ctypes.c_void_p]),
    "decode_gray": (ctypes.c_int, [ctypes.c_char_p, _FLOATS, ctypes.c_int,
                                   ctypes.c_int]),
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the loader library; once per process.
    Raises RuntimeError, with the compiler's output, when it cannot be
    built."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native loader needs a C++ compiler (g++) "
                           "and libpng's headers")
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libslamloader_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
        res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), *LIBS, "-o",
                              str(tmp)], capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the native loader failed (exit "
                               f"{res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, so)              # atomic: concurrent builds agree
    return _bind(ctypes.CDLL(str(so)))


def available() -> bool:
    """Whether the loader library builds and loads here (library() raises
    where it cannot)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


class PrefetchLoader:
    """Iterates (left, right) float32 stereo pairs decoded on the native
    loader's background thread, `ring` frames ahead. A frame that fails
    to decode, or whose size is not (height, width), raises IOError."""

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 height: int, width: int, ring: int = 4):
        if len(left_paths) != len(right_paths):
            raise ValueError(f"{len(left_paths)} left and "
                             f"{len(right_paths)} right paths")
        self._lib = library()
        self.n = len(left_paths)
        self.height, self.width = height, width
        self._paths = left_paths
        self._i = 0
        arr_l = (ctypes.c_char_p * self.n)(*[p.encode() for p in left_paths])
        arr_r = (ctypes.c_char_p * self.n)(*[p.encode()
                                             for p in right_paths])
        self._h = self._lib.loader_open(arr_l, arr_r, self.n, height, width,
                                        ring)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._i >= self.n:
            raise StopIteration
        if not self._h:
            raise ValueError("the loader is closed")
        left = np.empty((self.height, self.width), np.float32)
        right = np.empty((self.height, self.width), np.float32)
        idx = self._lib.loader_next(self._h, left.ctypes.data_as(_FLOATS),
                                    right.ctypes.data_as(_FLOATS))
        if idx != self._i:
            raise IOError(f"stereo pair {self._i} ({self._paths[self._i]}) "
                          f"failed to decode at {self.width}x{self.height}")
        self._i += 1
        return left, right

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def decode_gray(path: str, height: int, width: int) -> np.ndarray:
    """One PNG decoded to (height, width) float32 grayscale by the native
    library; IOError where it fails."""
    out = np.empty((height, width), np.float32)
    if library().decode_gray(path.encode(), out.ctypes.data_as(_FLOATS),
                             height, width) != 0:
        raise IOError(f"{path}: failed to decode at {width}x{height}")
    return out
