"""ctypes bindings of the native frame loader (`csrc/frameloader.cpp`) and
its numpy stand-in (twin of `cusift_tpu/utils/native_loader.py`).

The disk -> float32 decode and its prefetch run on the host.  The native
library is built at first use with g++ (and zlib) into
`cusift_tpu_torch/_build/`, keyed by a hash of its source and flags, as
`kernels/_build.py` builds the CUDA sources.  Where it does not build (no
g++, no zlib.h) `decode` and `FrameStream` take the numpy decoder of
`utils/imgcodec.py`, which gives the same bytes; `decoder()` says which
one runs, and every caller prints it.  The reference falls back to cv2,
which the port does not import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import imgcodec

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "frameloader.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off")

_lib = None
_tried = False
_lock = threading.Lock()
build_error = ""          # the compiler's output when the build failed


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libframeloader_{h}.so"


def _build() -> Path | None:
    global build_error
    so = _so_path()
    if so.is_file():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        build_error = str(e)
        return None
    if proc.returncode != 0:
        build_error = proc.stdout + proc.stderr
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """The native library (built on first use), or None where it does not
    build."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.fl_open.restype = ctypes.c_int
        lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.fl_close.argtypes = [ctypes.c_int]
        lib.fl_decode.restype = ctypes.c_int
        lib.fl_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_float]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def decoder() -> str:
    """"native" where the library builds, else "numpy"."""
    return "native" if native_available() else "numpy"


def _backend(backend: str | None) -> str:
    if backend is None:
        return decoder()
    if backend not in ("native", "numpy"):
        raise ValueError(f"unknown decoder {backend!r}")
    if backend == "native" and not native_available():
        raise RuntimeError(f"native loader unavailable: {build_error.strip()[:500]}")
    return backend


def decode(path: str, scale: float = 0.0, max_pixels: int = 4096 * 4096,
           backend: str | None = None) -> np.ndarray:
    """Decode one PNG/PGM/PPM/.npy file to float32 [H, W]; `backend`
    "native", "numpy" or None (the native one where it builds)."""
    if _backend(backend) == "numpy":
        try:
            out = imgcodec.decode_file(path, scale)
        except OSError as e:
            raise ValueError(f"decode failed: {path}: {e}") from None
        if out.size > max_pixels:
            raise ValueError(f"decode failed (-3): {path}")
        return out
    lib = get_lib()
    buf = np.empty(max_pixels, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.fl_decode(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       max_pixels, ctypes.byref(h), ctypes.byref(w), scale)
    if rc != 0:
        raise ValueError(f"decode failed ({rc}): {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class FrameStream:
    """Prefetching frame iterator over a list of files: the native worker
    pool, or a thread pool over the numpy decoder (`backend` as for
    `decode`; `self.backend` says which).

    scale == 0 -> normalise by the format's max value (images in [0, 1]);
    otherwise multiply raw values by `scale` (e.g. 1/5000 for TUM depth).
    A file that does not decode raises ValueError at its turn.
    """

    def __init__(self, paths: list[str], threads: int = 4, queue_depth: int = 8,
                 scale: float = 0.0, max_pixels: int = 4096 * 4096,
                 backend: str | None = None):
        self.backend = _backend(backend)
        self._closed = False
        self._max_pixels = max_pixels
        if self.backend == "numpy":
            self._paths = list(paths)
            self._scale = scale
            self._depth = max(1, queue_depth)
            self._pool = ThreadPoolExecutor(max(1, threads))
            self._pending = []
            self._next = 0
            self._fill()
            return
        lib = get_lib()
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.fl_open(arr, len(self._paths), threads, queue_depth, scale)
        self._buf = np.empty(max_pixels, np.float32)

    def _fill(self):
        while len(self._pending) < self._depth and self._next < len(self._paths):
            self._pending.append(self._pool.submit(
                decode, self._paths[self._next], self._scale, self._max_pixels, "numpy"))
            self._next += 1

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._closed:
            raise StopIteration
        if self.backend == "numpy":
            if not self._pending:
                self.close()
                raise StopIteration
            fut = self._pending.pop(0)
            try:
                out = fut.result()
            except ValueError:
                self.close()
                raise
            self._fill()
            return out
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.fl_next(self._handle,
                               self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               self._max_pixels, ctypes.byref(h), ctypes.byref(w))
        if rc == -1:
            self.close()
            raise StopIteration
        if rc < 0:
            self.close()
            raise ValueError(f"native frame decode failed (rc={rc})")
        return self._buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self.backend == "numpy":
            for fut in self._pending:
                fut.cancel()
            self._pending = []
            self._pool.shutdown(wait=False)
        else:
            self._lib.fl_close(self._handle)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
