"""ctypes binding to the native stream IO engine (``native/scio.cc``).

Counterpart of ``singlecarrier_tpu/runtime/engine.py``: the same
``extern "C"`` entry points with the same argument types, and the same
contracts of ``deinterleave``, ``interleave``, ``FrameRing`` and
``PcmFile`` (zero padding past EOF included).  The engine does the
host-side work the reference did with a single-channel fread loop
(reference: src/qpsk.c:436-458): multi-channel deinterleaving, frame
assembly (a lock-free SPSC ring) and mmap'd PCM file access, so Python
only moves ready [n_channels, frame_size] blocks to the device.

The library is this package's own build of the repository's
``native/scio.cc``, compiled with ``native/Makefile``'s flags into
``build/torch_native/libscio.so`` of the checkout at first use.  Two
processes (or threads) that load it at once build it once: the build
holds an ``fcntl`` lock on a file beside the library, compiles to a
temporary file named by process and thread and renames it into place.
Nothing is written under ``native/``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "scio.cc"
BUILD_DIR = _ROOT / "build" / "torch_native"
# native/Makefile's CXXFLAGS (tests/test_torch_ingest.py holds them equal)
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_lib_guard = threading.Lock()


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``libscio.so`` into ``build_dir`` unless it is there;
    return its path.  Raises ``RuntimeError`` if the compiler fails."""
    build_dir = Path(build_dir)
    lib_path = build_dir / "libscio.so"
    if lib_path.exists():
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "libscio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if lib_path.exists():               # another process built it
            return lib_path
        tmp = build_dir / f"libscio.{os.getpid()}.{threading.get_ident()}.tmp"
        cxx = os.environ.get("CXX", "g++")
        res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on {SOURCE} "
                               f"({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Load (building if needed) libscio and type its entry points."""
    global _lib
    with _lib_guard:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.scio_deinterleave.argtypes = [i16p, i16p, ctypes.c_long,
                                          ctypes.c_long]
        lib.scio_deinterleave.restype = None
        lib.scio_interleave.argtypes = [i16p, i16p, ctypes.c_long,
                                        ctypes.c_long]
        lib.scio_interleave.restype = None
        lib.scio_ring_create.restype = ctypes.c_void_p
        lib.scio_ring_create.argtypes = [ctypes.c_long] * 3
        lib.scio_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.scio_ring_destroy.restype = None
        lib.scio_ring_blocks_ready.argtypes = [ctypes.c_void_p]
        lib.scio_ring_blocks_ready.restype = ctypes.c_long
        lib.scio_ring_push_interleaved.argtypes = [ctypes.c_void_p, i16p,
                                                   ctypes.c_long]
        lib.scio_ring_push_interleaved.restype = ctypes.c_long
        lib.scio_ring_pop_block.argtypes = [ctypes.c_void_p, i16p]
        lib.scio_ring_pop_block.restype = ctypes.c_int
        lib.scio_file_open.restype = ctypes.c_void_p
        lib.scio_file_open.argtypes = [ctypes.c_char_p]
        lib.scio_file_samples.argtypes = [ctypes.c_void_p]
        lib.scio_file_samples.restype = ctypes.c_long
        lib.scio_file_read.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                       ctypes.c_long, i16p]
        lib.scio_file_read.restype = ctypes.c_long
        lib.scio_file_close.argtypes = [ctypes.c_void_p]
        lib.scio_file_close.restype = None
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    """The int16 pointer of a C-contiguous int16 array (a pinned
    tensor's ``.numpy()`` view included)."""
    if a.dtype != np.int16 or not a.flags.c_contiguous:
        raise ValueError("the engine takes C-contiguous int16 buffers")
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def deinterleave(data: np.ndarray, n_channels: int,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """[n_samples*n_channels] interleaved -> [n_channels, n_samples]
    (into ``out`` if given)."""
    lib = load_library()
    data = np.ascontiguousarray(data, np.int16)
    n_samples = data.size // n_channels
    if out is None:
        out = np.empty((n_channels, n_samples), np.int16)
    elif out.size != n_channels * n_samples:
        raise ValueError(f"out holds {out.size} samples, expected "
                         f"{n_channels * n_samples}")
    lib.scio_deinterleave(_ptr(data), _ptr(out), n_samples, n_channels)
    return out


def interleave(chans: np.ndarray) -> np.ndarray:
    """[n_channels, n_samples] -> interleaved [n_samples*n_channels]."""
    lib = load_library()
    chans = np.ascontiguousarray(chans, np.int16)
    n_channels, n_samples = chans.shape
    out = np.empty(n_samples * n_channels, np.int16)
    lib.scio_interleave(_ptr(chans), _ptr(out), n_samples, n_channels)
    return out


class FrameRing:
    """Lock-free SPSC ring of [n_channels, frame_size] blocks."""

    def __init__(self, n_channels: int, frame_size: int,
                 capacity_blocks: int = 8):
        self._lib = load_library()
        self.n_channels = n_channels
        self.frame_size = frame_size
        self._ring = self._lib.scio_ring_create(
            n_channels, frame_size, capacity_blocks)

    def push(self, interleaved: np.ndarray) -> int:
        """Push [n_samples, n_channels] interleaved int16; returns
        samples consumed."""
        data = np.ascontiguousarray(interleaved, np.int16)
        n_samples = data.size // self.n_channels
        return self._lib.scio_ring_push_interleaved(
            self._ring, _ptr(data), n_samples)

    @property
    def blocks_ready(self) -> int:
        return self._lib.scio_ring_blocks_ready(self._ring)

    def pop(self, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """The next block (into ``out`` if given), or None if none is
        complete."""
        if out is None:
            out = np.empty((self.n_channels, self.frame_size), np.int16)
        elif out.size != self.n_channels * self.frame_size:
            raise ValueError(f"out holds {out.size} samples, expected "
                             f"{self.n_channels * self.frame_size}")
        if self._lib.scio_ring_pop_block(self._ring, _ptr(out)):
            return out
        return None

    def close(self) -> None:
        if self._ring:
            self._lib.scio_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PcmFile:
    """mmap-backed int16 PCM file (zero-padded reads past EOF)."""

    def __init__(self, path: str):
        self._lib = load_library()
        self._f = self._lib.scio_file_open(os.fsencode(path))
        if not self._f:
            raise FileNotFoundError(path)

    @property
    def n_samples(self) -> int:
        return self._lib.scio_file_samples(self._f)

    def read(self, offset: int, count: int,
             out: Optional[np.ndarray] = None) -> np.ndarray:
        """``count`` samples from ``offset`` (into ``out`` if given)."""
        if out is None:
            out = np.empty(count, np.int16)
        elif out.size != count:
            raise ValueError(f"out holds {out.size} samples, expected "
                             f"{count}")
        self._lib.scio_file_read(self._f, offset, count, _ptr(out))
        return out

    def close(self) -> None:
        if self._f:
            self._lib.scio_file_close(self._f)
            self._f = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
