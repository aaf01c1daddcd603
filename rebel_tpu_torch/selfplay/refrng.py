"""The reference C++'s random stream: ``std::mt19937`` with libstdc++'s
distributions, as ``csrc/refrng.cc`` exposes them through a C interface.

The distributions are implementation-defined in C++, so the faithful way to
draw the reference's numbers is to call the real library.  The port's own
ctypes binding: :func:`library` loads the tracked ``csrc/librebel_host.so``,
or, where that file is absent, builds the same library from ``csrc/``
(``refrng.cc`` and ``replay_store.cc``) with ``g++`` into the git-ignored
``rebel_tpu_torch/_build/`` under a file lock (parallel test workers must
not load a half-written library).  It writes nothing into ``csrc/``.
:mod:`rebel_tpu_torch.selfplay.host_store` binds the same library.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC_LIB = _ROOT / "csrc" / "librebel_host.so"
SOURCE = _ROOT / "csrc" / "refrng.cc"
SOURCES = (SOURCE, _ROOT / "csrc" / "replay_store.cc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
BUILT_LIB = BUILD_DIR / "librebel_host.so"

_lib = None


def _build() -> pathlib.Path:
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "librebel_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not BUILT_LIB.exists():
                tmp = BUILT_LIB.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o",
                     str(tmp), *map(str, SOURCES)],
                    check=True, capture_output=True)
                os.replace(tmp, BUILT_LIB)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return BUILT_LIB


def library_path() -> pathlib.Path:
    """The library that is loaded: the tracked one, else the port's build."""
    return CSRC_LIB if CSRC_LIB.exists() else _build()


def library() -> ctypes.CDLL:
    """The library, loaded (built first where needed)."""
    return ctypes.CDLL(str(library_path()))


def _load():
    global _lib
    if _lib is None:
        lib = library()
        lib.refrng_create.restype = ctypes.c_void_p
        lib.refrng_create.argtypes = [ctypes.c_uint]
        lib.refrng_destroy.argtypes = [ctypes.c_void_p]
        lib.refrng_uniform_int.restype = ctypes.c_int
        lib.refrng_uniform_int.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
        lib.refrng_uniform_float.restype = ctypes.c_float
        lib.refrng_uniform_float.argtypes = [ctypes.c_void_p]
        lib.refrng_discrete.restype = ctypes.c_int
        lib.refrng_discrete.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_double),
                                        ctypes.c_int]
        lib.refrng_raw.restype = ctypes.c_uint
        lib.refrng_raw.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class ReferenceRng:
    """One ``std::mt19937`` seeded with ``seed`` and the draws the
    reference's self-play makes from it."""

    def __init__(self, seed: int):
        self._lib = _load()
        self._h = self._lib.refrng_create(seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.refrng_destroy(self._h)
            self._h = None

    def uniform_int(self, lo: int, hi: int) -> int:
        """``uniform_int_distribution<>(lo, hi)``, both bounds included."""
        return int(self._lib.refrng_uniform_int(self._h, lo, hi))

    def uniform_float(self) -> float:
        """``uniform_real_distribution<float>(0, 1)``."""
        return float(self._lib.refrng_uniform_float(self._h))

    def discrete(self, weights) -> int:
        """``discrete_distribution<>`` over ``weights``."""
        w = np.ascontiguousarray(weights, np.float64)
        return int(self._lib.refrng_discrete(
            self._h, w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            w.size))

    def raw(self) -> int:
        """The engine's next raw 32-bit output."""
        return int(self._lib.refrng_raw(self._h))
