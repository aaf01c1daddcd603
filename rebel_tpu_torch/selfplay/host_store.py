"""The host-side archive of training examples, the counterpart of
``rebel_tpu/selfplay/host_store.py`` :class:`HostReplayStore`: an
unbounded store in host memory (``csrc/replay_store.cc``) with the
reference's binary dataset format, which the replay ring's
:func:`~rebel_tpu_torch.selfplay.replay.load_file` and
:func:`~rebel_tpu_torch.selfplay.replay.save` read and write too.  It
binds the same library as :mod:`rebel_tpu_torch.selfplay.refrng`
(:func:`~rebel_tpu_torch.selfplay.refrng.library`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from rebel_tpu_torch.selfplay import refrng

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = refrng.library()
        lib.replay_store_create.restype = ctypes.c_void_p
        lib.replay_store_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.replay_store_destroy.argtypes = [ctypes.c_void_p]
        lib.replay_store_size.restype = ctypes.c_int64
        lib.replay_store_size.argtypes = [ctypes.c_void_p]
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.replay_store_append.argtypes = [ctypes.c_void_p, f32p, f32p,
                                            ctypes.c_int64]
        lib.replay_store_read.restype = ctypes.c_int64
        lib.replay_store_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int64, f32p, f32p]
        lib.replay_store_save.restype = ctypes.c_int64
        lib.replay_store_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int64]
        lib.replay_store_load.restype = ctypes.c_int64
        lib.replay_store_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HostReplayStore:
    """Rows of ``query_size`` query and ``num_hands`` value floats,
    appended without bound."""

    def __init__(self, query_size: int, num_hands: int):
        self._lib = _load()
        self.query_size = query_size
        self.num_hands = num_hands
        self._h = self._lib.replay_store_create(query_size, num_hands)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.replay_store_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.replay_store_size(self._h))

    def append(self, queries, values) -> None:
        """Append rows (arrays or CPU tensors)."""
        q = np.ascontiguousarray(queries, np.float32)
        v = np.ascontiguousarray(values, np.float32)
        if q.shape[1] != self.query_size or v.shape[1] != self.num_hands \
                or q.shape[0] != v.shape[0]:
            raise ValueError(f"rows {q.shape} and {v.shape} do not fit a "
                             f"store of ({self.query_size}, "
                             f"{self.num_hands})")
        self._lib.replay_store_append(self._h, _fptr(q), _fptr(v), q.shape[0])

    def read(self, start: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Up to ``n`` rows from row ``start``."""
        q = np.empty((n, self.query_size), np.float32)
        v = np.empty((n, self.num_hands), np.float32)
        got = self._lib.replay_store_read(self._h, start, n, _fptr(q),
                                          _fptr(v))
        return q[:got], v[:got]

    def save(self, path, stride: int = 1) -> int:
        """Every ``stride``-th row to ``path``; returns the rows written."""
        n = self._lib.replay_store_save(self._h, str(path).encode(), stride)
        if n < 0:
            raise IOError(f"failed to save {path}")
        return int(n)

    def load(self, path, max_rows: int = 0, stride: int = 1) -> int:
        """Append every ``stride``-th row of ``path`` (at most
        ``max_rows``, 0: all); returns the rows read."""
        n = self._lib.replay_store_load(self._h, str(path).encode(),
                                        max_rows, stride)
        if n < 0:
            raise IOError(f"failed to load {path} (missing or wrong sizes)")
        return int(n)
