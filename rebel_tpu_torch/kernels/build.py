"""Build the port's CUDA kernels on first use and load them with ctypes.

Each kernel is one ``.cu`` file beside this module with a plain C
interface.  ``load(name)`` compiles it with ``nvcc`` for ``sm_90a`` into
``rebel_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
the source and flags, and loads the shared library; ``defines`` adds a
``-D`` for each (``mlp_breakdown``'s variants).  A source listed in
:data:`UNITS` is compiled in that many units side by side, one ``nvcc``
each with ``-DGRID2_UNIT=u`` (each unit holds one of its kernels'
instantiations); the objects are linked into the one library.  A build
for a few launches only (``units``: ``mlp_breakdown``'s variants) compiles
the other units as stubs (``-DGRID2_STUB``) whose launches fail.
``load_checked(name)`` builds and loads the index-checked build
(:data:`CHECK_INDEX`: every index into a part of the workspace or of
shared memory checked, a trap where one leaves it) of the units
:data:`CHECKED_UNITS`, into ``_build/checked/``, only when asked:
nothing on the main path loads it.  A plain C interface
keeps PyTorch's headers out of the compile: it takes seconds where a
``torch.utils.cpp_extension`` build takes minutes.  Nothing is compiled
when this module is imported, and a missing ``nvcc`` or a failed compile
raises: there is no fallback.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

KERNEL_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parent / "_build"
# No --use_fast_math: it changes division, exp and rsqrt and flushes
# denormals, and the kernels are held to their plain versions at f32
# rounding (the limits are in chip_smoke.py).
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# Sources compiled in units side by side: grid2_cfr.cu's twenty-two
# instantiations, one a unit (the last four the wide units, nets of width
# 257-512).  At most one nvcc a CPU core runs at a time, across the builds
# of all threads (mlp_breakdown builds its variants side by side).
UNITS = {"grid2_cfr": 22}
_NVCC_SLOTS = threading.BoundedSemaphore(os.cpu_count() or 8)

# The index-checked build's define, and the units of grid2_cfr.cu it
# compiles in full: the workspace instantiations (kinds 3-5); the others
# are stubs.
CHECK_INDEX = "GRID2_CHECK_INDEX"
CHECKED_UNITS = tuple(range(9, 18))

_loaded: dict[str, ctypes.CDLL] = {}
# Seconds each build took to compile in this process (0.0: found built),
# by name and defines ("grid2_cfr", "grid2_cfr BREAKDOWN=2").
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
        )
    return found


def flags(defines: tuple[str, ...] = ()) -> list[str]:
    """``NVCC_FLAGS`` and a ``-D`` for each of ``defines``."""
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def library_path(name: str, defines: tuple[str, ...] = (),
                 units: tuple[int, ...] | None = None) -> pathlib.Path:
    src = (KERNEL_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + " ".join(flags(defines)).encode()
        + f" units={UNITS.get(name, 1)}".encode()
        + (b"" if units is None else f" only={sorted(units)}".encode())
    ).hexdigest()
    where = BUILD_DIR / "checked" if CHECK_INDEX in defines else BUILD_DIR
    return where / f"lib{name}-{digest[:16]}.so"


def build(name: str, defines: tuple[str, ...] = (),
          units: tuple[int, ...] | None = None) -> pathlib.Path:
    """Compile ``kernels/<name>.cu`` with ``defines`` unless a build of
    this exact source and these flags exists; returns the library path.
    ``units``: of a source in :data:`UNITS`, the units to compile in full
    (None: all); the others are stubs whose launches fail.  The compiler's
    output (register and shared-memory use per kernel) is kept beside it
    as ``.log``."""
    so = library_path(name, defines, units)
    key = " ".join((name, *defines))
    if so.exists():
        build_seconds.setdefault(key, 0.0)
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    src = str(KERNEL_DIR / f"{name}.cu")
    nvcc = nvcc_path()
    stub = lambda u: [] if units is None or u in units else ["-DGRID2_STUB"]
    unit_flags = [[f"-DGRID2_UNIT={u}", *stub(u)] for u in range(UNITS[name])] \
        if name in UNITS else [[]]
    objs = [str(so.with_suffix(f".{os.getpid()}.u{u}.o"))
            for u in range(len(unit_flags))]
    compile_flags = [f for f in flags(defines) if f != "-shared"]

    def compile_unit(unit, obj):
        with _NVCC_SLOTS:
            return subprocess.run(
                [nvcc, *compile_flags, *unit, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(unit_flags)) as pool:
        procs = list(pool.map(compile_unit, unit_flags, objs))
    out = "".join(proc.stdout for proc in procs)
    rc = max(proc.returncode for proc in procs)
    if rc == 0:
        link = subprocess.run([nvcc, *flags(defines), "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        out += link.stdout + link.stderr
        rc = link.returncode
    for obj in objs:
        pathlib.Path(obj).unlink(missing_ok=True)
    build_seconds[key] = time.perf_counter() - t0
    so.with_suffix(".log").write_text(out)
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu with {list(defines)}:\n{out}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def load_checked(name: str) -> ctypes.CDLL:
    """The index-checked build of ``name`` (:data:`CHECK_INDEX`, the units
    :data:`CHECKED_UNITS`), built on first use into ``_build/checked/``."""
    key = f"{name} {CHECK_INDEX}"
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, (CHECK_INDEX,), CHECKED_UNITS)))
        _loaded[key] = lib
    return lib


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""
