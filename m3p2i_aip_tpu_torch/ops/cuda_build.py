"""Builds and loads the port's CUDA kernels (``csrc/*.cu``).

All kernels go into ONE shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``: one ``nvcc``
per source, all started together, then one link.  The library is cached in
``m3p2i_aip_tpu_torch/_build/`` under a name derived from the sources, the
shared headers and the flags, so an edited source rebuilds; concurrent
processes build it once, under a file lock.  Importing this module compiles
nothing.

``--use_fast_math`` is deliberately absent: the beta search and the contact
gates branch on values that approximate ``expf``/``sqrtf``/division can push
across a threshold.  ``-fmad=false`` keeps the kernels' floating point
close to the plain PyTorch versions, whose element-wise kernels never fuse a
multiply into an add.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from m3p2i_aip_tpu_torch.utils import profiling

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("point_rollout.cu", "multimodal_weights.cu", "panda_rollout.cu", "albert_rollout.cu", "point_step.cu",
           "panda_step.cu")
HEADERS = ("pbd2d.cuh", "panda_fk.cuh", "team.cuh")  # device code shared by the sources
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# filled by the first load: seconds spent building or loading (the
# ``kernels.load`` span), the library path, and nvcc's output (ptxas
# registers / spills per kernel, kept beside the library and read back when
# it is cached)
build_info: dict = {}

_lock = threading.Lock()
_lib = None

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one entry point per kernel; each takes the seed count B (a single rollout
# or weight update is a launch with B = 1); and the weights kernel's once-a-
# device opt-in to its shared memory
_SIGNATURES = {
    "m3p2i_multimodal_weights": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _VP],
    "m3p2i_multimodal_weights_prepare": [],
    "m3p2i_point_rollout": [_VP] * 7 + [_I] * 16 + [_VP],
    "m3p2i_panda_rollout": [_VP] * 6 + [_I] * 10 + [_VP],
    "m3p2i_albert_rollout": [_VP] * 6 + [_I] * 6 + [_VP],
    "m3p2i_point_step": [_VP] * 4 + [_I] * 10 + [_VP],
    "m3p2i_panda_step": [_VP] * 4 + [_I] * 6 + [_VP],
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libm3p2i_kernels_{h.hexdigest()[:16]}.so"


def _build(target: pathlib.Path) -> None:
    nvcc = _nvcc()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{pathlib.Path(s).stem}.o") for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(link.stdout)
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    if link is None or link.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use (a ``kernels.load`` span)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with profiling.span("kernels.load"):
            target = _library_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "build.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)  # released on close or exit
                if not target.exists():
                    _build(target)
            log = target.with_suffix(".log")
            build_info["log"] = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        t0, t1 = profiling.last_span("kernels.load")
        build_info["seconds"] = (t1 - t0) / 1e9
        build_info["path"] = str(target)
        _lib = lib
        return _lib
