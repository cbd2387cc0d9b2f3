"""Build and bind the package's hand-written CUDA kernels.

Every source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers: ``nvcc`` then takes seconds, not minutes).
Libraries go to ``build/torch_kernels/`` at the root of the checkout,
named by a hash of their source and of the headers (``csrc/*.cuh``) the
sources share, so an edited source or header is rebuilt and an unchanged
one is reused within a checkout.  Nothing is built or imported
when this module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per source: seconds the build took and nvcc's -Xptxas -v report
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels are "
        "built from source at first use"
    )


def _so_path(src: str) -> str:
    headers = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    )
    sha = hashlib.sha1()
    for path in [src, *headers]:
        with open(path, "rb") as fh:
            sha.update(fh.read())
    digest = sha.hexdigest()[:12]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start_build(src: str, so: str, defines=()) -> subprocess.Popen:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src,
        *(f"-D{d}" for d in defines),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.pt_cmd = cmd  # type: ignore[attr-defined]
    proc.pt_tmp = tmp  # type: ignore[attr-defined]
    return proc


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Build every kernel source (or those named, e.g. ``["lane2_join"]``)
    that is not built yet: one ``nvcc`` per source, all started together.
    Returns seconds per source built (0.0 when already built)."""
    srcs = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )
    if names is not None:
        srcs = [s for s in srcs if os.path.basename(s)[:-3] in names]
    with _lock:
        t0 = time.monotonic()
        procs = {}
        for src in srcs:
            so = _so_path(src)
            if not os.path.exists(so):
                procs[src] = (_start_build(src, so), so)
        times = {os.path.basename(s)[:-3]: 0.0 for s in srcs}
        errors = []
        for src, (proc, so) in procs.items():
            out, _ = proc.communicate()
            name = os.path.basename(src)[:-3]
            times[name] = time.monotonic() - t0
            BUILD_LOG[name] = {"seconds": times[name], "nvcc": out}
            if proc.returncode != 0:
                errors.append(
                    f"{' '.join(proc.pt_cmd)} failed:\n{out}"
                )
            else:
                os.replace(proc.pt_tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        return times


def build_profiled(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with ``-DPT_PROFILE`` (phase timers in the
    kernel and a ``pt_profile_read`` entry point), beside the plain
    build; for measurement scripts, on no path of the package."""
    src = os.path.join(CSRC, name + ".cu")
    so = _so_path(src)[:-3] + "_profile.so"
    if not os.path.exists(so):
        proc = _start_build(src, so, defines=["PT_PROFILE"])
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(proc.pt_cmd)} failed:\n{out}")
        os.replace(proc.pt_tmp, so)
    return ctypes.CDLL(so)


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC, name + ".cu")
    so = _so_path(src)
    if not os.path.exists(so):
        build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(so)
            _libs[name] = lib
    return lib
