"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, bound with
``ctypes``. Builds happen at first use, all sources at once (one ``nvcc``
process per source, started together), into ``_build/<hash>/`` beside this
file, where ``<hash>`` covers the sources and the flags, so an edited
source builds anew and an unchanged one is reused. ``-Xptxas -v``'s report
(registers, shared memory, spills) is kept next to each library.

Nothing here runs at import time: the CPU tests import every module on
machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

from .. import _hooks

__all__ = ["BuildInfo", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas: List[str]  # the -Xptxas -v report lines


_lock = threading.Lock()
_built: Dict[str, BuildInfo] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(log: str) -> List[str]:
    # "ptxas info" lines, and the unprefixed stack-frame/spill line after each entry
    return [ln.strip() for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]


def build_all() -> Dict[str, BuildInfo]:
    """Build every ``csrc/*.cu`` not built yet, in parallel; return the
    build record of each library."""
    with _lock:
        if _built:
            return dict(_built)
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        pending = {}
        for src in sorted(CSRC.glob("*.cu")):
            name = src.stem
            lib = out_dir / f"lib{name}.so"
            logf = out_dir / f"{name}.log"
            if lib.exists() and logf.exists():
                _built[name] = BuildInfo(name, lib, 0.0, _ptxas_lines(logf.read_text()))
                continue
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            _hooks.observe("build.compile", source=src.name)
            pending[name] = (proc, tmp, lib, logf, time.perf_counter())
        failures = []
        for name, (proc, tmp, lib, logf, t0) in pending.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, lib)  # atomic: another process never loads a half-written library
            logf.write_text(log)
            _built[name] = BuildInfo(name, lib, secs, _ptxas_lines(log))
        if failures:
            _built.clear()
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        return dict(_built)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds at first use)."""
    lib = _libs.get(name)
    if lib is None:
        info = build_all().get(name)
        if info is None:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        lib = _libs.setdefault(name, ctypes.CDLL(str(info.path)))
    return lib
