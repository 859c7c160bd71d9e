"""Build the port's CUDA sources into shared libraries and load them with
ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with `nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared` into
`_build/<hash>/lib<name>.so` inside the package, keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused within a checkout. No fast-math flag: the mLSTM normaliser amplifies
approximate exponentials. Several sources build at once, one nvcc process
each. A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


class CudaCompileError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise CudaCompileError("nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda")


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / f"lib{name}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all at once.

    Returns {name: {"path", "seconds", "log"}}; "log" holds nvcc's ptxas
    report (registers, shared memory, spills) for the sources built now.
    """
    started = {}
    report = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            report[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in started.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise CudaCompileError(f"nvcc timed out building {name}.cu")
        if proc.returncode != 0:
            raise CudaCompileError(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        report[name] = {"path": str(lib), "seconds": time.perf_counter() - t0,
                        "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _loaded:
        path = build([name])[name]["path"]
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
