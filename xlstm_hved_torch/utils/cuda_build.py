"""Build the port's native sources into shared libraries and load them with
ctypes: the CUDA kernels and the host C++ NIfTI decoder.

Each `csrc/<name>.cu` or `csrc/<name>.cc` exposes a plain C interface and is
compiled on first use into `_build/<hash>/lib<name>.so` inside the package,
keyed by a hash of the source, the headers beside it (`csrc/*.cuh`) and the
command's flags, so an edited source or header rebuilds and an unchanged one
is reused within a checkout:
- `.cu` with `nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared`. No
  fast-math flag: the mLSTM normaliser amplifies approximate exponentials.
- `.cc` with `g++ -O3 -fPIC -shared -std=c++17 ... -lz -lpthread`, for the
  baseline x86-64 instruction set (no -march=native: a library built on one
  host may be carried to another in `_build/`).
Several sources build at once, one compiler process each. A failed build
raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
GXX_LIBS = ("-lz", "-lpthread")
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


class CudaCompileError(RuntimeError):
    """A native source did not build (nvcc or g++ failed or is missing)."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise CudaCompileError("nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda")


def _source(name: str) -> Path:
    for suffix in (".cu", ".cc"):
        path = CSRC_DIR / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def _flags(source: Path) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(flags before the output and source, libraries after them)."""
    return (NVCC_FLAGS, ()) if source.suffix == ".cu" else (GXX_FLAGS, GXX_LIBS)


def _command(source: Path, out: Path) -> List[str]:
    flags, libs = _flags(source)
    if source.suffix == ".cu":
        compiler = nvcc_path()
    else:
        compiler = shutil.which("g++")
        if compiler is None:
            raise CudaCompileError("g++ not found on PATH")
    return [compiler, *flags, "-o", str(out), str(source), *libs]


def library_path(name: str) -> Path:
    source = _source(name)
    flags, libs = _flags(source)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(flags + libs).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / f"lib{name}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all at once.

    Returns {name: {"path", "seconds", "log"}}; "log" holds the compiler's
    output (for the CUDA sources, ptxas's registers, shared memory and
    spills) for the sources built now.
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
        proc = subprocess.Popen(_command(_source(name), tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in started.items():
        source = _source(name).name
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise CudaCompileError(f"the compiler timed out building {source}")
        if proc.returncode != 0:
            raise CudaCompileError(
                f"the compiler failed on {source} (rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        report[name] = {"path": str(lib), "seconds": time.perf_counter() - t0,
                        "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` or `.cc`, built first if
    needed."""
    if name not in _loaded:
        path = build([name])[name]["path"]
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
