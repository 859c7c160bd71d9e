"""ctypes binding of the port's native NIfTI decoder (`csrc/nifti_loader.cc`,
the port's copy of the JAX package's `runtime/`), with the JAX binding's
functions and argument types.

The library is built on first use with g++ against zlib into
`xlstm_hved_torch/_build/<hash>/` (`utils/cuda_build.py`); a failed build
raises with g++'s output. The JAX binding instead reports the decoder
unavailable and its dataset falls back to the Python reader; the port has
no fallback, so a missing compiler or zlib shows where it happens.
`native_read_subject` decodes a subject's modality files on one thread
each; the voxels are those of `data/nifti.py::read_nifti`, bit for bit.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import numpy as np

from xlstm_hved_torch.utils import cuda_build

SOURCE = "nifti_loader"
_SHAPE = ctypes.c_int64 * 8
_FLOATS = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.nifti_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.nifti_read_f32.argtypes = [ctypes.c_char_p, _FLOATS, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.nifti_read_subject_f32.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                           _FLOATS, ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_int64)]
    for fn in (lib.nifti_probe, lib.nifti_read_f32, lib.nifti_read_subject_f32):
        fn.restype = ctypes.c_int
    return lib


def _shape_from(arr) -> Tuple[int, ...]:
    return tuple(int(arr[i + 1]) for i in range(int(arr[0])))


def _probe(lib, path: str) -> Tuple[int, ...]:
    shape_out = _SHAPE()
    rc = lib.nifti_probe(path.encode(), shape_out)
    if rc != 0:
        raise IOError(f"nifti_probe({path}) failed rc={rc}")
    return _shape_from(shape_out)


def native_read_nifti(path: str) -> np.ndarray:
    """Decode one NIfTI file to fp32, in the file's (i, j, k) axis order as
    the Python reader gives it."""
    lib = _lib()
    shape = _probe(lib, path)
    out = np.empty(int(np.prod(shape)), np.float32)
    rc = lib.nifti_read_f32(path.encode(), out.ctypes.data_as(_FLOATS), out.size, _SHAPE())
    if rc != 0:
        raise IOError(f"nifti_read_f32({path}) failed rc={rc}")
    return out.reshape(shape, order="F")


def native_read_subject(data_dir: str, subject: str,
                        suffixes: Sequence[str] = ("t1c", "t1n", "t2f", "t2w")) -> np.ndarray:
    """Decode the modality files of one subject
    (<dir>/<subject>/<subject>-<suffix>.nii.gz, or .nii), one thread each,
    into (M, ...) fp32. All must share the first file's shape."""
    lib = _lib()
    first = os.path.join(data_dir, subject, f"{subject}-{suffixes[0]}.nii.gz")
    if not os.path.exists(first):
        first = first[:-3]
    vol_shape = _probe(lib, first)
    count = int(np.prod(vol_shape))
    out = np.empty(len(suffixes) * count, np.float32)
    rc = lib.nifti_read_subject_f32(data_dir.encode(), subject.encode(),
                                    ",".join(suffixes).encode(), out.ctypes.data_as(_FLOATS),
                                    out.size, _SHAPE())
    if rc != 0:
        raise IOError(f"nifti_read_subject_f32({subject}) failed rc={rc}")
    # each modality's block is one Fortran-ordered volume
    return np.stack([out[m * count:(m + 1) * count].reshape(vol_shape, order="F")
                     for m in range(len(suffixes))], axis=0)
