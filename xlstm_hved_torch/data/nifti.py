"""Minimal pure-numpy NIfTI-1 reader/writer (.nii / .nii.gz), the port's
own copy of `xlstm_hved_tpu/data/nifti.py`.

Covers the subset of NIfTI-1 that BraTS files use: single-file (.nii) magic
'n+1', scalar datatypes, optional scl_slope/inter scaling, Fortran-ordered
voxels. The native decoder (`data/native.py`) returns the same voxels for
the modality files; the datasets read the seg files, and the modality files
when asked, through this module.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

HEADER_SIZE = 348

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_nifti(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (data, affine). Data axes follow the file's (i, j, k) order
    like nibabel's get_fdata()."""
    raw = _read_bytes(path)
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != HEADER_SIZE:
        # try big-endian
        if struct.unpack_from(">i", raw, 0)[0] == HEADER_SIZE:
            return _read_impl(raw, ">", path, dtype)
        raise ValueError(f"{path}: bad sizeof_hdr {sizeof_hdr}")
    return _read_impl(raw, "<", path, dtype)


def _read_impl(raw: bytes, bo: str, path: str, dtype) -> Tuple[np.ndarray, np.ndarray]:
    dim = struct.unpack_from(f"{bo}8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1: 1 + max(ndim, 1)])
    datatype = struct.unpack_from(f"{bo}h", raw, 70)[0]
    vox_offset = int(struct.unpack_from(f"{bo}f", raw, 108)[0])
    scl_slope = struct.unpack_from(f"{bo}f", raw, 112)[0]
    scl_inter = struct.unpack_from(f"{bo}f", raw, 116)[0]
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad magic {magic!r}")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype code {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count,
                         offset=max(vox_offset, HEADER_SIZE + 4))
    data = data.reshape(shape, order="F").astype(dtype)
    if scl_slope not in (0.0, 1.0) and np.isfinite(scl_slope):
        data = data * scl_slope + scl_inter

    srow = np.zeros((4, 4), np.float64)
    srow[0] = struct.unpack_from(f"{bo}4f", raw, 280)
    srow[1] = struct.unpack_from(f"{bo}4f", raw, 296)
    srow[2] = struct.unpack_from(f"{bo}4f", raw, 312)
    srow[3] = [0, 0, 0, 1]
    return data, srow


def write_nifti(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> None:
    """Write a single-file NIfTI-1 volume (label maps, recon export)."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    code = _DTYPE_CODES.get(np.dtype(data.dtype))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    hdr = bytearray(HEADER_SIZE + 4)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)  # pixdim
    struct.pack_into("<f", hdr, 108, HEADER_SIZE + 4)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 252, 1)  # sform_code
    if affine is None:
        affine = np.eye(4)
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    if path.endswith(".gz"):
        # mtime=0 + no embedded filename so regenerating identical volumes
        # is byte-deterministic (gzip otherwise stamps the current time into
        # header bytes 4-7, making every regeneration a spurious diff).
        with open(path, "wb") as raw:
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0,
                               compresslevel=4) as f:
                f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def load_subject(data_dir: str, subject: str,
                 suffixes=("t1c", "t1n", "t2f", "t2w"),
                 seg_suffix: str = "seg") -> Tuple[np.ndarray, np.ndarray]:
    """BraTS2024 layout: <dir>/<subject>/<subject>-<suffix>.nii.gz (or
    .nii). Returns (image (4, ...), seg (...))."""
    mods = []
    for suffix in suffixes:
        p = os.path.join(data_dir, subject, f"{subject}-{suffix}.nii.gz")
        if not os.path.exists(p):
            p = p[:-3]  # allow uncompressed
        arr, _ = read_nifti(p)
        mods.append(arr)
    p = os.path.join(data_dir, subject, f"{subject}-{seg_suffix}.nii.gz")
    if not os.path.exists(p):
        p = p[:-3]
    seg, _ = read_nifti(p)
    return np.stack(mods, axis=0), seg
