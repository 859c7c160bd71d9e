"""PyTorch port: the native NIfTI decoder (`csrc/nifti_loader.cc` through
`data/native.py`), built with g++ against zlib on first use.

- On synthetic BraTS subjects its volumes are those of the Python reader
  (`data/nifti.py::read_nifti`) and of the JAX package's own native decoder
  bit for bit, per file and per subject (one thread per modality file).
- Every voxel type the Python reader reads, gzipped or not, with and
  without a scale (a finite slope other than 0 and 1 scales, as the Python
  reader decides), bit for bit.
- `BraTSDataset(use_native=None)` resolves as the JAX dataset does: native
  when the host has more than one core.
- A source that does not build raises with g++'s output (the JAX dataset
  would fall back to the Python reader); a corrupt file raises IOError.
"""
import os
import struct

import numpy as np
import pytest

from xlstm_hved_tpu.data import brats as jbrats
from xlstm_hved_tpu.runtime import native_read_subject as jax_native_read_subject
from xlstm_hved_torch.data import brats as tbrats
from xlstm_hved_torch.data import native
from xlstm_hved_torch.data.nifti import read_nifti, write_nifti
from xlstm_hved_torch.data.synthetic import write_synthetic_dataset
from xlstm_hved_torch.utils import cuda_build

SUFFIXES = ("t1c", "t1n", "t2f", "t2w")


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (a.dtype, b.dtype,
                                                                     a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("native")), 2, (24, 20, 16),
                                   seed=4)


def test_subjects_decode_as_the_python_reader_and_jax_decode_them(subjects):
    for subject in ("SYN-0000", "SYN-0001"):
        got = native.native_read_subject(subjects, subject, SUFFIXES)
        assert got.shape == (4, 24, 20, 16)
        python = [read_nifti(os.path.join(subjects, subject, f"{subject}-{s}.nii.gz"))[0]
                  for s in SUFFIXES]
        _equal(got, np.stack(python))
        _equal(got, jax_native_read_subject(subjects, subject, SUFFIXES))
        for s in SUFFIXES + ("seg",):
            path = os.path.join(subjects, subject, f"{subject}-{s}.nii.gz")
            _equal(native.native_read_nifti(path), read_nifti(path)[0])


def _scaled(path, slope, inter):
    """Rewrite the header's scl_slope / scl_inter of an uncompressed file."""
    with open(path, "r+b") as f:
        f.seek(112)
        f.write(struct.pack("<2f", slope, inter))


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint16, np.int32,
                                   np.uint32, np.int64, np.uint64, np.float32, np.float64])
def test_every_voxel_type_and_scale_decodes_as_the_python_reader(tmp_path, dtype):
    rng = np.random.RandomState(3)
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    if info is None:
        data = (1e3 * rng.randn(7, 5, 3)).astype(dtype)
    else:   # the type's extremes and values between
        data = rng.randint(max(info.min, -2 ** 62), min(info.max, 2 ** 62), (7, 5, 3),
                           dtype=np.int64 if info.min < 0 else np.uint64).astype(dtype)
        data.flat[0], data.flat[1] = info.min, info.max
    for suffix in (".nii.gz", ".nii"):
        path = str(tmp_path / f"v{suffix}")
        write_nifti(path, data)
        _equal(native.native_read_nifti(path), read_nifti(path)[0])
    path = str(tmp_path / "v.nii")
    for slope, inter in ((0.37, -12.5), (0.0, 5.0), (1.0, 5.0), (float("nan"), 3.0)):
        _scaled(path, slope, inter)
        _equal(native.native_read_nifti(path), read_nifti(path)[0])


def test_use_native_resolves_as_the_jax_dataset(subjects, monkeypatch):
    for cores in (1, 8):
        monkeypatch.setattr(os, "cpu_count", lambda: cores)
        jds = jbrats.BraTSDataset(subjects)
        tds = tbrats.BraTSDataset(subjects)
        assert tds.use_native == jds.use_native == (cores > 1)
    for use_native in (True, False):
        assert tbrats.BraTSDataset(subjects, use_native=use_native).use_native == use_native


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / f"{native.SOURCE}.cc").write_text("int broken( {\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(cuda_build.CudaCompileError, match="error"):
        native.native_read_nifti(str(tmp_path / "any.nii.gz"))
    with pytest.raises(cuda_build.CudaCompileError):
        tbrats.BraTSDataset(str(tmp_path), use_native=True)


def test_a_corrupt_file_raises_ioerror(tmp_path):
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"\x1f\x8b not really gzip")
    with pytest.raises(IOError, match="failed"):
        native.native_read_nifti(str(bad))
    with pytest.raises(IOError):
        native.native_read_nifti(str(tmp_path / "missing.nii"))
