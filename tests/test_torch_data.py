"""PyTorch port: the data layer against the JAX package. The port keeps its own
copies of the numpy modules (NIfTI, synthetic data, host transforms, SDM,
datasets), so the same files, seeds and `RandomState`s must give bitwise the
same arrays; the torch device transforms are held to JAX's eval transform
bitwise and to the train-time augmentation's semantics (its draws come from
a torch.Generator, not a PRNG key)."""
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_hved_tpu.data import brats as jbrats
from xlstm_hved_tpu.data import nifti as jnifti
from xlstm_hved_tpu.data import sdm as jsdm
from xlstm_hved_tpu.data import synthetic as jsyn
from xlstm_hved_tpu.data import transforms as jtf
from xlstm_hved_torch.data import brats as tbrats
from xlstm_hved_torch.data import nifti as tnifti
from xlstm_hved_torch.data import sdm as tsdm
from xlstm_hved_torch.data import synthetic as tsyn
from xlstm_hved_torch.data import transforms as ttf


def _equal(a, b):
    """Bitwise equal, dtype and shape included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _equal_items(a, b):
    assert (a is None) == (b is None)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _equal(x, y)


@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
def test_nifti_written_by_each_package_reads_in_the_other(tmp_path, suffix):
    rng = np.random.RandomState(0)
    affine = np.diag([1.5, 2.0, 0.5, 1.0])
    for dtype in (np.float32, np.int16, np.uint8, np.float64):
        vol = (rng.rand(7, 9, 5) * 100).astype(dtype)
        name = f"v_{dtype.__name__}{suffix}"   # gzip stores the file name
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "t").mkdir(exist_ok=True)
        pj, pt = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
        jnifti.write_nifti(pj, vol, affine)
        tnifti.write_nifti(pt, vol, affine)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        for reader, path in ((tnifti.read_nifti, pj), (jnifti.read_nifti, pt)):
            data, aff = reader(path)
            _equal(data, jnifti.read_nifti(pj)[0])
            _equal(aff, jnifti.read_nifti(pj)[1])
            np.testing.assert_array_equal(data, vol.astype(np.float32))


def test_synthetic_subjects_and_files_match_jax(tmp_path):
    for seed in (0, 5):
        a = jsyn.synthetic_subject(np.random.RandomState(seed), (20, 24, 16))
        b = tsyn.synthetic_subject(np.random.RandomState(seed), (20, 24, 16))
        _equal_items(a, b)
    jroot = jsyn.write_synthetic_dataset(str(tmp_path / "j"), 2, (12, 10, 8), seed=3)
    troot = tsyn.write_synthetic_dataset(str(tmp_path / "t"), 2, (12, 10, 8), seed=3)
    files = sorted(p.relative_to(jroot) for p in (tmp_path / "j").rglob("*.nii.gz"))
    assert len(files) == 10
    assert files == sorted(p.relative_to(troot) for p in (tmp_path / "t").rglob("*.nii.gz"))
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes()


@pytest.fixture(scope="module")
def brats_dir(tmp_path_factory):
    return jsyn.write_synthetic_dataset(str(tmp_path_factory.mktemp("brats")), 4,
                                        (16, 20, 12), seed=1)


@pytest.mark.parametrize("m_full", [True, False])
def test_brats_dataset_items_and_keep_draws_match_jax(brats_dir, m_full):
    jds = jbrats.BraTSDataset(brats_dir, m_full=m_full, seed=7)
    tds = tbrats.BraTSDataset(brats_dir, m_full=m_full, seed=7)
    assert tds.subjects == jds.subjects and len(tds) == 4
    for i in (0, 3, 1, 1, 2):
        _equal_items(tds.load(i), jds.load(i))
    for _ in range(64):
        _equal(tds.sample_keep(), jds.sample_keep())


def test_brats_dataset_refuses_native_and_skips_corrupt(brats_dir, tmp_path):
    """The native decoder gives the Python reader's items bit for bit; a
    corrupt subject is skipped with either reader."""
    native = tbrats.BraTSDataset(brats_dir, m_full=True, seed=7, use_native=True)
    python = tbrats.BraTSDataset(brats_dir, m_full=True, seed=7, use_native=False)
    assert native.use_native and not python.use_native
    for i in (0, 3):
        _equal_items(native.load(i), python.load(i))
    bad = tmp_path / "bad" / "SYN-0000"
    bad.mkdir(parents=True)
    for suffix in ("t1c", "t1n", "t2f", "t2w", "seg"):
        (bad / f"SYN-0000-{suffix}.nii.gz").write_bytes(b"not a gzip file")
    for use_native in (True, False):
        assert tbrats.BraTSDataset(str(tmp_path / "bad"), use_native=use_native).load(0) is None


@pytest.mark.parametrize("shuffle,shard", [(True, None), (True, (0, 2)), (True, (1, 2)),
                                           (False, None)])
def test_prefetch_loader_order_and_shard_match_jax(brats_dir, shuffle, shard):
    def run(mod):
        ds = mod.BraTSDataset(brats_dir, m_full=True, seed=2)
        return list(mod.prefetch_loader(ds, batch_size=1, shuffle=shuffle, seed=3,
                                        shard=shard))

    got, want = run(tbrats), run(jbrats)
    assert len(got) == len(want) == (4 if shard is None else 2)
    for a, b in zip(got, want):
        _equal_items(a[0], b[0])


def test_prefetch_loader_raises_what_the_loader_thread_raised():
    class Broken:
        def __len__(self):
            return 3

        def load(self, index):
            if index == 1:
                raise KeyError("missing volume")
            return index

    with pytest.raises(KeyError, match="missing volume"):
        list(tbrats.prefetch_loader(Broken(), shuffle=False))


def _volume(seed, shape=(20, 24, 22)):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*shape, 4) * 255).astype(np.float32)
    img[:3] = 0.0   # a background slab, as brain volumes have
    return img, rng.randint(0, 5, shape).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_transforms_match_jax(seed):
    img, lab = _volume(seed)
    for kw in ({}, {"shift": 0.0}, {"flip_prob": 0.0, "normalize": False}):
        _equal_items(ttf.host_augment(np.random.RandomState(seed + 10), img, lab, (16, 16, 16), **kw),
                     jtf.host_augment(np.random.RandomState(seed + 10), img, lab, (16, 16, 16), **kw))
    _equal_items(ttf.host_eval_transform(img, lab, crop=(16, 12, 16)),
                 jtf.host_eval_transform(img, lab, crop=(16, 12, 16)))
    chw = np.moveaxis(img, -1, 0)
    _equal(ttf.host_zscore_nonzero(chw), jtf.host_zscore_nonzero(chw))
    _equal(ttf.host_zscore_ref(chw), jtf.host_zscore_ref(chw))
    _equal(ttf.background_info(chw, (16, 16, 16)), jtf.background_info(chw, (16, 16, 16)))
    _equal_items(ttf.extract_brain(chw, lab, 12), jtf.extract_brain(chw, lab, 12))
    for name in ("host_random_rotate90", "host_random_scale", "host_random_rotate"):
        _equal_items(getattr(ttf, name)(np.random.RandomState(seed), chw, lab),
                     getattr(jtf, name)(np.random.RandomState(seed), chw, lab))
    _equal(ttf.host_add_gaussian_noise(np.random.RandomState(seed), chw),
           jtf.host_add_gaussian_noise(np.random.RandomState(seed), chw))


def test_device_eval_transform_and_seg_to_mask_match_jax():
    img, lab = _volume(3)
    for crop in ((16, 16, 16), None):
        x, m = ttf.device_eval_transform(torch.from_numpy(img), torch.from_numpy(lab), crop=crop)
        jx, jmask = jtf.device_eval_transform(jnp.asarray(img), jnp.asarray(lab), crop=crop)
        _equal(np.moveaxis(x.numpy(), 0, -1), np.asarray(jx))
        _equal(np.moveaxis(m.numpy(), 0, -1), np.asarray(jmask))
    batch = torch.from_numpy(np.stack([lab, lab[::-1].copy()]))
    _equal(np.moveaxis(ttf.seg_to_mask(batch).numpy(), 1, -1),
           np.asarray(jtf.seg_to_mask(jnp.asarray(batch.numpy()))))


def test_device_augment_semantics():
    """Shapes, range and nesting; the crop is a sub-block of the flipped
    volume shifted by std(nonzero) * alpha per channel with one alpha in
    [-0.1, 0.1]; the same generator seed gives the same crop."""
    img, lab = _volume(4, (12, 14, 13))
    crop = (8, 8, 8)
    timg, tlab = torch.from_numpy(img), torch.from_numpy(lab)
    outs = [ttf.device_augment(torch.Generator().manual_seed(s), timg, tlab, crop)
            for s in (0, 0, 1, 2, 3, 4, 5)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    assert any(not torch.equal(outs[0][0], o[0]) for o in outs[2:])
    nz = img != 0
    std = np.array([img[..., c][nz[..., c]].std() for c in range(4)])
    for x, m in outs:
        assert x.shape == (4, *crop) and m.shape == (3, *crop) and m.dtype == torch.float32
        assert float(x.max()) <= 1.1 and float(x.min()) >= -0.1
        assert torch.all(m[2] <= m[1]) and torch.all(m[1] <= m[0])
        xc, mc = np.moveaxis(x.numpy(), 0, -1), np.moveaxis(m.numpy(), 0, -1)
        alphas = []
        for flips in np.ndindex(2, 2, 2):
            axes = tuple(a for a in range(3) if flips[a])
            fimg, flab = np.flip(img, axes), np.flip(lab, axes)
            for o in np.ndindex(*(s - c + 1 for s, c in zip(img.shape[:3], crop))):
                sl = tuple(slice(a, a + c) for a, c in zip(o, crop))
                sub = fimg[sl]
                if (np.array_equal(jtf.host_seg_to_mask(flab[sl]), mc)
                        and np.array_equal(sub != 0, xc != 0)):
                    alphas.append((xc * 255.0 - sub)[sub != 0]
                                  / np.broadcast_to(std, sub.shape)[sub != 0])
        assert alphas, "the crop is no sub-block of the flipped volume"
        alpha = alphas[0]
        assert abs(float(alpha.mean())) <= 0.1 + 1e-4 and np.ptp(alpha) < 1e-3


def test_compute_sdm_matches_jax():
    rng = np.random.RandomState(5)
    seg = np.zeros((2, 10, 12, 11, 3), bool)
    seg[0, 2:8, 3:9, 2:7] = True
    seg[1, ..., 1] = rng.rand(10, 12, 11) > 0.7
    got = tsdm.compute_sdm(np.moveaxis(seg, -1, 1))
    _equal(np.moveaxis(got, 1, -1), jsdm.compute_sdm(seg))


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    rng = np.random.RandomState(6)
    path = str(tmp_path_factory.mktemp("h5") / "set.h5")
    images = np.zeros((5, 4, 14, 12, 10), np.float32)
    images[:, :, 2:12, 2:10, 1:9] = rng.rand(5, 4, 10, 8, 8) + 0.1
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=images)
        f.create_dataset("masks", data=rng.randint(0, 2, (5, 14, 12, 10)).astype(np.uint8))
        f.create_dataset("image", data=images[:, 0])
        f.create_dataset("label", data=rng.randint(0, 4, (5, 14, 12, 10)).astype(np.int16))
    return path


def test_hdf5_datasets_match_jax(h5_file):
    for m_full in (True, False):
        j = jbrats.ISLESDataset(h5_file, indices=[0, 2, 4], m_full=m_full, seed=1)
        t = tbrats.ISLESDataset(h5_file, indices=[0, 2, 4], m_full=m_full, seed=1)
        assert len(t) == 3 and t.subjects == j.subjects
        for i in (0, 2, 1):
            _equal_items(t.load(i), j.load(i))
    for extract in (True, False):
        j = jbrats.BraTSValidationSet(h5_file, extract=extract, seed=2, pad_multiple=4)
        t = tbrats.BraTSValidationSet(h5_file, extract=extract, seed=2, pad_multiple=4)
        for i in (1, 3):
            _equal_items(t.load(i), j.load(i))
        for _ in range(32):
            _equal(t.sample_keep(), j.sample_keep())
    j, t = jbrats.HDF5Dataset(h5_file), tbrats.HDF5Dataset(h5_file)
    assert len(t) == len(j) == 5
    _equal_items(t.load(2), j.load(2))
