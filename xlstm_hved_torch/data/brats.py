"""Datasets with modality dropout and a prefetching host loader (the port's
own copy of `xlstm_hved_tpu/data/brats.py`).

A thread prefetches items while the caller steps; items stay numpy on the
host and channels-last, (img (D, H, W, 4) fp32, labels (D, H, W) int32,
keep (4,) bool, bg_info (3,)), as the JAX package gives them, so the same
seed gives the same items and the same keep draws. The batch assembly
(`cli/common.py`) augments, copies to the device and lays them out NCDHW.
Semantics kept:
- per-subject NIfTI layout {subject}-{t1c,t1n,t2f,t2w,seg}.nii.gz,
- random modality dropout with >= 1 modality kept,
- m_full=False forces >= 1 dropped modality,
- corrupt subjects are skipped (reported, not raised).
`h5py` is imported by the HDF5 datasets only, when one is opened.
"""
from __future__ import annotations

import os
import queue
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from xlstm_hved_torch.data import native
from xlstm_hved_torch.data.nifti import load_subject, read_nifti
from xlstm_hved_torch.data.transforms import (background_info, extract_brain,
                                              host_zscore_nonzero, host_zscore_ref)


class BraTSDataset:
    """A BraTS-layout directory of subject folders. `use_native` decodes
    the modality files with the native decoder (`data/native.py`, one
    thread per file) and the seg file with the Python reader; None, as in
    the JAX package, asks for it when the host has more than one core. The
    voxels are the same either way. The JAX dataset falls back to the
    Python reader when its decoder does not build; here the build error
    is raised, at construction."""

    def __init__(self, data_dir: str, m_full: bool = False,
                 suffixes=("t1c", "t1n", "t2f", "t2w"),
                 seed: int = 0, use_native: Optional[bool] = None):
        if use_native is None:
            use_native = (os.cpu_count() or 1) > 1
        self.use_native = use_native
        if use_native:
            native._lib()  # build (or load) the decoder now, not in the loader thread
        self.data_dir = data_dir
        self.m_full = m_full
        self.suffixes = suffixes
        self.subjects: List[str] = sorted(
            d for d in os.listdir(data_dir)
            if os.path.isdir(os.path.join(data_dir, d)))
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.subjects)

    def load(self, index: int) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, np.ndarray]]:
        """Returns (img (D,H,W,4) fp32, labels (D,H,W) int32, keep (4,) bool,
        bg_info (3,)) or None on a load error."""
        subject = self.subjects[index]
        try:
            if self.use_native:
                img = native.native_read_subject(self.data_dir, subject, self.suffixes)
                seg_path = os.path.join(self.data_dir, subject, f"{subject}-seg.nii.gz")
                if not os.path.exists(seg_path):
                    seg_path = seg_path[:-3]
                seg, _ = read_nifti(seg_path)
            else:
                img, seg = load_subject(self.data_dir, subject, self.suffixes)
        except (OSError, ValueError, EOFError, struct.error, zlib.error) as e:
            # a missing or corrupt file: skip the subject
            print(f"error {e} loading {subject}, skipping")
            return None
        keep = self.sample_keep()
        bg = background_info(img)
        img = np.moveaxis(img, 0, -1).astype(np.float32)  # channels-last
        return img, seg.astype(np.int32), keep, bg

    def sample_keep(self) -> np.ndarray:
        """Random modality keep mask (True = present)."""
        keep = self.rng.randint(2, size=4).astype(bool)
        if not keep.any():
            keep[self.rng.randint(4)] = True
        if not self.m_full and keep.all():
            keep[self.rng.randint(4)] = False
        return keep


class _LoaderError:
    """An exception raised by the loader thread, on its way to the consumer."""

    def __init__(self, error: Exception):
        self.error = error


def prefetch_loader(dataset, batch_size: int = 1, shuffle: bool = True,
                    drop_last: bool = True, seed: int = 0, epochs: Optional[int] = 1,
                    shard: Optional[Tuple[int, int]] = None
                    ) -> Iterator[List[Tuple]]:
    """Threaded prefetching iterator yielding lists of per-subject tuples
    (the batch assembly, which knows the crop, stacks them).

    `shard=(process_id, process_count)` gives each process a disjoint
    strided slice of the (identically seeded, hence identically shuffled)
    index order. One producer thread loads the items in order."""
    order_rng = np.random.RandomState(seed)
    q: "queue.Queue" = queue.Queue(maxsize=max(2 * batch_size, 4))
    stop = threading.Event()

    def put(item):
        # give up once the consumer has gone, rather than block on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            epoch = 0
            while not stop.is_set() and (epochs is None or epoch < epochs):
                idxs = np.arange(len(dataset))
                if shuffle:
                    order_rng.shuffle(idxs)
                if shard is not None:
                    idxs = idxs[shard[0]::shard[1]]
                for i in idxs:
                    if stop.is_set():
                        return
                    item = dataset.load(int(i))
                    if item is not None:
                        put(item)
                epoch += 1
            put(None)
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            put(_LoaderError(e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        batch: List[Tuple] = []
        while True:
            item = q.get()
            if isinstance(item, _LoaderError):
                raise item.error
            if item is None:
                break
            batch.append(item)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch and not drop_last:
            yield batch
    finally:
        stop.set()


class HDF5Dataset:
    """HDF5 validation sets: an .h5 with 'image' and optional 'label'
    datasets per index; per-channel z-score over the brain."""

    def __init__(self, path: str, image_key: str = "image",
                 label_key: str = "label", zscore: bool = True):
        import h5py

        self.f = h5py.File(path, "r")
        self.images = self.f[image_key]
        self.labels = self.f[label_key] if label_key in self.f else None
        self.zscore = zscore

    def __len__(self):
        return len(self.images)

    def load(self, index: int):
        img = np.asarray(self.images[index], np.float32)
        if img.ndim == 3:
            img = img[None]
        if self.zscore:
            img = host_zscore_nonzero(img)
        lab = (np.asarray(self.labels[index], np.int32)
               if self.labels is not None else None)
        return np.moveaxis(img, 0, -1), lab


class ISLESDataset:
    """ISLES HDF5 dataset: an .h5 with 'images' (N, 4, D, H, W) and 'masks'
    (N, D, H, W); per-channel z-score over non-background voxels;
    per-modality Bernoulli(0.5) dropout (a modality is dropped when its
    draw exceeds 0.5) with >= 1 modality kept and, when m_full=False, >= 1
    dropped. The same item contract as BraTSDataset; bg_info marks the
    brain bbox corner."""

    def __init__(self, path: str, indices: Optional[Sequence[int]] = None,
                 m_full: bool = False, zscore: bool = True, seed: int = 0,
                 image_key: str = "images", mask_key: str = "masks"):
        import h5py

        self.f = h5py.File(path, "r")
        self.images = self.f[image_key]
        self.masks = self.f[mask_key] if mask_key in self.f else None
        self.indices = (list(indices) if indices is not None
                        else list(range(len(self.images))))
        self.m_full = m_full
        self.zscore = zscore
        self.rng = np.random.RandomState(seed)
        self.subjects = [str(i) for i in self.indices]

    def __len__(self) -> int:
        return len(self.indices)

    def sample_keep(self) -> np.ndarray:
        """Bernoulli(0.5) per-modality keep (True = present)."""
        keep = self.rng.rand(4) <= 0.5
        if not keep.any():
            keep[self.rng.randint(4)] = True
        if not self.m_full and keep.all():
            keep[self.rng.randint(4)] = False
        return keep

    def load(self, index: int):
        """(img (D,H,W,4) fp32 z-scored, labels (D,H,W) int32, keep (4,)
        bool, bg_info (3,))."""
        i = self.indices[index]
        img = np.asarray(self.images[i], np.float32)      # (4, D, H, W)
        if self.zscore:
            img = host_zscore_nonzero(img)
        lab = (np.asarray(self.masks[i], np.int32)
               if self.masks is not None
               else np.zeros(img.shape[1:], np.int32))
        bg = background_info(img)
        return (np.moveaxis(img, 0, -1).astype(np.float32), lab,
                self.sample_keep(), bg)


class BraTSValidationSet:
    """Label-free BraTS2018 HDF5 validation set: 'images' (N, 4, W, H, D)
    transposed to (4, D, H, W); an optional `extract_brain` crop (dynamic
    bbox, >= 112 per axis); the channel-0-mask z-score (`host_zscore_ref`);
    per-modality U(0, 1) > 0.5 dropout with >= 1 kept and >= 1 missing
    modality on every item.

    Masks do not exist for this split; a zero placeholder keeps the item
    contract. With `extract`, the crop is padded up to a multiple of
    `pad_multiple` per axis so the model sees a bounded set of shapes."""

    def __init__(self, path: str, indices: Optional[Sequence[int]] = None,
                 extract: bool = True, seed: int = 0,
                 image_key: str = "images", pad_multiple: int = 16):
        import h5py

        self.f = h5py.File(path, "r")
        self.images = self.f[image_key]
        self.indices = (list(indices) if indices is not None
                        else list(range(len(self.images))))
        self.extract = extract
        self.pad_multiple = pad_multiple
        self.rng = np.random.RandomState(seed)
        self.subjects = [str(i) for i in self.indices]

    def __len__(self) -> int:
        return len(self.indices)

    def sample_keep(self) -> np.ndarray:
        """U(0, 1) per modality, dropped when > 0.5; >= 1 kept and >= 1
        dropped."""
        ch = self.rng.rand(4)
        keep = ch <= 0.5
        if not keep.any():
            keep[self.rng.choice(4)] = True
        if keep.all():
            keep[self.rng.choice(4)] = False
        return keep

    def load(self, index: int):
        i = self.indices[index]
        img = np.asarray(self.images[i], np.float32)       # (4, W, H, D)
        img = np.transpose(img, (0, 3, 2, 1))              # (4, D, H, W)
        bg = background_info(img)
        lab = np.zeros(img.shape[1:], np.int32)
        if self.extract:
            img, lab = extract_brain(img, lab)
            if self.pad_multiple > 1:
                m = self.pad_multiple
                pads = [(0, (-img.shape[1 + a]) % m) for a in range(3)]
                img = np.pad(img, [(0, 0)] + pads)
                lab = np.pad(lab, pads)
        img = host_zscore_ref(img)
        return (np.moveaxis(img, 0, -1).astype(np.float32),
                lab, self.sample_keep(), bg)
