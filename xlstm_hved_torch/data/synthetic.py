"""Synthetic BraTS-like volumes for tests, smoke runs and benches (the
port's own copy of `xlstm_hved_tpu/data/synthetic.py`: the same seed gives
the same arrays and files).

Smooth multi-modal intensities with a nested ellipsoidal tumour labelled
over the full alphabet {1, 2, 3, 4} that SegToMask distinguishes:

    WT = (m > 0)            -> labels {1, 2, 3, 4}
    TC = (m in {1, 2, 3})   -> labels {1, 2, 3}   (strict subset of WT)
    ET = (m == 1)           -> label 1

Each label has its own intensity offset, separated by >= 30/255 in every
modality, so every nested region can be segmented from any one modality.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

# Per-label intensity offsets inside each nested region (uint8-scaled
# inputs), distinct per label in every modality.
LABEL_OFFSETS = {4: 30.0, 2: 70.0, 3: 110.0, 1: 150.0}

# Nested region thresholds on the ellipsoidal coordinate r (quadratic form):
# outer shell = label 4 (WT only), then 2, 3, and the innermost = 1 (ET);
# region volume scales as t^1.5, so ET/WT = 25 % and TC/WT = 65 %.
REGION_THRESHOLDS = ((1.0, 4), (0.75, 2), (0.55, 3), (0.4, 1))


def synthetic_subject(rng: np.random.RandomState,
                      shape: Sequence[int] = (64, 64, 64)
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (img (4, D, H, W) in [0, 255], labels (D, H, W) in {0..4})."""
    D, H, W = shape
    zz, yy, xx = np.meshgrid(np.linspace(-1, 1, D), np.linspace(-1, 1, H),
                             np.linspace(-1, 1, W), indexing="ij")
    center = rng.uniform(-0.25, 0.25, 3)
    radii = rng.uniform(0.3, 0.55, 3)
    r = (((zz - center[0]) / radii[0]) ** 2 + ((yy - center[1]) / radii[1]) ** 2
         + ((xx - center[2]) / radii[2]) ** 2)
    brain = r < 4.0
    labels = np.zeros(shape, np.int16)
    for threshold, label in REGION_THRESHOLDS:
        labels[r < threshold] = label
    img = np.zeros((4,) + tuple(shape), np.float32)
    for c in range(4):
        # keep base + max offset below 255 so no label saturates/clips
        # (max: 40 + 45 + 15 + 150 + jitter ~= 255)
        base = 40 + 15 * c + 15 * np.sin(3 * (zz + c)) * np.cos(2 * yy)
        noise = rng.randn(*shape) * 5
        boost = np.zeros(shape, np.float32)
        for label, offset in LABEL_OFFSETS.items():
            # per-modality/per-subject jitter keeps labels >= ~30 apart
            boost[labels == label] = offset + rng.uniform(-5, 5)
        img[c] = np.clip((base + noise + boost) * brain, 0, 255)
    return img, labels


def write_synthetic_dataset(root: str, n_subjects: int = 2,
                            shape: Sequence[int] = (32, 32, 32),
                            seed: int = 0) -> str:
    """Materialize a BraTS-layout directory of synthetic subjects (for
    end-to-end loader/eval tests)."""
    from xlstm_hved_torch.data.nifti import write_nifti

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n_subjects):
        name = f"SYN-{i:04d}"
        sdir = os.path.join(root, name)
        os.makedirs(sdir, exist_ok=True)
        img, labels = synthetic_subject(rng, shape)
        for c, suffix in enumerate(("t1c", "t1n", "t2f", "t2w")):
            write_nifti(os.path.join(sdir, f"{name}-{suffix}.nii.gz"), img[c])
        write_nifti(os.path.join(sdir, f"{name}-seg.nii.gz"),
                    labels.astype(np.uint8))
    return root
