"""Modality-subset table: the 15 non-empty subsets of the 4 MRI modalities
(t1c, t1n, t2f, t2w), ordered by size then lexicographically, as a static
(15, 4) boolean keep-mask table. Same table as `xlstm_hved_tpu/utils/subsets.py`.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

NUM_MODALITIES = 4
MODALITIES = tuple(range(NUM_MODALITIES))
MODALITY_NAMES = ("t1c", "t1n", "t2f", "t2w")

# (0,),(1,),(2,),(3,),(0,1),(0,2),(0,3),(1,2),(1,3),(2,3),
# (0,1,2),(0,1,3),(0,2,3),(1,2,3),(0,1,2,3)
SUBSETS_MODALITIES = tuple(
    itertools.chain.from_iterable(
        itertools.combinations(MODALITIES, r) for r in range(1, NUM_MODALITIES + 1)
    )
)
NUM_SUBSETS = len(SUBSETS_MODALITIES)  # 15
FULL_SUBSET_INDEX = NUM_SUBSETS - 1  # 14

# (15, 4) bool: SUBSET_MASKS[s, m] is True iff modality m is present in subset s.
SUBSET_MASKS = np.zeros((NUM_SUBSETS, NUM_MODALITIES), dtype=bool)
for _s, _subset in enumerate(SUBSETS_MODALITIES):
    SUBSET_MASKS[_s, list(_subset)] = True
SUBSET_MASKS.setflags(write=False)


def subset_mask(subset_index: int, device=None) -> torch.Tensor:
    """(4,) bool keep-mask of one subset."""
    return torch.tensor(SUBSET_MASKS[subset_index], device=device)


def drop_mask(subset_index: int, device=None) -> torch.Tensor:
    """(4,) bool drop-mask (True = modality missing)."""
    return ~subset_mask(subset_index, device)
