"""Modality-subset table: the 15 non-empty subsets of the 4 MRI modalities
(t1c, t1n, t2f, t2w), ordered by size then lexicographically, as a static
(15, 4) boolean keep-mask table, and the training samplers. Same table as
`xlstm_hved_tpu/utils/subsets.py`; the samplers draw from a `torch.Generator`
(the same distributions as the JAX samplers, not the same draws).
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

# Index range [start, end) of each subset-size bucket (size -> (start, end)).
SIZE_BUCKETS = {1: (0, 4), 2: (4, 10), 3: (10, 14), 4: (14, 15)}


def subset_mask(subset_index: int, device=None) -> torch.Tensor:
    """(4,) bool keep-mask of one subset."""
    return torch.tensor(SUBSET_MASKS[subset_index], device=device)


def drop_mask(subset_index: int, device=None) -> torch.Tensor:
    """(4,) bool drop-mask (True = modality missing)."""
    return ~subset_mask(subset_index, device)


def sample_subset_index(generator: torch.Generator, min_size: int = 1,
                        max_size: int = 3) -> int:
    """One subset index the way the training loop draws it: a size uniform
    in [min_size, max_size], then a subset uniform within that size's
    bucket (the buckets of SIZE_BUCKETS, which fix the upstream loop's
    off-by-one). With the defaults the full subset (14) is never drawn."""
    device = generator.device
    size = int(torch.randint(min_size, max_size + 1, (), generator=generator, device=device))
    lo, hi = SIZE_BUCKETS[size]
    u = float(torch.rand((), generator=generator, device=device))
    return lo + int(u * (hi - lo))


def sample_instance_drop(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 4) bool drop-mask (True = dropped), each modality dropped with
    probability 1/2; an instance that lost all four gets one random modality
    back."""
    device = generator.device
    drop = torch.rand((batch, NUM_MODALITIES), generator=generator, device=device) < 0.5
    forced = torch.randint(0, NUM_MODALITIES, (batch,), generator=generator, device=device)
    all_dropped = drop.all(dim=1)
    drop[all_dropped, forced[all_dropped]] = False
    return drop
