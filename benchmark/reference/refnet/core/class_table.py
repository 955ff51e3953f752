"""Unified class table across datasets.

Mirror of reference unidet3d/encoder.py:151-161: the classification head
predicts over the sorted union of all datasets' class names plus `no_obj`;
each dataset selects its own columns. For static batched gathers we pad every
dataset's column-index list to NC_MAX and pin `no_obj` at fixed position
NC_MAX (the reference keeps it last per dataset; softmax semantics are
identical because padded columns are masked to -inf).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np


class ClassTable(NamedTuple):
    unified_classes: tuple  # sorted union + ['no_obj']
    gather: np.ndarray  # (D, NC_MAX + 1) int32; -1 = padding
    valid: np.ndarray  # (D, NC_MAX + 1) bool
    num_classes: np.ndarray  # (D,) real class count per dataset
    nc_max: int

    @property
    def num_unified(self) -> int:
        return len(self.unified_classes)

    @property
    def no_obj_col(self) -> int:
        """Column index of no_obj in the gathered per-dataset layout."""
        return self.nc_max


def build_class_table(datasets_classes: Sequence[Sequence[str]]) -> ClassTable:
    unified = sorted(
        set(itertools.chain.from_iterable(datasets_classes))
    ) + ["no_obj"]
    nc_max = max(len(c) for c in datasets_classes)
    d = len(datasets_classes)
    gather = np.full((d, nc_max + 1), -1, dtype=np.int32)
    for i, classes in enumerate(datasets_classes):
        for j, cls in enumerate(classes):
            gather[i, j] = unified.index(cls)
        gather[i, nc_max] = len(unified) - 1  # no_obj
    valid = gather >= 0
    num_classes = np.array([len(c) for c in datasets_classes], dtype=np.int32)
    return ClassTable(
        unified_classes=tuple(unified),
        gather=gather,
        valid=valid,
        num_classes=num_classes,
        nc_max=nc_max,
    )
