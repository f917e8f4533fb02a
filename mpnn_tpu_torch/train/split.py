"""Train/test split: a numpy copy of sklearn's
train_test_split(xs, test_size=…, random_state=seed) for a list, as the
JAX package's `train` verb splits (mpnn_tpu/train/cli.py): ShuffleSplit
takes the first ceil(test_size·n) indices of
RandomState(seed).permutation(n) as the test set and the rest, in
permutation order, as the training set."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def train_test_split(xs: Sequence, test_size: float = 0.1,
                     random_state: int = 0) -> Tuple[List, List]:
    n = len(xs)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} must be in (0, 1)")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"with {n} samples and test_size={test_size} the "
                         "training set is empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return [xs[i] for i in perm[n_test:]], [xs[i] for i in perm[:n_test]]
