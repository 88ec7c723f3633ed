"""Seeded synthetic batches with the columns of Criteo.

The columns and draws of ``examples/criteo/train.py:31-49``: categorical
columns ``c0, c1, ...`` of zipf(1.5) ids modulo the vocab (int64), dense
columns ``i0, i1, ...`` of exponential(1) values (float32), and a float32
``label`` drawn from a planted signal: an id that 5 divides in one of the
first four categorical columns adds 0.8, and ``log1p`` of each of the
first two dense values adds 0.3 times itself; the label is 1 with the
sigmoid of the signal less its mean. So a model can learn it, and AUC
means something. The mean is each batch's own (the example centers over
its whole file). Numpy arrays, one dict per batch: no pandas, no Parquet.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def criteo_batches(batch: int, count: int, vocab: int, tables: int = 26,
                   dense_features: int = 13, seed: int = 0
                   ) -> List[Dict[str, np.ndarray]]:
  """``count`` batches of ``batch`` rows from ``RandomState(seed)``, each
  drawn in the example's order."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(count):
    cols = {}
    signal = np.zeros(batch)
    for c in range(tables):
      ids = rng.zipf(1.5, batch) % vocab
      cols[f'c{c}'] = ids.astype(np.int64)
      if c < 4:
        signal = signal + (ids % 5 == 0) * 0.8
    for d in range(dense_features):
      v = rng.exponential(1.0, batch).astype(np.float32)
      cols[f'i{d}'] = v
      if d < 2:
        signal = signal + 0.3 * np.log1p(v)
    p = 1.0 / (1.0 + np.exp(-(signal - signal.mean())))
    cols['label'] = (rng.rand(batch) < p).astype(np.float32)
    out.append(cols)
  return out


__all__ = ['criteo_batches']
