"""Evaluation metrics: AUC, mean, accuracy and grouped AUC.

Counterpart of ``hybridbackend_tpu/metrics/__init__.py:31-230``. Each
metric is a small state of tensors on the device of its inputs, updated
by a function that returns the new state and never reads the device back;
only ``*_result`` gives a value, and still as a 0-d tensor. The formulas,
thresholds and orders of operations are the JAX package's, so on the
same f32 inputs the two agree exactly wherever the sums are of 0/1
weights (counts below 2**24 are exact in f32), and to f32 summation order
otherwise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from hybridbackend_tpu_torch.ops.scatter import dense_row_totals

_EPS = 1e-7


class AUCState(NamedTuple):
  tp: torch.Tensor
  fp: torch.Tensor
  tn: torch.Tensor
  fn: torch.Tensor


def auc_init(num_thresholds: int = 200,
             device: Optional[torch.device] = None) -> AUCState:
  z = torch.zeros((num_thresholds,), dtype=torch.float32, device=device)
  return AUCState(z, z, z, z)


@functools.lru_cache(maxsize=None)
def _thresholds(num_thresholds: int, device: torch.device) -> torch.Tensor:
  """``-eps``, the interior thresholds ``(i + 1) / (T - 1)`` and
  ``1 + eps``, each rounded once to f32 (as the JAX package builds them),
  made once per device."""
  t = [-_EPS] + [(i + 1) * 1.0 / (num_thresholds - 1)
                 for i in range(num_thresholds - 2)] + [1.0 + _EPS]
  return torch.tensor(t, dtype=torch.float32, device=device)


def auc_update(state: AUCState, labels: torch.Tensor,
               predictions: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> AUCState:
  """Accumulate the weighted confusion matrix at every threshold."""
  thr = _thresholds(state.tp.shape[0], predictions.device)
  labels = labels.reshape(-1).to(torch.float32)
  predictions = predictions.reshape(-1).to(torch.float32)
  if weights is None:
    w = torch.ones_like(predictions)
  else:
    w = weights.reshape(-1).to(torch.float32)
  pred_pos = predictions[None, :] > thr[:, None]        # [T, N]
  label_pos = (labels > 0)[None, :]
  w_n = w[None, :]
  tp = torch.where(pred_pos & label_pos, w_n, 0.0).sum(1)
  fp = torch.where(pred_pos & ~label_pos, w_n, 0.0).sum(1)
  tn = torch.where(~pred_pos & ~label_pos, w_n, 0.0).sum(1)
  fn = torch.where(~pred_pos & label_pos, w_n, 0.0).sum(1)
  return AUCState(state.tp + tp, state.fp + fp, state.tn + tn,
                  state.fn + fn)


def auc_result(state: AUCState, curve: str = 'ROC') -> torch.Tensor:
  """Riemann-sum AUC of the ROC or PR curve."""
  if curve == 'ROC':
    x = state.fp / torch.clamp(state.fp + state.tn, min=_EPS)   # fpr
    y = state.tp / torch.clamp(state.tp + state.fn, min=_EPS)   # tpr
  elif curve == 'PR':
    x = state.tp / torch.clamp(state.tp + state.fn, min=_EPS)   # recall
    y = state.tp / torch.clamp(state.tp + state.fp, min=_EPS)   # precision
  else:
    raise ValueError(f'Unknown curve: {curve}')
  # Thresholds ascend, so x descends: integrate |dx| * mean(y).
  return torch.sum((x[:-1] - x[1:]) * (y[:-1] + y[1:]) / 2.0)


def auc_limit(predictions, reference, labels,
              num_thresholds: int = 200) -> Tuple[float, int, float]:
  """How far the ROC AUC of ``predictions`` may lie from that of
  ``reference`` (the same examples, 0/1 labels and weights, scored by the
  same model on another device or package): ``(limit, near, gap)``.

  A reference prediction within ``gap``, the largest distance between
  the two, of one of the thresholds may fall in another bucket; each of
  the ``near`` such predictions moves one count at one threshold, which
  moves the Riemann sum by at most ``1 / min(positives, negatives)``. The
  counts are otherwise equal (0/1 weights are exact in f32), and the sum
  may round in another order (1e-6)."""
  p = torch.as_tensor(predictions).reshape(-1).to('cpu', torch.float32)
  r = torch.as_tensor(reference).reshape(-1).to('cpu', torch.float32)
  y = torch.as_tensor(labels).reshape(-1).to('cpu', torch.float32)
  gap = float((p - r).abs().max())
  thr = _thresholds(num_thresholds, torch.device('cpu'))
  near = int(((r[:, None] - thr[None, :]).abs() <= gap).any(1).sum())
  pos = float(y.sum())
  return near / min(pos, y.numel() - pos) + 1e-6, near, gap


class MeanState(NamedTuple):
  total: torch.Tensor
  count: torch.Tensor


def mean_init(device: Optional[torch.device] = None) -> MeanState:
  z = torch.zeros((), dtype=torch.float32, device=device)
  return MeanState(z, z)


def mean_update(state: MeanState, values: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> MeanState:
  values = values.reshape(-1).to(torch.float32)
  if weights is None:
    w = torch.ones_like(values)
  else:
    w = torch.broadcast_to(weights.to(torch.float32).reshape(-1),
                           values.shape)
  return MeanState(state.total + torch.sum(values * w),
                   state.count + torch.sum(w))


def mean_result(state: MeanState) -> torch.Tensor:
  return state.total / torch.clamp(state.count, min=_EPS)


def accuracy_update(state: MeanState, labels: torch.Tensor,
                    predictions: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> MeanState:
  correct = labels.reshape(-1) == predictions.reshape(-1)
  return mean_update(state, correct.to(torch.float32), weights)


accuracy_init = mean_init
accuracy_result = mean_result


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
  """Each segment's count of 0/1 ``values``: exact in any order."""
  return torch.zeros(n, dtype=values.dtype,
                     device=values.device).index_add_(0, segments, values)


def _segment_total(values: torch.Tensor, segments: torch.Tensor,
                   n: int) -> torch.Tensor:
  """The f32 sum of each segment's ``values`` in list order, the same
  bits on every call (kernel 4 on a card; an ``index_add_`` of floats
  there adds with atomics in no fixed order)."""
  return dense_row_totals(segments, values.reshape(-1, 1), n).reshape(n)


def gauc_batch(labels: torch.Tensor, predictions: torch.Tensor,
               indicators: torch.Tensor,
               skip_boundary_groups: bool = True,
               sort_groups: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """One batch's grouped-AUC contribution ``(sum aucs * sizes, sum
  sizes)``, the JAX package's vectorized form of the reference kernel.

  Groups are contiguous runs of equal ``indicators`` (``sort_groups``
  first sorts the batch by indicator, stably, and then keeps the first
  and last groups). Within a group examples are ordered by prediction,
  ties in batch order (two stable sorts, the JAX ``lexsort``), and the
  trapezoid is accumulated from two global prefix sums less the prefix
  at the group's start, as JAX does. Groups of one class are skipped,
  and with ``skip_boundary_groups`` the first and last group, which a
  batch boundary may cut.
  """
  labels = labels.reshape(-1).to(torch.float32)
  predictions = predictions.reshape(-1).to(torch.float32)
  indicators = indicators.reshape(-1)
  n = labels.shape[0]
  if sort_groups:
    order0 = torch.sort(indicators, stable=True).indices
    labels, predictions = labels[order0], predictions[order0]
    indicators = indicators[order0]
    skip_boundary_groups = False  # groups are complete after sorting

  changed = torch.cat([
      torch.zeros((1,), dtype=torch.int64, device=labels.device),
      (indicators[1:] != indicators[:-1]).to(torch.int64)])
  gid = torch.cumsum(changed, 0)                # dense group ids, sorted
  num_groups = gid[-1] + 1

  # Sort by (group, prediction), both stable.
  by_pred = torch.sort(predictions, stable=True).indices
  order = by_pred[torch.sort(gid[by_pred], stable=True).indices]
  g = gid[order]
  click = labels[order]
  nonclick = 1.0 - click

  # The group-local prefix: the global prefix less its value before the
  # group's first member, spread over the group by a segment max (the
  # JAX formulation; the false-positive prefix it also builds is unused).
  ctp = torch.cumsum(click, 0)
  first_of_group = torch.cat([
      torch.ones((1,), dtype=torch.bool, device=g.device), g[1:] != g[:-1]])
  seg_start_ctp = torch.full((n,), -torch.inf, device=g.device).scatter_reduce(
      0, g, torch.where(first_of_group, ctp - click, -torch.inf), 'amax')
  tp2 = ctp - seg_start_ctp[g]
  contrib = nonclick * (2.0 * tp2 - click)       # (fp2-fp1)(tp2+tp1)

  auc_acc = _segment_total(contrib, g, n)
  tp_g = _segment_sum(click, g, n)
  fp_g = _segment_sum(nonclick, g, n)
  size_g = _segment_sum(torch.ones_like(click), g, n)

  group_ids = torch.arange(n, device=g.device)
  exists = group_ids < num_groups
  threshold = size_g - 1e-3
  valid = exists & (tp_g * fp_g > 0) & (tp_g <= threshold) & (
      fp_g <= threshold)
  if skip_boundary_groups:
    valid = valid & (group_ids != 0) & (group_ids != num_groups - 1)
  auc_g = 1.0 - auc_acc / torch.clamp(2.0 * tp_g * fp_g, min=_EPS)
  vw = torch.where(valid, size_g, 0.0)
  return torch.sum(auc_g * vw), torch.sum(vw)


def gauc_update(state: MeanState, labels: torch.Tensor,
                predictions: torch.Tensor, indicators: torch.Tensor,
                skip_boundary_groups: bool = True,
                sort_groups: bool = False) -> MeanState:
  num, den = gauc_batch(labels, predictions, indicators,
                        skip_boundary_groups, sort_groups=sort_groups)
  return MeanState(state.total + num, state.count + den)


gauc_init = mean_init
gauc_result = mean_result


__all__ = [
    'AUCState', 'auc_init', 'auc_update', 'auc_result', 'auc_limit',
    'MeanState', 'mean_init', 'mean_update', 'mean_result',
    'accuracy_init', 'accuracy_update', 'accuracy_result',
    'gauc_init', 'gauc_batch', 'gauc_update', 'gauc_result',
]
