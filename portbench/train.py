"""The training settings a configuration states, and the port's state
and sparse step built from them.

Every key of ``table_dtype``, ``tf32``, ``table_optimizer`` and
``tower_optimizer`` is read. A value the benchmark does not implement is
refused with an error, never run as something else: the check
(``check.observe``) reads gradients back through Adagrad's and Adam's
updates, and the reference (``reference/common.py``) follows them in
float32 with TF32 off.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

# The sparse step takes no epsilon: the port's Adagrad adds 1e-7.
PORT_ADAGRAD_EPS = 1e-7
TABLE_DTYPES = {'float32': torch.float32}
_TABLE_KEYS = {'name', 'lr', 'initial_accumulator', 'eps', 'dedup'}
_TOWER_KEYS = {'name', 'lr', 'betas', 'eps'}


@dataclasses.dataclass(frozen=True)
class Settings:
  table_dtype: torch.dtype
  tf32: bool
  table_lr: float
  table_acc0: float
  table_eps: float
  table_dedup: bool
  tower_lr: float
  tower_betas: Tuple[float, float]
  tower_eps: float


def _refuse(key: str, value, implemented) -> None:
  raise ValueError(f'{key} = {value!r}: the benchmark implements only '
                   f'{implemented}')


def settings(cfg: dict) -> Settings:
  """The configuration's training settings; an error on any value the
  benchmark does not implement."""
  if cfg['table_dtype'] not in TABLE_DTYPES:
    _refuse('table_dtype', cfg['table_dtype'], sorted(TABLE_DTYPES))
  if cfg['tf32'] is not False:
    _refuse('tf32', cfg['tf32'], [False])
  tab, twr = cfg['table_optimizer'], cfg['tower_optimizer']
  if tab['name'] != 'adagrad':
    _refuse('table_optimizer.name', tab['name'], ['adagrad'])
  if set(tab) != _TABLE_KEYS:
    _refuse('table_optimizer keys', sorted(tab), sorted(_TABLE_KEYS))
  if tab['eps'] != PORT_ADAGRAD_EPS:
    _refuse('table_optimizer.eps', tab['eps'], [PORT_ADAGRAD_EPS])
  if tab['dedup'] is not True:
    # The check reads a row's gradient total back through one square.
    _refuse('table_optimizer.dedup', tab['dedup'], [True])
  if twr['name'] != 'adam':
    _refuse('tower_optimizer.name', twr['name'], ['adam'])
  if set(twr) != _TOWER_KEYS:
    _refuse('tower_optimizer keys', sorted(twr), sorted(_TOWER_KEYS))
  return Settings(TABLE_DTYPES[cfg['table_dtype']], cfg['tf32'], tab['lr'],
                  tab['initial_accumulator'], tab['eps'], tab['dedup'],
                  twr['lr'], tuple(twr['betas']), twr['eps'])


def state_and_step(s: Settings, fx, tower: torch.nn.Module,
                   tables: Dict[str, torch.Tensor], ctx, *,
                   model_loss=None, raw_model_loss=None):
  """The port's ``SparseTrainState`` over ``tables`` (Adagrad slots) and
  ``tower`` (torch Adam), and its ``make_sparse_train_step``."""
  import hybridbackend_tpu_torch as hbt
  state = hbt.SparseTrainState.create(
      tower, tables,
      functools.partial(torch.optim.Adam, lr=s.tower_lr,
                        betas=s.tower_betas, eps=s.tower_eps),
      adagrad_init=s.table_acc0, ctx=ctx)
  step = hbt.make_sparse_train_step(
      fx, model_loss, table_lr=s.table_lr, table_dedup=s.table_dedup,
      table_optimizer='adagrad', raw_model_loss=raw_model_loss)
  return state, step


__all__ = ['Settings', 'settings', 'state_and_step']
