"""What decides ``correct``: readings of the first three steps.

The run drives the port's step through its first three steps on the
pool's first three batches (distinct rows) inside set-up, through the
window's own call and feed, and keeps a snapshot of its state: the
losses, the tower's Adam first moments after step 1, each member
table's rows that step 1 touched (and their accumulator) after step 1,
the tower and every touched row after step 3, before step 4 changes
them. :func:`observe` turns a snapshot into readings:

* the losses of the three steps;
* each leaf's first gradient as the optimizer got it, worked out from
  its state after one step: the tower's ``m1 / (1 - beta1)``; a table's
  per-row totals ``s = -(t1 - t0) (sqrt(a1) + eps) / lr`` from Adagrad's
  update of the rows it touched (``t0`` the counter function's rows);
* each leaf's change after three steps (``t3 - t0`` over every touched
  row; untouched rows do not move).

The reference's snapshot is read the same way, so that both sides' first
gradients carry the same rounding of the stored rows they are worked out
from. :func:`compare` takes the port's readings against the reference's,
leaf by leaf: the gap between the two norms over the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from portbench import initfn, train

NUMBERS = ('loss_gap', 'grad_gap', 'change_gap', 'change_median')
ROUND_OFF_SHARE = 1e-3


def observe(snap: dict, cfg: dict, seed: int, device: torch.device) -> dict:
  """The readings of a snapshot (the port's, or a control's), through
  the updates of the configuration's optimizers (``train.settings``
  refuses any other)."""
  st = train.settings(cfg)
  lr, eps, beta1 = st.table_lr, st.table_eps, st.tower_betas[0]
  dim = cfg['embedding_dim']
  grad = {k: float((v.to(device).double() / (1 - beta1)).norm())
          for k, v in snap['m1'].items()}
  change = {k: float((snap['p3'][k].to(device).double()
                      - snap['p0'][k].to(device).double()).norm())
            for k in snap['p3']}
  for name, t in snap['tables'].items():
    m = t['index']
    u0 = t['u0'].to(device)
    t0 = initfn.table_rows(seed, m, u0, dim).double()
    s = -(t['t1'].to(device).double() - t0) * (
        t['a1'].to(device).double().sqrt() + eps) / lr
    grad['table/' + name] = math.sqrt(float(s.square().sum()))
    big = t['U'].to(device)
    t0 = initfn.table_rows(seed, m, big, dim).double()
    change['table/' + name] = math.sqrt(float(
        (t['t3'].to(device).double() - t0).square().sum()))
  return {'losses': list(snap['losses']), 'grad': grad, 'change': change}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
  """Each leaf's gap: the two norms' difference over the reference's
  norm of that leaf or of the median leaf, whichever is larger."""
  med = statistics.median(ref[k] for k in keys)
  out = {}
  for k in keys:
    gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
    out[k] = gap if math.isfinite(gap) else math.inf
  return out


def compare(prog: dict, ref: dict) -> dict:
  """``{number: (value, what it was read at)}`` for the four numbers,
  the port's readings against the reference's:

  * ``loss_gap``: the first step's relative loss gap. The later steps'
    swing from seed to seed with their noise (below), and each later
    step's state is held by the change; their gaps are given beside it;
  * ``grad_gap``: the worst leaf's first-gradient gap;
  * ``change_gap``: the worst leaf's change gap after three steps;
  * ``change_median``: the median leaf's change gap, steadier from seed
    to seed than the worst leaf's (Adam's first steps move an element by
    about ``lr`` whatever its gradient, so where a gradient is zero to
    rounding the two sides may step opposite ways), which catches a
    small drift over most leaves.
  """
  steps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
           for p, r in zip(prog['losses'], ref['losses'])]
  out = {'loss_gap': (steps[0], 'step 1; steps 2 and 3 '
                      + ' '.join(f'{g:.3e}' for g in steps[1:]))}
  grads = _gaps(prog['grad'], ref['grad'], sorted(ref['grad']))
  leaf = max(grads, key=grads.get)
  out['grad_gap'] = (grads[leaf], leaf)
  med = statistics.median(ref['grad'].values())
  moving = sorted(k for k, g in ref['grad'].items()
                  if g >= ROUND_OFF_SHARE * med)
  changes = _gaps(prog['change'], ref['change'], moving)
  leaf = max(changes, key=changes.get)
  out['change_gap'] = (changes[leaf], f'{leaf} of {len(changes)} leaves')
  out['change_median'] = (statistics.median(changes.values()),
                          f'median of {len(changes)} leaves')
  return out


def judge(gaps: dict, limits: dict) -> bool:
  """Whether every compared number is within its limit. A number whose
  limit is null is not compared; a missing limits file fails."""
  if not limits:
    return False
  ok = True
  for name in NUMBERS:
    lim = limits.get(name)
    if lim is not None:
      ok = ok and gaps[name][0] <= lim
  return ok


__all__ = ['NUMBERS', 'compare', 'judge', 'observe']
