"""The plain reference's training loop, shared by the configurations.

Plain PyTorch: it imports nothing of the port and takes nothing the port
made. It is handed the benchmark's inputs (the first three batches of
the pool, the initial tower weights, the seed of the tables' counter
function) and follows the sparse step through three steps:

* each member table held as its rows that the three batches touch,
  rebuilt from ``initfn.table_rows``, the accumulator at its initial
  value;
* the embeddings gathered (an id ``< 0`` reads zeros), the model's loss
  (the configuration's ``forward``) and its gradients by autograd;
* the tower by Adam, written out (torch's order of operations), and
  every touched row by Adagrad on its gradient total, summed in float64
  (``acc += s*s``, ``row -= lr*s/(sqrt(acc)+eps)``), stored as float32.

It returns a snapshot of its state in the form the benchmark takes from
the port (``check.observe`` reads both), so that the same readout judges
the port and a control put in its place.

``precision='tf32'`` rounds every matmul's operands to TF32 (10 mantissa
bits, to nearest) with float32 accumulation, which is what a TF32 tensor
core computes: the control. ``half_batch=True`` trains on the first half
of each batch, the mean over it: a fault.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from portbench import initfn, train

Batch = Dict[str, torch.Tensor]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
  """``x`` (float32) rounded to nearest, ties to even, to TF32's 10
  mantissa bits."""
  i = x.contiguous().view(torch.int32)
  r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
  return r.view(torch.float32)


class _Round(torch.autograd.Function):
  """A matmul's operand rounded to TF32; its gradient passes through."""

  @staticmethod
  def forward(ctx, x):
    return to_tf32(x)

  @staticmethod
  def backward(ctx, g):
    return g


class _RoundGrad(torch.autograd.Function):
  """A matmul's output as it is; the gradient that reaches it rounded to
  TF32, the operand of the backward's matmuls."""

  @staticmethod
  def forward(ctx, x):
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return to_tf32(g)


@dataclasses.dataclass(frozen=True)
class Ops:
  """Matmuls in the reference's precision: with ``tf32`` every operand of
  the forward's and the backward's products is rounded to TF32."""
  tf32: bool = False

  def _call(self, fn, a, b):
    if not self.tf32:
      return fn(a, b)
    return _RoundGrad.apply(fn(_Round.apply(a), _Round.apply(b)))

  def mm(self, a, b):
    return self._call(torch.matmul, a, b)

  def bmm(self, a, b):
    return self._call(torch.bmm, a, b)

  def einsum(self, eq, a, b):
    return self._call(lambda x, y: torch.einsum(eq, x, y), a, b)


def dense(ops: Ops, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
          act=None) -> torch.Tensor:
  """The port's ``Dense`` layout: ``act(x @ w + b)``, ``w: [in, out]``."""
  y = ops.mm(x, p[name + '.w']) + p[name + '.b']
  return y if act is None else act(y)


def bce(preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Mean binary cross-entropy of predictions clipped to [1e-6, 1-1e-6]."""
  p = torch.clamp(preds, 1e-6, 1 - 1e-6)
  return torch.mean(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)))


def half(b: Batch) -> Batch:
  """The first half of every column's rows."""
  n = next(iter(b.values())).shape[0] // 2
  return {k: v[:n] for k, v in b.items()}


def train3(cfg: dict, seed: int, batches: List[Batch],
           tower0: Dict[str, torch.Tensor],
           members: List[Tuple[str, int]],
           member_ids: Callable[[Batch], Dict[str, torch.Tensor]],
           forward: Callable[[Ops, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor], Batch], torch.Tensor],
           precision: str = 'f32', half_batch: bool = False) -> dict:
  """Three steps; ``members`` is ``[(name, index)]`` of the tables,
  ``member_ids(batch)`` each member's ids, ``forward(ops, params, emb,
  batch)`` the loss. Returns the snapshot."""
  if precision not in ('f32', 'tf32'):
    raise ValueError(f'unknown precision {precision!r}')
  ops = Ops(tf32=precision == 'tf32')
  dim = cfg['embedding_dim']
  st = train.settings(cfg)
  lr, eps, acc0 = st.table_lr, st.table_eps, st.table_acc0
  b1, b2 = st.tower_betas
  tlr, teps = st.tower_lr, st.tower_eps
  if half_batch:
    batches = [half(b) for b in batches]
  ids = [member_ids(b) for b in batches]
  index = dict(members)
  uniq, tables, accs = {}, {}, {}
  for name, m in members:
    allv = torch.cat([i[name].reshape(-1) for i in ids]).to(torch.int64)
    uniq[name] = torch.unique(allv[allv >= 0])
    tables[name] = initfn.table_rows(seed, m, uniq[name], dim)
    accs[name] = torch.full_like(tables[name], acc0)
  params = {k: v.detach().clone().float().requires_grad_()
            for k, v in tower0.items()}
  p0 = {k: v.detach().clone() for k, v in params.items()}
  m_, v_ = ({k: torch.zeros_like(v) for k, v in params.items()}
            for _ in range(2))
  losses, snap_tables, m1 = [], {}, {}
  for k, (b, bid) in enumerate(zip(batches, ids)):
    local, valid, emb = {}, {}, {}
    for name, _ in members:
      x = bid[name].to(torch.int64)
      valid[name] = x >= 0
      local[name] = torch.searchsorted(uniq[name], x.clamp(min=0))
      rows = tables[name][local[name].clamp(max=max(len(uniq[name]) - 1, 0))]
      emb[name] = (rows * valid[name].unsqueeze(-1)).detach().requires_grad_()
    loss = forward(ops, params, emb, b)
    loss.backward()
    losses.append(float(loss.detach()))
    with torch.no_grad():
      t = k + 1
      for name, p in params.items():
        g = p.grad
        m_[name].mul_(b1).add_(g, alpha=1 - b1)
        v_[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        if k == 0:
          m1[name] = m_[name].clone()
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        denom = (v_[name].sqrt() / (bc2 ** 0.5)).add_(teps)
        p.addcdiv_(m_[name], denom, value=-tlr / bc1)
        p.grad = None
      for name, _ in members:
        vm = valid[name]
        s = torch.zeros(tables[name].shape, dtype=torch.float64,
                        device=tables[name].device)
        s.index_add_(0, local[name][vm], emb[name].grad[vm].double())
        a = accs[name].double() + s * s
        tables[name] = (tables[name].double()
                        - lr * s / (a.sqrt() + eps)).float()
        accs[name] = a.float()
        if k == 0:
          touched = torch.unique(local[name][vm])
          snap_tables[name] = {'index': index[name],
                               'u0': uniq[name][touched],
                               't1': tables[name][touched].clone(),
                               'a1': accs[name][touched].clone()}
  for name, _ in members:
    snap_tables[name].update(U=uniq[name], t3=tables[name])
  return {'losses': losses, 'm1': m1, 'p0': p0,
          'p3': {k: v.detach() for k, v in params.items()},
          'tables': snap_tables}

__all__ = ['Ops', 'bce', 'dense', 'half', 'to_tf32', 'train3']
