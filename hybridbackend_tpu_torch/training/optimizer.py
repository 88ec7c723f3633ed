"""Optimizers of the dense-gradient path: the table/tower split, an
optax-equivalent Adagrad, a composite optimizer, and the LR schedule.

Counterpart of ``hybridbackend_tpu/training/optimizer.py:35-156``
(``is_embedding_path``, ``split_trees``, ``multi_optimizer``,
``lr_with_linear_warmup_and_polynomial_decay``). Parameters are split by
their names in ``named_parameters()``: a name with a part that contains
``'table'`` or ``'embedding'`` is a table parameter, as the JAX predicate
reads a pytree path.

``Adagrad`` here is ``optax.adagrad``, not ``torch.optim.Adagrad``: optax
starts the accumulator at 0.1 and updates by ``g * rsqrt(acc + 1e-7)``
(0 where ``acc == 0``); torch starts it at 0 and divides by
``sqrt(acc) + 1e-10``, so the two part from the first step.

Optimizer state exists from construction, as optax's does after
``init``: ``Adagrad`` makes its accumulators at once and
:func:`init_state` makes torch Adam's moments before its first step,
so a checkpoint template carries every slot. :func:`slots_by_name` and
:func:`load_slots_by_name` key that state by parameter name, not by the
position torch's ``state_dict`` uses.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

import torch
from torch import nn

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def is_embedding_path(name: str) -> bool:
  """Whether the parameter ``name`` (dotted, as ``named_parameters``
  gives it) is a table: a part that contains 'table' or 'embedding'."""
  return any('table' in part or 'embedding' in part
             for part in name.split('.'))


def split_trees(module: nn.Module,
                predicate: Callable[[str], bool] = is_embedding_path
                ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
  """``(matching, rest)``: the module's parameters by name, split by
  ``predicate``."""
  matching, rest = {}, {}
  for name, p in module.named_parameters():
    (matching if predicate(name) else rest)[name] = p
  return matching, rest


class Adagrad(torch.optim.Optimizer):
  """``optax.adagrad(lr, initial_accumulator_value, eps)``:
  ``acc += g * g``, then ``p += -lr * (g * rsqrt(acc + eps))``, with the
  update 0 where ``acc`` is 0; in the operand order and with the
  roundings of optax, in plain foreach tensor ops. ``lr`` may be changed
  through ``param_groups`` (a torch LR scheduler does)."""

  def __init__(self, params, lr: float,
               initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    if initial_accumulator_value < 0:
      raise ValueError('initial_accumulator_value must be >= 0')
    super().__init__(params, dict(lr=lr, eps=eps,
                                  initial_accumulator_value=
                                  initial_accumulator_value))
    for group in self.param_groups:
      for p in group['params']:
        self.state[p]['sum_of_squares'] = torch.full_like(
            p, group['initial_accumulator_value'],
            memory_format=torch.preserve_format)

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    for group in self.param_groups:
      params = [p for p in group['params'] if p.grad is not None]
      if not params:
        continue
      grads = [p.grad for p in params]
      acc = [self.state[p]['sum_of_squares'] for p in params]
      total = torch._foreach_mul(grads, grads)
      torch._foreach_add_(total, acc)               # g * g + acc
      torch._foreach_copy_(acc, total)
      scale = [torch.where(t > 0, torch.rsqrt(t + group['eps']), 0.0)
               for t in total]
      updates = torch._foreach_mul(scale, grads)
      torch._foreach_mul_(updates, -group['lr'])
      torch._foreach_add_(params, updates)
    return loss


class MultiOptimizer:
  """One optimizer for the table parameters and one for the rest, driven
  as one: ``step``, ``zero_grad``, ``state_dict`` and ``state`` cover
  both."""

  def __init__(self, table_opt: Optional[torch.optim.Optimizer],
               dense_opt: Optional[torch.optim.Optimizer]):
    self.table_opt, self.dense_opt = table_opt, dense_opt
    self.optimizers: List[torch.optim.Optimizer] = [
        o for o in (table_opt, dense_opt) if o is not None]

  @property
  def state(self) -> Dict[torch.Tensor, dict]:
    return {p: s for o in self.optimizers for p, s in o.state.items()}

  def zero_grad(self, set_to_none: bool = True) -> None:
    for o in self.optimizers:
      o.zero_grad(set_to_none=set_to_none)

  def step(self) -> None:
    for o in self.optimizers:
      o.step()

  def state_dict(self) -> dict:
    return {'table': self.table_opt and self.table_opt.state_dict(),
            'dense': self.dense_opt and self.dense_opt.state_dict()}


def multi_optimizer(table_opt: OptimizerFactory, dense_opt: OptimizerFactory,
                    predicate: Callable[[str], bool] = is_embedding_path
                    ) -> Callable[[nn.Module], MultiOptimizer]:
  """``table_opt`` on the table parameters and ``dense_opt`` on the rest
  (the canonical recipe: ``Adagrad`` on tables, Adam on the tower). Each
  is a factory of parameters, such as ``functools.partial(Adagrad,
  lr=0.05)``. Returns ``module -> MultiOptimizer``, as the JAX function
  returns ``params -> GradientTransformation``."""

  def build(module: nn.Module) -> MultiOptimizer:
    tables, rest = split_trees(module, predicate)
    return MultiOptimizer(
        table_opt(list(tables.values())) if tables else None,
        dense_opt(list(rest.values())) if rest else None)

  return build


def _optimizers(optimizer) -> List[torch.optim.Optimizer]:
  return list(getattr(optimizer, 'optimizers', [optimizer]))


def init_state(optimizer) -> None:
  """Make torch Adam's (and AdamW's) per-parameter state now, as its
  first step would: zero moments and a step count of 0, where its
  ``_init_group`` puts them. Other optimizers are left as they are
  (``Adagrad`` makes its state at construction)."""
  scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)
  for opt in _optimizers(optimizer):
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
      continue
    for group in opt.param_groups:
      on_device = group.get('capturable') or group.get('fused')
      for p in group['params']:
        state = opt.state[p]
        if state:
          continue
        state['step'] = (torch.zeros((), dtype=scalar, device=p.device)
                         if on_device else torch.tensor(0.0, dtype=scalar))
        state['exp_avg'] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
        state['exp_avg_sq'] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
        if group.get('amsgrad'):
          state['max_exp_avg_sq'] = torch.zeros_like(
              p, memory_format=torch.preserve_format)


def slots_by_name(optimizer, module: nn.Module) -> Dict[str, Dict]:
  """The optimizer's state of each of ``module``'s parameters, keyed by
  the parameter's name: ``{name: {slot: tensor}}`` (the tensors
  themselves, not copies)."""
  out = {}
  for opt in _optimizers(optimizer):
    for name, p in module.named_parameters():
      if p in opt.state and opt.state[p]:
        out[name] = dict(opt.state[p])
  return out


def load_slots_by_name(optimizer, module: nn.Module,
                       slots: Mapping[str, Mapping]) -> None:
  """Copy ``slots`` (as :func:`slots_by_name` gives them) into the
  optimizer's state in place; every slot must already exist."""
  live = slots_by_name(optimizer, module)
  with torch.no_grad():
    for name, by_slot in slots.items():
      for slot, value in by_slot.items():
        live[name][slot].copy_(value)


def lr_with_linear_warmup_and_polynomial_decay(
    initial_value: float = 24.0,
    scaling_factor: float = 1.0,
    warmup_steps=None,
    decay_steps=None,
    decay_start_step=None,
    decay_exp: int = 2,
    epsilon: float = 1e-7) -> Callable[[int], float]:
  """Linear warmup, then polynomial decay: ``schedule(step) -> lr``, each
  operation in f32 in the JAX function's order, the value returned as a
  Python float (exactly that f32 value)."""
  initial_lr = initial_value * scaling_factor

  def schedule(step) -> float:
    step = torch.tensor(step, dtype=torch.float32)
    if warmup_steps is None:
      return float(torch.tensor(initial_lr, dtype=torch.float32))
    warmup_rate = initial_lr / warmup_steps
    warmup_lr = initial_lr - (warmup_steps - step) * warmup_rate
    if decay_steps is None or decay_start_step is None:
      return float(warmup_lr)
    decayed = torch.clamp(step - decay_start_step, max=decay_steps)
    decay_lr = torch.clamp(
        initial_lr * ((decay_steps - decayed) / decay_steps) ** decay_exp,
        min=epsilon)
    return float(torch.where(
        step < warmup_steps, warmup_lr,
        torch.where(step > decay_start_step, decay_lr,
                    torch.tensor(initial_lr, dtype=torch.float32))))

  return schedule


__all__ = ['Adagrad', 'MultiOptimizer', 'init_state', 'is_embedding_path',
           'load_slots_by_name', 'lr_with_linear_warmup_and_polynomial_decay',
           'multi_optimizer', 'slots_by_name', 'split_trees']
