"""The port's dense-path optimizers against optax and
``hybridbackend_tpu.training.optimizer``: the optax-equivalent
``Adagrad`` (its accumulator start, its ``rsqrt(acc + eps)`` and its 0
update where the accumulator is 0, unlike ``torch.optim.Adagrad``),
torch Adam against ``optax.adam``, ``multi_optimizer``'s split by name
and its step, and the warmup/decay schedule.

Tolerances: Adagrad's accumulators after 4 steps to ``rtol = 2e-7``,
its parameters to ``rtol = 2e-7, atol = 1e-8``: the same f32 operations
in the same order, but XLA's and torch's ``rsqrt`` may differ in the
last bit, which moves an update of up to ``0.05 * 3`` by about 2e-8.
Adam's parameters to ``rtol = 1e-6, atol = 1e-7``: torch divides by
``sqrt(v) / sqrt(1 - b2**t) + eps`` where optax divides by
``sqrt(v / (1 - b2**t)) + eps``, a few ulps of an update of up to
``1e-3`` per step. The schedule's
values exactly (f32 operations in the JAX order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hybridbackend_tpu.training import optimizer as jopt

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.training import optimizer as topt

STEPS = 4


def _params_and_grads(seed):
  rng = np.random.RandomState(seed)
  params = {'tables': {'a': rng.randn(10, 4).astype(np.float32),
                       'b': rng.randn(6, 4).astype(np.float32)},
            'net': {'w': rng.randn(4, 3).astype(np.float32),
                    'b': rng.randn(3).astype(np.float32)}}
  grads = []
  for _ in range(STEPS):
    g = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                     params)
    g['tables']['a'][::3] = 0.0            # untouched rows
    grads.append(g)
  return params, grads


class _Module(nn.Module):

  def __init__(self, params):
    super().__init__()
    self.tables = nn.ParameterDict(
        {k: nn.Parameter(torch.tensor(v)) for k, v in params['tables'].items()})
    self.net = nn.ParameterDict(
        {k: nn.Parameter(torch.tensor(v)) for k, v in params['net'].items()})


def _run_jax(tx, params, grads):
  state = tx.init(params)
  for g in grads:
    updates, state = tx.update(g, state, params)
    params = optax.apply_updates(params, updates)
  return jax.tree.map(np.asarray, params), state


def _run_port(opt, module, grads):
  for g in grads:
    opt.zero_grad()
    for name, p in module.named_parameters():
      group, key = name.split('.')
      p.grad = torch.tensor(g[group][key])
    opt.step()


def _assert_params(module, want, **tol):
  for name, p in module.named_parameters():
    group, key = name.split('.')
    np.testing.assert_allclose(p.detach().numpy(), want[group][key], **tol)


@pytest.mark.parametrize('initial', [0.1, 0.0])
def test_adagrad_matches_optax(initial):
  params, grads = _params_and_grads(0)
  want, state = _run_jax(optax.adagrad(0.05, initial_accumulator_value=
                                       initial), params, grads)
  module = _Module(params)
  opt = hbt.Adagrad(module.parameters(), lr=0.05,
                    initial_accumulator_value=initial)
  _run_port(opt, module, grads)
  _assert_params(module, want, rtol=2e-7, atol=1e-8)
  sos = state[0].sum_of_squares
  for name, p in module.named_parameters():
    group, key = name.split('.')
    np.testing.assert_allclose(opt.state[p]['sum_of_squares'].numpy(),
                               np.asarray(sos[group][key]), rtol=2e-7)


def test_adagrad_is_not_torch_adagrad():
  params, grads = _params_and_grads(1)
  want, _ = _run_jax(optax.adagrad(0.05), params, grads[:1])
  module = _Module(params)
  _run_port(torch.optim.Adagrad(module.parameters(), lr=0.05), module,
            grads[:1])
  got = module.tables['b'].detach().numpy()
  assert not np.allclose(got, want['tables']['b'], rtol=1e-3)


def test_torch_adam_matches_optax_adam():
  params, grads = _params_and_grads(2)
  want, state = _run_jax(optax.adam(1e-3), params, grads)
  module = _Module(params)
  opt = torch.optim.Adam(module.parameters(), lr=1e-3)
  topt.init_state(opt)
  _run_port(opt, module, grads)
  _assert_params(module, want, rtol=1e-6, atol=1e-7)
  assert int(state[0].count) == STEPS
  for p in module.parameters():
    assert float(opt.state[p]['step']) == STEPS


def test_split_matches_jax_masks():
  params, _ = _params_and_grads(3)
  params['user_embedding'] = {'v': np.zeros(2, np.float32)}
  table_mask, dense_mask = jopt.split_trees(params)
  module = _Module(params)
  module.user_embedding = nn.ParameterDict(
      {'v': nn.Parameter(torch.zeros(2))})
  tables, rest = hbt.split_trees(module)
  flat = jax.tree_util.tree_flatten_with_path(table_mask)[0]
  want = {'.'.join(str(k.key) for k in path) for path, m in flat if m}
  assert set(tables) == want == {'tables.a', 'tables.b', 'user_embedding.v'}
  assert set(rest) == {'net.w', 'net.b'}
  assert hbt.is_embedding_path('model.table_3.w')
  assert not hbt.is_embedding_path('tower.mlp.0.w')


def test_multi_optimizer_matches_jax():
  params, grads = _params_and_grads(4)
  tx = jopt.multi_optimizer(optax.adagrad(0.05), optax.adam(1e-3))(params)
  want, _ = _run_jax(tx, params, grads)
  module = _Module(params)
  opt = hbt.multi_optimizer(functools.partial(hbt.Adagrad, lr=0.05),
                            functools.partial(torch.optim.Adam, lr=1e-3))(
                                module)
  assert isinstance(opt.table_opt, hbt.Adagrad)
  assert isinstance(opt.dense_opt, torch.optim.Adam)
  _run_port(opt, module, grads)
  _assert_params(module, want, rtol=1e-6, atol=1e-7)
  slots = topt.slots_by_name(opt, module)
  assert set(slots['tables.a']) == {'sum_of_squares'}
  assert set(slots['net.w']) == {'step', 'exp_avg', 'exp_avg_sq'}


def test_slots_by_name_round_trip():
  params, grads = _params_and_grads(5)
  module = _Module(params)
  opt = hbt.multi_optimizer(functools.partial(hbt.Adagrad, lr=0.05),
                            functools.partial(torch.optim.Adam, lr=1e-3))(
                                module)
  topt.init_state(opt)
  _run_port(opt, module, grads[:2])
  saved = {n: {k: v.clone() for k, v in s.items()}
           for n, s in topt.slots_by_name(opt, module).items()}
  _run_port(opt, module, grads[2:])
  topt.load_slots_by_name(opt, module, saved)
  for name, slots in topt.slots_by_name(opt, module).items():
    for k, v in slots.items():
      assert torch.equal(v, saved[name][k])
      assert v.device == saved[name][k].device


@pytest.mark.parametrize('kwargs', [
    dict(),
    dict(initial_value=0.1, warmup_steps=10),
    dict(initial_value=24.0, scaling_factor=0.5, warmup_steps=8,
         decay_steps=30, decay_start_step=20, decay_exp=2),
    dict(initial_value=3.0, warmup_steps=5, decay_steps=7,
         decay_start_step=12, decay_exp=3, epsilon=1e-3)])
def test_schedule_matches_jax(kwargs):
  want = jopt.lr_with_linear_warmup_and_polynomial_decay(**kwargs)
  got = hbt.lr_with_linear_warmup_and_polynomial_decay(**kwargs)
  for step in [0, 1, 3, 5, 7, 8, 11, 12, 13, 20, 21, 25, 37, 50, 100]:
    assert got(step) == float(want(step)), step
