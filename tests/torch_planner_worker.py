"""One rank of the planner's calibration: the bytes the port's collectives
put on the wire.

Run under the launcher, one process per rank:

  python -m hybridbackend_tpu_torch.run --simulate 4 --nodes 2 \\
      --device cpu tests/torch_planner_worker.py OUT_DIR

For each placement and shape of ``POINTS`` the rank runs one lookup
forward and backward and one routed Adagrad update of a ``[V, d]`` f32
table, with every collective of ``distribute/collective.py`` wrapped to
add up what it sends by ``benchmarks/collective_benchmark.py:
wire_bytes`` (over the ranks that the call spans). It writes ``{(placement,
global ids, d): bytes}`` to ``OUT_DIR/<rank>.json``. Torch and the port
only: never JAX.
"""

import functools
import json
import os
import sys

import numpy as np
import torch

import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.benchmarks.collective_benchmark import wire_bytes
from hybridbackend_tpu_torch.distribute import collective

V = 8192
# (placement, global ids a step, dim)
POINTS = [('replicated', 1024, 16), ('replicated', 4096, 16),
          ('allgather', 1024, 16), ('allgather', 4096, 64),
          ('alltoall', 1024, 16), ('alltoall', 4096, 64),
          ('hierarchical', 1024, 16), ('hierarchical', 4096, 64),
          ('column', 1024, 16), ('column', 4096, 64)]
WIRE_NAMES = {'allreduce': 'allreduce', 'allgather': 'allgather',
              'alltoall': 'alltoall', 'reduce_scatter': 'reducescatter'}


def _counted(ctx, sent):
  """Wrap the module's collectives (``all_to_all_v`` calls ``alltoall``
  through the module, so it is counted there)."""
  for name, wire in WIRE_NAMES.items():
    real = getattr(collective, name)

    @functools.wraps(real)
    def call(x, *args, _real=real, _wire=wire, **kwargs):
      if not kwargs.get('axis', 0):      # not the moved-axis recursion
        size = collective.span(
            ctx, kwargs.get('topology', collective.Topology.ALL)).size
        sent[0] += wire_bytes(_wire, x.numel(), size, x.element_size())
      return _real(x, *args, **kwargs)

    setattr(collective, name, call)


def _step(ctx, placement, n, d):
  """One lookup forward and backward and one routed update of this
  rank's ``n / W`` ids."""
  cfg = hbt.TableConfig(
      'cal', V, d, sharded=placement != 'replicated',
      partition='column' if placement == 'column' else 'row')
  table = hbt.create_table(cfg, torch.Generator().manual_seed(0),
                           ctx.device, ctx)
  rng = np.random.RandomState(0)
  ids = torch.from_numpy(rng.randint(0, V, n).astype(np.int32)[ctx.rows(n)])
  cot = torch.from_numpy(rng.randn(n, d).astype(np.float32)[ctx.rows(n)])
  shard = table.clone().requires_grad_()
  strategy = 'allgather' if placement in ('replicated', 'column') else (
      placement)
  out = hbt.lookup(shard, ids, cfg, ctx=ctx, strategy=strategy,
                   overflow_fallback=False)
  (out * cot).sum().backward()
  state = hbt.init_adagrad_state(table, 0.1)
  hbt.sparse_adagrad_apply(table, state, ids, cot, cfg, 0.1, ctx=ctx,
                           overflow_fallback=False)


def main(out_dir):
  ctx = hbt.Context.join('cpu')
  sent = [0.0]
  _counted(ctx, sent)
  got = {}
  for placement, n, d in POINTS:
    sent[0] = 0.0
    _step(ctx, placement, n, d)
    got[f'{placement}/{n}/{d}'] = sent[0]
  with open(os.path.join(out_dir, f'{ctx.rank}.json'), 'w') as f:
    json.dump(got, f)
  ctx.leave()


if __name__ == '__main__':
  main(sys.argv[1])
