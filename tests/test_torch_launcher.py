"""The port's launcher, ``python -m hybridbackend_tpu_torch.run``.

Counterpart of ``tests/test_launcher.py``: gloo CPU ranks
(``--simulate N --device cpu``) that all-reduce across the process
boundary, a failing rank that takes its peers down, a world past its
deadline, a collective whose peer never comes, and whole lines relayed
from every rank; then the train harness as a world of two (also with
per-occurrence Adagrad on bf16 tables and a bf16 gradient wire, and
its interleaved step against its world of one), the DIN harness's
raw-mode sparse step as one, and both harnesses' dense modes as worlds
of two, against their world of one; ``--nodes``: the
environment each child gets, node counts that do not divide the ranks,
and the card a rank joins on. Every launch has a ``subprocess``
deadline, so that a hang fails one test.
"""

import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(tmp_path, body, *flags, timeout=90):
  script = tmp_path / 'child.py'
  script.write_text(body)
  env = dict(os.environ, OMP_NUM_THREADS='1')
  t0 = time.monotonic()
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', *flags,
       str(script)], cwd=ROOT, env=env, capture_output=True, text=True,
      timeout=timeout)
  return out, time.monotonic() - t0


ALLREDUCE = """
import torch
import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
ctx = hbt.Context.join('cpu')
assert (ctx.world_size, ctx.local_rank) == (2, ctx.rank), ctx
total = collective.allreduce(torch.tensor([ctx.rank + 1.0]), ctx=ctx)
print('CHILD_OK', ctx.rank, float(total), flush=True)
ctx.leave()
"""


@pytest.mark.timeout(120)
def test_two_ranks_allreduce(tmp_path):
  out, _ = _launch(tmp_path, ALLREDUCE, '--simulate', '2', '--device', 'cpu',
                   '--timeout', '80')
  assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
  assert sorted(l for l in out.stdout.splitlines()
                if l.startswith('CHILD_OK')) == ['CHILD_OK 0 3.0',
                                                 'CHILD_OK 1 3.0']


@pytest.mark.timeout(120)
def test_failing_rank_kills_its_peers(tmp_path):
  out, took = _launch(tmp_path, (
      'import os, sys, time\n'
      'if os.environ["RANK"] == "1":\n'
      '    sys.exit(3)\n'
      'time.sleep(120)\n'), '--simulate', '2', '--device', 'cpu')
  assert out.returncode == 3, (out.returncode, out.stderr[-500:])
  assert took < 60, took


@pytest.mark.timeout(120)
def test_world_past_its_deadline_is_killed(tmp_path):
  out, took = _launch(tmp_path, 'import time\ntime.sleep(120)\n',
                      '--simulate', '2', '--device', 'cpu', '--timeout', '3')
  assert out.returncode == 124, (out.returncode, out.stderr[-500:])
  assert 'still running' in out.stderr
  assert took < 60, took


STUCK = """
import time
import torch
import hybridbackend_tpu_torch as hbt
from hybridbackend_tpu_torch.distribute import collective
ctx = hbt.Context.join('cpu')
if ctx.rank == 1:
  time.sleep(120)     # never joins the all-reduce
collective.allreduce(torch.ones(1), ctx=ctx)
"""


@pytest.mark.timeout(120)
def test_a_stuck_collective_raises(tmp_path):
  """Rank 0's all-reduce raises at the collectives' deadline; the
  launcher then takes rank 1 down."""
  out, took = _launch(tmp_path, STUCK, '--simulate', '2', '--device', 'cpu',
                      '--collective-timeout', '4')
  assert out.returncode not in (0, 124), out.returncode
  assert took < 60, took


LINES = """
import os
rank = os.environ['RANK']
for i in range(400):
  print(f'LINE {rank} {i} ' + rank * 3000, flush=True)
"""


@pytest.mark.timeout(120)
def test_lines_are_relayed_whole(tmp_path):
  out, _ = _launch(tmp_path, LINES, '--simulate', '3', '--device', 'cpu',
                   '--timeout', '80')
  assert out.returncode == 0, out.stderr[-1000:]
  lines = out.stdout.splitlines()
  assert len(lines) == 1200
  for line in lines:
    tag, rank, i, payload = line.split(' ')
    assert tag == 'LINE' and payload == rank * 3000, line[:80]


@pytest.mark.timeout(150)
def test_harness_as_a_world_of_two():
  """``-m`` form: only rank 0 prints the report, for the global batch."""
  env = dict(os.environ, OMP_NUM_THREADS='1')
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       '2', '--timeout', '120', '-m',
       'hybridbackend_tpu_torch.benchmarks.train_benchmark', '--sparse',
       '--device', 'cpu', '--tables', '2', '--vocab', '1000', '--batch', '64',
       '--dense-features', '3', '--lookup', 'alltoall', '--repeats', '1',
       '--inner-steps', '2', '--json'], cwd=ROOT, env=env,
      capture_output=True, text=True, timeout=140)
  assert out.returncode == 0, out.stderr[-2000:]
  (line,) = [l for l in out.stdout.splitlines() if l.startswith('{')]
  got = json.loads(line)
  assert (got['world'], got['lookup'], got['backend'], got['batch']) == (
      2, 'alltoall', 'gloo', 64)
  assert got['final_loss'] == got['final_loss'] > 0


def _launched(module, *flags, sparse=True):
  """``module`` as a world of two gloo CPU ranks at a tiny shape (its
  ``--sparse`` mode unless ``sparse`` is False); its one JSON line, which
  rank 0 alone prints."""
  env = dict(os.environ, OMP_NUM_THREADS='1')
  mode = ['--sparse'] if sparse else []
  out = subprocess.run(
      [sys.executable, '-m', 'hybridbackend_tpu_torch.run', '--simulate',
       '2', '--timeout', '120', '-m', module, *mode, '--device', 'cpu',
       '--repeats', '1', '--inner-steps', '2', '--json', *flags], cwd=ROOT,
      env=env, capture_output=True, text=True, timeout=140)
  assert out.returncode == 0, out.stderr[-2000:]
  (line,) = [l for l in out.stdout.splitlines() if l.startswith('{')]
  return json.loads(line)


@pytest.mark.timeout(150)
def test_harness_with_every_table_option_as_a_world_of_two():
  """Per-occurrence Adagrad on bf16 tables with the gradients on a bf16
  wire, as a world of two."""
  got = _launched('hybridbackend_tpu_torch.benchmarks.train_benchmark',
                  '--tables', '2', '--vocab', '1000', '--batch', '64',
                  '--dense-features', '3', '--lookup', 'alltoall',
                  '--no-dedup', '--table-dtype', 'bfloat16',
                  '--gradient-wire-dtype', 'bfloat16')
  assert (got['world'], got['backend'], got['no_dedup'], got['table_dtype'],
          got['gradient_wire_dtype']) == (2, 'gloo', True, 'bfloat16',
                                          'bfloat16')
  assert got['final_loss'] == got['final_loss'] > 0


@pytest.mark.timeout(150)
def test_din_harness_as_a_world_of_two():
  """The DIN harness's raw-mode sparse step as a world of two, the stack
  looked up through the alltoall exchange."""
  got = _launched('hybridbackend_tpu_torch.benchmarks.din_benchmark',
                  '--batch', '64', '--hist', '8', '--vocab', '1000',
                  '--dim', '8', '--lookup', 'alltoall')
  assert (got['world'], got['lookup'], got['backend'], got['batch']) == (
      2, 'alltoall', 'gloo', 64)
  assert got['final_loss'] == got['final_loss'] > 0


DENSE_HARNESSES = {
    'train': ('hybridbackend_tpu_torch.benchmarks.train_benchmark',
              ('--tables', '2', '--vocab', '1000', '--batch', '64',
               '--dense-features', '3', '--gradient-wire-dtype', 'bfloat16')),
    'din': ('hybridbackend_tpu_torch.benchmarks.din_benchmark',
            ('--batch', '64', '--hist', '8', '--vocab', '1000', '--dim', '8')),
}


@pytest.mark.timeout(150)
@pytest.mark.parametrize('harness', sorted(DENSE_HARNESSES))
def test_dense_harness_as_a_world_of_two(harness):
  """The dense mode as a world of two: data-parallel, the tables
  row-sharded; the final loss is the world of one's, to the order of the
  sums over the ranks (the train harness asks for a bf16 gradient wire,
  which falls back to f32 with sharded tables)."""
  import importlib
  module, flags = DENSE_HARNESSES[harness]
  got = _launched(module, *flags, sparse=False)
  assert (got['world'], got['backend'], got['sparse']) == (2, 'gloo', False)
  mod = importlib.import_module(module)
  one = mod.run(mod.parse_args(['--device', 'cpu', '--repeats', '1',
                                '--inner-steps', '2', *flags]))
  assert one['world'] == 1
  assert abs(got['final_loss'] - one['final_loss']) <= 1e-5 * one[
      'final_loss']


@pytest.mark.timeout(150)
def test_interleaved_harness_as_a_world_of_two():
  """``--sparse --interleave 2`` as a world of two: each rank's rows in 2
  micro-batches looked up through the alltoall exchange, one table update
  a step; the final loss is the world of one's interleaved step's, to the
  order of the sums over the ranks and the micro-batches."""
  from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb
  flags = ('--tables', '2', '--vocab', '1000', '--batch', '64',
           '--dense-features', '3', '--interleave', '2', '--lookup',
           'alltoall')
  got = _launched('hybridbackend_tpu_torch.benchmarks.train_benchmark',
                  *flags)
  assert (got['world'], got['backend'], got['interleave'], got['lookup']) \
      == (2, 'gloo', 2, 'alltoall')
  one = tb.run(tb.parse_args(['--sparse', '--device', 'cpu', '--repeats',
                              '1', '--inner-steps', '2', *flags]))
  assert (one['world'], one['interleave']) == (1, 2)
  assert abs(got['final_loss'] - one['final_loss']) <= 1e-5 * one[
      'final_loss']


NODES = """
import os
keys = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE', 'GROUP_RANK',
        'HB_TORCH_RUN_CARD')
print('CHILD', ' '.join(os.environ[k] for k in keys), flush=True)
"""


@pytest.mark.timeout(120)
def test_nodes_lay_the_ranks_out_as_torchrun(tmp_path):
  """``--nodes 2`` of 4 ranks: nodes of 2 consecutive ranks, each child
  with torchrun's local rank, node size and node, and its own card."""
  out, _ = _launch(tmp_path, NODES, '--simulate', '4', '--nodes', '2',
                   '--device', 'cpu', '--timeout', '80')
  assert out.returncode == 0, out.stderr[-1000:]
  assert sorted(l for l in out.stdout.splitlines()
                if l.startswith('CHILD')) == [
                    'CHILD 0 4 0 2 0 0', 'CHILD 1 4 1 2 0 1',
                    'CHILD 2 4 0 2 1 2', 'CHILD 3 4 1 2 1 3']


@pytest.mark.timeout(120)
@pytest.mark.parametrize('nodes', ['2', '0'])
def test_nodes_that_do_not_divide_the_ranks_are_refused(tmp_path, nodes):
  out, _ = _launch(tmp_path, 'print("CHILD", flush=True)\n', '--simulate',
                   '3', '--nodes', nodes, '--device', 'cpu')
  assert out.returncode != 0
  assert f'--nodes {nodes} does not divide 3 ranks' in out.stderr
  assert 'CHILD' not in out.stdout


def _child_card(rank, nranks, nodes, backend, shared):
  """The card ``Context.join`` picks for a child of the launcher."""
  import torch
  from hybridbackend_tpu_torch import run
  from hybridbackend_tpu_torch.framework.context import card_of
  env = run.child_env(rank, nranks, nodes, backend, shared, 'store', 60.0)
  return card_of(torch.device('cuda'), backend, rank, env)


@pytest.mark.parametrize('rank', range(4))
def test_a_rank_of_a_simulated_node_keeps_its_own_card(rank):
  """The device rule: ``--nproc 4 --nodes 2`` gives ranks 1 and 3 one
  local rank, and each its own card, ``cuda:<rank>``; ``--simulate 4
  --nodes 2 --device cuda`` puts every rank on the shared card."""
  import torch
  assert _child_card(rank, 4, 2, 'nccl', None) == torch.device('cuda', rank)
  assert _child_card(rank, 4, 2, 'gloo', 'cuda:0') == torch.device('cuda', 0)


def test_the_card_rule_outside_the_launcher():
  """Without the launcher's card, a rank takes ``LOCAL_RANK`` (torchrun's,
  one machine a node), else its rank; a named card and the CPU are the
  caller's; NCCL refuses a shared card."""
  import torch
  from hybridbackend_tpu_torch.framework.context import card_of
  cuda = torch.device('cuda')
  assert card_of(cuda, 'nccl', 5, {'LOCAL_RANK': '1'}) == torch.device(
      'cuda', 1)
  assert card_of(cuda, 'nccl', 5, {}) == torch.device('cuda', 5)
  assert card_of(torch.device('cuda', 2), 'nccl', 5, {}) == torch.device(
      'cuda', 2)
  assert card_of(torch.device('cpu'), 'gloo', 5, {}) == torch.device('cpu')
  with pytest.raises(ValueError, match='NCCL refuses two ranks'):
    card_of(cuda, 'nccl', 0, {'HB_TORCH_RUN_SHARED_DEVICE': 'cuda:0'})
