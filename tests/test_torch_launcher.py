"""The port's launcher, ``python -m hybridbackend_tpu_torch.run``.

Counterpart of ``tests/test_launcher.py``: gloo CPU ranks
(``--simulate N --device cpu``) that all-reduce across the process
boundary, a failing rank that takes its peers down, a world past its
deadline, a collective whose peer never comes, and whole lines relayed
from every rank; then the train harness as a world of two. Every launch
has a ``subprocess`` deadline, so that a hang fails one test.
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
