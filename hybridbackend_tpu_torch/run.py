"""Launcher: ``python -m hybridbackend_tpu_torch.run [--nproc N |
--simulate N] [--nodes M] [--device cuda|cpu] [--timeout S] script.py |
-m module [args]``.

Counterpart of ``hybridbackend_tpu/run.py`` (after the reference's
``run.py:65-228``), which spawns one process per visible GPU. It starts
the ranks of one world on this machine, each a process of its own that
runs the script (or module) with its arguments:

* by default one NCCL rank per visible GPU (``--nproc N`` for fewer),
  rank ``r`` on ``cuda:<r>``;
* ``--simulate N``: N gloo ranks. With ``--device cpu`` they are CPU
  processes; with ``--device cuda`` (the default) all N share the one
  card, ``cuda:0``, which NCCL refuses. That mode checks correctness
  only: its times say nothing of NCCL or of a link between cards.

``--nodes M`` (M divides N; one by default) lays the N ranks out as M
nodes of N/M consecutive ranks, torchrun's layout, all on this machine:
the counterpart of the JAX launcher's ``--devices-per-process``, whose
processes are the mesh's ``dcn`` axis and their devices its ``ici``
axis. Each child finds ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (``r %
(N/M)``), ``LOCAL_WORLD_SIZE`` (N/M) and ``GROUP_RANK`` (its node, ``r //
(N/M)``) in its environment, with the rendezvous (a file store in a
temporary directory that the launcher owns and removes: it cannot race
for a TCP port), the backend, the shared card, the rank's own card and
the collectives' deadline, which
:meth:`~hybridbackend_tpu_torch.framework.context.Context.join` reads.
Two ranks of two simulated nodes share a local rank, so a rank's card is
not its ``LOCAL_RANK`` but its index among the launcher's processes,
``HB_TORCH_RUN_CARD`` (the rank itself): ``--nproc N --nodes M`` still
gives each rank a card of its own, and ``--simulate`` puts them all on
one (``framework/context.py``'s ``card_of``).
``OMP_NUM_THREADS`` is 1 unless the environment sets it, as torchrun
does.

The failure rules are the JAX launcher's (``run.py:140-190``): when a
child exits nonzero the others are killed and the launcher exits with
that child's code; a child dies with the launcher (``PR_SET_PDEATHSIG``);
each child's output is relayed a whole line at a time. ``--timeout``
bounds the launch: past it every child is killed and the launcher exits
124, so a deadlock cannot outlive its caller's deadline.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from hybridbackend_tpu_torch.framework.context import (
    BACKEND_ENV, CARD_ENV, SHARED_DEVICE_ENV, STORE_ENV, TIMEOUT_ENV)

TIMED_OUT = 124
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _die_with_parent():
  """Linux: SIGKILL this child when the launcher dies, so that a launcher
  killed before its clean-up leaves no rank behind."""
  try:
    import ctypes
    libc = ctypes.CDLL('libc.so.6', use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
  except OSError:
    pass


def _relay_lines(src, dst_fd: int) -> None:
  """Forward each complete line of a child's pipe with one ``os.write``:
  a write of at most PIPE_BUF (4096) bytes to a pipe is atomic, so lines
  of two ranks never interleave; a longer line goes in PIPE_BUF chunks.
  After a failed write (the reader went away) the rest is read and
  dropped, so that the child never blocks on a full pipe."""
  discard = False
  try:
    for line in iter(src.readline, b''):
      if discard:
        continue
      view = memoryview(line)
      while view:
        try:
          n = os.write(dst_fd, view[:4096])
        except OSError:
          discard = True
          break
        view = view[n:]
  except ValueError:  # the pipe was closed during shutdown
    pass
  finally:
    src.close()


_VALUED = ('--nproc', '--simulate', '--nodes', '--device', '--timeout',
           '--collective-timeout')


def _split(argv: List[str]):
  """The launcher's own flags, and the target: ``['-m', module, *args]``
  or ``[script, *args]``, whose flags are not the launcher's."""
  i = 0
  while i < len(argv):
    arg = argv[i]
    if arg == '-m':
      return argv[:i], argv[i:]
    if not arg.startswith('-'):
      return argv[:i], argv[i:]
    i += 2 if arg in _VALUED else 1
  return argv, []


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(
      prog='python -m hybridbackend_tpu_torch.run',
      usage='%(prog)s [--nproc N | --simulate N] [--nodes M] '
            '[--device cuda|cpu] [--timeout S] script.py | -m module [args]',
      description='Start the ranks of one world of the PyTorch port.')
  ranks = p.add_mutually_exclusive_group()
  ranks.add_argument('--nproc', type=int, default=0, metavar='N',
                     help='NCCL ranks, one per GPU (default: every '
                          'visible GPU)')
  ranks.add_argument('--simulate', type=int, default=0, metavar='N',
                     help='N gloo ranks: CPU processes, or with --device '
                          'cuda all on the one card cuda:0; this checks '
                          'correctness only, and its times say nothing '
                          'of NCCL or of links between cards')
  p.add_argument('--nodes', type=int, default=1, metavar='M',
                 help='lay the ranks out as M nodes of N/M consecutive '
                      'ranks, all on this machine (default 1; M must '
                      'divide N)')
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                 help="the ranks' device type (default cuda)")
  p.add_argument('--timeout', type=float, default=0.0, metavar='S',
                 help='kill every rank and exit 124 after S seconds '
                      '(default: no limit)')
  p.add_argument('--collective-timeout', type=float, default=300.0,
                 metavar='S', help='deadline of each collective; a rank '
                 'whose peers stopped raises after it (default 300)')
  argv = sys.argv[1:] if argv is None else list(argv)
  own, target = _split(argv)
  opts = p.parse_args(own)
  if not target or target == ['-m']:
    p.error('name a script or -m MODULE')
  opts.target = target
  return opts


def _world(opts: argparse.Namespace):
  """``(ranks, backend, shared card or None)``."""
  if opts.simulate:
    if opts.simulate < 1:
      raise SystemExit('--simulate needs at least one rank')
    return opts.simulate, 'gloo', ('cuda:0' if opts.device == 'cuda'
                                   else None)
  if opts.device == 'cpu':
    raise SystemExit('CPU ranks are simulated: pass --simulate N')
  import torch
  gpus = torch.cuda.device_count()
  n = opts.nproc or gpus
  if n < 1 or n > gpus:
    raise SystemExit(f'{n} NCCL ranks need as many GPUs; {gpus} visible '
                     '(pass --simulate N for gloo ranks)')
  return n, 'nccl', None


def child_env(rank: int, nranks: int, nodes: int, backend: str,
              shared: Optional[str], store: str,
              collective_timeout: float) -> Dict[str, str]:
  """The variables the launcher gives rank ``rank`` of ``nranks`` in
  ``nodes`` nodes (see the module docstring)."""
  local = nranks // nodes
  return {'RANK': str(rank), 'WORLD_SIZE': str(nranks),
          'LOCAL_RANK': str(rank % local), 'LOCAL_WORLD_SIZE': str(local),
          'GROUP_RANK': str(rank // local), CARD_ENV: str(rank),
          STORE_ENV: store, BACKEND_ENV: backend,
          SHARED_DEVICE_ENV: shared or '',
          TIMEOUT_ENV: str(collective_timeout), 'PYTHONUNBUFFERED': '1'}


def main(argv: Optional[List[str]] = None) -> int:
  opts = parse_args(argv)
  nranks, backend, shared = _world(opts)
  if opts.nodes < 1 or nranks % opts.nodes:
    raise SystemExit(f'--nodes {opts.nodes} does not divide {nranks} ranks')
  target = opts.target
  rundir = tempfile.mkdtemp(prefix='hbtpu_torch_run_')
  procs = []
  relays = []
  code = 0
  try:
    for rank in range(nranks):
      env = dict(os.environ)
      env.update(child_env(rank, nranks, opts.nodes, backend, shared,
                           os.path.join(rundir, 'store'),
                           opts.collective_timeout))
      env.setdefault('OMP_NUM_THREADS', '1')
      # The ranks import the port the launcher came from.
      env['PYTHONPATH'] = os.pathsep.join(
          p for p in (_ROOT, env.get('PYTHONPATH')) if p)
      procs.append(subprocess.Popen(
          [sys.executable, *target], env=env, stdout=subprocess.PIPE,
          stderr=subprocess.PIPE, preexec_fn=_die_with_parent))
      for src, dst in ((procs[-1].stdout, 1), (procs[-1].stderr, 2)):
        t = threading.Thread(target=_relay_lines, args=(src, dst),
                             daemon=True)
        t.start()
        relays.append(t)
    deadline = time.monotonic() + opts.timeout if opts.timeout else None
    live = list(procs)
    while live and code == 0:
      for p in list(live):
        rc = p.poll()
        if rc is not None:
          live.remove(p)
          # A child killed by a signal reports -signum.
          code = rc if rc >= 0 else 128 - rc
      if deadline is not None and time.monotonic() > deadline and live:
        print(f'hybridbackend_tpu_torch.run: {len(live)} of {nranks} '
              f'ranks still running after {opts.timeout} s; killing them',
              file=sys.stderr, flush=True)
        code = TIMED_OUT
      time.sleep(0.05)
  finally:
    for p in procs:
      if p.poll() is None:
        p.send_signal(signal.SIGTERM)
    stop = time.monotonic() + 10.0
    for p in procs:
      try:
        p.wait(timeout=max(0.1, stop - time.monotonic()))
      except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    for t in relays:
      t.join(timeout=5.0)
    shutil.rmtree(rundir, ignore_errors=True)
  return code


if __name__ == '__main__':
  sys.exit(main())
