#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py [--profile] [--tune]

It builds the port's CUDA kernels from ``hybridbackend_tpu_torch/ops/csrc``
(one nvcc per source, all at once) and drives the flagship sparse train
step, ``benchmarks/train_benchmark.py --sparse`` with its defaults: 26
tables of [100000, 16] stacked into one [2600000, 16] table, batch 8192
with 13 dense features, BCE loss, Adam 1e-3 on the tower, ids shifted by
one per step; with f32 tables, and then bf16 tables and slots (the JAX
harness's ``--table-dtype bfloat16``); in these variants:
  * DCNv2 (429x429 cross layer, MLP 1024-512-256-1) with row-sparse
    Adagrad 0.05 on the table, with and without duplicate combining;
  * DLRM (``--model dlrm``: bottom MLP 512-256, dot interaction of 27
    features of 16, top MLP 1024-512-1) with LazyAdam 0.05 on the table;
  * DCNv2 with the dense-split Adagrad update (``table_split_dense=True``,
    the JAX option ``emb_update_split_dense='on'``);
  * DCNv2 with bf16 matmul operands (the JAX harness's ``--bf16``).
Weights are random, drawn from a fixed seed. The config, its state and
step, the batch and the timing of a window of steps are the port's
harness's (``hybridbackend_tpu_torch/benchmarks/train_benchmark.py``), so
the timed phases and the harness time the same thing.

Phases; any failure raises and the script exits nonzero:
  0. the card (nvidia-smi), torch/CUDA/nvcc versions, pyarrow's version
     (or that it is absent), the kernel builds
     with ptxas's registers and spills, and the resident blocks per SM of
     the Adagrad and LazyAdam kernels at the flagship row width;
  1. each kernel against its plain PyTorch version on the card, at the
     flagship update list, with both times and, where one PyTorch call
     computes the same function, that call's time: Adagrad (both modes),
     the add kernel through ``sparse_sgd_apply``, LazyAdam, the dense row
     totals, the split-dense update against the fused one, the row gather
     (at the flagship lookup and at [100000, 128] x 16384) and the
     stochastic bf16 round of the flagship gradients; then the gather and
     the round once more through their entry points, with the launch
     counts read around them; then the Adagrad (both modes), add,
     LazyAdam and dense-totals kernels at full width on an edge list
     (runs across and longer than a tile), with the gradients and then
     the table and slots one float into their storage, against the plain
     versions on the CPU copy; then the bf16 storage mode of the Adagrad
     (both modes), LazyAdam and add kernels at the flagship list against
     their plain versions on the CPU copy (at most 1 bf16 ulp an element,
     the count that differ printed), with their times and bounds, the
     bf16 split-dense update bitwise against the fused one, and the bf16
     modes on edge lists (d = 16 aligned, gradients and then table and
     slots one bf16 into their storage; d = 5; rows too wide to stage);
  2. one full-width DCNv2 + Adagrad step on the GPU against the CPU;
  3. that step timed on the card; the Adagrad kernel must have been
     launched once per step;
  4. one full-width DCNv2 step with ``table_dedup=False``, GPU vs CPU;
  5. one full-width DLRM + LazyAdam step, GPU vs CPU;
  6. that step timed on the card; the LazyAdam kernel must have been
     launched once per step;
  7. one full-width DCNv2 step with the dense-split Adagrad update, GPU
     vs CPU; the dense row-totals kernel launched once, the fused
     Adagrad kernel never;
  8. that step timed on the card, with the same launch counts per step;
  9. one full-width DCNv2 + Adagrad step with bf16 tables, GPU vs CPU;
 10. that step timed; the Adagrad kernel launched once per step;
 11. one full-width DCNv2 + no-dedup Adagrad step with bf16 tables, GPU
     vs CPU;
 12. one full-width DLRM + LazyAdam step with bf16 tables, GPU vs CPU;
 13. that step timed; the LazyAdam kernel launched once per step;
 14. one full-width DCNv2 + split-dense Adagrad step with bf16 tables,
     GPU vs CPU;
 15. one full-width DCNv2 step with bf16 matmul operands, GPU vs CPU;
 16. one run of the port's harness, ``python -m
     hybridbackend_tpu_torch.benchmarks.train_benchmark --sparse
     --table-dtype bfloat16 --json``, whose JSON line is printed;
 17. the flagship DCNv2 + Adagrad through ``SparseTrainer``, as a user
     trains it: 64 steps of seeded Criteo-like host batches
     (``benchmarks/synthetic.py``) through ``DeviceIterator``, with a
     ``StepStatHook`` and a checkpoint every 32 steps; the Adagrad kernel
     launched once per step; then ``evaluate`` (4 batches of 8192 and one
     of 1000) on the card against the CPU's on the same parameters (AUC
     within a limit set by the predictions near a threshold), ``predict``,
     a fresh trainer's restore of step 64 and a resume from step 32, both
     bitwise equal to the live state; its synced ms/step beside the
     harness's bare step, the stall fraction and the AUC are printed;
     then 8 steps with LazyAdam tables (``table_optimizer='adam'``), the
     LazyAdam kernel launched once per step; then the loop timed in
     alternating rounds: the step alone on placed batches, ``train``
     with and without ``DeviceIterator`` from an in-memory source and
     from one that waits 4 ms a batch, and the two input paths alone;
 18. the dense-gradient ``Trainer`` at the flagship width (26 unstacked
     tables, ``multi_optimizer(Adagrad 0.05, Adam 1e-3)``): 3 steps on
     the card against the same 3 on the CPU (tables, accumulators, tower
     gradients and second moments across the devices; each device's
     tower weights against Adam's step from its own moments), then 33
     timed steps and one evaluation; no counted kernel runs;
 19. the harness in its dense mode (no ``--sparse``), its JSON line
     printed.
With ``--profile`` it then traces 10 steps of each timed variant with
``torch.profiler`` and prints device time per step by kernel class. With
``--tune`` phase 1 also times the add kernel over tile sizes, the
dense-totals kernel over block and chunk sizes, and the Adagrad (both
modes) and LazyAdam kernels over tile sizes and state batches (the rows
of how many run heads a thread loads before it waits for its tile's
gradients); each sweep forth and back.
The second-to-last line is a JSON object describing each kernel (its
times, launches on its path and in the trainers' runs, and its bound: the
larger of its bytes over 3.35 TB/s and its operations over the card's
peak rate); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it fails before printing
either.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hybridbackend_tpu_torch.benchmarks import synthetic
from hybridbackend_tpu_torch.benchmarks import train_benchmark as tb

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = 'hybridbackend_tpu_torch/ops/csrc'
PALLAS = 'hybridbackend_tpu/ops/pallas'
# name -> (source, TPU kernel it replaces)
KERNELS = {
    'adagrad_update_sorted': (f'{CSRC}/adagrad_update.cu',
                              f'{PALLAS}/scatter.py:534'),
    'adagrad_update_sorted[dedup=False]': (f'{CSRC}/adagrad_update.cu',
                                           f'{PALLAS}/scatter.py:534'),
    'scatter_add_sorted': (f'{CSRC}/scatter_add.cu',
                           f'{PALLAS}/scatter.py:429'),
    'adam_update_sorted': (f'{CSRC}/adam_update.cu',
                           f'{PALLAS}/scatter.py:749'),
    'gsum_dense_sorted': (f'{CSRC}/gsum_dense.cu',
                          f'{PALLAS}/scatter.py:677'),
    'gather_rows': (f'{CSRC}/gather_rows.cu', f'{PALLAS}/gather.py:51'),
    'stochastic_round_bf16': (f'{CSRC}/stochastic_round.cu',
                              f'{PALLAS}/cast.py:27'),
    # The bf16 storage mode of kernels 1-3: bf16 table, slots, gradients.
    'adagrad_update_sorted[bf16]': (f'{CSRC}/adagrad_update.cu',
                                    f'{PALLAS}/scatter.py:534'),
    'adagrad_update_sorted[bf16,dedup=False]': (f'{CSRC}/adagrad_update.cu',
                                                f'{PALLAS}/scatter.py:534'),
    'adam_update_sorted[bf16]': (f'{CSRC}/adam_update.cu',
                                 f'{PALLAS}/scatter.py:749'),
    'scatter_add_sorted[bf16]': (f'{CSRC}/scatter_add.cu',
                                 f'{PALLAS}/scatter.py:429'),
}
# The rows of the kernels that hold state rows in registers.
STATE_KERNELS = ('adagrad_update_sorted',
                 'adagrad_update_sorted[dedup=False]', 'adam_update_sorted',
                 'adagrad_update_sorted[bf16]',
                 'adagrad_update_sorted[bf16,dedup=False]',
                 'adam_update_sorted[bf16]')
# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores. Integer work (the Philox rounds) is counted at half
# the f32 rate, the SM's 64 INT32 lanes against 128 FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 2
L2_FLUSH_BYTES = 256 * 2**20


def flagship(*flags: str) -> argparse.Namespace:
  """The port's harness's flags for ``--sparse`` with its defaults (the
  JAX harness's) and ``flags``: the flagship config and its variants."""
  return tb.parse_args(['--sparse', *flags])


def _counts():
  import hybridbackend_tpu_torch as hbt
  return {name: getattr(hbt, name).launches for name in tb.COUNTED}


def _reset_counts():
  import hybridbackend_tpu_torch as hbt
  for name in tb.COUNTED:
    getattr(hbt, name).launches = 0


def _expect(label, counts, **want):
  """Fails unless ``counts`` are ``want`` and every other count is 0."""
  want = {name: want.get(name, 0) for name in tb.COUNTED}
  if counts != want:
    raise AssertionError(f'{label}: kernel launches {counts}, expected '
                         f'{want}')


def _bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
  """The least time the card could take: the larger of the bytes over the
  memory rate and the operations over the peak rate."""
  by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  by_ops = ops / ops_per_s * 1e3
  return dict(bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
              bound_by='bytes' if by_bytes >= by_ops else 'operations')


@functools.cache
def _l2_flush_buffer():
  return torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                     device=torch.device('cuda', torch.cuda.current_device()))


def _flush_l2():
  """Reads ``L2_FLUSH_BYTES`` (more than five times the 50 MB L2), so the
  next call finds none of its inputs in L2 and its last outputs have
  been written back, as a caller whose data is not the last one touched
  would. A read leaves clean lines, which cost the next call nothing to
  evict."""
  _l2_flush_buffer().sum()


def _median_ms(fn, iters=20, warmup=3, per=10, queued=True):
  """Device time of one call of ``fn``, by CUDA events: the median over
  ``iters`` runs of ``per`` calls, each call after an L2 flush
  (:func:`_flush_l2`) and between its own pair of events, so the flush
  is not timed.

  ``queued``: each run first holds the device with a spin kernel long
  enough for the host to enqueue all ``per`` calls behind it, so the
  events time the device's work and not the host's enqueue (a wrapper
  spends tens of microseconds in Python, as long as a small kernel
  runs). The spin is doubled until the first event is still pending when
  the last call has been enqueued; the ``per`` calls must launch fewer
  kernels than the device's queue holds (about a thousand). A function
  that waits for the device (the plain versions: boolean masks and
  ``unique`` read a count back) takes ``queued=False``: events around
  each call, host waits included."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _flush_l2()
  fn()
  hold_ms = 2 * per * (time.perf_counter() - t0) * 1e3 + 0.5
  calls = per if queued else 1
  times, runs = [], 0
  while runs < iters:
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    if queued:
      # At most 2 GHz, so 2e6 cycles last at least a millisecond.
      torch.cuda._sleep(int(2e6 * hold_ms))
    for start, end in events:
      _flush_l2()
      start.record()
      fn()
      end.record()
    held = not queued or not events[0][0].query()
    events[-1][1].synchronize()
    if held:
      times += [start.elapsed_time(end) for start, end in events]
      runs += 1
    elif hold_ms > 10_000:
      raise RuntimeError(f'the host did not enqueue {per} calls while the '
                         'device was held: a call waits for the device, or '
                         'they launch more kernels than its queue holds')
    else:
      hold_ms *= 2
  return statistics.median(times)


def _run(cmd):
  return subprocess.run(cmd, capture_output=True, text=True, check=True,
                        timeout=120).stdout.strip()


def phase0_environment():
  from hybridbackend_tpu_torch.ops import build
  smi = _run(['nvidia-smi', '--query-gpu=name,power.limit',
              '--format=csv,noheader']).splitlines()[0]
  print(smi)
  nvcc = _run([build.nvcc_path(), '--version']).splitlines()[-1]
  print(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda} nvcc: {nvcc}')
  try:
    import pyarrow
    print(f'pyarrow {pyarrow.__version__}')
  except ImportError:
    print('pyarrow: absent')
  t0 = time.perf_counter()
  libs = build.load_all()
  print(f'kernel builds: {time.perf_counter() - t0:.3f} s wall for '
        f'{len(libs)} libraries, built concurrently; each is built from and '
        f'hashed with {", ".join(h.name for h in build.headers())}')
  for name, lib in libs.items():
    print(f'  {name}: {lib.build_seconds:.3f} s nvcc ({lib.path.name})')
    for line in lib.compiler_log.splitlines():
      if 'registers' in line or 'spill' in line:
        print(f'    ptxas: {line.strip()}')
  from hybridbackend_tpu_torch.ops import scatter
  d = flagship().dim
  tile, batch = scatter.tile_entries(d), scatter.STATE_BATCH
  print(f'resident blocks per SM (256 threads each) at d = {d}, tiles of '
        f'{tile} entries, state batch {batch}: ' + ', '.join(
            f'{name} {_blocks_per_sm(name, d, tile, batch)}'
            for name in STATE_KERNELS))
  return smi


def _blocks_per_sm(name, d, tile, batch):
  """Blocks of ``name``'s 4-element-lane kernel that one SM holds at once
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
  from hybridbackend_tpu_torch.ops import build
  blocks = ctypes.c_int()
  bf16 = int('bf16' in name)
  if name.startswith('adagrad'):
    lib = build.load('adagrad_update').lib
    fn = lib.hb_adagrad_update_sorted_blocks_per_sm
    args = (d, tile, batch, int('dedup=False' not in name), bf16)
  else:
    fn = build.load('adam_update').lib.hb_adam_update_sorted_blocks_per_sm
    args = (d, tile, batch, bf16)
  fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
  fn.restype = ctypes.c_int
  err = fn(*args, ctypes.byref(blocks))
  if err:
    raise RuntimeError(f'{name}: occupancy query failed: CUDA error {err}')
  return blocks.value


def _update_list(cfg: argparse.Namespace, step: int,
                 rng: np.random.RandomState):
  """The stacked update list of one flagship step (ids drawn as in
  ``train_benchmark.py:147-167``), plus 1000 ``-1`` and 1000 ``>= V``
  rows, and N(0, 0.01) gradients."""
  base = [rng.randint(0, cfg.vocab, cfg.batch) for _ in range(cfg.tables)]
  ids = np.stack([(b + step) % cfg.vocab + t * cfg.vocab
                  for t, b in enumerate(base)], axis=1).reshape(-1)
  n, v = ids.shape[0], cfg.tables * cfg.vocab
  ids[rng.choice(n, 1000, replace=False)] = -1
  ids[rng.choice(n, 1000, replace=False)] = v + rng.randint(0, 5000, 1000)
  grads = (rng.randn(n, cfg.dim) * 0.01).astype(np.float32)
  return ids.astype(np.int32), grads


def _hold(name, state0, rows, kernel, plain, tol=1e-5):
  """Runs ``kernel`` and ``plain`` on copies of ``state0`` (table first,
  then slots), checks them against each other at ``rtol = atol = tol``,
  and checks that rows not in the list stay bitwise equal."""
  got = [t.clone() for t in state0]
  want = [t.clone() for t in state0]
  kernel(*got)
  plain(*want)
  torch.cuda.synchronize()
  err = max(float((g - w).abs().max()) for g, w in zip(got, want))
  for i, (g, w) in enumerate(zip(got, want)):
    if not torch.allclose(g, w, rtol=tol, atol=tol):
      raise AssertionError(f'{name}: operand {i} differs from the plain '
                           f'version (max abs err {err})')
  v = state0[0].shape[0]
  touched = torch.zeros(v, dtype=torch.bool, device=rows.device)
  touched[rows[(rows >= 0) & (rows < v)].long()] = True
  for g, before in zip(got, state0):
    if not torch.equal(g[~touched], before[~touched]):
      raise AssertionError(f'{name} changed rows the update list does '
                           'not hold')
  return err, got


def _against_bound(m):
  return (f'bound {m["bound_ms"]:.4f} ms ({m["bytes"] / 1e6:.2f} MB), '
          f'{m["ms"] / m["bound_ms"]:.2f}x it')


def phase1_kernels(cfg: argparse.Namespace, dev: torch.device,
                   tune: bool = False):
  import hybridbackend_tpu_torch as hbt
  v = cfg.tables * cfg.vocab
  rng = np.random.RandomState(tb.SEED)
  ids, grads = _update_list(cfg, 3, rng)
  rows, order = torch.sort(torch.from_numpy(ids).to(dev), stable=True)
  g = torch.from_numpy(grads).to(dev).index_select(0, order)
  gen = torch.Generator().manual_seed(tb.SEED)
  table0 = hbt.default_initializer(gen, (v, cfg.dim)).to(dev)
  acc0 = torch.full_like(table0, tb.ADAGRAD_INIT)
  # Moments as after some steps with N(0, 0.01) gradients.
  m0 = (torch.randn(v, cfg.dim, generator=gen) * 1e-3).to(dev)
  v0 = (torch.rand(v, cfg.dim, generator=gen) * 1e-4).to(dev)
  lr = torch.full((), tb.TABLE_LR, device=dev)
  step = torch.full((), 3.0, device=dev)
  n_touched = int(torch.unique(rows[(rows >= 0) & (rows < v)]).numel())
  print(f'phase 1: update list of {ids.shape[0]} rows, {n_touched} '
        f'distinct, on [{v}, {cfg.dim}] (rtol = atol = 1e-5 against the '
        'plain version on the card: f32 sums of duplicates in another '
        'order)')
  out = {}
  stacked = hbt.TableConfig('stack', v, cfg.dim)
  raw_ids = torch.from_numpy(ids).to(dev)
  raw_g = torch.from_numpy(grads).to(dev)
  # Bytes each kernel must move at this list: the list (rows and
  # gradients, n*(d+1)*4) read once, and each distinct row of the table
  # and of each slot read and written once.
  n, d, u = ids.shape[0], cfg.dim, n_touched
  list_bytes = n * (d + 1) * 4
  valid = (rows >= 0) & (rows < v)

  for name, dedup in (('adagrad_update_sorted', True),
                      ('adagrad_update_sorted[dedup=False]', False)):
    k = functools.partial(hbt.adagrad_update_sorted, rows=rows, updates=g,
                          lr=lr, dedup=dedup)
    p = functools.partial(hbt.adagrad_update_sorted_reference, rows=rows,
                          updates=g, lr=lr, dedup=dedup)
    err, (tk, ak) = _hold(name, (table0, acc0), rows, k, p)
    tr, ar = table0.clone(), acc0.clone()
    ms = _median_ms(lambda: k(tk, ak))
    plain_ms = _median_ms(lambda: p(tr, ar), queued=False)
    st = hbt.init_adagrad_state(tk)
    path_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
        tk, st, raw_ids, raw_g, stacked, lr, dedup=dedup))
    # Sums of the list, then per distinct element a square, an add, a
    # root, an add, a product, a quotient and a difference (dedup=False
    # squares each occurrence instead).
    ops = n * d * (1 if dedup else 3) + 7 * u * d
    out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, path_ms=path_ms,
                     **_bound(list_bytes + 4 * u * d * 4, ops))
    print(f'  {name}: max abs err {err:.3e}; kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms; sort+gather+kernel {path_ms:.4f} ms; '
          + _against_bound(out[name]))

  # The add kernel, as sparse_sgd_apply drives it: -lr·g summed per row.
  scaled = g * -tb.TABLE_LR
  err, (tk,) = _hold('scatter_add_sorted', (table0,), rows,
                     lambda t: hbt.scatter_add_sorted(t, rows, scaled),
                     lambda t: hbt.scatter_add_sorted_reference(
                         t, rows, scaled))
  tr = table0.clone()
  ms = _median_ms(lambda: hbt.scatter_add_sorted(tk, rows, scaled))
  plain_ms = _median_ms(
      lambda: hbt.scatter_add_sorted_reference(tr, rows, scaled),
      queued=False)
  # One PyTorch call computes the same function: index_add_ of the valid
  # entries (atomics, in no fixed order).
  valid_rows, valid_scaled = rows[valid].long(), scaled[valid]
  library_ms = _median_ms(
      lambda: tr.index_add_(0, valid_rows, valid_scaled))
  # The entry point, checked against the plain version of its list with
  # the launch counts read around it, then timed.
  ts = table0.clone()
  _reset_counts()
  hbt.sparse_sgd_apply(ts, raw_ids, raw_g, stacked, tb.TABLE_LR)
  torch.cuda.synchronize()
  _expect('sparse_sgd_apply', _counts(), scatter_add_sorted=1)
  launches = 1
  want = hbt.scatter_add_sorted_reference(table0.clone(), rows, scaled)
  if not torch.allclose(ts, want, rtol=1e-5, atol=1e-5):
    raise AssertionError('sparse_sgd_apply differs from the plain version')
  path_ms = _median_ms(lambda: hbt.sparse_sgd_apply(
      ts, raw_ids, raw_g, stacked, tb.TABLE_LR), iters=10)
  out['scatter_add_sorted'] = dict(
      max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
      launches=launches, path_ms=path_ms,
      **_bound(list_bytes + 2 * u * d * 4, n * d + u * d))
  print(f'  scatter_add_sorted: max abs err {err:.3e}; kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; '
        f'sparse_sgd_apply {path_ms:.4f} ms, {launches} launch a call')

  k = functools.partial(hbt.adam_update_sorted, rows=rows, updates=g,
                        lr=lr, step=step)
  p = functools.partial(hbt.adam_update_sorted_reference, rows=rows,
                        updates=g, lr=lr, step=step)
  err, (tk, mk, vk) = _hold('adam_update_sorted', (table0, m0, v0), rows,
                            k, p)
  tr, mr, vr = table0.clone(), m0.clone(), v0.clone()
  ms = _median_ms(lambda: k(tk, mk, vk))
  plain_ms = _median_ms(lambda: p(tr, mr, vr), queued=False)
  st = hbt.SparseOptState(acc=(mk, vk))
  path_ms = _median_ms(lambda: hbt.sparse_adam_apply(
      tk, st, raw_ids, raw_g, stacked, lr, step))
  # Per distinct element about 15 operations (two moments, two bias
  # corrections, a root, the step).
  out['adam_update_sorted'] = dict(
      max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
      path_ms=path_ms, **_bound(list_bytes + 6 * u * d * 4,
                                n * d + 15 * u * d))
  print(f'  adam_update_sorted: max abs err {err:.3e}; kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms; sort+gather+kernel {path_ms:.4f} ms; '
        + _against_bound(out['adam_update_sorted']))

  inputs = dict(rows=rows, g=g, valid=valid, table0=table0, acc0=acc0,
                m0=m0, v0=v0, raw_ids=raw_ids, raw_g=raw_g, stacked=stacked,
                lr=lr, step=step)
  out.update(phase1_gsum(cfg, dev, inputs, out['adagrad_update_sorted']))
  out.update(phase1_gather(cfg, dev, inputs))
  out.update(phase1_round(cfg, dev, inputs))
  phase1_edges(cfg, dev, inputs)
  out.update(phase1_bf16(cfg, dev, inputs))
  phase1_edges_bf16(cfg, dev, inputs)
  if tune:
    phase1_tune(cfg, dev, inputs)
  return out


def _at_offset(t, k, dev):
  """A copy of ``t`` on ``dev`` that starts ``k`` floats into its
  storage."""
  flat = torch.empty(t.numel() + k, dtype=t.dtype, device=dev)
  flat[k:].copy_(t.reshape(-1))
  return flat[k:].view(t.shape)


def phase1_edges(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernels 1 (both modes), 2, 3 and 4 at full width on a list built to
  hit the edges of their tiles (all four cut the list by
  ``scatter.tile_entries``), against the plain versions on the CPU copy
  (which add a run in list order, as the kernels do; atomics on the card
  do not); aligned, with the gradients one float into their storage, and
  with the table and slots one float into theirs."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import scatter
  v, d = inp['table0'].shape
  tile = scatter.tile_entries(d)
  n = 40 * tile + 1                           # one more than whole tiles
  rng = np.random.RandomState(tb.SEED + 7)
  rows = np.sort(rng.randint(0, v, n))
  rows[tile - 3:tile + 3] = rows[tile - 3]    # a run across a boundary
  start = 5 * tile + tile // 2                # a run longer than a tile
  rows[start:start + 3 * tile + 5] = rows[start]
  # 5 tiles of entries on 300 neighbouring rows: one block's slice of
  # kernel 4 spans several chunks.
  start = 20 * tile
  rows[start:start + 5 * tile] = rows[start] + np.sort(
      rng.randint(0, 300, 5 * tile))
  rows[:7], rows[-9:] = -1, v + 2
  assert (np.diff(rows) >= 0).all()
  rows = torch.from_numpy(rows.astype(np.int32))
  g = torch.from_numpy(rng.randn(n, d).astype(np.float32))
  lr, step = tb.TABLE_LR, 3
  state = {k: inp[k].cpu() for k in ('table0', 'acc0', 'm0', 'v0')}
  # name -> (kernel, plain version, state it updates)
  kernels = {
      'adagrad_update_sorted': (
          lambda t, a, r, u: hbt.adagrad_update_sorted(t, a, r, u, lr),
          lambda t, a, r, u: hbt.adagrad_update_sorted_reference(
              t, a, r, u, lr), ('table0', 'acc0')),
      'adagrad_update_sorted[dedup=False]': (
          lambda t, a, r, u: hbt.adagrad_update_sorted(t, a, r, u, lr,
                                                       dedup=False),
          lambda t, a, r, u: hbt.adagrad_update_sorted_reference(
              t, a, r, u, lr, dedup=False), ('table0', 'acc0')),
      'scatter_add_sorted': (hbt.scatter_add_sorted,
                             hbt.scatter_add_sorted_reference, ('table0',)),
      'adam_update_sorted': (
          lambda t, m, vv, r, u: hbt.adam_update_sorted(t, m, vv, r, u, lr,
                                                        step),
          lambda t, m, vv, r, u: hbt.adam_update_sorted_reference(
              t, m, vv, r, u, lr, step), ('table0', 'm0', 'v0')),
  }
  wants = {}
  for name, (_, plain, keys) in kernels.items():
    wants[name] = [state[k].clone() for k in keys]
    plain(*wants[name], rows, g)
  want_sum = hbt.gsum_dense_sorted_reference(rows, g, v)
  untouched = torch.ones(v, dtype=torch.bool)
  untouched[rows[(rows >= 0) & (rows < v)].long()] = False
  errs = collections.defaultdict(float)
  for label, g_shift, state_shift in (
      ('aligned', 0, 0), ('gradients one float into their storage', 1, 0),
      ('table and slots one float into theirs', 0, 1)):
    g_dev, rows_dev = _at_offset(g, g_shift, dev), rows.to(dev)
    for name, (kernel, _, keys) in kernels.items():
      got = [_at_offset(state[k], state_shift, dev) for k in keys]
      kernel(*got, rows_dev, g_dev)
      for key, x, want in zip(keys, got, wants[name]):
        x = x.cpu()
        if not torch.allclose(x, want, rtol=1e-5, atol=1e-5):
          raise AssertionError(f'{name} on the edge list ({label}): {key} '
                               'differs from the plain version')
        if not torch.equal(x[untouched], state[key][untouched]):
          raise AssertionError(f'{name} on the edge list ({label}) changed '
                               f'rows of {key} the list does not hold')
        errs[name] = max(errs[name], float((x - want).abs().max()))
      del got
    if not torch.equal(hbt.gsum_dense_sorted(rows_dev, g_dev, v).cpu(),
                       want_sum):
      raise AssertionError(f'gsum_dense_sorted on the edge list ({label}) '
                           'is not bitwise the plain version')
  print(f'  edge list of {n} rows (40 tiles of {tile} and one entry; a run '
        f'across a tile boundary, a run of {3 * tile + 5}, {5 * tile} entries '
        'on 300 neighbouring rows; aligned, gradients one float into their '
        f'storage, table and slots one float into theirs) on [{v}, {d}], '
        'max abs err against the plain version on the CPU (rtol = atol = '
        '1e-5), untouched rows of every array bitwise: '
        + ', '.join(f'{name} {e:.3e}' for name, e in errs.items())
        + '; gsum_dense_sorted bitwise equal')


def _ulps_apart(got, want):
  """Per element, how many bf16 values lie between two bf16 tensors: the
  sign-magnitude bits mapped onto one integer line."""
  def line(x):
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7fff), bits)
  return (line(got) - line(want)).abs()


def _within_an_ulp(label, got, want, atol=1e-6, share=0.01, moved=None,
                   moved_atol=0.0):
  """Fails unless every element of the bf16 ``got`` is at most 1 bf16 ulp
  from ``want`` or within ``atol`` of it (a result that cancels to near 0
  keeps the f32 order error of its terms, where a bf16 ulp is far
  smaller), or, where the mask ``moved`` is set (an input of the element
  moved by more than its rounding), within ``moved_atol``; and at most
  ``share`` of them differ at all. Returns ``(elements that differ, max
  abs difference)``."""
  got, want = got.cpu(), want.cpu()
  ulps = _ulps_apart(got, want)
  diff = (got.float() - want.float()).abs()
  far = (ulps > 1) & (diff > atol)
  if moved is not None:
    far &= ~(moved & (diff <= moved_atol))
  differ = int((ulps > 0).sum())
  if bool(far.any()) or differ > share * ulps.numel():
    raise AssertionError(
        f'{label}: {int(far.sum())} elements more than 1 bf16 ulp and '
        f'{atol} apart, {differ} of {ulps.numel()} differ (max abs '
        f'{float(diff.max())})')
  return differ, float(diff.max())


def phase1_bf16(cfg: argparse.Namespace, dev: torch.device, inp):
  """The bf16 storage mode of kernels 1 (both modes), 3 and 2 at the
  flagship update list: table, slots and gradients rounded to bf16; each
  kernel against its plain version on the CPU copy (the same f32 math in
  the same order, rounded once: at most 1 bf16 ulp, ``_within_an_ulp``),
  untouched rows bitwise; then timed with its plain version on the card;
  then the split-dense update against the fused one on bf16 state,
  through the entry point, bitwise."""
  import hybridbackend_tpu_torch as hbt
  rows, g, valid = inp['rows'], inp['g'].bfloat16(), inp['valid']
  v, d = inp['table0'].shape
  n, u = rows.shape[0], int(torch.unique(rows[valid]).numel())
  lr, step = inp['lr'], inp['step']
  bf = {k: inp[k].bfloat16() for k in ('table0', 'acc0', 'm0', 'v0')}
  cpu = {k: t.cpu() for k, t in bf.items()}
  rows_c, g_c = rows.cpu(), g.cpu()
  untouched = torch.ones(v, dtype=torch.bool)
  untouched[rows_c[valid.cpu()].long()] = False
  # Bytes: the list (rows, then 2-byte gradients) read once; each distinct
  # row of the table and of each slot (2 bytes an element) read and
  # written once.
  list_bytes = n * 4 + n * d * 2
  raw_g = inp['raw_g'].bfloat16()
  print(f'phase 1, bf16 storage: the flagship list ({n} rows, {u} distinct, '
        f'gradients rounded to bf16) on [{v}, {d}] bf16 table and slots; '
        'each kernel against its plain version on the CPU copy: at most 1 '
        'bf16 ulp an element (or 1e-6 where a result cancels to near 0), '
        'at most 1% of the elements apart, untouched rows bitwise')
  # name -> (wrapper call, plain version, state keys, operations, path);
  # the plain versions run on the CPU copy and on the card, and take lr
  # and step on their state's device.
  def adagrad(dedup):
    return (lambda t, a, r, x: hbt.adagrad_update_sorted(t, a, r, x, lr,
                                                         dedup=dedup),
            lambda t, a, r, x: hbt.adagrad_update_sorted_reference(
                t, a, r, x, lr.to(t.device), dedup=dedup),
            ('table0', 'acc0'),
            n * d * (1 if dedup else 3) + 7 * u * d,
            lambda t, a: hbt.sparse_adagrad_apply(
                t, hbt.SparseOptState(acc=(a,)), inp['raw_ids'], raw_g,
                inp['stacked'], lr, dedup=dedup))
  kernels = {
      'adagrad_update_sorted[bf16]': adagrad(True),
      'adagrad_update_sorted[bf16,dedup=False]': adagrad(False),
      'adam_update_sorted[bf16]': (
          lambda t, m, w, r, x: hbt.adam_update_sorted(t, m, w, r, x, lr,
                                                       step),
          lambda t, m, w, r, x: hbt.adam_update_sorted_reference(
              t, m, w, r, x, lr.to(t.device), step.to(t.device)),
          ('table0', 'm0', 'v0'),
          n * d + 15 * u * d,
          lambda t, m, w: hbt.sparse_adam_apply(
              t, hbt.SparseOptState(acc=(m, w)), inp['raw_ids'], raw_g,
              inp['stacked'], lr, step)),
      'scatter_add_sorted[bf16]': (
          hbt.scatter_add_sorted, hbt.scatter_add_sorted_reference,
          ('table0',), n * d + u * d, None),
  }
  out = {}
  for name, (kernel, plain, keys, ops, path) in kernels.items():
    x = g * -tb.TABLE_LR if name.startswith('scatter') else g
    got = [bf[k].clone() for k in keys]
    kernel(*got, rows, x)
    want = [cpu[k].clone() for k in keys]
    plain(*want, rows_c, x.cpu())
    torch.cuda.synchronize()
    differ, err = 0, 0.0
    for key, a, w in zip(keys, got, want):
      k_differ, k_err = _within_an_ulp(f'{name} {key}', a, w)
      differ, err = differ + k_differ, max(err, k_err)
      if not torch.equal(a.cpu()[untouched], cpu[key][untouched]):
        raise AssertionError(f'{name} changed rows of {key} the list does '
                             'not hold')
    ms = _median_ms(lambda: kernel(*got, rows, x))
    ref = [bf[k].clone() for k in keys]
    plain_ms = _median_ms(lambda: plain(*ref, rows, x), queued=False)
    row = dict(max_abs_err=err, elements_differ=differ, ms=ms,
               plain_ms=plain_ms, library_ms=None,
               **_bound(list_bytes + 2 * len(keys) * u * d * 2, ops))
    extra = ''
    if path is not None:
      row['path_ms'] = _median_ms(lambda: path(*got))
      extra = f'; sort+gather+kernel {row["path_ms"]:.4f} ms'
    else:
      # The entry point, with the launch counts read around it.
      ts = bf['table0'].clone()
      _reset_counts()
      hbt.sparse_sgd_apply(ts, inp['raw_ids'], raw_g, inp['stacked'],
                           tb.TABLE_LR)
      torch.cuda.synchronize()
      _expect('sparse_sgd_apply on a bf16 table', _counts(),
              scatter_add_sorted=1)
      row['launches'] = 1
      _within_an_ulp('sparse_sgd_apply on a bf16 table', ts,
                     hbt.scatter_add_sorted_reference(
                         cpu['table0'].clone(), rows_c, x.cpu()))
      extra = '; sparse_sgd_apply 1 launch a call'
    out[name] = row
    print(f'  {name}: {differ} elements differ from the plain version (max '
          f'abs {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms'
          f'{extra}; ' + _against_bound(row))

  # The split-dense update against the fused one on bf16 state: the same
  # f32 totals and apply, rounded once; bitwise.
  args = (inp['raw_ids'], raw_g, inp['stacked'], lr)
  fused_t, split_t = bf['table0'].clone(), bf['table0'].clone()
  fused_s = hbt.SparseOptState(acc=(bf['acc0'].clone(),))
  split_s = hbt.SparseOptState(acc=(bf['acc0'].clone(),))
  hbt.sparse_adagrad_apply(fused_t, fused_s, *args)
  hbt.sparse_adagrad_apply(split_t, split_s, *args, split_dense=True)
  torch.cuda.synchronize()
  bitwise = (torch.equal(split_t, fused_t)
             and torch.equal(split_s.acc[0], fused_s.acc[0]))
  if not bitwise:
    raise AssertionError('the bf16 split-dense update differs from the fused '
                         f'one in {int((split_t != fused_t).sum())} table and '
                         f'{int((split_s.acc[0] != fused_s.acc[0]).sum())} '
                         'acc elements')
  split_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
      split_t, split_s, *args, split_dense=True), iters=10)
  out['adagrad_update_sorted[bf16]']['split_bitwise'] = bitwise
  print(f'  split-dense update vs fused on bf16 state: bitwise equal: '
        f'{bitwise}; update path split {split_ms:.4f} ms, fused '
        f'{out["adagrad_update_sorted[bf16]"]["path_ms"]:.4f} ms')
  return out


def _edge_list(v, d, n_tiles, seed):
  """A sorted list of ``n_tiles`` tiles of ``scatter.tile_entries(d)``
  and one entry on ``[v, d]``: a run across a tile boundary, a run longer
  than a tile, 5 tiles of entries on 300 neighbouring rows, 7 ``-1`` and
  9 ``>= v`` entries; rows and N(0, 1) f32 gradients on the CPU."""
  from hybridbackend_tpu_torch.ops import scatter
  tile = scatter.tile_entries(d)
  n = n_tiles * tile + 1
  rng = np.random.RandomState(seed)
  rows = np.sort(rng.randint(0, v, n))
  rows[tile - 3:tile + 3] = rows[tile - 3]    # a run across a boundary
  start = 5 * tile + tile // 2                # a run longer than a tile
  rows[start:start + 3 * tile + 5] = rows[start]
  start = 20 * tile
  rows[start:start + 5 * tile] = rows[start] + np.sort(
      rng.randint(0, 300, 5 * tile))
  rows[:7], rows[-9:] = -1, v + 2
  assert (np.diff(rows) >= 0).all()
  return (torch.from_numpy(rows.astype(np.int32)),
          torch.from_numpy(rng.randn(n, d).astype(np.float32)), tile)


def phase1_edges_bf16(cfg: argparse.Namespace, dev: torch.device, inp):
  """The bf16 modes of kernels 1 (both modes), 2 and 3 on edge lists
  against the plain versions on the CPU copy: the full-width edge list at
  d = 16 (16-byte rows of 8-byte lanes, gradients staged) aligned, with
  the gradients one bf16 into their storage (8-byte lanes, plain loads)
  and with the table and slots one bf16 into theirs (scalar lanes); an
  edge list at d = 5 (scalar lanes, plain loads); and rows of 8192 bf16,
  whose 16-entry tile is too wide to stage."""
  import hybridbackend_tpu_torch as hbt
  lr, step = tb.TABLE_LR, 3
  kernels = {
      'adagrad_update_sorted[bf16]': (
          lambda t, a, r, x: hbt.adagrad_update_sorted(t, a, r, x, lr), 2),
      'adagrad_update_sorted[bf16,dedup=False]': (
          lambda t, a, r, x: hbt.adagrad_update_sorted(t, a, r, x, lr,
                                                       dedup=False), 2),
      'scatter_add_sorted[bf16]': (hbt.scatter_add_sorted, 1),
      'adam_update_sorted[bf16]': (
          lambda t, m, w, r, x: hbt.adam_update_sorted(t, m, w, r, x, lr,
                                                       step), 3),
  }
  gen = torch.Generator().manual_seed(tb.SEED + 8)
  v, d = inp['table0'].shape
  flagship = {k: inp[k].cpu().bfloat16() for k in ('table0', 'acc0', 'm0',
                                                    'v0')}
  rows, g, tile = _edge_list(v, d, 40, tb.SEED + 7)
  cases = [(f'd = {d} aligned', rows, g.bfloat16(), flagship, 0, 0),
           (f'd = {d}, gradients one bf16 into their storage', rows,
            g.bfloat16(), flagship, 1, 0),
           (f'd = {d}, table and slots one bf16 into theirs', rows,
            g.bfloat16(), flagship, 0, 1)]
  for label, vv, dd in (('d = 5', 100_000, 5),
                        ('rows of 8192, too wide to stage', 64, 8192)):
    if dd == 5:
      r, x, _ = _edge_list(vv, dd, 40, tb.SEED + dd)
    else:
      r = torch.randint(-1, vv + 2, (40,), generator=gen,
                        dtype=torch.int32).sort().values
      x = torch.randn(40, dd, generator=gen)
    state = {'table0': torch.rand(vv, dd, generator=gen) - 0.5,
             'acc0': torch.full((vv, dd), 0.1),
             'm0': torch.randn(vv, dd, generator=gen) * 1e-3,
             'v0': torch.rand(vv, dd, generator=gen) * 1e-4}
    cases.append((label, r, x.bfloat16(), {k: t.bfloat16()
                                           for k, t in state.items()}, 0, 0))
  keys = ('table0', 'acc0', 'm0', 'v0')
  counts = collections.defaultdict(int)
  for label, r, x, state, g_shift, state_shift in cases:
    vv = state['table0'].shape[0]
    untouched = torch.ones(vv, dtype=torch.bool)
    untouched[r[(r >= 0) & (r < vv)].long()] = False
    x_dev, r_dev = _at_offset(x, g_shift, dev), r.to(dev)
    for name, (kernel, arrays) in kernels.items():
      use = (keys[0],) + (keys[1:2] if arrays == 2 else keys[2:4]
                          if arrays == 3 else ())
      got = [_at_offset(state[k], state_shift, dev) for k in use]
      want = [state[k].clone() for k in use]
      kernel(*got, r_dev, x_dev)
      kernel(*want, r, x)
      for key, a, w in zip(use, got, want):
        differ, _ = _within_an_ulp(f'{name} on the edge list ({label}) {key}',
                                   a, w)
        counts[name] += differ
        if not torch.equal(a.cpu()[untouched], state[key][untouched]):
          raise AssertionError(f'{name} on the edge list ({label}) changed '
                               f'rows of {key} the list does not hold')
      del got
  print(f'  bf16 edge lists ({"; ".join(c[0] for c in cases)}; the first '
        f'three of {rows.shape[0]} rows, 40 tiles of {tile} and one entry), '
        'against the plain versions on the CPU, at most 1 bf16 ulp, '
        'untouched rows bitwise; elements that differ over all of them: '
        + ', '.join(f'{name} {c}' for name, c in counts.items()))


def phase1_tune(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernel 2 over tile sizes, kernel 4 over block and chunk sizes, and
  kernels 1 (both modes) and 3 over tile sizes and state batches, at the
  flagship list; each sweep forth and back."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch.ops import scatter
  rows, g = inp['rows'], inp['g']
  v, d = inp['table0'].shape
  table = inp['table0'].clone()
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  saved = (scatter.TILE_ENTRIES, scatter.TILE_BYTES,
           scatter.GSUM_BLOCK_BYTES, scatter.GSUM_CHUNK_ENTRIES)
  tiles = (64, 128, 256, 512, 1024)
  for tile in tiles + tiles[::-1]:
    scatter.TILE_ENTRIES, scatter.TILE_BYTES = tile, tile * 4 * d
    ms = _median_ms(lambda: hbt.scatter_add_sorted(table, rows, g))
    print(f'  tune scatter_add_sorted: tile {scatter.tile_entries(d)} '
          f'entries: {ms:.4f} ms')
  scatter.TILE_BYTES = saved[1]
  blocks = (512, 1024, 2048, 4096, 8192)
  for chunk in (512, 256, 256, 512):
    for block in blocks if chunk == 512 else blocks[::-1]:
      scatter.GSUM_BLOCK_BYTES, scatter.GSUM_CHUNK_ENTRIES = (block * 4 * d,
                                                              chunk)
      block_rows, chunk_entries = scatter.gsum_blocking(v, d, sms)
      ms = _median_ms(lambda: hbt.gsum_dense_sorted(rows, g, v))
      print(f'  tune gsum_dense_sorted: about {block} rows a block: '
            f'{-(-v // block_rows)} blocks of {block_rows} rows on {sms} '
            f'SMs, chunks of {chunk_entries} entries: {ms:.4f} ms')
  (scatter.TILE_ENTRIES, scatter.TILE_BYTES, scatter.GSUM_BLOCK_BYTES,
   scatter.GSUM_CHUNK_ENTRIES) = saved
  lr, step = inp['lr'], inp['step']
  acc, m, vv = inp['acc0'].clone(), inp['m0'].clone(), inp['v0'].clone()
  calls = {
      'adagrad_update_sorted': lambda: hbt.adagrad_update_sorted(
          table, acc, rows, g, lr),
      'adagrad_update_sorted[dedup=False]': lambda: hbt.adagrad_update_sorted(
          table, acc, rows, g, lr, dedup=False),
      'adam_update_sorted': lambda: hbt.adam_update_sorted(
          table, m, vv, rows, g, lr, step)}
  saved = (scatter.TILE_ENTRIES, scatter.TILE_BYTES, scatter.STATE_BATCH)
  sweep = [(tile, batch) for tile in (64, 128, 256, 512)
           for batch in (1, 2, 4, 8)]
  for name, call in calls.items():
    for tile, batch in sweep + sweep[::-1]:
      scatter.TILE_ENTRIES, scatter.TILE_BYTES = tile, tile * 4 * d
      scatter.STATE_BATCH = batch
      ms = _median_ms(call)
      print(f'  tune {name}: tile {tile} entries, state batch {batch} '
            f'({_blocks_per_sm(name, d, tile, batch)} blocks per SM): '
            f'{ms:.4f} ms')
  scatter.TILE_ENTRIES, scatter.TILE_BYTES, scatter.STATE_BATCH = saved


def phase1_gsum(cfg: argparse.Namespace, dev: torch.device, inp, fused):
  """Kernel 4 against its plain version, and the split-dense update
  against the fused one, at the flagship update list."""
  import hybridbackend_tpu_torch as hbt
  rows, g, valid = inp['rows'], inp['g'], inp['valid']
  v, d, n = inp['table0'].shape[0], cfg.dim, rows.shape[0]
  got = hbt.gsum_dense_sorted(rows, g, v)
  want = hbt.gsum_dense_sorted_reference(rows, g, v)
  torch.cuda.synchronize()
  err = float((got - want).abs().max())
  if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
    raise AssertionError(f'gsum_dense_sorted differs from the plain '
                         f'version (max abs err {err})')
  touched = torch.zeros(v, dtype=torch.bool, device=dev)
  touched[rows[valid].long()] = True
  if bool(got[~touched].any()):
    raise AssertionError('gsum_dense_sorted: an untouched row is not 0')
  ms = _median_ms(lambda: hbt.gsum_dense_sorted(rows, g, v))
  plain_ms = _median_ms(
      lambda: hbt.gsum_dense_sorted_reference(rows, g, v), queued=False)
  # One PyTorch call: zeros, then index_add_ of the valid entries.
  valid_rows, valid_g = rows[valid].long(), g[valid]
  library_ms = _median_ms(lambda: torch.zeros(v, d, device=dev).index_add_(
      0, valid_rows, valid_g))
  # The list read once, the dense output written once; one add per entry.
  bound = _bound(n * (d + 1) * 4 + v * d * 4, n * d)
  print(f'  gsum_dense_sorted: max abs err {err:.3e} (rtol = atol = 1e-5), '
        f'untouched rows exactly 0; kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, zeros + index_add_ {library_ms:.4f} ms; '
        f'bound {bound["bound_ms"]:.4f} ms ({bound["bytes"] / 1e6:.2f} MB)')

  # The split-dense update against the fused one, through the entry
  # point, on the same list. Both round every operation the same way
  # (explicit rounding in the kernel, one op per pass in torch), so they
  # should agree bit for bit; held to 1e-6.
  args = (inp['raw_ids'], inp['raw_g'], inp['stacked'], inp['lr'])
  fused_t, split_t = inp['table0'].clone(), inp['table0'].clone()
  fused_s = hbt.SparseOptState(acc=(inp['acc0'].clone(),))
  split_s = hbt.SparseOptState(acc=(inp['acc0'].clone(),))
  hbt.sparse_adagrad_apply(fused_t, fused_s, *args)
  hbt.sparse_adagrad_apply(split_t, split_s, *args, split_dense=True)
  torch.cuda.synchronize()
  split_err = max(float((split_t - fused_t).abs().max()),
                  float((split_s.acc[0] - fused_s.acc[0]).abs().max()))
  bitwise = (torch.equal(split_t, fused_t)
             and torch.equal(split_s.acc[0], fused_s.acc[0]))
  if split_err > 1e-6:
    raise AssertionError(f'split-dense update differs from the fused one '
                         f'by {split_err}')
  why = '' if bitwise else (
      f'; {int((split_t != fused_t).sum())} table and '
      f'{int((split_s.acc[0] != fused_s.acc[0]).sum())} acc elements differ '
      'in the last bits')
  torch.cuda.reset_peak_memory_stats(dev)
  base = torch.cuda.memory_allocated(dev)
  split_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
      split_t, split_s, *args, split_dense=True), iters=10)
  extra = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
  # The least a fused split apply could move: read table, acc and gsum,
  # write table and acc, plus kernel 4's own bytes.
  split_bound = _bound(5 * v * d * 4 + bound['bytes'], n * d + 7 * v * d)
  print(f'  split-dense update vs fused: max abs diff {split_err:.3e}, '
        f'bitwise equal: {bitwise}{why}; update path split '
        f'{split_ms:.4f} ms (bound {split_bound["bound_ms"]:.4f} ms), '
        f'fused {fused["path_ms"]:.4f} ms; split peak {extra:.1f} MiB '
        'above its inputs')
  return {'gsum_dense_sorted': dict(
      max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
      split_path_ms=split_ms, split_bitwise=bitwise, split_max_diff=split_err,
      **bound)}


def phase1_gather(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernel 5 bitwise against its plain version at the flagship lookup
  (the update list's ids, -1 and >= V among them, into the stacked
  table) and at the TPU kernel's measured shape, [100000, 128] f32 with
  16384 random ids; then once more with the counts read around it."""
  import hybridbackend_tpu_torch as hbt
  gen = torch.Generator().manual_seed(tb.SEED + 5)
  wide = torch.rand(100_000, 128, generator=gen).to(dev)
  wide_ids = torch.randint(0, 100_000, (16384,), generator=gen,
                           dtype=torch.int32).to(dev)
  res = {}
  for label, table, ids in (('flagship lookup', inp['table0'],
                             inp['raw_ids']),
                            ('[100000, 128] x 16384', wide, wide_ids)):
    got = hbt.gather_rows(table, ids)
    if not torch.equal(got, hbt.gather_rows_reference(table, ids)):
      raise AssertionError(f'gather_rows differs from the plain version at '
                           f'the {label}')
    clipped = ids.long().clamp(0, table.shape[0] - 1)
    ms = _median_ms(lambda: hbt.gather_rows(table, ids))
    plain_ms = _median_ms(lambda: hbt.gather_rows_reference(table, ids))
    library_ms = _median_ms(lambda: table.index_select(0, clipped))
    n, d = ids.shape[0], table.shape[1]
    # Ids read once, n rows read and n rows written; no arithmetic.
    bound = _bound(n * 4 + 2 * n * d * table.element_size(), 0)
    print(f'  gather_rows at the {label}: bitwise equal; kernel '
          f'{ms:.4f} ms, plain {plain_ms:.4f} ms, index_select '
          f'{library_ms:.4f} ms; bound {bound["bound_ms"]:.4f} ms '
          f'({bound["bytes"] / 1e6:.2f} MB)')
    res.setdefault('gather_rows', dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound))
  _reset_counts()
  hbt.gather_rows(inp['table0'], inp['raw_ids'])
  torch.cuda.synchronize()
  counts = _counts()
  _expect('gather_rows', counts, gather_rows=1)
  res['gather_rows']['launches'] = counts['gather_rows']
  return res


def phase1_round(cfg: argparse.Namespace, dev: torch.device, inp):
  """Kernel 6 on the flagship gradients, bitwise against its plain
  version for one seed; every output is its input truncated to bf16 or
  one bf16 ulp above that in magnitude. Then once through
  ``stochastic_round_bf16`` with the counts read around it."""
  import hybridbackend_tpu_torch as hbt
  x = inp['raw_g']
  gen = torch.Generator().manual_seed(tb.SEED + 6)
  seed = hbt.draw_seed(torch.Generator().set_state(gen.get_state()))
  got = hbt.stochastic_round_bf16(x, gen)
  want = hbt.stochastic_round_bf16_reference(x, seed)
  nan = torch.isnan(got)
  if not (torch.equal(nan, torch.isnan(want)) and torch.equal(
      got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])):
    raise AssertionError('stochastic_round_bf16 differs from the plain '
                         'version')
  trunc = (x.view(torch.int32) >> 16).to(torch.int16).to(torch.int32)
  up = got.view(torch.int16).to(torch.int32) - trunc
  if not bool(((up == 0) | (up == 1)).all()):
    raise AssertionError('stochastic_round_bf16: an output is neither the '
                         'truncation nor one ulp above it')
  ms = _median_ms(lambda: hbt.stochastic_round_bf16(x, gen))
  # The plain version launches about 250 kernels: one call at a time.
  plain_ms = _median_ms(
      lambda: hbt.stochastic_round_bf16_reference(x, seed), iters=5, per=1)
  n = x.numel()
  # 4 bytes read and 2 written per element; per 8 elements a Philox call
  # of ten rounds (2 products, 2 high products, 4 xors, 2 key adds), and
  # per element an add, a shift and a select of the noise.
  bound = _bound(n * 6, n // 8 * 100 + 3 * n, INT32_OPS_PER_S)
  print(f'  stochastic_round_bf16 on [{", ".join(map(str, x.shape))}]: '
        f'bitwise equal for one seed, {float(up.float().mean()):.4f} of the '
        f'outputs rounded up; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; '
        f'bound {bound["bound_ms"]:.4f} ms ({bound["bytes"] / 1e6:.2f} MB)')
  _reset_counts()
  hbt.stochastic_round_bf16(x, gen)
  torch.cuda.synchronize()
  counts = _counts()
  _expect('stochastic_round_bf16', counts, stochastic_round_bf16=1)
  return {'stochastic_round_bf16': dict(
      max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
      launches=counts['stochastic_round_bf16'], **bound)}


def _close(got, want, rtol, atol_of_max):
  """``allclose`` with ``atol`` a share of the reference's largest value."""
  return torch.allclose(got, want, rtol=rtol,
                        atol=atol_of_max * float(want.abs().max()))


def gpu_vs_cpu(dev: torch.device, label: str, flags=(),
               optimizer: str = 'adagrad', split: bool = False):
  """One full-width step of the flagship config with the harness's
  ``flags`` on the GPU against the same step on the CPU, on the batch
  drawn from seed 1. Returns the GPU state and step, to go on from, and
  the kernel launches of the GPU step."""
  cpu = torch.device('cpu')
  args = flagship(*flags)
  bf16_tables = args.table_dtype == 'bfloat16'
  gstate, gstep = tb.build(args, dev, optimizer, split)
  cstate, cstep = tb.build(args, cpu, optimizer, split)
  batch = {d: tb.shifted(*tb.make_batch(args, d, tb.SEED + 1), args.vocab, 0)
           for d in (dev, cpu)}
  _reset_counts()
  gstate, gm = gstep(gstate, batch[dev])
  torch.cuda.synchronize()
  launches = _counts()
  cstate, cm = cstep(cstate, batch[cpu])
  gloss, closs = float(gm['loss']), float(cm['loss'])
  # The loss comes from one forward pass of the same state: f32 matmul
  # sums in another order on the card, about 1e-6 relative. With bf16
  # matmul operands a layer's f32 output within that order error of a bf16
  # rounding boundary feeds the next layer a value one bf16 ulp (2**-8
  # relative) away; 1e-3 covers a few such values in the mean.
  loss_rtol = 1e-3 if args.bf16 else 1e-4
  if not abs(gloss - closs) <= loss_rtol * abs(closs):
    raise AssertionError(f'{label}: loss {gloss} on the GPU, {closs} on '
                         'the CPU')
  report = {'loss_rel_err': abs(gloss - closs) / abs(closs)}
  (name,) = gstate.tables
  slots = zip(('acc',) if optimizer == 'adagrad' else ('m', 'v'),
              gstate.table_opt[name].acc, cstate.table_opt[name].acc)
  pairs = {'table': (gstate.tables[name], cstate.tables[name]),
           **{k: (g, c) for k, g, c in slots}}
  for key, (g, c) in pairs.items():
    g = g.cpu()
    report[f'{key}_max_abs_err'] = float((g.float() - c.float()).abs().max())
    if bf16_tables:
      # bf16 tables, slots and gradients: the tower's f32 order moves an
      # embedding gradient across a bf16 rounding boundary now and then,
      # which moves a stored value by one bf16 ulp. At most 1 ulp, or
      # where a value cancels to near 0 1e-6 (an f32 order error).
      atol, moved = 1e-6, None
      if optimizer == 'adam' and key == 'table':
        # LazyAdam's first step moves an element by lr*s/(|s|+eps), which
        # moves by up to lr*2**-8/4 = 4.9e-5 when s moves by its own bf16
        # ulp. Where a run's total s cancels, one of its gradients moved
        # by that gradient's ulp moves s by many ulps of s, and the step
        # by up to 2*lr (2.2*lr with the stored value's rounding): allowed
        # only where the first moment m = 0.1*s differs too, so the total
        # itself moved.
        atol, moved = 1e-4, pairs['m'][0].cpu() != pairs['m'][1]
        far = (_ulps_apart(g, c) > 1) & ((g.float() - c.float()).abs() > atol)
        report['table_elems_far_where_m_moved'] = int(far.sum())
      elif optimizer == 'adam':
        # m = 0.1*s and v = 0.001*s^2: a total that cancels keeps the
        # absolute error of the gradient that moved (up to 2**-7 of it);
        # 2**-5 of the largest moment bounds four such moves.
        atol = 2**-5 * float(c.float().abs().max())
      report[f'{key}_elems_differ'], _ = _within_an_ulp(
          f'{label}: {key}', g, c, atol=atol, moved=moved,
          moved_atol=2.2 * tb.TABLE_LR)
      continue
    if optimizer == 'adagrad':
      # Table and acc move by 0.05*g/sqrt(0.1+g^2) and g^2 with g ~ 1e-4,
      # so the gradients' order error stays far below 1e-5.
      ok = torch.allclose(g, c, rtol=1e-5, atol=1e-5)
    elif key == 'table':
      # LazyAdam's first step moves an element by lr*s/(|s|+eps): a
      # gradient s near zero turns an order difference ds into up to
      # lr*ds/eps = 5e6*ds; ds up to 1e-10 gives 5e-4. A wrong row or a
      # wrong sign moves it by 0.05 or more.
      report['table_elems_over_1e-5'] = int(((g - c).abs() > 1e-5).sum())
      ok = torch.allclose(g, c, rtol=0, atol=1e-3)
    else:
      # m = 0.1*s and v = 0.001*s^2 follow the gradients' order error,
      # relative to the largest moment.
      ok = _close(g, c, rtol=1e-3, atol_of_max=1e-4)
    if not ok:
      raise AssertionError(f'{label}: {key} differs: {report}')
  # The tower's gradients, read from Adam's first moment ((1 - b1)*g after
  # one step), follow the f32 order of the two devices: a weight's
  # gradient is a sum over the batch of 8192 terms of either sign, whose
  # order error reaches about n*2**-24 = 5e-4 of the sum of their sizes,
  # so 1e-3 relative plus 1e-3 of the tensor's largest gradient. With
  # bf16 matmul operands a layer's input that sits at a bf16 rounding
  # boundary takes the neighbouring bf16 value on one device (2**-8
  # relative), and sums over the batch carry that: 2**-5 of the largest
  # gradient.
  # Adam's first step moves a weight by lr*g/(|g|+1e-8): a 1e-10
  # difference in g moves it by at most 1e-5, so weights are held to
  # rtol = atol = 1e-4. With f32 tables and matmul operands the gradients
  # agree to about 1e-5 of their largest and that holds every weight.
  # With bf16 tables or operands they agree less well, and where the
  # gradient allowance exceeds |g| the two devices may give g either
  # sign: those weights may move up to 2*lr apart (2.2*lr with rounding),
  # and are counted.
  gparams = dict(gstate.dense.named_parameters())
  cp = dict(cstate.dense.named_parameters())
  group = cstate.dense_opt.param_groups[0]
  g_atol_of_max = 2**-5 if args.bf16 else 1e-3

  def grad(state, p):
    return (state.dense_opt.state[p]['exp_avg'] / (1 - group['betas'][0])
            ).cpu()

  report['tower_max_abs_err'] = max(
      float((gparams[n].detach().cpu() - cp[n].detach()).abs().max())
      for n in cp)
  grad_err, grad_err_param, either_sign_far = -1.0, None, 0
  for n in cp:
    gg, cg = grad(gstate, gparams[n]), grad(cstate, cp[n])
    allowance = 1e-3 * cg.abs() + g_atol_of_max * float(cg.abs().max())
    g_diff = (gg - cg).abs()
    if float(g_diff.max()) / float(cg.abs().max()) > grad_err:
      grad_err = float(g_diff.max()) / float(cg.abs().max())
      grad_err_param = n
    if bool((g_diff > allowance).any()):
      raise AssertionError(f'{label}: tower gradient of {n} differs by up to '
                           f'{float(g_diff.max())}, largest '
                           f'{float(cg.abs().max())}: {report}')
    want = cp[n].detach()
    diff = (gparams[n].detach().cpu() - want).abs()
    bad = diff > 1e-4 + 1e-4 * want.abs()
    if bf16_tables or args.bf16:
      either_sign = cg.abs() <= allowance
      either_sign_far += int((bad & either_sign).sum())
      bad &= ~(either_sign & (diff <= 2.2 * group['lr']))
    if bool(bad.any()):
      i = int(torch.argmax(torch.where(bad, diff, 0).flatten()))
      raise AssertionError(
          f'{label}: tower param {n} differs in {int(bad.sum())} elements, '
          f'by up to {float(diff.flatten()[i])} where the gradient is '
          f'{float(gg.flatten()[i])} on the card and '
          f'{float(cg.flatten()[i])} on the CPU: {report}')
  report['tower_grad_err_of_max'] = grad_err
  report['tower_grad_err_in'] = grad_err_param
  if either_sign_far:
    report['tower_far_where_grad_either_sign'] = either_sign_far
  print(f'{label}: one full-width step, GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items()))
  return gstate, gstep, launches


def timed(cfg: argparse.Namespace, dev: torch.device, label: str, state,
          step, smi, kernel: str, steps=30):
  """The step timed on the card as the harness times one window: its
  batch, warmup and ids shifted by one a step, ``steps`` steps enqueued
  back to back with CUDA events between consecutive steps. ``kernel``
  must have been launched once per step, and no other counted kernel."""
  base, ids = tb.make_batch(cfg, dev)
  state, *_ = tb.time_steps(state, step, base, ids, cfg.vocab, 0, tb.WARMUP)
  torch.cuda.reset_peak_memory_stats(dev)
  held = torch.cuda.memory_allocated(dev)

  _reset_counts()
  t0 = time.perf_counter()
  state, losses, step_ms, _ = tb.time_steps(state, step, base, ids,
                                            cfg.vocab, tb.WARMUP, steps)
  wall = time.perf_counter() - t0
  counts = _counts()
  _expect(f'{label}, {steps} steps', counts, **{kernel: steps})
  losses = torch.stack(losses)
  if not bool(torch.isfinite(losses).all()):
    raise AssertionError(f'{label}: non-finite loss: {losses.tolist()}')
  med = statistics.median(step_ms)
  print(f'{label}: on {smi}: median {med:.4f} ms/step (device events, '
        f'{steps} steps; min {min(step_ms):.4f}, max {max(step_ms):.4f}), '
        f'{cfg.batch / med * 1e3:.1f} examples/s; host clock '
        f'{wall / steps * 1e3:.4f} ms/step; peak memory '
        f'{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, of which '
        f'{held / 2**30:.3f} GiB held before the steps (the states of all '
        f'variants so far); loss '
        f'{float(losses[0]):.5f} -> {float(losses[-1]):.5f}')
  return state, counts[kernel]


def profile(cfg: argparse.Namespace, dev: torch.device, label: str, state, step,
            steps=10):
  """Device time per step by kernel class over ``steps`` traced steps,
  and the device's busy share of the traced span."""
  from torch.profiler import ProfilerActivity, profile as tprofile
  base, ids = tb.make_batch(cfg, dev)
  torch.cuda.synchronize()
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(steps):
      state, _ = step(state, tb.shifted(base, ids, cfg.vocab, 100 + i))
    torch.cuda.synchronize()
    span_ms = (time.perf_counter() - t0) * 1e3
  classes = collections.Counter()
  counts = collections.Counter()
  for e in prof.key_averages():
    us = getattr(e, 'device_time_total', None)
    if us is None:
      us = e.cuda_time_total
    if us <= 0 or e.device_type.name != 'CUDA':
      continue
    key = e.key
    for pattern, cls in (('gemm', 'GEMM'), ('sgemm', 'GEMM'),
                         ('xmma', 'GEMM'), ('gsum_dense', 'update'),
                         ('sorted_kernel', 'update'),
                         ('gather', 'gather'), ('sort', 'sort'),
                         ('multi_tensor', 'optimizer'),
                         ('reduce', 'reduction'), ('Memcpy', 'copy'),
                         ('Memset', 'copy')):
      if pattern.lower() in key.lower():
        key = f'{cls}: {e.key}' if cls == 'update' else cls
        break
    else:
      key = 'elementwise and other'
    classes[key] += us / 1e3 / steps
    counts[key] += e.count / steps
  device_ms = sum(classes.values())
  print(f'{label} profile: {device_ms:.4f} ms device time per step over '
        f'{steps} steps; traced span {span_ms / steps:.4f} ms/step, device '
        f'busy {100 * device_ms * steps / span_ms:.1f}% of it')
  for key, ms in classes.most_common():
    print(f'  {ms:.4f} ms/step ({100 * ms / device_ms:.1f}%), '
          f'{counts[key]:.1f} ops/step: {key}')


def harness(smi):
  """Phase 16: the port's train-step harness at its defaults with bf16
  tables, as a user runs it, in a process of its own; its JSON line is
  printed. Its Adagrad kernel must have been launched once per timed
  step, and no other counted kernel."""
  cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.benchmarks.'
         'train_benchmark', '--sparse', '--table-dtype', 'bfloat16', '--json']
  out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
  if out.returncode != 0:
    raise RuntimeError(f'{" ".join(cmd[1:])} failed:\n{out.stderr}')
  line = out.stdout.strip().splitlines()[-1]
  report = json.loads(line)
  want = {name: 0 for name in tb.COUNTED}
  want['adagrad_update_sorted'] = report['timed_steps']
  if report['kernel_launches'] != want or report['card'] != smi:
    raise AssertionError(f'the harness launched {report["kernel_launches"]} '
                         f'on {report["card"]}; expected {want} on {smi}')
  print(f'phase 16 (python -m {cmd[2]} --sparse --table-dtype bfloat16 '
        f'--json): {line}')


TRAIN_STEPS = 64           # phase 17's training run
SAVE_EVERY = 32            # and its checkpoints
EVAL_SHORT = 1000          # rows of its last, short eval batch
STAT_WINDOW = 16           # steps between StepStatHook's syncs
ADAM_STEPS = 8             # the LazyAdam SparseTrainer's run
LOOP_ROUNDS, LOOP_STEPS = 4, 16   # the loop's timing rounds
SLOW_SOURCE_MS = 4.0       # a source's wait per batch, as a reader's I/O
DENSE_STEPS = 3            # phase 18's GPU-vs-CPU steps
DENSE_TIMED = 33           # and its timed steps (2 windows of 16)


def _flat_state(trainer):
  """``{path: value}`` of a trainer's checkpoint state."""
  out = {}

  def walk(prefix, v):
    if isinstance(v, dict):
      for k, x in v.items():
        walk(f'{prefix}/{k}', x)
    elif isinstance(v, (list, tuple)):
      for i, x in enumerate(v):
        walk(f'{prefix}/{i}', x)
    else:
      out[prefix] = v
  walk('', trainer._checkpoint_state())
  return out


def _bitwise_equal(label, a, b):
  """Fails unless two trainers' states hold the same bits everywhere."""
  fa, fb = _flat_state(a), _flat_state(b)
  if fa.keys() != fb.keys():
    raise AssertionError(f'{label}: state keys differ')
  for key, x in fa.items():
    y = fb[key]
    same = (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
            else x == y)
    if not same:
      diff = (float((x.float() - y.float()).abs().max())
              if isinstance(x, torch.Tensor) else f'{x} vs {y}')
      raise AssertionError(f'{label}: {key} differs (max abs diff {diff})')
  return len(fa)


def _sparse_trainer(cfg, dev, model_dir, table_optimizer='adagrad'):
  """The flagship DCNv2 config as a ``SparseTrainer`` on ``dev`` (the
  harness's weights from its seed, table lr, accumulator and tower Adam)
  with row-sparse ``table_optimizer``, checkpointing into ``model_dir``."""
  import hybridbackend_tpu_torch as hbt
  fx, tables, tower, model_loss = tb.sparse_parts(cfg, dev)
  return hbt.SparseTrainer(
      fx, model_loss, tower, tables=tables,
      dense_optimizer=functools.partial(torch.optim.Adam, lr=tb.TOWER_LR),
      table_lr=tb.TABLE_LR, adagrad_init=tb.ADAGRAD_INIT,
      table_optimizer=table_optimizer, model_dir=model_dir)


def _step_alone_ms(trainer, batches, dev):
  """The trainer's own step enqueued back to back with CUDA events
  between steps, on batches placed on the card beforehand: the step
  without the trainer's loop, input path and hooks. The median gap."""
  import hybridbackend_tpu_torch as hbt
  placed = [hbt.put_batch(b, dev) for b in batches]
  torch.cuda.synchronize(dev)
  marks = [torch.cuda.Event(enable_timing=True)]
  marks[0].record()
  for b in placed:
    trainer.state, _ = trainer._step_fn(trainer.state, b)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
  torch.cuda.synchronize(dev)
  return statistics.median(a.elapsed_time(b) for a, b in zip(marks,
                                                             marks[1:]))


def _slow_source(batches, ms):
  """``batches``, each after a wait of ``ms`` that holds no interpreter
  lock, as a reader's file reads and decoding do."""
  for b in batches:
    time.sleep(ms / 1e3)
    yield b


def _train_ms(trainer, batches, dev, prefetch, wait_ms=0.0):
  """ms/step of ``trainer.train`` over ``batches`` on the host clock,
  from an idle card to the end of its last step, with or without the
  ``DeviceIterator``; the source waits ``wait_ms`` before each batch."""
  source = _slow_source(batches, wait_ms) if wait_ms else iter(batches)
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  trainer.train(source, prefetch=prefetch)
  torch.cuda.synchronize(dev)
  return (time.perf_counter() - t0) * 1e3 / len(batches)


def _input_ms(batches, dev, prefetch):
  """ms/batch of the input path alone, no step: the ``DeviceIterator``
  or ``put_batch`` of each batch, from an idle card to the last copy."""
  import hybridbackend_tpu_torch as hbt
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  if prefetch:
    it = hbt.DeviceIterator(iter(batches), dev)
    for _ in it:
      pass
    it.close()
  else:
    for b in batches:
      hbt.put_batch(b, dev)
  torch.cuda.synchronize(dev)
  return (time.perf_counter() - t0) * 1e3 / len(batches)


def phase17_sparse_trainer(cfg, dev, smi, bare_state, bare_step):
  """Phase 17: the flagship DCNv2 + Adagrad as a user trains it, through
  ``SparseTrainer``: 64 steps fed from seeded Criteo-like host batches
  (``benchmarks/synthetic.py``) through ``DeviceIterator``, a
  ``StepStatHook``, checkpoints every 32 steps; then an evaluation of 4
  full batches and one of 1000 rows, held against the CPU's evaluation
  of the same parameters (restored from the step-64 checkpoint); a
  fresh trainer's restore, and a resume from step 32 over the same 32
  batches, both held bit for bit against the live state; a short run of
  ``table_optimizer='adam'``, which must launch the LazyAdam kernel once
  a step; and the loop timed with and without ``DeviceIterator``, from a
  source that waits for nothing and from one that waits. Returns the
  kernel launches of the two trainers' runs, and the batches."""
  import hybridbackend_tpu_torch as hbt
  from hybridbackend_tpu_torch import metrics as hbm
  cpu = torch.device('cpu')
  kw = dict(vocab=cfg.vocab, tables=cfg.tables,
            dense_features=cfg.dense_features)
  batches = synthetic.criteo_batches(cfg.batch, TRAIN_STEPS, seed=tb.SEED,
                                     **kw)
  evals = (synthetic.criteo_batches(cfg.batch, 4, seed=tb.SEED + 1, **kw)
           + synthetic.criteo_batches(EVAL_SHORT, 1, seed=tb.SEED + 2, **kw))
  labels = np.concatenate([b['label'] for b in evals])
  # The harness's bare step, in this process, just before the trainer.
  base, ids = tb.make_batch(cfg, dev)
  *_, bare_gaps, _ = tb.time_steps(bare_state, bare_step, base, ids,
                                   cfg.vocab, 1000, 30)
  bare_ms = statistics.median(bare_gaps)
  with tempfile.TemporaryDirectory() as tmp:
    dir_a, dir_b = os.path.join(tmp, 'a'), os.path.join(tmp, 'b')
    live = _sparse_trainer(cfg, dev, dir_a)
    reports = []
    hook = hbt.StepStatHook(batch_size=cfg.batch, every_n_steps=0,
                            sync_every_n=STAT_WINDOW, log=reports.append)
    torch.cuda.synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    metrics = live.train(iter(batches), hooks=[hook], prefetch=True,
                         save_checkpoint_steps=SAVE_EVERY)
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = _counts()
    _expect(f'phase 17, SparseTrainer.train of {TRAIN_STEPS} steps', counts,
            adagrad_update_sorted=TRAIN_STEPS)
    if live.global_step != TRAIN_STEPS or live._ckpt.all_steps() != [
        SAVE_EVERY, TRAIN_STEPS]:
      raise AssertionError(f'phase 17: step {live.global_step}, '
                           f'checkpoints {live._ckpt.all_steps()}')
    if not np.isfinite(metrics['loss']):
      raise AssertionError(f'phase 17: train loss {metrics["loss"]}')
    stalls = hook.input_stall_stats
    synced = [s * 1e3 for s in hook.synced_secs_per_step]

    # Evaluation and prediction on the card, against the CPU.
    # Through the DeviceIterator: its pinned staging on the card is what
    # the CPU's evaluation checks.
    res_gpu = live.evaluate(iter(evals), prefetch=True)
    preds_gpu = torch.cat(list(live.predict(iter(evals),
                                            prefetch=True))).cpu()
    on_cpu = _sparse_trainer(cfg, cpu, dir_a)
    if on_cpu.global_step != TRAIN_STEPS:
      raise AssertionError(f'phase 17: the CPU trainer restored step '
                           f'{on_cpu.global_step}')
    res_cpu = on_cpu.evaluate(iter(evals))
    preds_cpu = torch.cat(list(on_cpu.predict(iter(evals))))
    del on_cpu
    limit, near, gap = hbm.auc_limit(preds_gpu, preds_cpu, labels)
    # The loss: per-example BCE of predictions about 1e-6 relative apart
    # (the tower's f32 sums in another order), averaged: 1e-4, as the
    # GPU-vs-CPU step phases hold the loss.
    if not (res_gpu['batches'] == res_cpu['batches'] == len(evals)
            and abs(res_gpu['auc'] - res_cpu['auc']) <= limit
            and abs(res_gpu['loss'] - res_cpu['loss'])
            <= 1e-4 * abs(res_cpu['loss'])
            and np.isfinite(res_gpu['auc'])):
      raise AssertionError(f'phase 17: evaluate on the GPU {res_gpu}, on '
                           f'the CPU {res_cpu}; AUC limit {limit} '
                           f'({near} predictions within {gap:.3e} of a '
                           'threshold)')

    # A fresh trainer restores the live state; a resume from step 32
    # over the same batches reaches it.
    restored = _sparse_trainer(cfg, dev, dir_a)
    n_tensors = _bitwise_equal('phase 17, restored at step 64', restored,
                               live)
    del restored
    os.makedirs(dir_b)
    shutil.copy(os.path.join(dir_a, f'checkpoint-{SAVE_EVERY}.pt'), dir_b)
    resumed = _sparse_trainer(cfg, dev, dir_b)
    if resumed.global_step != SAVE_EVERY:
      raise AssertionError(f'phase 17: resumed at {resumed.global_step}')
    resumed.train(iter(batches[SAVE_EVERY:]))
    _bitwise_equal('phase 17, resumed from step 32', resumed, live)
    del resumed, live

  # The LazyAdam tables: kernel 3 once a train step.
  adam = _sparse_trainer(cfg, dev, None, table_optimizer='adam')
  torch.cuda.synchronize(dev)
  _reset_counts()
  adam_loss = adam.train(iter(batches[:ADAM_STEPS]))['loss']
  torch.cuda.synchronize(dev)
  adam_counts = _counts()
  _expect(f"phase 17, SparseTrainer(table_optimizer='adam').train of "
          f'{ADAM_STEPS} steps', adam_counts, adam_update_sorted=ADAM_STEPS)
  if adam.global_step != ADAM_STEPS or not np.isfinite(adam_loss):
    raise AssertionError(f'phase 17, LazyAdam: step {adam.global_step}, '
                         f'loss {adam_loss}')
  del adam

  # The loop, timed: the step alone on placed batches, and train() with
  # and without the DeviceIterator from a source that waits for nothing
  # and from one that waits SLOW_SOURCE_MS a batch; and the input paths
  # alone. In rounds, each in the other order than the one before: the
  # host's pace drifts by tens of percent within a process, so one window
  # of each would compare two paces.
  timer = _sparse_trainer(cfg, dev, None)
  ways = {
      'placed': lambda part: _step_alone_ms(timer, part, dev),
      'train(prefetch=False)': lambda part: _train_ms(timer, part, dev,
                                                       False),
      'train(prefetch=True)': lambda part: _train_ms(timer, part, dev, True),
      'slow source, train(prefetch=False)': lambda part: _train_ms(
          timer, part, dev, False, SLOW_SOURCE_MS),
      'slow source, train(prefetch=True)': lambda part: _train_ms(
          timer, part, dev, True, SLOW_SOURCE_MS),
      'put_batch alone': lambda part: _input_ms(part, dev, False),
      'DeviceIterator alone': lambda part: _input_ms(part, dev, True),
  }
  loop = {name: [] for name in ways}
  for r in range(LOOP_ROUNDS):
    part = batches[r * LOOP_STEPS:(r + 1) * LOOP_STEPS]
    for name in (list(ways) if r % 2 == 0 else list(reversed(ways))):
      loop[name].append(ways[name](part))
  del timer
  print(f'phase 17 (SparseTrainer, DCNv2 + Adagrad flagship, '
        f'{TRAIN_STEPS} steps of seeded Criteo-like batches through '
        f'DeviceIterator, checkpoints every {SAVE_EVERY}): on {smi}: '
        f'trainer {statistics.median(synced):.4f} ms/step synced '
        f'(StepStatHook windows of {STAT_WINDOW} steps: '
        f'{", ".join(f"{x:.4f}" for x in synced)}; the one with step '
        f'{SAVE_EVERY} holds its checkpoint), {wall_ms:.4f} ms/step wall '
        f'over the run; the harness bare step (time_steps, phase 3 '
        f'state) {bare_ms:.4f} ms/step; kernel 1 launches '
        f'{counts["adagrad_update_sorted"] / TRAIN_STEPS:.0f} per '
        f'step; input stalls {stalls["stalls"]}/{stalls["gets"]} '
        f'(fraction {stalls["stall_fraction"]:.4f}, {stalls["stall_s"]:.4f} '
        f's waited); last train loss {metrics["loss"]:.5f}')
  print(f'  the loop, {LOOP_ROUNDS} rounds of {LOOP_STEPS} steps each way '
        f'(medians; rounds in order; a slow source waits '
        f'{SLOW_SOURCE_MS} ms a batch):')
  for name, v in loop.items():
    unit = 'ms/batch' if 'alone' in name else 'ms/step'
    print(f'    {name}: {statistics.median(v):.4f} {unit} '
          f'({", ".join(f"{x:.4f}" for x in v)})')
  print(f'  evaluate ({len(evals)} batches: 4 of {cfg.batch} and one of '
        f'{EVAL_SHORT} rows): GPU auc {res_gpu["auc"]:.6f} loss '
        f'{res_gpu["loss"]:.6f} batches {res_gpu["batches"]:.0f}; CPU auc '
        f'{res_cpu["auc"]:.6f} loss {res_cpu["loss"]:.6f}; predictions '
        f'{gap:.3e} apart at most, {near} within that of a threshold, so '
        f'AUC limit {limit:.3e}, AUC apart {abs(res_gpu["auc"] - res_cpu["auc"]):.3e}')
  print(f'  restore at step {TRAIN_STEPS} and resume from step '
        f'{SAVE_EVERY}: {n_tensors} state entries bitwise equal to the live '
        f'state')
  print(f"  SparseTrainer(table_optimizer='adam'), {ADAM_STEPS} steps: "
        f'kernel 3 launches {adam_counts["adam_update_sorted"]} '
        f'({adam_counts["adam_update_sorted"] / ADAM_STEPS:.0f} per step), '
        f'last train loss {adam_loss:.5f}')
  for line in reports:
    print(f'  StepStatHook: {line}')
  launches = collections.Counter(counts)
  launches.update(adam_counts)
  return launches, batches, evals


def phase18_dense_trainer(cfg, dev, smi, batches, evals):
  """Phase 18: the dense-gradient ``Trainer`` at the flagship width (26
  tables of [100000, 16], one per column; ``multi_optimizer`` with the
  optax-equivalent Adagrad 0.05 on the tables and Adam 1e-3 on the
  tower, as the JAX harness sets it up): 3 steps on the card, each held
  against the same step on the CPU from the same state (the CPU trainer
  takes the card's state before each), then 33 timed steps and one
  evaluation. No counted kernel runs on this path. Returns the kernel
  launches of its runs."""
  import hybridbackend_tpu_torch as hbt
  cpu = torch.device('cpu')
  args = argparse.Namespace(**{**vars(cfg), 'sparse': False})
  g_trainer, c_trainer = (
      hbt.Trainer(*tb.dense_parts(args, d), ctx=hbt.Context(d))
      for d in (dev, cpu))
  # Each step from one state: before it the CPU trainer takes the card's
  # state, so that every comparison is of one step, as in phase 2.
  report = {'loss_rel_err': 0.0, 'table_max_abs_err': 0.0,
            'acc_max_abs_err': 0.0, 'tower_grad_err_of_max': 0.0,
            'tower_v_err_of_allowance': 0.0,
            'tower_adam_err_of_tol_card': 0.0,
            'tower_adam_err_of_tol_cpu': 0.0, 'tower_max_abs_err': 0.0,
            'tower_weights_over_1e-4_apart': 0,
            'their_largest_grad_of_max_card': 0.0,
            'their_largest_grad_of_max_cpu': 0.0}
  apart_in = set()
  group = c_trainer.state.optimizer.dense_opt.param_groups[0]
  lr, (b1, b2), eps = group['lr'], group['betas'], group['eps']
  launches = collections.Counter()
  _reset_counts()
  for i in range(DENSE_STEPS):
    c_trainer._load_checkpoint_state(g_trainer._checkpoint_state())
    g_state, c_state = g_trainer.state, c_trainer.state
    g_net, c_net = g_state.params['net'], c_state.params['net']
    before = [(p.detach().clone(),
               c_state.optimizer.state[p]['exp_avg'].clone())
              for p in c_net.parameters()]
    v_before = [c_state.optimizer.state[p]['exp_avg_sq'].clone()
                for p in c_net.parameters()]
    gl = g_trainer.train(iter(batches[i:i + 1]))['loss']
    cl = c_trainer.train(iter(batches[i:i + 1]))['loss']
    report['loss_rel_err'] = max(report['loss_rel_err'],
                                 abs(gl - cl) / abs(cl))
    if not abs(gl - cl) <= 1e-4 * abs(cl):
      raise AssertionError(f'phase 18, step {i + 1}: loss {gl} on the GPU, '
                           f'{cl} on the CPU')
    # Tables and accumulators: a table row's gradient is a sum over the
    # batch's occurrences of its id, in atomic order on the card
    # (index_add_) and in list order on the CPU: at most n * 2**-24 of the
    # sum of the terms' sizes apart, about 1e-7 of it for the hottest ids.
    # Adagrad moves an element by 0.05 * g / sqrt(acc) with acc >= 0.1, so
    # a gradient's rounding moves it by at most 0.16 times that, and acc
    # by 2 * |g| times it: far below 1e-5.
    g_tables, c_tables = g_state.params['tables'], c_state.params['tables']
    for name, c in c_tables.items():
      ga = g_state.optimizer.state[g_tables[name]]['sum_of_squares'].cpu()
      ca = c_state.optimizer.state[c]['sum_of_squares']
      for key, x, y in (('table', g_tables[name].detach().cpu(), c.detach()),
                        ('acc', ga, ca)):
        err = float((x - y).abs().max())
        report[f'{key}_max_abs_err'] = max(report[f'{key}_max_abs_err'], err)
        if not torch.allclose(x, y, rtol=1e-5, atol=1e-5):
          raise AssertionError(f'phase 18, step {i + 1}: {key} of {name} '
                               f'differs by up to {err}')
    # The tower, in two parts. (a) Across the devices: each weight's
    # gradient, read from Adam's first moment (g = (m - b1 * m_before) /
    # (1 - b1), m_before the same on both), is a sum over the batch whose
    # order error reaches about n * 2**-24 = 5e-4 of the sum of its terms'
    # sizes: 1e-3 of itself plus 1e-3 of the tensor's largest gradient, as
    # phase 2 holds it; the second moment then within (1 - b2) times what
    # twice that allowance does to g**2 (a gradient read from m carries
    # m's rounding over 1 - b1 besides), plus 4 of its own ulps. (b) On each
    # device: every weight is Adam's step from the state before it, by
    # that device's own moments, to 2**-22 of the weight and 2**-18 of the
    # step (a few f32 roundings of each). Together they hold every weight:
    # where the devices' gradients differ within (a), the weights differ
    # by what Adam makes of it, which near a zero gradient is up to 2 * lr
    # (lr * g / (|g| + eps) takes either sign); those weights are counted
    # below with their gradients' share of the tensor's largest.
    for (n, gp), cp, (w0, m0), v0 in zip(g_net.named_parameters(),
                                         c_net.parameters(), before,
                                         v_before):
      gs, cs = g_state.optimizer.state[gp], c_state.optimizer.state[cp]
      gm, gv = gs['exp_avg'].cpu(), gs['exp_avg_sq'].cpu()
      cm, cv = cs['exp_avg'], cs['exp_avg_sq']
      gg, cg = ((m - b1 * m0) / (1 - b1) for m in (gm, cm))
      largest = float(cg.abs().max())
      allowance = 1e-3 * cg.abs() + 1e-3 * largest
      g_diff = (gg - cg).abs()
      report['tower_grad_err_of_max'] = max(
          report['tower_grad_err_of_max'], float(g_diff.max()) / largest)
      if bool((g_diff > allowance).any()):
        raise AssertionError(f'phase 18, step {i + 1}: the gradient of '
                             f'net.{n} differs by up to '
                             f'{float(g_diff.max())}, largest {largest}')
      v_allow = ((1 - b2) * 2 * allowance * (2 * cg.abs() + 2 * allowance)
                 + 2**-21 * cv)
      v_ratio = float(((gv - cv).abs() / v_allow.clamp(min=1e-38)).max())
      report['tower_v_err_of_allowance'] = max(
          report['tower_v_err_of_allowance'], v_ratio)
      if v_ratio > 1:
        raise AssertionError(f'phase 18, step {i + 1}: the second moment of '
                             f'net.{n} differs by {v_ratio:.3g} times its '
                             'allowance')
      t = float(cs['step'])
      if float(gs['step']) != t:
        raise AssertionError(f'phase 18, step {i + 1}: Adam steps '
                             f'{float(gs["step"])} and {t}')
      for where, w, m, v in (('card', gp.detach().cpu(), gm, gv),
                             ('cpu', cp.detach(), cm, cv)):
        step = (lr / (1 - b1**t) * m.double()
                / (v.double().sqrt() / math.sqrt(1 - b2**t) + eps))
        want = w0.double() - step
        tol = 2**-22 * want.abs() + 2**-18 * step.abs()
        ratio = float(((w.double() - want).abs()
                       / tol.clamp(min=1e-300)).max())
        report[f'tower_adam_err_of_tol_{where}'] = max(
            report[f'tower_adam_err_of_tol_{where}'], ratio)
        if ratio > 1:
          raise AssertionError(f'phase 18, step {i + 1}: net.{n} on the '
                               f'{where} is {ratio:.3g} times its tolerance '
                               "from Adam's step of its own moments")
      diff = (gp.detach().cpu() - cp.detach()).abs()
      report['tower_max_abs_err'] = max(report['tower_max_abs_err'],
                                        float(diff.max()))
      apart = diff > 1e-4 + 1e-4 * cp.detach().abs()
      if bool(apart.any()):
        apart_in.add(f'net.{n} at step {i + 1}')
        report['tower_weights_over_1e-4_apart'] += int(apart.sum())
        for where, g in (('card', gg), ('cpu', cg)):
          key = f'their_largest_grad_of_max_{where}'
          report[key] = max(report[key],
                            float(g[apart].abs().max()) / largest)
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f'phase 18, Trainer.train of {DENSE_STEPS} steps', counts)
  launches.update(counts)
  del c_trainer, c_state, c_tables, c_net
  # Timed steps, then one evaluation.
  reports = []
  hook = hbt.StepStatHook(batch_size=cfg.batch, every_n_steps=0,
                          sync_every_n=STAT_WINDOW, log=reports.append)
  _reset_counts()
  g_trainer.train(iter(batches[DENSE_STEPS:DENSE_STEPS + DENSE_TIMED]),
                  hooks=[hook], prefetch=True)
  torch.cuda.synchronize(dev)
  counts = _counts()
  _expect(f'phase 18, {DENSE_TIMED} timed steps', counts)
  launches.update(counts)
  synced = [s * 1e3 for s in hook.synced_secs_per_step]
  res = g_trainer.evaluate(iter(evals))
  if not (np.isfinite(res['auc']) and np.isfinite(res['loss'])
          and res['batches'] == len(evals)):
    raise AssertionError(f'phase 18: evaluate gave {res}')
  stalls = hook.input_stall_stats
  print(f'phase 18 (Trainer, dense-gradient DCNv2 flagship, {cfg.tables} '
        f'tables of [{cfg.vocab}, {cfg.dim}] under multi_optimizer(Adagrad 0.05, '
        f'Adam 1e-3)): {DENSE_STEPS} steps GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items())
        + f' (in {", ".join(sorted(apart_in)) or "none"})')
  print(f'  on {smi}: {statistics.median(synced):.4f} ms/step synced '
        f'(windows of {STAT_WINDOW}: {", ".join(f"{x:.4f}" for x in synced)}), '
        f'{cfg.batch / statistics.median(synced) * 1e3:.1f} examples/s; '
        f'input stalls {stalls["stalls"]}/{stalls["gets"]}; evaluate: auc '
        f'{res["auc"]:.6f} loss {res["loss"]:.6f} batches '
        f'{res["batches"]:.0f}')
  return launches


def harness_dense(smi):
  """Phase 19: the port's harness in its dense mode (no ``--sparse``) at
  its defaults, in a process of its own; its JSON line is printed. It
  launches no counted kernel."""
  cmd = [sys.executable, '-m', 'hybridbackend_tpu_torch.benchmarks.'
         'train_benchmark', '--json']
  out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
  if out.returncode != 0:
    raise RuntimeError(f'{" ".join(cmd[1:])} failed:\n{out.stderr}')
  line = out.stdout.strip().splitlines()[-1]
  report = json.loads(line)
  if (any(report['kernel_launches'].values()) or report['sparse']
      or report['card'] != smi):
    raise AssertionError(f'the dense harness reported {report}')
  print(f'phase 19 (python -m {cmd[2]} --json, the dense mode): {line}')


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--profile', action='store_true',
                      help='trace 10 steps of each timed variant')
  parser.add_argument('--tune', action='store_true',
                      help='time kernels 2 and 4 over tile and block '
                      'sizes, and kernels 1 and 3 over tile sizes and state '
                      'batches')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this smoke run needs one',
          file=sys.stderr)
    return 1
  import hybridbackend_tpu_torch as hbt
  if not os.path.abspath(hbt.__file__).startswith(
      os.path.join(HERE, 'hybridbackend_tpu_torch')):
    raise RuntimeError('hybridbackend_tpu_torch must come from this '
                       f'checkout, not {hbt.__file__}')
  # Exact f32 on both sides of every comparison.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  cfg = flagship()

  smi = phase0_environment()
  k = phase1_kernels(cfg, dev, tune=args.tune)
  state, dcn_step, counts = gpu_vs_cpu(dev, 'phase 2 (DCNv2 + Adagrad)')
  _expect('DCNv2 + Adagrad step', counts, adagrad_update_sorted=1)
  dcn_state, launches = timed(cfg, dev, 'phase 3 (DCNv2 + Adagrad flagship)',
                              state, dcn_step, smi, 'adagrad_update_sorted')
  k['adagrad_update_sorted']['launches'] = launches
  _, _, counts = gpu_vs_cpu(dev, 'phase 4 (DCNv2 + no-dedup Adagrad)',
                            ['--no-dedup'])
  _expect('no-dedup step', counts, adagrad_update_sorted=1)
  k['adagrad_update_sorted[dedup=False]']['launches'] = counts[
      'adagrad_update_sorted']
  state, dlrm_step, counts = gpu_vs_cpu(dev, 'phase 5 (DLRM + LazyAdam)',
                                        ['--model', 'dlrm'], 'adam')
  _expect('LazyAdam step', counts, adam_update_sorted=1)
  dlrm_state, launches = timed(cfg, dev, 'phase 6 (DLRM + LazyAdam flagship)',
                               state, dlrm_step, smi, 'adam_update_sorted')
  k['adam_update_sorted']['launches'] = launches
  state, split_step, counts = gpu_vs_cpu(
      dev, 'phase 7 (DCNv2 + split-dense Adagrad)', split=True)
  _expect('split-dense step', counts, gsum_dense_sorted=1)
  split_state, launches = timed(
      cfg, dev, 'phase 8 (DCNv2 + split-dense Adagrad flagship)', state,
      split_step, smi, 'gsum_dense_sorted')
  k['gsum_dense_sorted']['launches'] = launches
  bf16 = ['--table-dtype', 'bfloat16']
  dcn16_state, dcn16_step, counts = gpu_vs_cpu(
      dev, 'phase 9 (DCNv2 + Adagrad, bf16 tables)', bf16)
  _expect('DCNv2 + Adagrad step, bf16 tables', counts,
          adagrad_update_sorted=1)
  dcn16_state, launches = timed(
      cfg, dev, 'phase 10 (DCNv2 + Adagrad flagship, bf16 tables)',
      dcn16_state, dcn16_step, smi, 'adagrad_update_sorted')
  k['adagrad_update_sorted[bf16]']['launches'] = launches
  _, _, counts = gpu_vs_cpu(
      dev, 'phase 11 (DCNv2 + no-dedup Adagrad, bf16 tables)',
      bf16 + ['--no-dedup'])
  _expect('no-dedup step, bf16 tables', counts, adagrad_update_sorted=1)
  k['adagrad_update_sorted[bf16,dedup=False]']['launches'] = counts[
      'adagrad_update_sorted']
  state, dlrm16_step, counts = gpu_vs_cpu(
      dev, 'phase 12 (DLRM + LazyAdam, bf16 tables)',
      bf16 + ['--model', 'dlrm'], 'adam')
  _expect('LazyAdam step, bf16 tables', counts, adam_update_sorted=1)
  dlrm16_state, launches = timed(
      cfg, dev, 'phase 13 (DLRM + LazyAdam flagship, bf16 tables)', state,
      dlrm16_step, smi, 'adam_update_sorted')
  k['adam_update_sorted[bf16]']['launches'] = launches
  _, _, counts = gpu_vs_cpu(
      dev, 'phase 14 (DCNv2 + split-dense Adagrad, bf16 tables)', bf16,
      split=True)
  _expect('split-dense step, bf16 tables', counts, gsum_dense_sorted=1)
  _, _, counts = gpu_vs_cpu(
      dev, 'phase 15 (DCNv2 + Adagrad, bf16 matmul operands)', ['--bf16'])
  _expect('DCNv2 step with bf16 matmul operands', counts,
          adagrad_update_sorted=1)
  harness(smi)
  trainer_launches, batches, evals = phase17_sparse_trainer(
      cfg, dev, smi, dcn_state, dcn_step)
  trainer_launches.update(phase18_dense_trainer(cfg, dev, smi, batches,
                                                evals))
  harness_dense(smi)
  if args.profile:
    profile(cfg, dev, 'DCNv2 + Adagrad', dcn_state, dcn_step)
    profile(cfg, dev, 'DLRM + LazyAdam', dlrm_state, dlrm_step)
    profile(cfg, dev, 'DCNv2 + split-dense Adagrad', split_state, split_step)
    profile(cfg, dev, 'DCNv2 + Adagrad, bf16 tables', dcn16_state,
            dcn16_step)
    profile(cfg, dev, 'DLRM + LazyAdam, bf16 tables', dlrm16_state,
            dlrm16_step)

  rows = []
  for name, (source, replaces) in KERNELS.items():
    m = k[name]
    rows.append({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': m['launches'],
                 'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                 'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
                 'bound_by': m['bound_by'], 'bytes': m['bytes'],
                 'library_ms': m['library_ms'],
                 # Launches in the trainers' runs (phases 17 and 18), by
                 # the kernel's own counter; null for a storage or dedup
                 # mode, whose counter it shares with its kernel's row.
                 'trainer_launches': (trainer_launches[name]
                                      if name in tb.COUNTED else None)})
  print(json.dumps({'kernels': rows}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
