#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py [--profile] [--tune]

It builds the port's CUDA kernels from ``hybridbackend_tpu_torch/ops/csrc``
(one nvcc per source, all at once) and drives the flagship sparse train
step, ``benchmarks/train_benchmark.py --sparse`` with its defaults: 26
tables of [100000, 16] stacked into one [2600000, 16] table, batch 8192
with 13 dense features, BCE loss, Adam 1e-3 on the tower, ids shifted by
one per step; in three variants:
  * DCNv2 (429x429 cross layer, MLP 1024-512-256-1) with row-sparse
    Adagrad 0.05 on the table, with and without duplicate combining;
  * DLRM (``--model dlrm``: bottom MLP 512-256, dot interaction of 27
    features of 16, top MLP 1024-512-1) with LazyAdam 0.05 on the table;
  * DCNv2 with the dense-split Adagrad update (``table_split_dense=True``,
    the JAX option ``emb_update_split_dense='on'``).
Weights are random, drawn from a fixed seed.

Phases; any failure raises and the script exits nonzero:
  0. the card (nvidia-smi), torch/CUDA/nvcc versions, the kernel builds
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
     versions on the CPU copy;
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
  8. that step timed on the card, with the same launch counts per step.
With ``--profile`` it then traces 10 steps of each timed variant with
``torch.profiler`` and prints device time per step by kernel class. With
``--tune`` phase 1 also times the add kernel over tile sizes, the
dense-totals kernel over block and chunk sizes, and the Adagrad (both
modes) and LazyAdam kernels over tile sizes and state batches (the rows
of how many run heads a thread loads before it waits for its tile's
gradients); each sweep forth and back.
The second-to-last line is a JSON object describing each kernel (its
times, launches on its path, and its bound: the larger of its bytes over
3.35 TB/s and its operations over the card's peak rate); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it fails before printing
either.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
}
# The rows of the kernels that hold state rows in registers.
STATE_KERNELS = ('adagrad_update_sorted',
                 'adagrad_update_sorted[dedup=False]', 'adam_update_sorted')
# The wrappers that count their launches.
COUNTED = ('adagrad_update_sorted', 'scatter_add_sorted', 'adam_update_sorted',
           'gsum_dense_sorted', 'gather_rows', 'stochastic_round_bf16')
# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores. Integer work (the Philox rounds) is counted at half
# the f32 rate, the SM's 64 INT32 lanes against 128 FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 2
L2_FLUSH_BYTES = 256 * 2**20


@dataclasses.dataclass(frozen=True)
class Flagship:
  """``benchmarks/train_benchmark.py --sparse`` with its defaults."""
  tables: int = 26
  vocab: int = 100_000
  dim: int = 16
  dense: int = 13
  batch: int = 8192
  mlp: tuple = (1024, 512, 256, 1)          # DCNv2
  bottom_mlp: tuple = (512, 256)            # DLRM
  top_mlp: tuple = (1024, 512, 1)           # DLRM
  table_lr: float = 0.05
  adagrad_init: float = 0.1
  dense_lr: float = 1e-3
  seed: int = 0


def _counts():
  import hybridbackend_tpu_torch as hbt
  return {name: getattr(hbt, name).launches for name in COUNTED}


def _reset_counts():
  import hybridbackend_tpu_torch as hbt
  for name in COUNTED:
    getattr(hbt, name).launches = 0


def _expect(label, counts, **want):
  """Fails unless ``counts`` are ``want`` and every other count is 0."""
  want = {name: want.get(name, 0) for name in COUNTED}
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
  d = Flagship.dim
  tile, batch = scatter.tile_entries(d), scatter.STATE_BATCH
  print(f'resident blocks per SM (256 threads each) at d = {d}, tiles of '
        f'{tile} entries, state batch {batch}: ' + ', '.join(
            f'{name} {_blocks_per_sm(name, d, tile, batch)}'
            for name in STATE_KERNELS))
  return smi


def _blocks_per_sm(name, d, tile, batch):
  """Blocks of ``name``'s 16-byte-lane kernel that one SM holds at once
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
  from hybridbackend_tpu_torch.ops import build
  blocks = ctypes.c_int()
  if name.startswith('adagrad'):
    lib = build.load('adagrad_update').lib
    fn = lib.hb_adagrad_update_sorted_blocks_per_sm
    args = (d, tile, batch, int('dedup=False' not in name))
  else:
    fn = build.load('adam_update').lib.hb_adam_update_sorted_blocks_per_sm
    args = (d, tile, batch)
  fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
  fn.restype = ctypes.c_int
  err = fn(*args, ctypes.byref(blocks))
  if err:
    raise RuntimeError(f'{name}: occupancy query failed: CUDA error {err}')
  return blocks.value


def _update_list(cfg: Flagship, step: int, rng: np.random.RandomState):
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


def phase1_kernels(cfg: Flagship, dev: torch.device, tune: bool = False):
  import hybridbackend_tpu_torch as hbt
  v = cfg.tables * cfg.vocab
  rng = np.random.RandomState(cfg.seed)
  ids, grads = _update_list(cfg, 3, rng)
  rows, order = torch.sort(torch.from_numpy(ids).to(dev), stable=True)
  g = torch.from_numpy(grads).to(dev).index_select(0, order)
  gen = torch.Generator().manual_seed(cfg.seed)
  table0 = hbt.default_initializer(gen, (v, cfg.dim)).to(dev)
  acc0 = torch.full_like(table0, cfg.adagrad_init)
  # Moments as after some steps with N(0, 0.01) gradients.
  m0 = (torch.randn(v, cfg.dim, generator=gen) * 1e-3).to(dev)
  v0 = (torch.rand(v, cfg.dim, generator=gen) * 1e-4).to(dev)
  lr = torch.full((), cfg.table_lr, device=dev)
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
  scaled = g * -cfg.table_lr
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
  hbt.sparse_sgd_apply(ts, raw_ids, raw_g, stacked, cfg.table_lr)
  torch.cuda.synchronize()
  _expect('sparse_sgd_apply', _counts(), scatter_add_sorted=1)
  launches = 1
  want = hbt.scatter_add_sorted_reference(table0.clone(), rows, scaled)
  if not torch.allclose(ts, want, rtol=1e-5, atol=1e-5):
    raise AssertionError('sparse_sgd_apply differs from the plain version')
  path_ms = _median_ms(lambda: hbt.sparse_sgd_apply(
      ts, raw_ids, raw_g, stacked, cfg.table_lr), iters=10)
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
  if tune:
    phase1_tune(cfg, dev, inputs)
  return out


def _at_offset(t, k, dev):
  """A copy of ``t`` on ``dev`` that starts ``k`` floats into its
  storage."""
  flat = torch.empty(t.numel() + k, dtype=t.dtype, device=dev)
  flat[k:].copy_(t.reshape(-1))
  return flat[k:].view(t.shape)


def phase1_edges(cfg: Flagship, dev: torch.device, inp):
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
  rng = np.random.RandomState(cfg.seed + 7)
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
  lr, step = cfg.table_lr, 3
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


def phase1_tune(cfg: Flagship, dev: torch.device, inp):
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


def phase1_gsum(cfg: Flagship, dev: torch.device, inp, fused):
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


def phase1_gather(cfg: Flagship, dev: torch.device, inp):
  """Kernel 5 bitwise against its plain version at the flagship lookup
  (the update list's ids, -1 and >= V among them, into the stacked
  table) and at the TPU kernel's measured shape, [100000, 128] f32 with
  16384 random ids; then once more with the counts read around it."""
  import hybridbackend_tpu_torch as hbt
  gen = torch.Generator().manual_seed(cfg.seed + 5)
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


def phase1_round(cfg: Flagship, dev: torch.device, inp):
  """Kernel 6 on the flagship gradients, bitwise against its plain
  version for one seed; every output is its input truncated to bf16 or
  one bf16 ulp above that in magnitude. Then once through
  ``stochastic_round_bf16`` with the counts read around it."""
  import hybridbackend_tpu_torch as hbt
  x = inp['raw_g']
  gen = torch.Generator().manual_seed(cfg.seed + 6)
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


def _bce(p, batch):
  p = torch.clamp(p, 1e-6, 1 - 1e-6)
  y = batch['label']
  return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}


def _setup(cfg: Flagship, dev: torch.device, model: str, optimizer: str,
           dedup: bool = True, split: bool = False):
  """Feature extractor, state and step on ``dev``; the weights are drawn
  on the CPU from ``cfg.seed``, so every device starts from one state."""
  import hybridbackend_tpu_torch as hbt
  ctx = hbt.Context(dev)
  specs = [hbt.EmbeddingSpec(hbt.TableConfig(f'c{i}', cfg.vocab, cfg.dim))
           for i in range(cfg.tables)]
  fx = hbt.StackedFeatureExtractor(
      specs, dense_columns=[f'i{d}' for d in range(cfg.dense)], ctx=ctx)
  gen = torch.Generator().manual_seed(cfg.seed)
  tables = fx.init(gen)
  if model == 'dcnv2':
    tower = hbt.StackedDCNv2([cfg.dim] * cfg.tables + [1] * cfg.dense,
                             list(cfg.mlp), generator=gen, device=dev)
    loss = lambda t, emb_f, dense_f, b: _bce(t(emb_f + dense_f), b)
  else:
    tower = hbt.DLRM(cfg.dense, cfg.tables, list(cfg.bottom_mlp), cfg.dim,
                     list(cfg.top_mlp), generator=gen, device=dev)
    loss = lambda t, emb_f, dense_f, b: _bce(t(dense_f, emb_f), b)
  state = hbt.SparseTrainState.create(
      tower, tables, functools.partial(torch.optim.Adam, lr=cfg.dense_lr),
      adagrad_init=cfg.adagrad_init, adam=optimizer == 'adam')
  step = hbt.make_sparse_train_step(fx, loss, table_lr=cfg.table_lr,
                                    table_dedup=dedup,
                                    table_optimizer=optimizer,
                                    table_split_dense=split)
  return state, step


def _base_batch(cfg: Flagship, dev: torch.device):
  rng = np.random.RandomState(cfg.seed + 1)
  batch = {f'c{i}': rng.randint(0, cfg.vocab, cfg.batch).astype(np.int32)
           for i in range(cfg.tables)}
  batch.update({f'i{d}': rng.rand(cfg.batch).astype(np.float32)
                for d in range(cfg.dense)})
  batch['label'] = rng.randint(0, 2, cfg.batch).astype(np.float32)
  return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _shifted(cfg: Flagship, base, step: int):
  """``train_benchmark.py:167``: every step shifts the ids by one."""
  batch = dict(base)
  for i in range(cfg.tables):
    batch[f'c{i}'] = (base[f'c{i}'] + step) % cfg.vocab
  return batch


def _close(got, want, rtol, atol_of_max):
  """``allclose`` with ``atol`` a share of the reference's largest value."""
  return torch.allclose(got, want, rtol=rtol,
                        atol=atol_of_max * float(want.abs().max()))


def gpu_vs_cpu(cfg: Flagship, dev: torch.device, label: str, model: str,
               optimizer: str, dedup: bool = True, split: bool = False):
  """One full-width step on the GPU against the same step on the CPU.
  Returns the GPU state and step, to go on from, and the kernel launches
  of the GPU step."""
  cpu = torch.device('cpu')
  gstate, gstep = _setup(cfg, dev, model, optimizer, dedup, split)
  cstate, cstep = _setup(cfg, cpu, model, optimizer, dedup, split)
  _reset_counts()
  gstate, gm = gstep(gstate, _base_batch(cfg, dev))
  torch.cuda.synchronize()
  launches = _counts()
  cstate, cm = cstep(cstate, _base_batch(cfg, cpu))
  gloss, closs = float(gm['loss']), float(cm['loss'])
  # The loss comes from one forward pass of the same state: f32 matmul
  # sums in another order on the card, about 1e-6 relative.
  if not abs(gloss - closs) <= 1e-4 * abs(closs):
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
    report[f'{key}_max_abs_err'] = float((g - c).abs().max())
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
  # Adam's first step divides each gradient by its own size plus 1e-8: a
  # gradient near zero turns a 1e-10 order difference into up to
  # lr*1e-10/1e-8 = 1e-5 in its weight. 1e-4 leaves a tenfold margin.
  gp = {n: p.detach().cpu() for n, p in gstate.dense.named_parameters()}
  cp = {n: p.detach() for n, p in cstate.dense.named_parameters()}
  report['tower_max_abs_err'] = max(float((gp[n] - cp[n]).abs().max())
                                    for n in gp)
  for n in gp:
    if not torch.allclose(gp[n], cp[n], rtol=1e-4, atol=1e-4):
      raise AssertionError(f'{label}: tower param {n} differs: {report}')
  print(f'{label}: one full-width step, GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                    for k, v in report.items()))
  return gstate, gstep, launches


def timed(cfg: Flagship, dev: torch.device, label: str, state, step, smi,
          kernel: str, warmup=3, steps=30):
  """The step timed on the card: ``steps`` steps enqueued back to back
  after ``warmup``; CUDA events between consecutive steps. ``kernel``
  must have been launched once per step, and no other counted kernel."""
  base = _base_batch(cfg, dev)
  for i in range(warmup):
    state, _ = step(state, _shifted(cfg, base, i + 1))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  held = torch.cuda.memory_allocated(dev)

  _reset_counts()
  events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
  losses = []
  t0 = time.perf_counter()
  events[0].record()
  for i in range(steps):
    state, m = step(state, _shifted(cfg, base, warmup + 1 + i))
    events[i + 1].record()
    losses.append(m['loss'])
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  counts = _counts()
  _expect(f'{label}, {steps} steps', counts, **{kernel: steps})
  losses = torch.stack(losses)
  if not bool(torch.isfinite(losses).all()):
    raise AssertionError(f'{label}: non-finite loss: {losses.tolist()}')
  step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
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


def profile(cfg: Flagship, dev: torch.device, label: str, state, step,
            steps=10):
  """Device time per step by kernel class over ``steps`` traced steps,
  and the device's busy share of the traced span."""
  from torch.profiler import ProfilerActivity, profile as tprofile
  base = _base_batch(cfg, dev)
  torch.cuda.synchronize()
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(steps):
      state, _ = step(state, _shifted(cfg, base, 100 + i))
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
  cfg = Flagship()

  smi = phase0_environment()
  k = phase1_kernels(cfg, dev, tune=args.tune)
  state, dcn_step, counts = gpu_vs_cpu(cfg, dev, 'phase 2 (DCNv2 + Adagrad)',
                                       'dcnv2', 'adagrad')
  _expect('DCNv2 + Adagrad step', counts, adagrad_update_sorted=1)
  dcn_state, launches = timed(cfg, dev, 'phase 3 (DCNv2 + Adagrad flagship)',
                              state, dcn_step, smi, 'adagrad_update_sorted')
  k['adagrad_update_sorted']['launches'] = launches
  _, _, counts = gpu_vs_cpu(cfg, dev, 'phase 4 (DCNv2 + no-dedup Adagrad)',
                            'dcnv2', 'adagrad', dedup=False)
  _expect('no-dedup step', counts, adagrad_update_sorted=1)
  k['adagrad_update_sorted[dedup=False]']['launches'] = counts[
      'adagrad_update_sorted']
  state, dlrm_step, counts = gpu_vs_cpu(cfg, dev, 'phase 5 (DLRM + LazyAdam)',
                                        'dlrm', 'adam')
  _expect('LazyAdam step', counts, adam_update_sorted=1)
  dlrm_state, launches = timed(cfg, dev, 'phase 6 (DLRM + LazyAdam flagship)',
                               state, dlrm_step, smi, 'adam_update_sorted')
  k['adam_update_sorted']['launches'] = launches
  state, split_step, counts = gpu_vs_cpu(
      cfg, dev, 'phase 7 (DCNv2 + split-dense Adagrad)', 'dcnv2', 'adagrad',
      split=True)
  _expect('split-dense step', counts, gsum_dense_sorted=1)
  split_state, launches = timed(
      cfg, dev, 'phase 8 (DCNv2 + split-dense Adagrad flagship)', state,
      split_step, smi, 'gsum_dense_sorted')
  k['gsum_dense_sorted']['launches'] = launches
  if args.profile:
    profile(cfg, dev, 'DCNv2 + Adagrad', dcn_state, dcn_step)
    profile(cfg, dev, 'DLRM + LazyAdam', dlrm_state, dlrm_step)
    profile(cfg, dev, 'DCNv2 + split-dense Adagrad', split_state, split_step)

  rows = []
  for name, (source, replaces) in KERNELS.items():
    m = k[name]
    rows.append({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': m['launches'],
                 'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                 'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
                 'bound_by': m['bound_by'], 'bytes': m['bytes'],
                 'library_ms': m['library_ms']})
  print(json.dumps({'kernels': rows}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
