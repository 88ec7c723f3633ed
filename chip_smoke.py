#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``hybridbackend_tpu_torch/ops/csrc``
and drives the flagship sparse train step: 26 tables of [100000, 16]
stacked into one [2600000, 16] table, batch 8192 with 13 dense features,
a stacked DCNv2 tower (429x429 cross layer, MLP 1024-512-256-1), BCE
loss, Adam 1e-3 on the tower and row-sparse Adagrad 0.05 on the table.
Weights are random, drawn from a fixed seed.

Phases; any failure raises and the script exits nonzero:
  0. the card (nvidia-smi), torch/CUDA/nvcc versions, the kernel build;
  1. the kernel against its plain PyTorch version on the card, at the
     flagship update list, with both times;
  2. one full-width step on the GPU against the same step on the CPU;
  3. the flagship step timed on the card; the kernel must have been
     launched once per step.
The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it fails before printing
either.
"""

from __future__ import annotations

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
KERNEL_SOURCE = 'hybridbackend_tpu_torch/ops/csrc/adagrad_update.cu'
KERNEL_REPLACES = 'hybridbackend_tpu/ops/pallas/scatter.py:534'


@dataclasses.dataclass(frozen=True)
class Flagship:
  """``benchmarks/train_benchmark.py --sparse`` with its defaults."""
  tables: int = 26
  vocab: int = 100_000
  dim: int = 16
  dense: int = 13
  batch: int = 8192
  mlp: tuple = (1024, 512, 256, 1)
  table_lr: float = 0.05
  adagrad_init: float = 0.1
  dense_lr: float = 1e-3
  seed: int = 0


def _median_ms(fn, iters=20, warmup=3):
  """Median device time of ``fn`` over ``iters`` calls, by CUDA events."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
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
  lib = build.load('adagrad_update')
  print(f'kernel build: {lib.build_seconds:.3f} s nvcc, '
        f'{time.perf_counter() - t0:.3f} s to load ({lib.path.name})')
  for line in lib.compiler_log.splitlines():
    if 'registers' in line or 'spill' in line:
      print(f'  ptxas: {line.strip()}')
  return smi


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


def phase1_kernel(cfg: Flagship, dev: torch.device):
  import hybridbackend_tpu_torch as hbt
  v = cfg.tables * cfg.vocab
  ids, grads = _update_list(cfg, 3, np.random.RandomState(cfg.seed))
  rows, order = torch.sort(torch.from_numpy(ids).to(dev), stable=True)
  g = torch.from_numpy(grads).to(dev).index_select(0, order)
  gen = torch.Generator().manual_seed(cfg.seed)
  table0 = hbt.default_initializer(gen, (v, cfg.dim)).to(dev)
  acc0 = torch.full_like(table0, cfg.adagrad_init)
  lr = torch.full((), cfg.table_lr, device=dev)

  tk, ak = table0.clone(), acc0.clone()
  hbt.adagrad_update_sorted(tk, ak, rows, g, lr)
  tr, ar = table0.clone(), acc0.clone()
  hbt.adagrad_update_sorted_reference(tr, ar, rows, g, lr)
  torch.cuda.synchronize()
  err = max(float((tk - tr).abs().max()), float((ak - ar).abs().max()))
  # 1e-5: duplicate gradients summed in another f32 order.
  for name, got, want in (('table', tk, tr), ('acc', ak, ar)):
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
      raise AssertionError(f'kernel {name} differs from the plain version '
                           f'(max abs err {err})')
  touched = torch.zeros(v, dtype=torch.bool, device=dev)
  touched[rows[(rows >= 0) & (rows < v)].long()] = True
  if not (torch.equal(tk[~touched], table0[~touched])
          and torch.equal(ak[~touched], acc0[~touched])):
    raise AssertionError('kernel changed rows the update list does not hold')
  n_touched = int(touched.sum())

  ms = _median_ms(lambda: hbt.adagrad_update_sorted(tk, ak, rows, g, lr))
  plain_ms = _median_ms(
      lambda: hbt.adagrad_update_sorted_reference(tr, ar, rows, g, lr))
  st = hbt.init_adagrad_state(tk)
  stacked = hbt.TableConfig('stack', v, cfg.dim)
  raw_ids = torch.from_numpy(ids).to(dev)
  raw_g = torch.from_numpy(grads).to(dev)
  path_ms = _median_ms(lambda: hbt.sparse_adagrad_apply(
      tk, st, raw_ids, raw_g, stacked, lr))
  print(f'phase 1: kernel vs plain at [{v}, {cfg.dim}], {ids.shape[0]} '
        f'rows, {n_touched} distinct: max abs err {err:.3e}; '
        f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; '
        f'sort+gather+kernel {path_ms:.4f} ms')
  return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _bce(tower, emb_f, dense_f, batch):
  p = torch.clamp(tower(emb_f + dense_f), 1e-6, 1 - 1e-6)
  y = batch['label']
  return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p)), {}


def _setup(cfg: Flagship, dev: torch.device):
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
  tower = hbt.StackedDCNv2([cfg.dim] * cfg.tables + [1] * cfg.dense,
                           list(cfg.mlp), generator=gen, device=dev)
  state = hbt.SparseTrainState.create(
      tower, tables, functools.partial(torch.optim.Adam, lr=cfg.dense_lr),
      adagrad_init=cfg.adagrad_init)
  step = hbt.make_sparse_train_step(fx, _bce, table_lr=cfg.table_lr)
  return fx, state, step


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


def _params(state):
  return {n: p.detach() for n, p in state.dense.named_parameters()}


def phase2_gpu_vs_cpu(cfg: Flagship, dev: torch.device):
  cpu = torch.device('cpu')
  _, gstate, gstep = _setup(cfg, dev)
  _, cstate, cstep = _setup(cfg, cpu)
  gstate, gm = gstep(gstate, _base_batch(cfg, dev))
  cstate, cm = cstep(cstate, _base_batch(cfg, cpu))
  torch.cuda.synchronize()
  gloss, closs = float(gm['loss']), float(cm['loss'])
  # The loss comes from one forward pass of the same state: f32 matmul
  # sums in another order on the card, about 1e-6 relative.
  if not abs(gloss - closs) <= 1e-4 * abs(closs):
    raise AssertionError(f'loss {gloss} on the GPU, {closs} on the CPU')
  report = {'loss_rel_err': abs(gloss - closs) / abs(closs)}
  (name,) = gstate.tables
  pairs = {'table': (gstate.tables[name], cstate.tables[name]),
           'acc': (gstate.table_opt[name].acc[0],
                   cstate.table_opt[name].acc[0])}
  # Table and acc move by 0.05*g/sqrt(0.1+g^2) with g ~ 1e-4, so the
  # gradients' order error stays far below 1e-5.
  for key, (g, c) in pairs.items():
    g = g.cpu()
    report[f'{key}_max_abs_err'] = float((g - c).abs().max())
    if not torch.allclose(g, c, rtol=1e-5, atol=1e-5):
      raise AssertionError(f'{key} differs: {report}')
  # Adam's first step divides each gradient by its own size plus 1e-8: a
  # gradient near zero turns a 1e-10 order difference into up to
  # lr*1e-10/1e-8 = 1e-5 in its weight. 1e-4 leaves a tenfold margin.
  gp, cp = _params(gstate), _params(cstate)
  report['tower_max_abs_err'] = max(float((gp[n].cpu() - cp[n]).abs().max())
                                    for n in gp)
  for n in gp:
    if not torch.allclose(gp[n].cpu(), cp[n], rtol=1e-4, atol=1e-4):
      raise AssertionError(f'tower param {n} differs: {report}')
  print('phase 2: one full-width step, GPU vs CPU: '
        + ', '.join(f'{k} {v:.3e}' for k, v in report.items()))
  return gstate, gstep


def phase3_flagship(cfg: Flagship, dev: torch.device, state, step, smi,
                    warmup=3, timed=30):
  import hybridbackend_tpu_torch as hbt
  base = _base_batch(cfg, dev)
  for i in range(warmup):
    state, _ = step(state, _shifted(cfg, base, i + 1))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)

  hbt.adagrad_update_sorted.launches = 0
  events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
  losses = []
  t0 = time.perf_counter()
  events[0].record()
  for i in range(timed):
    state, m = step(state, _shifted(cfg, base, warmup + 1 + i))
    events[i + 1].record()
    losses.append(m['loss'])
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = hbt.adagrad_update_sorted.launches

  if launches != timed:
    raise AssertionError(f'update kernel launched {launches} times in '
                         f'{timed} steps')
  losses = torch.stack(losses)
  if not bool(torch.isfinite(losses).all()):
    raise AssertionError(f'non-finite loss: {losses.tolist()}')
  step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(timed)]
  med = statistics.median(step_ms)
  print(f'phase 3: flagship step on {smi}: median {med:.4f} ms/step '
        f'(device events, {timed} steps; min {min(step_ms):.4f}, max '
        f'{max(step_ms):.4f}), {cfg.batch / med * 1e3:.1f} examples/s; '
        f'host clock {wall / timed * 1e3:.4f} ms/step; peak memory '
        f'{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; '
        f'loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}')
  return launches


def main() -> int:
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this smoke run needs one',
          file=sys.stderr)
    return 1
  import hybridbackend_tpu_torch
  if not os.path.abspath(hybridbackend_tpu_torch.__file__).startswith(
      os.path.join(HERE, 'hybridbackend_tpu_torch')):
    raise RuntimeError('hybridbackend_tpu_torch must come from this '
                       f'checkout, not {hybridbackend_tpu_torch.__file__}')
  # Exact f32 on both sides of every comparison.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  cfg = Flagship()

  smi = phase0_environment()
  k = phase1_kernel(cfg, dev)
  state, step = phase2_gpu_vs_cpu(cfg, dev)
  launches = phase3_flagship(cfg, dev, state, step, smi)

  print(json.dumps({'kernels': [{
      'name': 'adagrad_update_sorted', 'route': 'cuda',
      'source': KERNEL_SOURCE, 'replaces': KERNEL_REPLACES,
      'launches': launches, **k}]}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
