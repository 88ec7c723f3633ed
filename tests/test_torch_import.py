"""The PyTorch port imports no JAX and builds no kernel at import.

The modules of the port, and the worker that the world-of-N tests start
in each rank (``tests/torch_sharded_worker.py``), are imported in a
fresh process, from the root of the repository."""

import os
import subprocess
import sys
import textwrap

import torch

import hybridbackend_tpu_torch as hbt


def test_import_leaves_jax_out():
  code = textwrap.dedent("""
      import sys
      import hybridbackend_tpu_torch
      import hybridbackend_tpu_torch.benchmarks.auc_parity
      import hybridbackend_tpu_torch.benchmarks.data_benchmark
      import hybridbackend_tpu_torch.benchmarks.din_benchmark
      import hybridbackend_tpu_torch.benchmarks.e2e_benchmark
      import hybridbackend_tpu_torch.benchmarks.serving_benchmark
      import hybridbackend_tpu_torch.benchmarks.synthetic
      import hybridbackend_tpu_torch.benchmarks.train_benchmark
      import hybridbackend_tpu_torch.data.dataframe
      import hybridbackend_tpu_torch.data.deduplicate
      import hybridbackend_tpu_torch.data.parquet
      import hybridbackend_tpu_torch.data.prefetch
      import hybridbackend_tpu_torch.data.rebatch
      import hybridbackend_tpu_torch.data.sync
      import hybridbackend_tpu_torch.data.validate
      import hybridbackend_tpu_torch.distribute
      import hybridbackend_tpu_torch.distribute.collective
      import hybridbackend_tpu_torch.distribute.partition
      import hybridbackend_tpu_torch.embedding.dynamic
      import hybridbackend_tpu_torch.embedding.quant
      import hybridbackend_tpu_torch.embedding.service
      import hybridbackend_tpu_torch.embedding.unique
      import hybridbackend_tpu_torch.estimator
      import hybridbackend_tpu_torch.examples.criteo.train
      import hybridbackend_tpu_torch.examples.taobao.train_din
      import hybridbackend_tpu_torch.metrics
      import hybridbackend_tpu_torch.native.idmap
      import hybridbackend_tpu_torch.native.tabular
      import hybridbackend_tpu_torch.pipeline
      import hybridbackend_tpu_torch.pipeline.interleave
      import hybridbackend_tpu_torch.run
      import hybridbackend_tpu_torch.training.checkpoint
      import hybridbackend_tpu_torch.training.hooks
      import hybridbackend_tpu_torch.training.optimizer
      import hybridbackend_tpu_torch.training.saved_model
      import hybridbackend_tpu_torch.training.train
      import runpy
      runpy.run_path('tests/torch_sharded_worker.py', run_name='worker')
      bad = sorted(m for m in sys.modules
                   if m == 'jax' or m.startswith('jax.')
                   or m == 'hybridbackend_tpu'
                   or m.startswith('hybridbackend_tpu.'))
      print(repr(bad))
  """)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, check=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
  assert out.stdout.strip() == '[]', out.stdout


def test_cpu_wrapper_does_not_count_a_launch():
  table = torch.zeros((8, 4))
  acc = torch.full((8, 4), 0.1)
  rows = torch.tensor([1, 1, 3], dtype=torch.int32)
  before = hbt.adagrad_update_sorted.launches
  hbt.adagrad_update_sorted(table, acc, rows, torch.ones((3, 4)), 0.05)
  assert hbt.adagrad_update_sorted.launches == before
  assert bool((acc[1] > 0.1).all())               # updated by the plain path
  assert torch.equal(acc[0], torch.full((4,), 0.1))  # untouched row


def test_import_builds_no_native_library():
  code = textwrap.dedent("""
      import hybridbackend_tpu_torch
      from hybridbackend_tpu_torch.native import idmap, tabular
      print(idmap._LOADED, tabular._LOADED)
  """)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, check=True, timeout=120)
  assert out.stdout.strip() == '{} {}', out.stdout
