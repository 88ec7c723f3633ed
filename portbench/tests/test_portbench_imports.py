"""Nothing the benchmark loads is JAX or the JAX package; the reference
loads nothing of the port; no file reads the JAX-era benchmark files."""

import ast
import os
import re
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hybridbackend_tpu')

_TINY_RUN = '''
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from conftest import tiny
from portbench import harness
cell = tiny(harness.load_cell({root!r}, 'dlrm-criteo1tb.zipf'))
harness.run_cell(cell, 11, 1.0, True, torch.device('cpu'), time.perf_counter())
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
'''

_REFERENCE = '''
import glob, os, sys
sys.path.insert(0, {root!r})
from portbench import harness
for path in sorted(glob.glob(os.path.join({root!r}, 'portbench', 'reference',
                                          '*.py'))):
  harness.load_module(path, 'ref_' + os.path.basename(path)[:-3])
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
'''


def _top_level(code: str):
  proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                        text=True, timeout=600, cwd=ROOT)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return set(proc.stdout.split())


def test_a_tiny_run_loads_no_jax():
  names = _top_level(_TINY_RUN.format(
      root=ROOT, tests=os.path.dirname(os.path.abspath(__file__))))
  assert 'hybridbackend_tpu_torch' in names
  assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
  names = _top_level(_REFERENCE.format(root=ROOT))
  assert not names & {*FORBIDDEN, 'hybridbackend_tpu_torch'}


def _sources():
  for dirpath, _, files in os.walk(os.path.join(ROOT, 'portbench')):
    for f in files:
      if f.endswith('.py') and not dirpath.endswith('tests'):
        with open(os.path.join(dirpath, f)) as fh:
          yield os.path.join(dirpath, f), ast.parse(fh.read())


def _imports(tree):
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def _strings(tree):
  """String constants that are not docstrings."""
  docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)
          and isinstance(n.value, ast.Constant)}
  for node in ast.walk(tree):
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docs):
      yield node.value


def test_no_file_imports_the_port_s_harnesses_or_the_jax_era_files():
  era = re.compile(r'BENCH_r0|BASELINE\.|MULTICHIP_r0|bench\.py|chip_smoke|'
                   r'^benchmarks/')
  for path, tree in _sources():
    for mod in _imports(tree):
      top = mod.split('.')[0]
      assert top not in FORBIDDEN and top not in ('benchmarks', 'chip_smoke'), (
          path, mod)
      assert not mod.startswith('hybridbackend_tpu_torch.benchmarks'), (
          path, mod)
    for text in _strings(tree):
      assert not era.search(text), (path, text)


def test_the_reference_imports_nothing_of_the_port():
  for path, tree in _sources():
    if os.sep + 'reference' + os.sep in path:
      for mod in _imports(tree):
        assert mod.split('.')[0] not in (*FORBIDDEN, 'hybridbackend_tpu_torch'), (
            path, mod)
