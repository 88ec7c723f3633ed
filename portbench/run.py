"""Run one cell of the port's benchmark once.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``hybridbackend_tpu_torch``). It loads the cell, sets it
up, measures for ``--seconds`` and prints one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics from a traced window, with ``breakdown``), ``device``
and, last, ``checks``, each number compared with its limit, which also
end standard error. It exits with another code than 0, and prints no
result, when there is no CUDA device or fewer than the cell asks for,
or when JAX or the JAX package was loaded.

``setup_s`` runs from this file's first line to the first timed step.
The port builds its kernels into ``hybridbackend_tpu_torch/_build/``
inside the checkout; the caches of Triton and of PyTorch's extensions
are pointed at ``.portbench_cache/`` there too.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def _environment() -> None:
  cache = os.path.join(ROOT, '.portbench_cache')
  os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_extensions')
  # A library of the port's that could load JAX by itself must not.
  os.environ['USE_FLAX'] = '0'
  os.environ['USE_JAX'] = '0'
  if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
  args = parse_args(argv)
  _environment()
  import torch
  from portbench import harness
  cell = harness.load_cell(ROOT, args.workload)
  if not torch.cuda.is_available():
    print('portbench: no CUDA device', file=sys.stderr)
    return 2
  if torch.cuda.device_count() < cell.chips:
    print(f'portbench: {args.workload} needs {cell.chips} CUDA devices, '
          f'found {torch.cuda.device_count()}', file=sys.stderr)
    return 2
  device = torch.device('cuda', 0)
  torch.cuda.set_device(device)
  result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, _T0)
  found = harness.forbidden_modules()
  if found:
    print(f'portbench: loaded JAX modules: {", ".join(found)}',
          file=sys.stderr)
    return 3
  print(f'portbench: {args.workload} seed {args.seed} on '
        f'{harness.card()}: memory peak '
        f'{result["device"]["memory_peak_bytes"]} bytes')
  for name, c in result['checks'].items():
    print(f'check {name} {c["value"]!r} limit {c["limit"]!r} '
          f'(worst: {c["worst"]})', file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result))
  return 0


if __name__ == '__main__':
  sys.exit(main())
