"""Schema validator CLI.

The port's own copy of ``hybridbackend_tpu/data/validate.py``, parity
with ``python -m hybridbackend.tensorflow.data.validate``
(``hybridbackend/tensorflow/data/validate.py:34-98``):
checks that field names, dtypes and ragged ranks are consistent across a
set of Parquet files.

Usage: ``python -m hybridbackend_tpu_torch.data.validate FILE [FILE...]``
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from hybridbackend_tpu_torch.data.parquet import _expand_files, infer_fields


def validate(filenames: List[str], format: str = 'parquet') -> List[str]:
  """Returns a list of human-readable inconsistency messages (empty=OK)."""
  files = _expand_files(filenames)
  problems: List[str] = []
  base = {f.name: f for f in infer_fields(files[0], format)}
  for fname in files[1:]:
    fields = {f.name: f for f in infer_fields(fname, format)}
    for name, f in fields.items():
      if name not in base:
        problems.append(f'{fname}: extra column {name!r}')
        continue
      b = base[name]
      if f.dtype != b.dtype:
        problems.append(
            f'{fname}: column {name!r} dtype {f.dtype} != {b.dtype} '
            f'(from {files[0]})')
      if f.ragged_rank != b.ragged_rank:
        problems.append(
            f'{fname}: column {name!r} ragged_rank {f.ragged_rank} != '
            f'{b.ragged_rank} (from {files[0]})')
    for name in base:
      if name not in fields:
        problems.append(f'{fname}: missing column {name!r}')
  return problems


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('files', nargs='+')
  p.add_argument('--format', default='parquet', choices=['parquet', 'orc'])
  args = p.parse_args(argv)
  problems = validate(args.files, args.format)
  if problems:
    for msg in problems:
      print(f'INCONSISTENT: {msg}', file=sys.stderr)
    return 1
  print('OK: schemas are consistent')
  return 0


if __name__ == '__main__':
  sys.exit(main())
