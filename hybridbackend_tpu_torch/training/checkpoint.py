"""Checkpoints of a training state, kept by step, at any world size.

Counterpart of ``hybridbackend_tpu/training/checkpoint.py:1-169``
(``CheckpointManager``), where orbax writes each host's shards of the
global arrays. A state is a nested dict (lists and tuples allowed) of
tensors, :class:`Shard` leaves and host values. A :class:`Shard` is a
rank's rows of a row-sharded table or slot, with where they stand among
the table's logical rows (its rows at a world of one), or a rank's
columns of a column-sharded one (every row, some columns), with where
they stand among its columns; every other tensor is the same on every
rank. Tables are stored by their logical
rows, so a checkpoint does not depend on the world that wrote it: a
world pads a table's rows up to a multiple of itself, and a stack's
members each to one (``padded_vocab``, ``build_stacks``), and those
rows are no logical rows.

Two layouts, both read at any world:

* a world of one writes ``checkpoint-<step>.pt``, one ``torch.save`` of
  the whole state, under a name of this process's own and then moved into
  place with ``os.replace``, so a reader never sees half a file;
* a world of more than one rank (``ctx``) writes the directory
  ``checkpoint-<step>/``: each rank its own rows (or columns) of every
  shard, with the rows and columns they are, in ``rank-<r>.pt``; rank 0 the replicated leaves in
  ``replicated.pt``; then, once every rank has written (a barrier), rank
  0 writes ``manifest.json``. A reader sees a step only once its
  manifest exists. Nothing is gathered on the way out. Only rank 0
  prunes old steps. Each file, too, is written under a temporary name and
  moved into place.

``restore(template)`` follows the JAX rules: the result has the
template's structure; a key the checkpoint lacks keeps the template's
value (a newly added table starts fresh); a stored key the template
lacks is dropped; each stored tensor takes the template tensor's device
and dtype. A :class:`Shard` of the template restores to a tensor of its
shape holding the logical rows it covers, read from whichever files hold
them; its other rows (the world's padding) keep the template's own
values. With ``grow_vocab``, a stored ``[V1, d]`` tensor restores
into a ``[V2 > V1, d]`` template (or a shard of one) as its first ``V1``
rows, the template's fresh rows after them (vocabulary growth between
runs; only meaningful for tables whose rows are not mixed,
``shuffle_ids=False``, and for the last member of a stack). Any other
shape mismatch raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from hybridbackend_tpu_torch.framework.context import Context

_FILE = re.compile(r'^checkpoint-(\d+)\.pt$')
_DIR = re.compile(r'^checkpoint-(\d+)$')
_MANIFEST = 'manifest.json'
_SHARD_KEY = '__hb_shard_rows__'     # a shard's place in replicated.pt
_WIDTH_KEY = '__hb_shard_width__'    # and a column shard's whole width


Segments = Tuple[Tuple[int, int, int], ...]


@dataclasses.dataclass
class Shard:
  """A rank's rows of a sharded leaf of ``rows`` logical rows:
  ``segments`` of ``(first row of value, first logical row, rows)``; a
  row of ``value`` that no segment names is padding. A column shard's
  ``value`` holds the leaf's columns ``[col, col + value.shape[1])`` of
  its ``width``."""
  value: torch.Tensor
  segments: Segments
  rows: int
  col: int = 0
  width: Optional[int] = None

  @classmethod
  def of_rows(cls, value: torch.Tensor, start: int, rows: int,
              col: int = 0, width: Optional[int] = None) -> 'Shard':
    """Rows ``[start, start + len(value))`` of a table's rows padded to a
    world, of which the first ``rows`` are its logical ones (and of a
    column shard, its columns from ``col`` of ``width``)."""
    n = max(0, min(value.shape[0], rows - start))
    return cls(value, ((0, start, n),) if n else (), rows, col, width)


def _width(t: torch.Tensor) -> int:
  return t.shape[1] if t.dim() > 1 else 1


def _leaf(template) -> Tuple[torch.Tensor, Segments, int, int, int]:
  """``(tensor, segments, logical rows, first column, width)`` of a
  tensor or shard leaf."""
  if isinstance(template, Shard):
    return (template.value, template.segments, template.rows, template.col,
            template.width or _width(template.value))
  n = template.shape[0] if template.dim() else 0
  return template, ((0, 0, n),), n, 0, _width(template)


def _write(obj: Any, path: str) -> None:
  tmp = os.path.join(os.path.dirname(path),
                     f'.{os.path.basename(path)}.{os.getpid()}.tmp')
  torch.save(obj, tmp)
  os.replace(tmp, path)


class _Pieces:
  """The shard rows a sharded checkpoint's rank files hold, by leaf
  path, loaded when first asked for (memory-mapped, on the CPU)."""

  def __init__(self, directory: str):
    self._dir = directory
    self._files: Optional[List[Dict[str, Any]]] = None

  def __getitem__(self, path: str) -> List[Dict[str, Any]]:
    if self._files is None:
      names = sorted(n for n in os.listdir(self._dir)
                     if re.match(r'^rank-\d+\.pt$', n))
      self._files = [torch.load(os.path.join(self._dir, n),
                                map_location='cpu', weights_only=True,
                                mmap=True) for n in names]
    return [f[path] for f in self._files if path in f]


class CheckpointManager:
  """Saves, lists, prunes and restores the checkpoints of one directory.

  ``ctx``: the world that saves (a world of one when None); every rank
  of a world of more than one rank calls :meth:`save` at the same step.
  """

  def __init__(self, directory: str, max_to_keep: Optional[int] = 5, *,
               device: torch.device, grow_vocab: bool = False,
               ctx: Optional[Context] = None):
    self._dir = os.path.abspath(directory)
    self._max_to_keep = max_to_keep
    self._device = torch.device(device)
    self._grow = grow_vocab
    self._ctx = ctx
    os.makedirs(self._dir, exist_ok=True)

  @property
  def _world(self) -> int:
    return self._ctx.world_size if self._ctx is not None else 1

  def _path(self, step: int) -> str:
    return os.path.join(self._dir, f'checkpoint-{step}.pt')

  def _dir_of(self, step: int) -> str:
    return os.path.join(self._dir, f'checkpoint-{step}')

  def all_steps(self) -> List[int]:
    steps = []
    for name in os.listdir(self._dir):
      m = _FILE.match(name)
      if m:
        steps.append(int(m.group(1)))
        continue
      m = _DIR.match(name)
      if m and os.path.exists(os.path.join(self._dir, name, _MANIFEST)):
        steps.append(int(m.group(1)))
    return sorted(steps)

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, step: int, state: Any) -> bool:
    """Write ``state`` as step ``step``. A step at or before the latest
    saved one is skipped (returns False), as orbax's manager does."""
    latest = self.latest_step()
    if latest is not None and step <= latest:
      return False
    if self._world == 1:
      _write(_unshard(state), self._path(step))
      self._prune()
      return True
    ctx = self._ctx
    out = self._dir_of(step)
    os.makedirs(out, exist_ok=True)
    pieces: Dict[str, Any] = {}
    replicated = _split(state, '', pieces)
    _write(pieces, os.path.join(out, f'rank-{ctx.rank}.pt'))
    if ctx.is_chief:
      _write(replicated, os.path.join(out, 'replicated.pt'))
    self._barrier()
    if ctx.is_chief:
      tmp = os.path.join(out, f'.{_MANIFEST}.tmp')
      with open(tmp, 'w') as f:
        json.dump({'step': step, 'world': ctx.world_size}, f)
      os.replace(tmp, os.path.join(out, _MANIFEST))
      self._prune()
    # Every rank sees the manifest before it decides its next save.
    self._barrier()
    return True

  def _barrier(self) -> None:
    from hybridbackend_tpu_torch.distribute import collective
    float(collective.allreduce(torch.zeros(1, device=self._ctx.device),
                               ctx=self._ctx))

  def _prune(self) -> None:
    if not self._max_to_keep:
      return
    for old in self.all_steps()[:-self._max_to_keep]:
      if os.path.exists(self._path(old)):
        os.remove(self._path(old))
      else:
        shutil.rmtree(self._dir_of(old), ignore_errors=True)

  def restore(self, template: Any, step: Optional[int] = None) -> Any:
    """The checkpoint of ``step`` (the latest by default) in the
    template's structure, every :class:`Shard` of it a tensor of its
    rows; the template itself when there is none."""
    if step is None:
      step = self.latest_step()
    if step is None:
      return template
    if os.path.exists(self._path(step)):
      stored = torch.load(self._path(step), map_location=self._device,
                          weights_only=True)
      return self._merge(stored, template, '', None)
    directory = self._dir_of(step)
    stored = torch.load(os.path.join(directory, 'replicated.pt'),
                        map_location=self._device, weights_only=True)
    return self._merge(stored, template, '', _Pieces(directory))

  def _merge(self, stored: Any, template: Any, path: str,
             pieces: Optional[_Pieces]) -> Any:
    if isinstance(template, dict):
      if not isinstance(stored, dict):
        raise ValueError(f'{path or "/"}: stored {type(stored).__name__}, '
                         'the template has a dict')
      return {k: (self._merge(stored[k], v, f'{path}/{k}', pieces)
                  if k in stored else v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
      if not isinstance(stored, (list, tuple)) or len(stored) != len(
          template):
        raise ValueError(f'{path}: stored {stored!r:.80} does not fit a '
                         f'sequence of {len(template)}')
      return type(template)(self._merge(s, t, f'{path}/{i}', pieces)
                            for i, (s, t) in enumerate(zip(stored, template)))
    if isinstance(stored, dict) and _SHARD_KEY in stored:
      return self._rows(stored[_SHARD_KEY], stored.get(_WIDTH_KEY),
                        pieces[path], template, path)
    if isinstance(template, Shard):
      piece = {'segments': [(0, 0, stored.shape[0])], 'value': stored}
      return self._rows(stored.shape[0], None, [piece], template, path)
    if not isinstance(template, torch.Tensor):
      return stored
    value = stored.to(device=template.device, dtype=template.dtype)
    if value.shape == template.shape:
      return value
    if (self._grow and value.dim() == template.dim() == 2
        and value.shape[1] == template.shape[1]
        and value.shape[0] < template.shape[0]):
      grown = template.clone()
      grown[:value.shape[0]] = value
      return grown
    raise ValueError(f'{path}: stored {tuple(value.shape)} does not fit '
                     f'{tuple(template.shape)}')

  def _rows(self, stored_rows: int, stored_width: Optional[int],
            pieces: List[Dict[str, Any]], template: Any,
            path: str) -> torch.Tensor:
    """The template leaf's rows: its logical ones, in its columns, from
    the stored ``pieces`` (each ``{'segments', 'value'}``, and a column
    piece's first column ``'col'``) of a leaf ``stored_width`` wide
    (None: as wide as a piece), its padding its own."""
    value, segments, rows, col, width = _leaf(template)
    if stored_rows != rows and not (self._grow and stored_rows < rows):
      raise ValueError(f'{path}: stored {stored_rows} rows do not fit '
                       f'{rows}')
    out = value.clone()
    for piece in pieces:
      src = piece['value']
      if (src.shape[2:] != out.shape[2:]
          or (stored_width or _width(src)) != width):
        raise ValueError(f'{path}: stored rows of {tuple(src.shape[1:])} '
                         f'(of {stored_width or _width(src)} columns) do '
                         f'not fit {tuple(out.shape[1:])} (of {width})')
    for t_row, t_logical, t_count in segments:
      lo, hi = t_logical, min(t_logical + t_count, stored_rows)
      for piece in pieces:
        src, p_col = piece['value'], piece.get('col', 0)
        c0 = max(col, p_col)
        c1 = min(col + _width(out), p_col + _width(src))
        if c1 <= c0:
          continue
        for p_row, p_logical, p_count in piece['segments']:
          a, b = max(lo, p_logical), min(hi, p_logical + p_count)
          if b > a:
            rows_in = src[p_row + a - p_logical:p_row + b - p_logical]
            rows_out = out[t_row + a - t_logical:t_row + b - t_logical]
            if out.dim() > 1:
              rows_in = rows_in[:, c0 - p_col:c1 - p_col]
              rows_out = rows_out[:, c0 - col:c1 - col]
            rows_out.copy_(rows_in.to(device=out.device, dtype=out.dtype))
    return out


def _unshard(state: Any) -> Any:
  """``state`` with each :class:`Shard` its tensor (a world of one holds
  every row)."""
  if isinstance(state, dict):
    return {k: _unshard(v) for k, v in state.items()}
  if isinstance(state, (list, tuple)):
    return type(state)(_unshard(v) for v in state)
  return state.value if isinstance(state, Shard) else state


def _split(state: Any, path: str, pieces: Dict[str, Any]) -> Any:
  """``state`` with each :class:`Shard` replaced by its logical rows'
  count, its rows put into ``pieces`` under its path."""
  if isinstance(state, dict):
    return {k: _split(v, f'{path}/{k}', pieces) for k, v in state.items()}
  if isinstance(state, (list, tuple)):
    return type(state)(_split(v, f'{path}/{i}', pieces)
                       for i, v in enumerate(state))
  if isinstance(state, Shard):
    pieces[path] = {'segments': [list(s) for s in state.segments],
                    'value': state.value, 'col': state.col}
    if state.width is None:
      return {_SHARD_KEY: state.rows}
    return {_SHARD_KEY: state.rows, _WIDTH_KEY: state.width}
  return state


__all__ = ['CheckpointManager', 'Shard']
