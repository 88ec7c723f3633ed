"""Checkpoints of a training state, kept by step.

Counterpart of ``hybridbackend_tpu/training/checkpoint.py:40-169``
(``CheckpointManager``). A state is a nested dict (lists and tuples
allowed) of tensors and host values; the port's tables are in their
logical ``[V, d]`` layout, so a checkpoint does not depend on the world
size. Each step is one file, ``checkpoint-<step>.pt``, written with
``torch.save`` under a name of this process's own and then moved into
place with ``os.replace``, so a reader never sees half a file and two
writers never share a temporary name.

``restore(template)`` follows the JAX rules: the result has the
template's structure; a key the checkpoint lacks keeps the template's
value (a newly added table starts fresh); a stored key the template
lacks is dropped; each stored tensor takes the template tensor's device
and dtype. The file is read with ``map_location`` set to the manager's
device. With ``grow_vocab``, a stored ``[V1, d]`` tensor restores into a
``[V2 > V1, d]`` template as its first ``V1`` rows, the template's fresh
rows after them (vocabulary growth between runs; only meaningful for
tables whose rows are not mixed, ``shuffle_ids=False``, and for the last
member of a stack). Any other shape mismatch raises.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r'^checkpoint-(\d+)\.pt$')


class CheckpointManager:
  """Saves, lists, prunes and restores the checkpoints of one directory."""

  def __init__(self, directory: str, max_to_keep: Optional[int] = 5, *,
               device: torch.device, grow_vocab: bool = False):
    self._dir = os.path.abspath(directory)
    self._max_to_keep = max_to_keep
    self._device = torch.device(device)
    self._grow = grow_vocab
    os.makedirs(self._dir, exist_ok=True)

  def _path(self, step: int) -> str:
    return os.path.join(self._dir, f'checkpoint-{step}.pt')

  def all_steps(self) -> List[int]:
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(self._dir)) if m)

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, step: int, state: Any) -> bool:
    """Write ``state`` as step ``step``. A step at or before the latest
    saved one is skipped (returns False), as orbax's manager does."""
    latest = self.latest_step()
    if latest is not None and step <= latest:
      return False
    tmp = os.path.join(self._dir, f'.checkpoint-{step}.pt.{os.getpid()}.tmp')
    torch.save(state, tmp)
    os.replace(tmp, self._path(step))
    if self._max_to_keep:
      for old in self.all_steps()[:-self._max_to_keep]:
        os.remove(self._path(old))
    return True

  def restore(self, template: Any, step: Optional[int] = None) -> Any:
    """The checkpoint of ``step`` (the latest by default) in the
    template's structure; the template itself when there is none."""
    if step is None:
      step = self.latest_step()
    if step is None:
      return template
    stored = torch.load(self._path(step), map_location=self._device,
                        weights_only=True)
    return self._merge(stored, template, '')

  def _merge(self, stored: Any, template: Any, path: str) -> Any:
    if isinstance(template, dict):
      if not isinstance(stored, dict):
        raise ValueError(f'{path or "/"}: stored {type(stored).__name__}, '
                         'the template has a dict')
      return {k: (self._merge(stored[k], v, f'{path}/{k}') if k in stored
                  else v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
      if not isinstance(stored, (list, tuple)) or len(stored) != len(
          template):
        raise ValueError(f'{path}: stored {stored!r:.80} does not fit a '
                         f'sequence of {len(template)}')
      return type(template)(self._merge(s, t, f'{path}/{i}') for i, (s, t)
                            in enumerate(zip(stored, template)))
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


__all__ = ['CheckpointManager']
