"""One-device context for the PyTorch port.

Counterpart of ``hybridbackend_tpu/framework/context.py``. The JAX
context owns a device mesh; this slice of the port runs on one device,
so the context is that device and a world of one. The device is always
given by the caller: nothing here picks a GPU when one is present or
falls back to the CPU when one is not.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Context:
  """The device every table, tower and batch of a run lives on; the
  world is this one device (rank 0 of 1). ``'cuda'`` without an index is
  the current CUDA device, ``cuda:<index>``: the device a tensor placed
  with ``.to('cuda')`` reports."""
  device: torch.device

  def __post_init__(self):
    device = torch.device(self.device)
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    object.__setattr__(self, 'device', device)


__all__ = ['Context']
