"""The device and the world of a run of the PyTorch port.

Counterpart of ``hybridbackend_tpu/framework/context.py:63-136``
(``world_size``, ``rank``, ``table_spec``). The JAX context owns a device
mesh; the port's unit is a process: one rank per process, one device per
rank, and the world is the ``torch.distributed`` process group the ranks
joined. ``Context(device)`` is a world of one, as in every earlier slice
of the port. :meth:`Context.join` joins the group that the port's
launcher (``python -m hybridbackend_tpu_torch.run``) describes in each
child's environment. The device is always given by the caller, or by the
launcher: nothing here picks a GPU when one is present or falls back to
the CPU when one is not.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch

# The launcher's rendezvous file, backend and the device its simulated
# ranks share (``run.py``); ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
# are torchrun's names.
STORE_ENV = 'HB_TORCH_RUN_STORE'
BACKEND_ENV = 'HB_TORCH_RUN_BACKEND'
SHARED_DEVICE_ENV = 'HB_TORCH_RUN_SHARED_DEVICE'
TIMEOUT_ENV = 'HB_TORCH_RUN_TIMEOUT'
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Context:
  """The device every table, tower and batch of a rank lives on, and the
  world of ranks. ``'cuda'`` without an index is the current CUDA device,
  ``cuda:<index>``: the device a tensor placed with ``.to('cuda')``
  reports.

  ``group`` is the process group of a joined world (see :meth:`join`);
  a context made directly is a world of one unless ``world_size`` says
  otherwise, and then its collectives run on the default group.
  ``store`` is the key-value store the ranks met through (a
  ``torch.distributed.Store``), which ``SyncReplicasIterator`` exchanges
  its per-step counts in, away from the group's collectives."""
  device: torch.device
  rank: int = 0
  world_size: int = 1
  local_rank: int = 0
  group: Any = dataclasses.field(default=None, compare=False, repr=False)
  store: Any = dataclasses.field(default=None, compare=False, repr=False)

  def __post_init__(self):
    device = torch.device(self.device)
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    object.__setattr__(self, 'device', device)
    if not 0 <= self.rank < self.world_size:
      raise ValueError(f'rank {self.rank} outside a world of '
                       f'{self.world_size}')

  @property
  def distributed(self) -> bool:
    """Whether collectives go through ``torch.distributed``: a world of
    more than one, or a joined world of one."""
    return self.world_size > 1 or self.group is not None

  @property
  def is_chief(self) -> bool:
    """Rank 0: the one rank that logs, reports and writes what the world
    writes once (the replicated checkpoint leaves, a bundle)."""
    return self.rank == 0

  def rows(self, n: int) -> slice:
    """This rank's contiguous share ``[r·n/W, (r+1)·n/W)`` of ``n`` rows
    (the JAX ``P(axes)`` split of a leading dimension): of a global
    batch, or of a row-sharded table's padded vocab. ``n`` must divide
    by the world."""
    if n % self.world_size:
      raise ValueError(f'{n} rows do not split evenly over a world of '
                       f'{self.world_size}')
    per = n // self.world_size
    return slice(self.rank * per, (self.rank + 1) * per)

  @classmethod
  def join(cls, device: Optional[str] = None, backend: Optional[str] = None,
           *, rank: Optional[int] = None, world_size: Optional[int] = None,
           init_method: Optional[str] = None,
           timeout_s: Optional[float] = None) -> 'Context':
    """Join the process group and return this rank's context.

    Every argument left None comes from the launcher's environment:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, the rendezvous file, the
    backend (``'nccl'`` or ``'gloo'``), the device (``'cuda'`` unless the
    caller names ``'cpu'``) and the deadline. ``timeout_s`` bounds every
    collective: a rank whose peers stopped raises instead of hanging.

    NCCL ranks use ``cuda:<local_rank>``, one card each; NCCL refuses two
    ranks on one card. Gloo ranks use ``cuda:<local_rank>`` too, unless
    the launcher's ``--simulate N --device cuda`` asked them to share one
    card, and then all are on it. A CPU device takes gloo."""
    env = os.environ
    rank = int(env.get('RANK', 0)) if rank is None else rank
    world_size = (int(env.get('WORLD_SIZE', 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get('LOCAL_RANK', rank))
    device = torch.device(device or 'cuda')
    backend = backend or env.get(BACKEND_ENV) or (
        'nccl' if device.type == 'cuda' else 'gloo')
    if device.type == 'cpu' and backend != 'gloo':
      raise ValueError(f'a CPU device takes the gloo backend, not {backend}')
    if device.type == 'cuda' and device.index is None:
      shared = env.get(SHARED_DEVICE_ENV)
      if shared and backend == 'nccl':
        raise ValueError('NCCL refuses two ranks on one card; ranks that '
                         'share a card run on gloo')
      device = torch.device(shared) if shared else torch.device(
          'cuda', local_rank)
    if device.type == 'cuda':
      torch.cuda.set_device(device)
    if init_method is None:
      store = env.get(STORE_ENV)
      init_method = f'file://{store}' if store else 'env://'
    timeout = datetime.timedelta(seconds=float(
        timeout_s if timeout_s is not None
        else env.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)))
    import torch.distributed as dist
    # The rendezvous ``init_process_group`` would make, kept: its store
    # also carries the data sync's exchange.
    store, rank, world_size = next(dist.rendezvous(
        init_method, rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    kwargs = dict(backend=backend, store=store, rank=rank,
                  world_size=world_size, timeout=timeout)
    if backend == 'nccl':
      kwargs['device_id'] = device
    dist.init_process_group(**kwargs)
    return cls(device, rank=rank, world_size=world_size,
               local_rank=local_rank, group=dist.group.WORLD, store=store)

  def leave(self) -> None:
    """Destroy the process group this context joined."""
    if self.group is not None:
      import torch.distributed as dist
      dist.destroy_process_group()


__all__ = ['Context']
