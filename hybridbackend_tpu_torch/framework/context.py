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

A world is laid out in nodes of ``local_world_size`` consecutive ranks
(torchrun's layout; one node unless the launcher's ``--nodes`` says
otherwise): rank ``r`` is local rank ``r % L`` of node ``r // L``, the
position ``(r // L, r % L)`` of the JAX package's ``(dcn, ici)`` mesh
(``num_hosts`` and ``local_world_size``, ``:91-97``). A joined world
also holds the two kinds of subgroup that the topology-aware exchange
runs on: the ranks of this rank's node (``intra_group``) and the ranks
of every node with this rank's local rank (``inter_group``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch

# The launcher's rendezvous file, backend, the device its simulated
# ranks share and the card of a rank of its own (``run.py``); ``RANK``,
# ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` are torchrun's
# names.
STORE_ENV = 'HB_TORCH_RUN_STORE'
BACKEND_ENV = 'HB_TORCH_RUN_BACKEND'
SHARED_DEVICE_ENV = 'HB_TORCH_RUN_SHARED_DEVICE'
CARD_ENV = 'HB_TORCH_RUN_CARD'
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
  its per-step counts in, away from the group's collectives.

  ``local_world_size`` is the ranks of a node (0: the world, one node);
  ``intra_group`` and ``inter_group`` are the joined world's subgroups
  of this rank's node and of this rank's local rank."""
  device: torch.device
  rank: int = 0
  world_size: int = 1
  local_world_size: int = 0
  group: Any = dataclasses.field(default=None, compare=False, repr=False)
  store: Any = dataclasses.field(default=None, compare=False, repr=False)
  intra_group: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)
  inter_group: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)

  def __post_init__(self):
    device = torch.device(self.device)
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    object.__setattr__(self, 'device', device)
    if not 0 <= self.rank < self.world_size:
      raise ValueError(f'rank {self.rank} outside a world of '
                       f'{self.world_size}')
    local = self.local_world_size or self.world_size
    if local < 1 or self.world_size % local:
      raise ValueError(f'nodes of {local} ranks do not split a world of '
                       f'{self.world_size}')
    object.__setattr__(self, 'local_world_size', local)

  @property
  def local_rank(self) -> int:
    """This rank's index in its node."""
    return self.rank % self.local_world_size

  @property
  def node(self) -> int:
    """This rank's node: the JAX mesh's ``dcn`` index."""
    return self.rank // self.local_world_size

  @property
  def num_nodes(self) -> int:
    """The world's nodes (JAX ``num_hosts``)."""
    return self.world_size // self.local_world_size

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
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE`` (the world when it is
    not set: one node), the rendezvous file, the backend (``'nccl'`` or
    ``'gloo'``), the device (``'cuda'`` unless the caller names
    ``'cpu'``) and the deadline. ``timeout_s`` bounds every collective: a
    rank whose peers stopped raises instead of hanging. Every rank then
    makes every node's subgroup and every local rank's, in one order
    (``torch.distributed.new_group`` is a collective of the world), and
    keeps its own two.

    The card is :func:`card_of`'s. A CPU device takes gloo."""
    env = os.environ
    rank = int(env.get('RANK', 0)) if rank is None else rank
    world_size = (int(env.get('WORLD_SIZE', 1)) if world_size is None
                  else world_size)
    local_world_size = int(env.get('LOCAL_WORLD_SIZE', world_size))
    device = torch.device(device or 'cuda')
    backend = backend or env.get(BACKEND_ENV) or (
        'nccl' if device.type == 'cuda' else 'gloo')
    if device.type == 'cpu' and backend != 'gloo':
      raise ValueError(f'a CPU device takes the gloo backend, not {backend}')
    device = card_of(device, backend, rank, env)
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
    ctx = cls(device, rank=rank, world_size=world_size,
              local_world_size=local_world_size, group=dist.group.WORLD,
              store=store)
    local, nodes = ctx.local_world_size, ctx.num_nodes
    groups = {}
    sub = dict(timeout=timeout)
    if backend == 'nccl':
      sub['device_id'] = device
    for name, members in (
        *(('intra', range(n * local, (n + 1) * local)) for n in range(nodes)),
        *(('inter', range(l, world_size, local)) for l in range(local))):
      group = dist.new_group(list(members), **sub)
      if rank in members:
        groups[name] = group
    return dataclasses.replace(ctx, intra_group=groups['intra'],
                               inter_group=groups['inter'])

  def leave(self) -> None:
    """Destroy the process group this context joined."""
    if self.group is not None:
      import torch.distributed as dist
      dist.destroy_process_group()


def card_of(device: torch.device, backend: str, rank: int,
            env=os.environ) -> torch.device:
  """The device a rank joins on. A CPU device or a card named by its
  index is the caller's. Otherwise ranks that the launcher's ``--simulate
  N --device cuda`` put on one card share it (gloo; NCCL refuses two
  ranks on one card). Any other rank takes a card of its own: the
  launcher's ``HB_TORCH_RUN_CARD``, the rank's index among the processes
  it started on this machine, which stays the rank's own when ``--nodes``
  gives two ranks one local rank; else ``LOCAL_RANK`` (torchrun's, one
  machine a node); else the rank."""
  if device.type != 'cuda' or device.index is not None:
    return device
  shared = env.get(SHARED_DEVICE_ENV)
  if shared:
    if backend == 'nccl':
      raise ValueError('NCCL refuses two ranks on one card; ranks that '
                       'share a card run on gloo')
    return torch.device(shared)
  return torch.device('cuda', int(env.get(CARD_ENV,
                                          env.get('LOCAL_RANK', rank))))


__all__ = ['Context', 'card_of']
