"""The port's input path on the CPU: ``DeviceIterator`` (order, dtypes,
one copy per dtype with the columns as views of it, the capacity bound, ``close`` with a producer blocked on a full queue, a
producer exception re-raised, ``stall_stats`` and ``reset_stall_stats``)
and the one-replica ``SyncReplicasIterator`` against the JAX one in a
one-device context, in train and eval mode. Batches compare bit for bit.
"""

import sys
import time

import jax
import numpy as np
import pytest
import torch

from hybridbackend_tpu.data.sync import (
    SYNC_VALID_KEY as JAX_SYNC_VALID_KEY,
    SyncReplicasIterator as JSyncReplicasIterator)
from hybridbackend_tpu.framework.context import Context as JContext
from hybridbackend_tpu.framework.context import build_mesh

from hybridbackend_tpu_torch.data.prefetch import DeviceIterator, put_batch
from hybridbackend_tpu_torch.data.sync import (
    SYNC_VALID_KEY, SyncReplicasIterator)

CPU = torch.device('cpu')


def _batches(n, rows=8, seed=0):
  rng = np.random.RandomState(seed)
  return [{'ids': rng.randint(0, 100, (rows, 3)).astype(np.int64),
           'x': rng.rand(rows).astype(np.float32),
           'm': rng.rand(rows, 3) < 0.5,
           'label': rng.randint(0, 2, rows).astype(np.float32)}
          for _ in range(n)]


class _Counting:
  """A source that counts the batches taken from it."""

  def __init__(self, batches, delay=0.0, fail_after=None):
    self.batches, self.delay, self.fail_after = batches, delay, fail_after
    self.taken = 0

  def __iter__(self):
    for i, b in enumerate(self.batches):
      if self.fail_after is not None and i == self.fail_after:
        raise ValueError('source failed')
      time.sleep(self.delay)
      self.taken += 1
      yield b


def _wait_for(cond, timeout=5.0):
  t0 = time.monotonic()
  while not cond():
    if time.monotonic() - t0 > timeout:
      return False
    time.sleep(0.01)
  return True


def test_batches_arrive_in_order_with_their_dtypes():
  batches = _batches(5)
  got = list(DeviceIterator(iter(batches), CPU))
  assert len(got) == 5
  for g, b in zip(got, batches):
    assert set(g) == set(b)
    for k in b:
      assert g[k].device == CPU
      assert g[k].dtype == torch.from_numpy(b[k]).dtype
      np.testing.assert_array_equal(g[k].numpy(), b[k])


def test_columns_of_a_dtype_share_one_copy():
  """One buffer per dtype, copied once; each column a view of it, shaped
  as the source and not aliasing the source's memory."""
  (b,) = _batches(1)
  b['scalar'] = np.float32(3.5)
  source = {k: np.array(v) for k, v in b.items()}
  (got,) = list(DeviceIterator(iter([b]), CPU))
  for k in b:
    np.testing.assert_array_equal(got[k].numpy(), source[k])
    assert tuple(got[k].shape) == np.shape(source[k])
  assert got['x'].untyped_storage().data_ptr() == got[
      'label'].untyped_storage().data_ptr()
  assert got['ids'].untyped_storage().data_ptr() != got[
      'x'].untyped_storage().data_ptr()
  b['ids'][:] = -5                         # the batch is a copy
  np.testing.assert_array_equal(got['ids'].numpy(), source['ids'])


def test_order_holds_under_frequent_thread_switches():
  """The producer and the consumer share the queue and the stop event:
  with the interpreter switching threads every microsecond, 300 batches
  through a queue of 1 arrive whole and in order."""
  batches = [{'i': np.full(3, i, np.int64)} for i in range(300)]
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    it = DeviceIterator(iter(batches), CPU, capacity=1)
    got = [int(b['i'][0]) for b in it]
    it.close()
  finally:
    sys.setswitchinterval(interval)
  assert got == list(range(300)) and not it._thread.is_alive()


def test_put_batch_takes_numpy_and_tensors():
  b = {'a': np.arange(4, dtype=np.int32), 't': torch.ones(2, 2)}
  out = put_batch(b, CPU)
  assert out['a'].dtype == torch.int32 and torch.equal(out['t'], b['t'])


@pytest.mark.parametrize('capacity', [1, 3])
def test_producer_stays_within_capacity(capacity):
  src = _Counting(_batches(20))
  it = DeviceIterator(iter(src), CPU, capacity=capacity)
  # The queue holds `capacity`; the producer holds one more, blocked.
  assert _wait_for(lambda: src.taken == capacity + 1)
  time.sleep(0.3)
  assert src.taken == capacity + 1
  # The first get takes two: the batch it hands out and the one it
  # places on the device ahead of the next step.
  next(it)
  assert _wait_for(lambda: src.taken == capacity + 3)
  time.sleep(0.3)
  assert src.taken == capacity + 3
  it.close()


def test_close_cancels_a_producer_blocked_on_a_full_queue():
  def endless():
    while True:
      yield {'x': np.zeros(4, np.float32)}
  it = DeviceIterator(endless(), CPU, capacity=1)
  assert _wait_for(lambda: it._q.full())
  t0 = time.monotonic()
  it.close()
  assert time.monotonic() - t0 < 5.0
  assert not it._thread.is_alive()
  with pytest.raises(StopIteration):
    next(it)


def test_a_producer_exception_is_raised_at_next():
  src = _Counting(_batches(5), fail_after=2)
  it = DeviceIterator(iter(src), CPU)
  next(it)
  next(it)
  with pytest.raises(ValueError, match='source failed'):
    next(it)
  # The failure's wait is not an input stall of a step.
  assert it.stall_stats['gets'] == 2


def test_stall_stats_count_waits_and_reset():
  src = _Counting(_batches(4), delay=0.1)
  it = DeviceIterator(iter(src), CPU, capacity=2)
  for _ in it:
    pass
  stats = it.stall_stats
  assert stats['gets'] == 4                 # the end is not a get
  assert 1 <= stats['stalls'] <= 4 and stats['stall_s'] > 0.05
  assert stats['stall_fraction'] == stats['stalls'] / 4
  it.reset_stall_stats()
  assert it.stall_stats == {'gets': 0, 'stalls': 0, 'stall_s': 0.0,
                            'stall_fraction': 0.0}
  fast = DeviceIterator(iter(_batches(3)), CPU, capacity=3)
  assert _wait_for(lambda: fast._q.qsize() == 3)
  next(fast)                               # the batch and the one ahead
  assert fast.stall_stats['stalls'] == 0 and fast.stall_stats['gets'] == 2
  fast.close()


def test_close_closes_the_wrapped_iterator():
  sync = SyncReplicasIterator(iter(_batches(50)))
  it = DeviceIterator(sync, CPU, capacity=1)
  next(it)
  it.close()
  with pytest.raises(StopIteration):
    next(sync)


@pytest.mark.parametrize('drop_remainder', [True, False])
def test_sync_iterator_matches_jax_with_one_replica(drop_remainder):
  batches = _batches(3, rows=8) + _batches(1, rows=5, seed=1)
  ctx = JContext(build_mesh(devices=jax.devices()[:1]))
  want = list(JSyncReplicasIterator(iter(batches), drop_remainder, ctx=ctx))
  got = list(SyncReplicasIterator(iter(batches), drop_remainder))
  assert SYNC_VALID_KEY == JAX_SYNC_VALID_KEY
  assert len(got) == len(want) == 4
  for g, w in zip(got, want):
    assert set(g) == set(w)
    assert (SYNC_VALID_KEY in g) == (not drop_remainder)
    for k in w:
      assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
      np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
