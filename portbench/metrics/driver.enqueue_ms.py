"""``driver.enqueue_ms``: the host's time in each ``step(...)`` call of
the sparse step (``training/sparse_step.py``), by the benchmark's host
clock around the call, the mean over the untraced window. Nothing on a
CPU run, where a step runs to its end inside the call."""


def read(r):
  if r.enqueue_ms is None or not r.enqueue_ms:
    return None
  return sum(r.enqueue_ms) / len(r.enqueue_ms)
