"""``adagrad_update_roofline``: kernel 1 (``adagrad_update_sorted``)
against its bound, in percent: the least time the card could take on
each traced step's update list (``peaks.adagrad_bound_s``, counted by the
benchmark from the ids the step was given: valid entries and distinct
rows), summed, over the device time of the kernel's launches in those
steps. Nothing when the trace holds no launch of it."""

from portbench import peaks

KERNEL = 'adagrad_update_sorted_kernel'


def read(r):
  if r.trace is None:
    return None
  ms = r.trace.device_s(lambda op: op.cat == 'kernel' and KERNEL in op.name)
  if ms <= 0:
    return None
  bound = sum(peaks.adagrad_bound_s(n, u, r.dim) for n, u in r.kernel1)
  return 100.0 * bound / ms
