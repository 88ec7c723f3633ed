"""``step_mfu``: the whole step's share of the chip's f32 peak while the
device works, in percent: the matmul FLOPs the traced steps require (the
configuration's count) over the device's busy time in the traced window
(the union of its operations) and the peak. The profiler slows the host,
not the device, so this leaves out the idle gaps that the end-to-end
``mfu`` keeps; a kernel's gain shows in both, a host's only there."""

from portbench import peaks


def read(r):
  if r.trace is None or r.trace.busy_s() <= 0:
    return None
  return 100.0 * sum(r.flops) / r.trace.busy_s() / peaks.F32_FLOP_PER_S
