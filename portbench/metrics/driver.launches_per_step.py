"""``driver.launches_per_step``: device kernels a step, counted in the
traced window's profile."""


def read(r):
  if r.trace is None:
    return None
  return len(r.trace.kernels()) / r.steps
