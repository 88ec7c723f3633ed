"""``lookup.device_ms``: device time a step of the operations launched
inside the sparse step's ``hb/lookup`` range, from the traced window's
profile (each operation attributed by its launch's correlation to the
host range, else by the range's span on the device)."""


def read(r):
  if r.trace is None:
    return None
  return r.trace.device_s(lambda op: op.range == 'hb/lookup') / r.steps * 1e3
