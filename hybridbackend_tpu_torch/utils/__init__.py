"""Summaries and traces (``hybridbackend_tpu/utils``): TensorBoard event
files (``summary.py``) and ``torch.profiler`` and NVTX ranges
(``profiler.py``).

The JAX package's ``utils/hlo_bytes.py`` and ``utils/scaling.py`` have no
counterpart (ROADMAP queue 1, "Not ported"): the first parses compiled
XLA HLO, which the port does not have, and the second holds ICI and DCN
constants and TPU phase times, for which no H100 measurement across
cards exists.
"""

from hybridbackend_tpu_torch.utils.profiler import named_scope, profile_trace
from hybridbackend_tpu_torch.utils.summary import (
    SummaryWriter, crc32c, read_event_scalars)

__all__ = ['SummaryWriter', 'crc32c', 'named_scope', 'profile_trace',
           'read_event_scalars']
