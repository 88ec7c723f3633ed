"""The benchmark of ``hybridbackend_tpu_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the sizes and training settings as they
  are run, the source, what was reduced and assumed;
  ``configs/<config>.py`` builds the port's model, state and step for it
  (``train.py`` reads the settings and refuses any it does not
  implement) and counts its matmul FLOPs;
* ``traffic/<mix>.json``: the parameters that ``generator.py`` reads;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``reference/<config>.py``: the plain reference that decides
  ``correct``, with ``limits/<cell>.json`` holding the limits;

Nothing here imports ``jax`` or the JAX package.
"""
