"""Entry points a user runs, ported from the JAX package's ``examples/``."""
