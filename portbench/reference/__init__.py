"""The benchmark's plain reference: ``oracle.cpp``, a scalar CPU path
tracer written against the upstream shader's spec (a copy of the
repository's independent oracle), and ``oracle.py``, which builds it and
hands it the benchmark's generated scene. Nothing here imports the
program, ``jax`` or the JAX package."""
