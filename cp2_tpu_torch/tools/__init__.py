"""Tools of the port: the quality gate and its corpus, and the measuring
tools (twins of the JAX package's ``tools/bench_*.py`` and
``tools/profile_step.py``)."""
