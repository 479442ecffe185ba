"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``bench/run.py`` is the one command; ``BENCHMARK.json`` at the repository
root names the cells, configurations and metrics, and the harness finds
the files of each by name: ``configs/<config>.json``, ``reference/
<config>.py``, ``systems/<system>.py`` (the served system a configuration
names), ``traffic/<traffic>.json``, ``metrics/<metric>.py`` and
``counts/<op>.py``. Nothing here imports JAX or the JAX package.
"""
