"""Plain PyTorch references of the benchmark's configurations: one module
per configuration, ``<config>.py``, importing nothing of the program."""
