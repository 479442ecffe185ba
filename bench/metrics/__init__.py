"""One reader per metric, ``<metric>.py``, each with ``read(run)`` that
returns the metric's number or None where the run holds nothing to read."""
