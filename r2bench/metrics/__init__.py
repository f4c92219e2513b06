"""One reader a per-layer metric, ``<metric name>.py``, loaded by path
(``harness.load_reader``): ``read(records)`` returns the metric's number, or
None where the run has nothing for it to read."""
