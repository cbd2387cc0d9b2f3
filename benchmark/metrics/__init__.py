"""Per-layer metric readers, one file a metric, found by the metric's
name: ``read(record)`` returns the number from the traced run's record
(``benchmark/trace.py::build_record``), or None when the record holds
nothing to read, and the harness then leaves the metric out."""
