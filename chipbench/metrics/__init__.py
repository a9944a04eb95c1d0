"""One reader a metric, ``read(run) -> float | None``, named as the
metric is in ``BENCHMARK.json``.  ``run`` is the kind's run record with
the device's row of ``peaks.json`` under ``peaks``.  A reader that finds
nothing to read returns None and the metric is left out of the line."""
