"""The benchmark: one cell of ``BENCHMARK.json`` per run of ``run.py``.

Everything that measures lives here, apart from the system under test
(``zaftpu``): the signal generator, the closed loop, the trace reduction,
the table of peaks, the work counted per request, the plain float64
references and the comparison that decides ``correct``. Cells,
configurations, traffic mixes, layers, limits and per-layer metrics are
files that the harness finds by the names in ``BENCHMARK.json``.
"""
