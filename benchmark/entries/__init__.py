"""Entries: what one request calls, its inputs, the work it cannot avoid,
and what its outputs are compared with. ``benchmark/traffic/<mix>.json``
names one by its ``entry`` key; the harness loads ``<entry>.py`` from
here."""
