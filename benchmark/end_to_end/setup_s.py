"""Seconds from the start of the run to the start of the measured window:
imports, the card's name, inputs made from the seed, loading or compiling
every program, and the warm-up pass."""


def read(run):
    return run.setup_s
