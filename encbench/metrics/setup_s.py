"""Seconds from the start of the benchmark's process to the first timed
call: imports, the kernels' build or load, making the inputs, building
the encoder and the warm-up (host clock)."""


def read(run):
    return run.setup_s
