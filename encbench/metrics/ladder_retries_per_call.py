"""Packs thrown away a call: the port's ``ladder_retries`` counter (one
for each pack whose overflow sends it to the next budget rung, on the
whole-image, batch and chunked ladders) summed over the window's
requests, over its calls (``tpuenc_torch.tracing``)."""

from harness import program


def read(run):
    return program.per_call(run, "ladder_retries")
