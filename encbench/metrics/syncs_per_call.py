"""Host-blocking device operations a call: the port's ``syncs`` counter
(each ``sync.*`` read and each pageable upload) summed over the window's
requests, over its calls (``tpuenc_torch.tracing``)."""

from harness import program


def read(run):
    return program.per_call(run, "syncs")
