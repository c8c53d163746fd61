"""Host milliseconds a megapixel in the port's ``upload`` spans: the
host-to-device copies of the pixels (and of small tables), each a
pageable copy that first waits for the stream's queued work, over the
window's calls (``tpuenc_torch.tracing``)."""

from harness import program


def read(run):
    return program.span_ms_per_mp(run, lambda name: name == "upload")
