"""Host milliseconds a megapixel in the port's ``sync.*`` spans: every
blocking read of a device result (the ladder's ``meta``, the two-pass
counts, the device finish's segment counts and bytes, the single
program's stream, the chunks' words), over the window's calls
(``tpuenc_torch.tracing``)."""

from harness import program


def read(run):
    return program.span_ms_per_mp(run,
                                  lambda name: name.startswith("sync."))
