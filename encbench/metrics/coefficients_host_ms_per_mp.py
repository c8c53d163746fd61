"""Host milliseconds a megapixel in the port's ``transform`` spans
(``kernels.pipeline.fn_cm`` / ``fn_cm_samples``: colour conversion,
padding, sampling and K1, launched, with their glue), over the window's
calls (``tpuenc_torch.tracing``)."""

from harness import program


def read(run):
    return program.span_ms_per_mp(run, lambda name: name == "transform")
