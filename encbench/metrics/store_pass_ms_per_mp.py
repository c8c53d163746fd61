"""Host milliseconds a megapixel in the port's ``multipass.store`` spans:
the chunked multipass route's first pass (every chunk's rows read and
uploaded, ``fn_cm``, the copy into the coefficient store and K7's counts,
launched), over the window's calls (``tpuenc_torch.tracing``).  None
where no request of the window opened such a span: a port from before
the span, or a call on another route."""

from harness import program

NAME = "multipass.store"


def read(run):
    reqs = program.window(run)
    if reqs is None or not any(s.name == NAME for r in reqs for s in r.spans):
        return None
    return program.span_ms_per_mp(run, lambda name: name == NAME)
