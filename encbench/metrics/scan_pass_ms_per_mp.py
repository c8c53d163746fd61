"""Host milliseconds a megapixel in the port's ``multipass.scan`` spans:
the chunked multipass route's second pass, each scan packed from its
coefficient store in chunks and each chunk finished on the card, over
the window's calls (``tpuenc_torch.tracing``).  None where no request of
the window opened such a span: a port from before the span, or a call on
another route."""

from harness import program

NAME = "multipass.scan"


def read(run):
    reqs = program.window(run)
    if reqs is None or not any(s.name == NAME for r in reqs for s in r.spans):
        return None
    return program.span_ms_per_mp(run, lambda name: name == NAME)
