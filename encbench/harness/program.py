"""The port's own tracer (``tpuenc_torch.tracing``), for the per-layer
metrics that read spans and counters from inside the program.

Importing this module turns the tracer on, each span also marked for
``torch.profiler`` under :data:`spans.PREFIX`, so that the profiled
sub-window's spans, and so the breakdown's idle gaps and ``launched_in``,
see the port's stages beside the harness's own.  ``cells.cell`` loads
the per-layer readers, and with them this module, only for ``--trace 1``:
a ``--trace 0`` run never turns the tracer on.  Against a port with no
tracer it does nothing, and every reader gives None.
"""

from __future__ import annotations

from . import spans

try:
    from tpuenc_torch import tracing
except ImportError:  # a port from before the tracer
    tracing = None
else:
    tracing.enable(annotate=spans.PREFIX)


def window(run):
    """The finished requests of the window's calls: the last ``run.calls
    * k`` kept, k the images a call for ``"takes": "image"`` (one request
    an image) and 1 for ``"images"`` (one request a call).  None without
    a tracer, or where fewer were kept."""
    if tracing is None:
        return None
    k = run.images_per_call if run.traffic["takes"] == "image" else 1
    n = run.calls * k
    kept = tracing.requests()
    if n == 0 or len(kept) < n:
        return None
    return kept[-n:]


def span_ms_per_mp(run, match):
    """Host milliseconds a megapixel in the window's spans whose name
    ``match`` accepts, or None."""
    reqs = window(run)
    if reqs is None:
        return None
    ns = sum(s.end - s.start for r in reqs for s in r.spans if match(s.name))
    return ns * 1e-6 / (run.calls * run.megapixels_per_call)


def per_call(run, counter):
    """Counter ``counter`` summed over the window's requests, a call, or
    None."""
    reqs = window(run)
    if reqs is None:
        return None
    return sum(r.counters.get(counter, 0) for r in reqs) / run.calls
