"""Restart segments finished a call: the port's ``restart_segments``
counter (each scan's segments, summed by the device finish and by the
chunked paths' streaming stuffer; one a scan with no restart interval)
summed over the window's requests, over its calls
(``tpuenc_torch.tracing``).  The cell's files fix it; it moves only where
a change alters what the finish does.

Every call of a port that has the counter finishes at least one segment,
so a window in which no request counted any is a port from before the
counter: None there, not 0."""

from harness import program


def read(run):
    reqs = program.window(run)
    if reqs is None or not any("restart_segments" in r.counters
                               for r in reqs):
        return None
    return program.per_call(run, "restart_segments")
