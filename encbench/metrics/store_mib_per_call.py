"""MiB of coefficient store a call: the port's ``store_bytes`` counter
(the chunked multipass route's device store, 128 bytes a block of each
component padded to its pack chunk) summed over the window's requests,
over its calls, in units of 2^20 bytes (``tpuenc_torch.tracing``).  The
cell's files fix it; it moves only where a change alters the store.

None where no request of the window counted it: a port from before the
counter, or calls on another route."""

from harness import program


def read(run):
    reqs = program.window(run)
    if reqs is None or not any("store_bytes" in r.counters for r in reqs):
        return None
    return program.per_call(run, "store_bytes") / 2**20
