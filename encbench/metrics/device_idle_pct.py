"""Share of the profiled sub-window's host span, in percent, in which no
kernel, copy or fill ran on the card (``torch.profiler``)."""


def read(run):
    if run.trace is None:
        return None
    t0, t1 = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_us() / (t1 - t0))
