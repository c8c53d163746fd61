"""Operations the host put on the card (kernels, copies, fills) per
megapixel encoded, counted by ``torch.profiler`` over the profiled
sub-window."""


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.window_ops()
    if not ops:
        return None
    return len(ops) / (run.profiled_calls * run.megapixels_per_call)
