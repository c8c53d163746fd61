"""Roofline share of the coefficient stage (``kernels.pipeline.fn_cm``:
colour conversion, padding, sampling, K1's transform and quantizer), in
percent: the stage's least time (``harness.work.coefficient_bytes`` over
the card's memory rate) over the device time of every operation launched
inside ``fn_cm`` in the profiled sub-window."""

from harness import work

SPANS = {"coefficients": ["tpuenc_torch.kernels.pipeline:fn_cm"]}


def read(run):
    if run.trace is None:
        return None
    device_s = sum(b - a for _, _, a, b, _ in
                   run.trace.launched_in({"coefficients"})) * 1e-6
    if device_s <= 0:
        return None
    least = (run.profiled_calls * run.images_per_call
             * work.coefficient_bytes(run.config, run.traffic)
             / work.HBM_BYTES_PER_S)
    return 100.0 * least / device_s
