"""Roofline share of the entropy stage (``entropy.pallas_pack`` and
``entropy.pallas_hist``: DC differences, the histograms of the two-pass
mode, P1 by K2, K6 or the DC path, the P2-P4 merge by K3-K5), in percent:
the stage's least time (``harness.work.entropy_bytes`` over the card's
memory rate, from the shapes and the scan bytes of the profiled calls'
files) over the device time of every operation launched inside the
stage's entries in the profiled sub-window."""

from harness import work

SPANS = {"entropy": [
    "tpuenc_torch.entropy.device:scan_histograms",
    "tpuenc_torch.entropy.device_encode:_pack_scans_v2",
    "tpuenc_torch.entropy.chunked:_pack",
    "tpuenc_torch.entropy.pallas_pack:dc_diffs_from_dc",
]}


def read(run):
    if run.trace is None:
        return None
    device_s = sum(b - a for _, _, a, b, _ in
                   run.trace.launched_in({"entropy"})) * 1e-6
    if device_s <= 0:
        return None
    scan_bytes = run.profiled_scan_bytes / run.images_per_call
    least = (run.profiled_calls * run.images_per_call
             * work.entropy_bytes(run.config, run.traffic, scan_bytes)
             / work.HBM_BYTES_PER_S)
    return 100.0 * least / device_s
