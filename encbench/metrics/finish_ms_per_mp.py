"""Host milliseconds a megapixel in the finish of the scans (byte
alignment, 1-padding, 0xFF stuffing, RST markers, the copy back), over the
whole traced window: whichever finish the route calls, outermost calls
only.  The whole-image routes finish on the device
(``device_encode._finish_scans_device``, which runs
``device_stuff.device_stuff``), the single-program batch on the host
(``device_encode._finish_scans_v2``), the chunked paths in the host's
``chunked.StreamingStuffer``."""

SPANS = {"finish": [
    "tpuenc_torch.entropy.device_encode:_finish_scans_device",
    "tpuenc_torch.entropy.device_stuff:device_stuff",
    "tpuenc_torch.entropy.device_encode:_finish_scans_v2",
    "tpuenc_torch.entropy.chunked:StreamingStuffer.add_chunk",
    "tpuenc_torch.entropy.chunked:StreamingStuffer.finish",
]}


def read(run):
    if "finish" not in run.spans:
        return None
    return 1e3 * run.spans["finish"] / (run.calls * run.megapixels_per_call)
