"""Host milliseconds a megapixel in the file's assembly: the frame header,
each scan's SOS and payload joined (``Encoder._assemble_scans``), over the
whole traced window."""

SPANS = {"assembly": ["tpuenc_torch.api:Encoder._assemble_scans"]}


def read(run):
    if "assembly" not in run.spans:
        return None
    return 1e3 * run.spans["assembly"] / (run.calls * run.megapixels_per_call)
