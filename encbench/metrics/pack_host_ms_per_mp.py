"""Host milliseconds a megapixel in the port's ``pack`` spans: every
attempt of the packer's ladder (P1-P4 launched: the DC path, K2, K6 or
K8, the K3-K5 merge), thrown-away attempts included, over the window's
calls (``tpuenc_torch.tracing``)."""

from harness import program


def read(run):
    return program.span_ms_per_mp(run, lambda name: name == "pack")
