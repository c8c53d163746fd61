"""Builds both native entropy libraries once, before any test process starts.

``tpuenc``'s loader (``tpuenc/entropy/native.py``) builds its library on
first use, with g++ writing straight to the final path.  Under xdist every
worker would try that at once, and a worker that loads a half-written file
marks the library failed for the rest of its life.  Building it here, in
the controller (or the only process of a run without xdist), leaves
workers a finished library, which its loader then only loads.  The port's
library (``tpuenc_torch/entropy/native.py``) is built through its own
loader as well, so that the workers do not each build it.

A library that cannot be built is left to fail or skip in the tests that
need it, as it would without this file.
"""

import importlib


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    for module, loader in (("tpuenc.entropy.native", "available"),
                           ("tpuenc_torch.entropy.native", "_load")):
        try:
            getattr(importlib.import_module(module), loader)()
        except (ImportError, OSError, RuntimeError):
            pass  # no JAX here, or no compiler: see the docstring
