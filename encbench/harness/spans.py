"""Spans put around the program's own functions from outside.

Each span is a name and the functions it goes around, given as
``module:qualified.name``.  While :class:`Spans` is entered, every binding
of such a function in the program's loaded modules (its own module, any
module that imported it by name, its class) calls a wrapper that adds the
host-clock time of the outermost call of that span name to its total and,
under ``torch.profiler``, marks the call as ``encbench:<name>`` so that
the device work it launched can be told apart.  On exit every binding is
restored.
"""

from __future__ import annotations

import importlib
import sys
import time
from collections import defaultdict

from torch.profiler import record_function

PREFIX = "encbench:"


def _resolve(target: str):
    mod_name, qual = target.split(":")
    owner = importlib.import_module(mod_name)
    *path, attr = qual.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, attr


class Spans:
    def __init__(self, spans: dict, package: str = "tpuenc_torch"):
        """``spans``: span name -> list of targets."""
        self.spans = spans
        self.package = package
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self._depth = defaultdict(int)
        self._restore = []

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            outer = self._depth[name] == 0
            self._depth[name] += 1
            t0 = time.perf_counter()
            try:
                with record_function(PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                self._depth[name] -= 1
                if outer:
                    self.seconds[name] += time.perf_counter() - t0
                    self.counts[name] += 1
        timed.__wrapped__ = fn
        return timed

    def __enter__(self):
        for name, targets in self.spans.items():
            for target in targets:
                owner, attr = _resolve(target)
                real = owner.__dict__[attr] if isinstance(owner, type) \
                    else getattr(owner, attr)
                wrapped = self._wrap(name, real)
                self._bind(owner, attr, real, wrapped)
                if not isinstance(owner, type):
                    # Names bound by ``from module import fn`` elsewhere.
                    for mod in list(sys.modules.values()):
                        if mod is owner or not getattr(
                                mod, "__name__", "").startswith(self.package):
                            continue
                        for key, value in list(vars(mod).items()):
                            if value is real:
                                self._bind(mod, key, real, wrapped)
        return self

    def _bind(self, owner, attr, real, wrapped):
        setattr(owner, attr, wrapped)
        self._restore.append((owner, attr, real))

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self._restore):
            setattr(owner, attr, real)
        self._restore.clear()
