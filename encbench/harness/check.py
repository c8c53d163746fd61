"""Whether the timed path produced the right files.

During the window a reservoir keeps a uniform sample, drawn from the
seed, of the calls (each call's input indices and the files it
returned).  After the window, with the program's state freed, the plain
reference encodes each input that the sample holds, once, and every
sampled file is compared with it byte for byte.  A call that raised, or
returned another number of files than it was given images, counts as
failed.  The numbers compared, each with its limit (an upper one):

* ``differing_files``: sampled files whose bytes are not the reference's
  (limit 0: the port's contract is the reference's bytes);
* ``failed_calls``: calls of the window that raised or returned the wrong
  number of files (limit 0);
* ``unchecked``: 1 where the sample holds no file at all (limit 0).
"""

from __future__ import annotations

import random
import sys
import time

from reference import jpeg


class Reservoir:
    """A uniform sample of ``k`` of the offered items (algorithm R),
    drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def _args(value):
    """The arguments of a setting given as ``{"<type's maker>": [args]}``."""
    return next(iter(value.values())) if isinstance(value, dict) else value


# What each encoder setting of a configuration or traffic mix means to the
# reference: (its keyword, the value it takes).  The constructor's
# ``options`` change no byte of a file, so the reference reads none.
SETTINGS = {
    "quality": ("quality", int),
    "sampling_factor": ("sampling", lambda v: tuple(_args(v))),
    "progressive": ("progressive_scans", lambda v: 4 if v else None),
    "progressive_scans": ("progressive_scans", int),
    "optimized_huffman_tables": ("optimize_tables", bool),
    "restart_interval": ("restart_interval", lambda v: int(v) or None),
}


def reference_kwargs(config, traffic) -> dict:
    """The reference's arguments for the settings of ``config`` and
    ``traffic``, applied in order as the encoder applies them; the
    encoder's default sampling is 4:2:0 below quality 90, else 4:4:4
    (the reference encoder's default)."""
    kw = {"color_type": config["color_type"]}
    for key, value in {**config["encoder"],
                       **traffic.get("encoder", {})}.items():
        if key not in SETTINGS:
            raise ValueError(f"the reference has no setting {key!r}")
        name, convert = SETTINGS[key]
        kw[name] = convert(value)
    kw.setdefault("sampling", (2, 2) if kw["quality"] < 90 else (1, 1))
    return kw


def reference_file(pixels, config, traffic, device, const_bits=13) -> bytes:
    return jpeg.encode(pixels, **reference_kwargs(config, traffic),
                       device=device, const_bits=const_bits)


def compare(sample, pool, config, traffic, device, failed_calls):
    """The numbers compared, each ``{"value", "limit"}``, the files
    checked, the reference's seconds and the reference files' bits a
    pixel."""
    t0 = time.perf_counter()
    want = {}
    differing = checked = 0
    for indices, files in sample.items:
        for idx, got in zip(indices, files):
            if idx not in want:
                want[idx] = reference_file(pool[idx], config, traffic, device)
            checked += 1
            differing += got != want[idx]
    bpp = (8 * sum(map(len, want.values()))
           / max(1, len(want) * config["width"] * config["height"]))
    checks = {
        "differing_files": {"value": differing, "limit": 0},
        "failed_calls": {"value": failed_calls, "limit": 0},
        "unchecked": {"value": int(checked == 0), "limit": 0},
    }
    return checks, checked, time.perf_counter() - t0, bpp


def correct(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks):
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
