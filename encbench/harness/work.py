"""The least work of the encode's stages, from the cell's shapes alone.

A stage's least bytes are what it must read and write of device memory,
whatever kernels do it today: its inputs read once and its outputs
written once.  Dividing them by the card's memory rate gives the least
time the stage can take; a stage's roofline share is that time over the
device time of the work it launched.
"""

from __future__ import annotations

from .check import reference_kwargs

# NVIDIA H100 SXM5 80 GB, HBM3 (NVIDIA's data sheet, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12

# Bytes of a quantized coefficient: int16 is the narrowest type that holds
# every one of them (at most 11 bits and a sign for 8-bit samples).
COEFFICIENT_BYTES = 2


def _cdiv(a, b):
    return -(-a // b)


def coded_blocks(config: dict, traffic: dict) -> int:
    """8x8 blocks that one image's file codes: the MCU grid in the
    interleaved mode, each component's own grid otherwise
    (encoder.rs:556-562, 1012-1025)."""
    w, h = config["width"], config["height"]
    mode = reference_kwargs(config, traffic)
    sh, sv = mode["sampling"]
    comps = [(sh, sv), (1, 1), (1, 1)] + \
        [(sh, sv)] * (config["channels"] == 4)
    interleaved = (not mode.get("progressive_scans")
                   and not mode.get("optimize_tables"))
    if interleaved:
        mcus = _cdiv(w, 8 * sh) * _cdiv(h, 8 * sv)
        return mcus * sum(a * b for a, b in comps)
    return sum(_cdiv(_cdiv(w, 8), sh // a) * _cdiv(_cdiv(h, 8), sv // b)
               for a, b in comps)


def coefficient_bytes(config: dict, traffic: dict) -> int:
    """Pixels -> quantized coefficients of one image: every input sample
    read once, every coefficient written once."""
    samples = config["width"] * config["height"] * config["channels"]
    return samples + 64 * COEFFICIENT_BYTES * coded_blocks(config, traffic)


def entropy_bytes(config: dict, traffic: dict, scan_bytes: float) -> float:
    """Coefficients -> coded scans of one image: the coefficients read
    once for each pass the mode needs (two with optimized tables: the
    histograms, then the coding), the scans' bytes written once."""
    passes = 2 if reference_kwargs(config, traffic).get("optimize_tables") \
        else 1
    return (passes * 64 * COEFFICIENT_BYTES * coded_blocks(config, traffic)
            + scan_bytes)
