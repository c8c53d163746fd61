"""Scan description shared by the packer stages.

Counterpart of ``tpuenc/entropy/device_pack.py``, of which the port needs
only :class:`ScanSpec`: the v1 XLA log-tree packer there is superseded by
the P1-P4 kernels (``entropy/pallas_pack.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class ScanSpec(NamedTuple):
    """Static description of one scan's entropy coding."""

    spectral_start: int
    spectral_end: int
    emit_dc: bool
    emit_ac: bool
    # Per-block table ids, as a repeating pattern (length = blocks per MCU
    # for interleaved scans, 1 otherwise).
    dc_tab_pattern: Tuple[int, ...]
    ac_tab_pattern: Tuple[int, ...]
    # Distance (in blocks) to the previous block of the same component,
    # per pattern position.
    dc_prev_delta: Tuple[int, ...]
    seg_blocks: int  # restart interval in blocks; 0 = single segment
