"""Progressive band plan.

Counterpart of ``tpuenc/entropy/huffopt.py``; the port needs only
:func:`progressive_bands` so far (``device_encode.build_scan_plan``).  The
two-pass K.2 table build is still to port (ROADMAP M7).
"""

from __future__ import annotations

from typing import List, Tuple


def progressive_bands(scans: int) -> List[Tuple[int, int]]:
    """AC spectral bands for an N-scan progressive encode
    (reference encoder.rs:924-936): scans-1 AC bands; band k covers
    [max(1, k*vps), (k+1)*vps) with the last band padded to 64."""
    n = scans - 1
    vps = 64 // n
    bands = []
    for scan in range(n):
        start = max(scan * vps, 1)
        end = 64 if scan == n - 1 else (scan + 1) * vps
        bands.append((start, end))
    return bands
