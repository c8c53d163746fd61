"""Fused zigzag + quantization, plain PyTorch.

Counterpart of ``tpuenc/kernels/quantize.py``: division by the x8 table
entry is the exact reciprocal multiply-shift ``((|v| + corr) * recip) >>
15`` with the sign restored (reference quantization.rs:291-307), in int32
like the JAX version, and the zigzag reorder is a constant gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tables import QUANT_SHIFT, ZIGZAG, QuantizationTable


def quantize_zigzag(dct_blocks, table: QuantizationTable):
    """Quantize a batch of DCT blocks and emit them in zigzag order.

    ``dct_blocks``: int32 (..., 64) natural-order DCT coefficients (x8
    scaled).  Returns int16 (..., 64) zigzag-ordered coefficients."""
    dev = dct_blocks.device
    zz = dct_blocks[..., torch.from_numpy(ZIGZAG.astype(np.int64)).to(dev)]
    recip = torch.from_numpy(np.asarray(table.reciprocals, np.int32)[ZIGZAG]).to(dev)
    corr = torch.from_numpy(np.asarray(table.corrections, np.int32)[ZIGZAG]).to(dev)
    return quantize_rows(zz.to(torch.int32), recip, corr)


def quantize_rows(v, recip, corr):
    """``((|v| + corr) * recip) >> 15`` with v's sign, in int32, cast to
    int16; ``recip``/``corr`` broadcast against ``v``."""
    q = ((torch.abs(v) + corr) * recip) >> QUANT_SHIFT
    return torch.where(v < 0, -q, q).to(torch.int16)
