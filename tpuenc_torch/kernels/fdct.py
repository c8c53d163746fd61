"""Batched forward DCT (Loeffler-Ligtenberg-Moschytz fixed point).

Counterpart of ``tpuenc/kernels/fdct.py`` in plain PyTorch: libjpeg's
``jpeg_fdct_islow`` (CONST_BITS 13, PASS1_BITS 2, round-half-up descale)
over int32 tensors, every operation elementwise over the block batch.
Output is scaled by 8, cancelled by the x8-premultiplied quantization
tables.  Together with :mod:`.quantize` this is the plain version of the
K1 kernel (:mod:`.pallas_fdct`).
"""

from __future__ import annotations

import torch

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _descale(x, n: int):
    """Right shift with round-half-up (reference fdct.rs:95-98)."""
    return (x + (1 << (n - 1))) >> n


def _dct_1d(v, first_pass: bool):
    """One LL&M 12-mul/32-add butterfly over 8 same-shape int32 tensors.

    ``v`` is a list of 8 tensors (the 8 positions along the transform
    axis).  Pass 1 leaves results scaled by 2^PASS1_BITS; pass 2 removes
    it (reference fdct.rs:116-171, 178-237)."""
    tmp0 = v[0] + v[7]
    tmp7 = v[0] - v[7]
    tmp1 = v[1] + v[6]
    tmp6 = v[1] - v[6]
    tmp2 = v[2] + v[5]
    tmp5 = v[2] - v[5]
    tmp3 = v[3] + v[4]
    tmp4 = v[3] - v[4]

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    out = [None] * 8
    if first_pass:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
        shift = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
        shift = CONST_BITS + PASS1_BITS

    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, shift)
    out[6] = _descale(z1 + tmp12 * -FIX_1_847759065, shift)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602

    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560
    z4 = z4 * -FIX_0_390180644

    z3 = z3 + z5
    z4 = z4 + z5

    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return out


def fdct_blocks(blocks):
    """Forward DCT over a batch of level-shifted 8x8 blocks.

    ``blocks``: int tensor (..., 8, 8) of pixel values minus 128.  Returns
    int32 (..., 8, 8) DCT coefficients scaled by 8."""
    x = blocks.to(torch.int32)
    rows_out = _dct_1d([x[..., i] for i in range(8)], first_pass=True)
    x = torch.stack(rows_out, dim=-1)
    cols_out = _dct_1d([x[..., i, :] for i in range(8)], first_pass=False)
    return torch.stack(cols_out, dim=-2)
