"""K1: fused fDCT + zigzag + quantize, coefficient-major.

Counterpart of ``tpuenc/kernels/pallas_fdct.py``.  The kernel is CUDA C++
(``csrc/fdct_quantize.cu``); :func:`fdct_quantize_ref` is its plain
PyTorch version with the same contract.  The layout stays the TPU one at
this boundary: (64, B) with the sample / coefficient index on rows and the
block index on columns.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib
from ..core.tables import ZIGZAG, QuantizationTable
from .fdct import _dct_1d
from .quantize import quantize_rows


def fdct_quantize_ref(x_cm, recip, corr):
    """Plain version of K1: ``x_cm`` int32 (64, B) level-shifted samples
    (row k = sample y*8+x); ``recip``/``corr`` int32 (64,) in zigzag
    order.  Returns int16 (64, B), row j = zigzag coefficient j."""
    x = x_cm.to(torch.int32)
    rows = [x[k] for k in range(64)]
    mid = [None] * 64
    for y in range(8):
        group = _dct_1d([rows[y * 8 + i] for i in range(8)], True)
        for i in range(8):
            mid[y * 8 + i] = group[i]
    final = [None] * 64
    for i in range(8):
        group = _dct_1d([mid[y * 8 + i] for y in range(8)], False)
        for y in range(8):
            final[y * 8 + i] = group[y]
    zz = torch.stack([final[int(n)] for n in ZIGZAG])
    return quantize_rows(zz, recip.view(64, 1), corr.view(64, 1))


def fdct_quantize(x_cm, recip, corr):
    """K1 on ``x_cm``'s device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Same contract as
    :func:`fdct_quantize_ref`."""
    if not cuda_lib.on_cuda(x_cm, "fdct_quantize"):
        return fdct_quantize_ref(x_cm, recip, corr)
    dev = x_cm.device
    B = x_cm.shape[-1]
    cuda_lib.check_tensor("x_cm", x_cm, torch.int32, (64, B), dev)
    cuda_lib.check_tensor("recip", recip, torch.int32, (64,), dev)
    cuda_lib.check_tensor("corr", corr, torch.int32, (64,), dev)
    out = torch.empty((64, B), dtype=torch.int16, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_fdct_quantize(
            x_cm.data_ptr(), recip.data_ptr(), corr.data_ptr(), out.data_ptr(),
            B, cuda_lib.stream_of(x_cm),
        ),
        "tpuenc_fdct_quantize",
    )
    fdct_quantize.launches += 1
    return out


fdct_quantize.launches = 0


def zigzag_params(table: QuantizationTable):
    """(reciprocals, corrections) of ``table`` as int32 (64,) numpy arrays
    in zigzag order: K1's ``recip`` / ``corr``."""
    return (np.asarray(table.reciprocals, np.int32)[ZIGZAG],
            np.asarray(table.corrections, np.int32)[ZIGZAG])


def fdct_quantize_pallas_cm(x_cm, table: QuantizationTable):
    """Coefficient-major fused transform (the public JAX entry's
    counterpart): ``x_cm`` int (64, B) level-shifted samples.  Returns
    int16 (64, B) zigzag-ordered quantized coefficients."""
    recip, corr = (torch.from_numpy(a).to(x_cm.device)
                   for a in zigzag_params(table))
    return fdct_quantize(x_cm.to(torch.int32).contiguous(), recip, corr)
