"""tpuenc_torch K1 (fDCT + zigzag + quantize) and the coefficient stage,
held bit for bit against tpuenc on the CPU (tolerance 0: every stage is
integer arithmetic).

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
the JAX side runs the Pallas kernel in interpret mode and the XLA path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpuenc.core.tables import quantization_table  # noqa: E402
from tpuenc.core.types import ColorType, EncoderConfig, SamplingFactor  # noqa: E402
from tpuenc.kernels.fdct import fdct_blocks  # noqa: E402
from tpuenc.kernels.pallas_fdct import fdct_quantize_pallas_cm  # noqa: E402
from tpuenc.kernels.pipeline import coefficients_fn  # noqa: E402
from tpuenc.kernels.quantize import quantize_zigzag  # noqa: E402
from tpuenc_torch.core import tables as ttables  # noqa: E402
from tpuenc_torch.core import types as ttypes  # noqa: E402
from tpuenc_torch.entropy.device_encode import params_from_numpy  # noqa: E402
from tpuenc_torch.kernels import pallas_fdct as tfdct  # noqa: E402
from tpuenc_torch.kernels import pipeline as tpipe  # noqa: E402


def _samples(B, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (64, B)).astype(np.int32) - 128
    x[:, :4] = -128  # flat extremes: all-dark and all-bright blocks
    x[:, 4:8] = 127
    return x


@pytest.mark.parametrize("preset,quality,luma", [
    ("default", 1, True),
    ("default", 50, False),
    ("default", 90, True),
    ("default", 100, False),
    ("flat", 100, True),
    ((1,) * 64, 50, True),  # all-ones: the largest reciprocals of any table
])
def test_k1_plain_matches_pallas_and_xla(preset, quality, luma):
    """The K1 plain version equals the Pallas kernel (interpret mode) and
    quantize_zigzag(fdct_blocks(...)), for a B that is no multiple of any
    tile."""
    x = _samples(517, quality)
    tab = quantization_table(preset, quality, luma)
    want = np.asarray(fdct_quantize_pallas_cm(jnp.asarray(x), tab))
    np.testing.assert_array_equal(want, np.asarray(quantize_zigzag(
        fdct_blocks(jnp.asarray(x.T).reshape(-1, 8, 8)).reshape(-1, 64), tab
    )).T)
    ttab = ttables.quantization_table(preset, quality, luma)
    got = tfdct.fdct_quantize_pallas_cm(torch.from_numpy(x), ttab)
    assert got.dtype == torch.int16 and got.shape == (64, 517)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fdct_blocks_and_quantize_match():
    """The block-major plain twins (kernels/fdct.py, kernels/quantize.py)."""
    from tpuenc_torch.kernels.fdct import fdct_blocks as tfdct_blocks
    from tpuenc_torch.kernels.quantize import quantize_zigzag as tquantize

    x = _samples(64, 3).T.reshape(-1, 8, 8)
    got = tfdct_blocks(torch.from_numpy(x))
    want = fdct_blocks(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tab = quantization_table("default", 75, False)
    np.testing.assert_array_equal(
        tquantize(got.reshape(-1, 64),
                  ttables.quantization_table("default", 75, False)).numpy(),
        np.asarray(quantize_zigzag(want.reshape(-1, 64), tab)),
    )


def test_wrapper_rejects_other_devices():
    x = torch.zeros((64, 8), dtype=torch.int32, device="meta")
    r = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfdct.fdct_quantize(x, r, r)


CM_CASES = [
    ("rgb444", ColorType.RGB, 3, SamplingFactor.F_1_1, 90, 37, 21),
    ("rgb420", ColorType.RGB, 3, SamplingFactor.F_2_2, 80, 37, 21),
    ("rgb21", ColorType.RGB, 3, SamplingFactor.F_2_1, 75, 19, 30),
    ("rgb12", ColorType.RGB, 3, SamplingFactor.F_1_2, 85, 19, 30),
    ("luma", ColorType.LUMA, 1, SamplingFactor.F_2_2, 70, 23, 17),
    ("cmyk", ColorType.CMYK, 4, SamplingFactor.F_2_2, 85, 26, 19),
    ("ycck", ColorType.CMYK_AS_YCCK, 4, SamplingFactor.F_2_2, 85, 26, 19),
    ("bgr", ColorType.BGR, 3, SamplingFactor.F_1_1, 95, 17, 9),
    ("ycbcr", ColorType.YCBCR, 3, SamplingFactor.F_2_2, 60, 33, 25),
]


@pytest.mark.parametrize("name,ct,ch,sf,q,w,h", CM_CASES,
                         ids=[c[0] for c in CM_CASES])
def test_fn_cm_matches_coefficients_fn(name, ct, ch, sf, q, w, h):
    """The port's interleaved (64, B) stream equals tpuenc's block-major
    coefficient stream, transposed: color conversion, edge padding,
    subsampling, K1 and the raster -> MCU column order."""
    rng = np.random.default_rng(len(name))
    shape = (h, w) if ch == 1 else (h, w, ch)
    px = rng.integers(0, 256, shape, np.uint8)
    config = EncoderConfig(quality=q, sampling_factor=sf)
    fn, _ = coefficients_fn(w, h, ct, config)
    (want,) = fn(jnp.asarray(px))

    tconfig = ttypes.EncoderConfig(
        quality=q, sampling_factor=ttypes.SamplingFactor(sf.value))
    q_tables = [ttables.quantization_table("default", q, True),
                ttables.quantization_table("default", q, False)]
    z = np.zeros((2, 256), np.uint32)
    params = params_from_numpy(q_tables, z, z, z, z, "cpu")
    (got,) = tpipe.fn_cm(torch.from_numpy(px), w, h, ttypes.ColorType(ct.value),
                         tconfig, params.reciprocals, params.corrections)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
