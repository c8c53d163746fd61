"""Pixels -> quantized zigzag coefficients, coefficient-major.

Counterpart of the coefficient-major path of ``tpuenc/kernels/pipeline.py``
(``fn_cm``): color convert, edge-replicating pad to the MCU grid, point
subsampling with the -128 level shift, blockify into (64, blocks), K1
(fDCT + zigzag + quantize, :mod:`.pallas_fdct`), then the raster -> MCU
column permutation of interleaved scans, or the per-component crop of
sequential and progressive ones.  Semantics follow the reference exactly:

* edge replication of the last row/column (encoder.rs:738-744), never
  zero padding;
* chroma subsampling by point sampling with stride max/comp
  (encoder.rs:1222-1242);
* interleaved scan order: MCU raster, then component, then v then h offset
  (encoder.rs:759-769);
* per-component block grids of ceil(ceil(dim/8)/scale) (encoder.rs:
  1012-1025).

The port always runs coefficient-major.
"""

from __future__ import annotations

import torch

from ..core.types import (
    ColorType,
    EncoderConfig,
    init_components,
    max_sampling,
)
from .color_convert import to_planes
from .pallas_fdct import fdct_quantize


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_edge(plane, target_h: int, target_w: int):
    """Replicate the last row and column of an (H, W) plane out to
    (target_h, target_w)."""
    h, w = plane.shape[-2:]
    dev = plane.device
    if target_h != h:
        rows = torch.arange(target_h, device=dev).clamp_(max=h - 1)
        plane = plane.index_select(-2, rows)
    if target_w != w:
        cols = torch.arange(target_w, device=dev).clamp_(max=w - 1)
        plane = plane.index_select(-1, cols)
    return plane


def _blockify_cm(plane, v_scale: int, h_scale: int):
    """Point-subsample, level shift and blockify one padded (H, W) plane
    into coefficient-major (64, R*C) int32: row y*8+x holds sample (y, x)
    of every block, columns run over blocks in raster order."""
    h, w = plane.shape
    R = h // (8 * v_scale)
    C = w // (8 * h_scale)
    # Rows of block-row r: plane rows r*8v + y*v; cols of block-col c,
    # offset x: plane col (8c + x) * h_scale.
    x = plane.reshape(R, 8, v_scale, w)[:, :, 0, :]
    x = x.reshape(R, 8, C, 8, h_scale)[..., 0] - 128      # (r, y, c, x)
    return x.permute(1, 3, 0, 2).reshape(64, R * C).contiguous()


def scan_layout(width: int, height: int, color_type: ColorType,
                config: EncoderConfig):
    """Static description of the block streams produced by the pipeline
    (same dict as ``tpuenc.kernels.pipeline.scan_layout``):

      components        — tuple[Component]
      interleaved       — bool
      mcu_count         — number of MCUs (interleaved only)
      mcu_block_comps   — per-block-in-MCU component index (interleaved)
      comp_block_counts — per-component block counts (sequential/progressive)
    """
    jct = color_type.jpeg_color_type
    components = init_components(jct, config.sampling_factor)
    max_h, max_v = max_sampling(components)
    interleaved = config.mode() == "interleaved"

    layout = {
        "components": components,
        "interleaved": interleaved,
        "max_h": max_h,
        "max_v": max_v,
    }
    if interleaved:
        num_cols = _cdiv(width, 8 * max_h)
        num_rows = _cdiv(height, 8 * max_v)
        blocks_per_mcu = []
        for idx, comp in enumerate(components):
            blocks_per_mcu += [idx] * (
                comp.vertical_sampling_factor * comp.horizontal_sampling_factor
            )
        layout["mcu_count"] = num_rows * num_cols
        layout["mcu_block_comps"] = tuple(blocks_per_mcu)
    else:
        counts = []
        for comp in components:
            h_scale = max_h // comp.horizontal_sampling_factor
            v_scale = max_v // comp.vertical_sampling_factor
            cols = _cdiv(_cdiv(width, 8), h_scale)
            rows = _cdiv(_cdiv(height, 8), v_scale)
            counts.append(rows * cols)
        layout["comp_block_counts"] = tuple(counts)
    return layout


def fn_cm(pixels, width: int, height: int, color_type: ColorType,
          config: EncoderConfig, reciprocals, corrections):
    """The coefficient streams of one image, coefficient-major.

    ``pixels``: (H, W[, C]) uint8 tensor on the encode device;
    ``reciprocals``/``corrections``: int32 (2, 64) zigzag-ordered tensors
    on the same device (luma, chroma; see :func:`tpuenc_torch.params_from_numpy`).
    Interleaved modes return ``(stream,)``, the MCU stream, int16 (64,
    mcu_count * blocks_per_mcu).  Sequential and progressive modes return
    one int16 (64, rows * cols) stream per component in its raster order,
    cropped to the component's own ceil(ceil(W/8)/h_scale) x
    ceil(ceil(H/8)/v_scale) grid (encoder.rs:1012-1025), which can be a
    block narrower than the MCU-padded grid.
    """
    color_type = ColorType(color_type)
    components = init_components(color_type.jpeg_color_type,
                                 config.sampling_factor)
    max_h, max_v = max_sampling(components)
    num_cols = _cdiv(width, 8 * max_h)
    num_rows = _cdiv(height, 8 * max_v)
    pad_w = num_cols * 8 * max_h
    pad_h = num_rows * 8 * max_v

    planes = to_planes(pixels, color_type)
    streams = []
    for comp in components:
        ch = comp.horizontal_sampling_factor
        cv = comp.vertical_sampling_factor
        plane = _pad_edge(planes[comp.id], pad_h, pad_w)
        x_cm = _blockify_cm(plane, max_v // cv, max_h // ch)
        t = comp.quantization_table
        x = fdct_quantize(x_cm, reciprocals[t], corrections[t])
        if config.mode() != "interleaved":
            rows = _cdiv(_cdiv(height, 8), max_v // cv)
            cols = _cdiv(_cdiv(width, 8), max_h // ch)
            x = x.view(64, num_rows * cv, num_cols * ch)[:, :rows, :cols]
            streams.append(x.reshape(64, rows * cols))
            continue
        # Columns raster -> MCU order: factor as (rows, cv, cols, ch) and
        # swap (cv, cols).
        if cv > 1 or ch > 1:
            x = x.reshape(64, num_rows, cv, num_cols, ch).permute(0, 1, 3, 2, 4)
        streams.append(x.reshape(64, num_rows * num_cols, cv * ch))
    if config.mode() != "interleaved":
        return tuple(streams)
    mcu = torch.cat(streams, dim=-1)
    return (mcu.reshape(64, -1),)
