"""Pixels -> quantized zigzag coefficients, coefficient-major.

Counterpart of the coefficient-major path of ``tpuenc/kernels/pipeline.py``
(``fn_cm``): color convert, edge-replicating pad to the MCU grid, point
subsampling with the -128 level shift, blockify into (64, blocks), K1
(fDCT + zigzag + quantize, :mod:`.pallas_fdct`), then the raster -> MCU
column permutation of interleaved scans, or the per-component crop of
sequential and progressive ones.  :func:`fn_cm_samples` stops before K1:
it gives the interleaved sample stream that K8 transforms and packs in
one pass.  Semantics follow the reference exactly:

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

from .. import tracing
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
    """Point-subsample, level shift and blockify one padded (H, W) plane,
    or an (N, H, W) batch of them, into coefficient-major (64, N*R*C)
    int32: row y*8+x holds sample (y, x) of every block, columns run over
    blocks in (image, block row, block column) order.  A batch is blocked
    as its images stacked vertically: each padded height is a whole
    number of block rows."""
    w = plane.shape[-1]
    plane = plane.reshape(-1, w)
    R = plane.shape[0] // (8 * v_scale)
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


def _sample_streams(pixels, width: int, height: int, color_type: ColorType,
                    config: EncoderConfig, batched: bool = False):
    """Each component's level-shifted samples, coefficient-major: the
    components, the MCU grid (rows, cols) of one image, the number of
    images, and one int32 (64, n*R*C) block stream per component over
    its MCU-padded grid, image by image, each in raster order."""
    color_type = ColorType(color_type)
    components = init_components(color_type.jpeg_color_type,
                                 config.sampling_factor)
    max_h, max_v = max_sampling(components)
    num_cols = _cdiv(width, 8 * max_h)
    num_rows = _cdiv(height, 8 * max_v)
    pad_w = num_cols * 8 * max_h
    pad_h = num_rows * 8 * max_v

    planes = to_planes(pixels, color_type, batched=batched)
    samples = []
    for comp in components:
        plane = _pad_edge(planes[comp.id], pad_h, pad_w)
        samples.append(_blockify_cm(
            plane, max_v // comp.vertical_sampling_factor,
            max_h // comp.horizontal_sampling_factor))
    n = pixels.shape[0] if batched else 1
    return components, (num_rows, num_cols), n, samples


def _mcu_order(streams, components, grid, n: int = 1):
    """The interleaved MCU stream (64, n * mcu_count * blocks_per_mcu)
    from each component's (64, n*R*C) stream of ``n`` images: columns
    raster -> MCU order (factor as (rows, cv, cols, ch) and swap (cv,
    cols); the images' block rows follow one another, so a batch factors
    as n * rows rows), then each MCU's blocks component by component.
    The columns run in (image, MCU, block) order: the n images' MCU
    streams one after another."""
    num_rows, num_cols = grid
    num_rows *= n
    mcu = []
    for comp, x in zip(components, streams):
        cv = comp.vertical_sampling_factor
        ch = comp.horizontal_sampling_factor
        if cv > 1 or ch > 1:
            x = x.reshape(64, num_rows, cv, num_cols, ch).permute(0, 1, 3, 2, 4)
        mcu.append(x.reshape(64, num_rows * num_cols, cv * ch))
    return torch.cat(mcu, dim=-1).reshape(64, -1)


def fn_cm(pixels, width: int, height: int, color_type: ColorType,
          config: EncoderConfig, reciprocals, corrections, *,
          batched: bool = False):
    """The coefficient streams of one image, or of a batch, coefficient-major.

    ``pixels``: (H, W[, C]) uint8 tensor on the encode device, or with
    ``batched`` (N, H, W[, C]): N images of one shape (LUMA has no
    channel axis);
    ``reciprocals``/``corrections``: int32 (2, 64) zigzag-ordered tensors
    on the same device (luma, chroma; see :func:`tpuenc_torch.params_from_numpy`).
    Interleaved modes return ``(stream,)``, the MCU stream, int16 (64,
    mcu_count * blocks_per_mcu).  Sequential and progressive modes return
    one int16 (64, rows * cols) stream per component in its raster order,
    cropped to the component's own ceil(ceil(W/8)/h_scale) x
    ceil(ceil(H/8)/v_scale) grid (encoder.rs:1012-1025), which can be a
    block narrower than the MCU-padded grid.  A batch gives the same
    streams with N times the columns, the images' streams one after
    another; K1 runs once per component for the whole batch.
    """
    with tracing.span("transform"):
        components, grid, n, samples = _sample_streams(
            pixels, width, height, color_type, config, batched)
        max_h, max_v = max_sampling(components)
        streams = []
        for comp, x_cm in zip(components, samples):
            t = comp.quantization_table
            streams.append(fdct_quantize(x_cm, reciprocals[t],
                                         corrections[t]))
        if config.mode() == "interleaved":
            return (_mcu_order(streams, components, grid, n),)
        cropped = []
        for comp, x in zip(components, streams):
            cv = comp.vertical_sampling_factor
            ch = comp.horizontal_sampling_factor
            rows = _cdiv(_cdiv(height, 8), max_v // cv)
            cols = _cdiv(_cdiv(width, 8), max_h // ch)
            x = x.view(64, n, grid[0] * cv, grid[1] * ch)[:, :, :rows, :cols]
            cropped.append(x.reshape(64, n * rows * cols))
        return tuple(cropped)


def fn_cm_samples(pixels, width: int, height: int, color_type: ColorType,
                  config: EncoderConfig, *, batched: bool = False):
    """The MCU-ordered, level-shifted sample stream of an interleaved
    scan, int16 (64, mcu_count * blocks_per_mcu): K8's input
    (``entropy.pallas_pack.fused_sample_pack_blocks``).  The same color
    conversion, padding, blockify and MCU column order as :func:`fn_cm`,
    ``batched`` included, with no transform.  Raises ``ValueError`` for
    a config that is not interleaved."""
    if config.mode() != "interleaved":
        raise ValueError(f"fn_cm_samples takes an interleaved config, got "
                         f"{config.mode()}")
    with tracing.span("transform"):
        components, grid, n, samples = _sample_streams(
            pixels, width, height, color_type, config, batched)
        return _mcu_order([x.to(torch.int16) for x in samples], components,
                          grid, n)
