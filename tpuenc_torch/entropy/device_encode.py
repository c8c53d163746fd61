"""Device encode: pixels -> finished scan bytes.

Counterpart of ``tpuenc/entropy/device_encode.py`` for single-scan
(interleaved) default-table modes.  On the encode device: the coefficient
stream (``kernels.pipeline.fn_cm``), the DC differences, P1-P4
(``entropy.pallas_pack``) and a small ``meta`` vector.  The host reads
``meta`` (overflow flag, scan bits, per-segment bits), copies the first
``total_words`` words of the stream, and finishes each restart segment
with the native realigner (byte-align, 1-pad, 0xFF-stuff, RST markers).

The packer's capacities follow a words-per-block budget.  An encode starts
at the lowest rung of :data:`BUDGET_LADDER` (or the rung learned for its
shape and config) and climbs on overflow; the top rung (224 words per
block) cannot overflow.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.types import ColorType, EncoderConfig
from . import native
from .device_pack import ScanSpec
from .huffopt import progressive_bands
from .pallas_pack import merge_pack_stream, scan_pack_blocks

# Budget rungs in words per block: per-block caps clamp to >= 16, the
# aggregate P2-P4 caps use the rung as it is (tpuenc.entropy.device_encode
# explains the rungs' choice).
BUDGET_LADDER = (4, 5, 6, 8, 12, 14, 16, 48, 224)

# (key) -> working budget, learned across calls; bounded LRU.
_budget_memo: OrderedDict = OrderedDict()
_BUDGET_MEMO_MAX = 4096


def _memo_put(key, budget: int) -> None:
    if key in _budget_memo:
        _budget_memo.move_to_end(key)
    elif len(_budget_memo) >= _BUDGET_MEMO_MAX:
        _budget_memo.popitem(last=False)
    _budget_memo[key] = budget


def _dc_prev_delta(pattern: Tuple[int, ...]) -> Tuple[int, ...]:
    """Distance from each pattern slot to the previous slot of the same
    component in the cyclically repeated pattern."""
    n = len(pattern)
    deltas = []
    for s in range(n):
        d = 1
        while d <= n:
            if pattern[(s - d) % n] == pattern[s]:
                break
            d += 1
        deltas.append(d)
    return tuple(deltas)


def build_scan_plan(layout, components, config: EncoderConfig):
    """List of (stream_index, ScanSpec, spectral) for the config's mode.

    ``stream_index`` selects which coefficient stream feeds the scan: 0 for
    the interleaved MCU stream, or the component index for
    sequential/progressive scans.  ``spectral`` is the SOS (Ss, Se) pair.
    """
    mode = config.mode()
    scans = []
    if mode == "interleaved":
        comp_pattern = layout["mcu_block_comps"]
        dc_pat = tuple(components[c].dc_huffman_table for c in comp_pattern)
        ac_pat = tuple(components[c].ac_huffman_table for c in comp_pattern)
        delta = _dc_prev_delta(comp_pattern)
        seg = (config.restart_interval or 0) * len(comp_pattern)
        scans.append(
            (0, ScanSpec(1, 64, True, True, dc_pat, ac_pat, delta, seg), None)
        )
        return scans

    interval = config.restart_interval or 0
    if mode == "sequential":
        for i, comp in enumerate(components):
            scans.append((
                i,
                ScanSpec(1, 64, True, True, (comp.dc_huffman_table,),
                         (comp.ac_huffman_table,), (1,), interval),
                None,
            ))
        return scans

    # Progressive: per-component DC scans, then AC bands with the component
    # loop inside the band loop (encoder.rs:869-975).
    for i, comp in enumerate(components):
        scans.append((
            i,
            ScanSpec(1, 1, True, False, (comp.dc_huffman_table,),
                     (comp.ac_huffman_table,), (1,), interval),
            (0, 0),
        ))
    for start, end in progressive_bands(config.progressive_scans):
        for i, comp in enumerate(components):
            scans.append((
                i,
                ScanSpec(start, end, False, True, (comp.dc_huffman_table,),
                         (comp.ac_huffman_table,), (1,), interval),
                (start, end - 1),
            ))
    return scans


def _n_segments(n_blocks: int, seg_blocks: int) -> int:
    seg = seg_blocks if seg_blocks > 0 else n_blocks
    return -(-n_blocks // seg)


class EncodeParams(NamedTuple):
    """The encoder's parameters as tensors on one device: zigzag-ordered
    quantizer vectors, int32 (2, 64) for (luma, chroma), and the packed
    Huffman tables, dc int32 (1, 128) [table*16 + size] and ac int32
    (T, 256) [symbol], each entry ``size << 16 | code``."""

    reciprocals: torch.Tensor
    corrections: torch.Tensor
    dc: torch.Tensor
    ac: torch.Tensor


def tables_to_arrays(huffman) -> Tuple[np.ndarray, ...]:
    """[(dc, ac) per table id] -> four (T, 256) uint32 lookup arrays."""
    T = len(huffman)
    dc_sizes = np.zeros((T, 256), np.uint32)
    dc_codes = np.zeros((T, 256), np.uint32)
    ac_sizes = np.zeros((T, 256), np.uint32)
    ac_codes = np.zeros((T, 256), np.uint32)
    for i, (dc, ac) in enumerate(huffman):
        if dc is not None:
            dc_sizes[i] = dc.sizes
            dc_codes[i] = dc.codes
        if ac is not None:
            ac_sizes[i] = ac.sizes
            ac_codes[i] = ac.codes
    return dc_sizes, dc_codes, ac_sizes, ac_codes


def _pack_tables(dc_sizes, dc_codes, ac_sizes, ac_codes):
    """Packed-table layout from the four (T, 256) lookup arrays (numpy):
    dc (1, 128) int32 [tab*16 + size, zero-padded], ac (T, 256) int32
    [size << 16 | code]."""
    T = dc_sizes.shape[0]
    if T > 4:
        raise ValueError(f"at most 4 Huffman tables, got {T}")
    dcp = (np.asarray(dc_sizes[:, :16], np.uint64) << 16) | np.asarray(
        dc_codes[:, :16], np.uint64)
    dc = np.zeros((1, 128), np.uint64)
    dc[0, :16 * T] = dcp.reshape(-1)
    ac = (np.asarray(ac_sizes, np.uint64) << 16) | np.asarray(ac_codes, np.uint64)
    return (dc.astype(np.uint32).view(np.int32),
            ac.astype(np.uint32).view(np.int32))


def params_from_numpy(q_tables, dc_sizes, dc_codes, ac_sizes, ac_codes,
                      device) -> EncodeParams:
    """The encoder's parameters as tensors on ``device``.

    ``q_tables``: the (luma, chroma) quantization tables (objects with
    natural-order ``reciprocals`` and ``corrections``); the four (T, 256)
    arrays are :func:`tables_to_arrays`' output."""
    from ..kernels.pallas_fdct import zigzag_params

    recip, corr = (np.stack(a) for a in zip(*map(zigzag_params, q_tables)))
    dc, ac = _pack_tables(dc_sizes, dc_codes, ac_sizes, ac_codes)
    return EncodeParams(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (recip, corr, dc, ac)))


def _pack_scans_v2(stream, spec: ScanSpec, params: EncodeParams, budget: int):
    """Pack one scan's (64, B) stream.  Returns ``(stream_words int32,
    meta int64)`` with meta = [overflow, scan_bits, seg_bits...]
    (unpadded segment bit counts), both on the stream's device."""
    B = stream.shape[1]
    words, lens, ovf = scan_pack_blocks(stream, spec, params.dc, params.ac,
                                        budget)
    seg = spec.seg_blocks if spec.seg_blocks > 0 else B
    n_seg = -(-B // seg)
    lens_real = torch.nn.functional.pad(lens[:B].to(torch.int64),
                                        (0, n_seg * seg - B))
    seg_bits = lens_real.view(n_seg, seg).sum(1)
    out, total_bits, ovf2 = merge_pack_stream(words, lens, budget)
    meta = torch.cat([(ovf | ovf2).to(torch.int64), total_bits.view(1),
                      seg_bits])
    return out, meta


def _finish_scans_v2(buf_words, meta_np, n_scans: int,
                     seg_structure) -> List[bytes]:
    """Host finishing: copy the first ``total_words`` words of the raw
    stream and realign / pad / stuff each scan's segments."""
    scan_bits = meta_np[1:1 + n_scans]
    seg_bits = meta_np[1 + n_scans:]
    total_words = (int(scan_bits.sum()) + 31) >> 5
    w = buf_words[:total_words].cpu().numpy().view(np.uint32)
    data = w.astype(">u4").tobytes()
    scans = []
    bit_off = 0
    seg_off = 0
    for i in range(n_scans):
        nseg = seg_structure[i]
        segs = seg_bits[seg_off:seg_off + nseg].astype(np.int64)
        seg_off += nseg
        scans.append(native.realign_segments(data, segs, bit_offset=bit_off))
        bit_off += int(scan_bits[i])
    return scans


def device_encode_scans(pixels, width: int, height: int,
                        color_type: ColorType, config: EncoderConfig,
                        params: EncodeParams):
    """Encode the single interleaved scan of ``pixels`` (an (H, W[, C])
    uint8 tensor on the params' device).  Returns ``(scans, budget)``: the
    per-scan entropy byte strings (stuffed, RST markers in place) and the
    budget rung that packed them."""
    from ..kernels.pipeline import fn_cm, scan_layout

    layout = scan_layout(width, height, color_type, config)
    components = layout["components"]
    scan_plan = build_scan_plan(layout, components, config)
    if len(scan_plan) != 1 or not layout["interleaved"]:
        raise NotImplementedError(
            "multi-scan plans (sequential/progressive) are not ported yet: "
            "ROADMAP M6"
        )
    (_, spec, _), = scan_plan
    n_blocks = len(layout["mcu_block_comps"]) * layout["mcu_count"]
    seg_structure = [_n_segments(n_blocks, spec.seg_blocks)]

    key = (width, height, color_type, config, pixels.device.type)
    budgets = list(BUDGET_LADDER)
    if key in _budget_memo:
        budgets = [b for b in budgets if b >= _budget_memo[key]]

    (stream,) = fn_cm(pixels, width, height, color_type, config,
                      params.reciprocals, params.corrections)
    for budget in budgets:
        buf, meta = _pack_scans_v2(stream, spec, params, budget)
        meta_np = meta.cpu().numpy()
        if meta_np[0]:  # overflow: next rung
            continue
        _memo_put(key, budget)
        return _finish_scans_v2(buf, meta_np, 1, seg_structure), budget
    raise RuntimeError(
        f"every budget rung overflowed ({width}x{height} {color_type})"
    )
