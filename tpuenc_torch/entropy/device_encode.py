"""Device encode: pixels -> finished scan bytes.

Counterpart of ``tpuenc/entropy/device_encode.py``.  On the encode device:
the coefficient streams (``kernels.pipeline.fn_cm``), P1 of every scan of
the plan (``entropy.pallas_pack``: the DC path for DC-only scans, K6 for
groups of AC band scans of one component, K2 for the rest), one shared
P2-P4 merge of all scans' block strings in plan order, and a small
``meta`` vector.  The host reads ``meta`` (overflow flag, scan bits,
per-segment bits), copies the first ``total_words`` words of the stream,
and finishes each scan's restart segments from its bit offset with the
native realigner (byte-align, 1-pad, 0xFF-stuff, RST markers).

The packer's capacities follow a words-per-block budget.  An encode starts
at the lowest rung of :data:`BUDGET_LADDER` (or the rung learned for its
shape and config, or the first rung that covers a content hint) and climbs
on overflow; the top rung (224 words per block) cannot overflow.
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
from .pallas_pack import (
    dc_only_pack_blocks,
    merge_pack_stream,
    scan_pack_blocks,
    scan_pack_blocks_acbands,
)

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


def _on(device, arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def quant_params(q_tables, device):
    """K1's (reciprocals, corrections): int32 (2, 64) zigzag-ordered
    tensors on ``device`` from the (luma, chroma) quantization tables
    (objects with natural-order ``reciprocals`` and ``corrections``)."""
    from ..kernels.pallas_fdct import zigzag_params

    return _on(device, (np.stack(a) for a in zip(*map(zigzag_params, q_tables))))


def huffman_params(huffman, device):
    """The packed Huffman tables (dc (1, 128), ac (T, 256), int32) on
    ``device`` from ``[(dc, ac) per table id]``."""
    return _on(device, _pack_tables(*tables_to_arrays(huffman)))


def params_from_numpy(q_tables, dc_sizes, dc_codes, ac_sizes, ac_codes,
                      device) -> EncodeParams:
    """The encoder's parameters as tensors on ``device``.

    ``q_tables``: the (luma, chroma) quantization tables (see
    :func:`quant_params`); the four (T, 256) arrays are
    :func:`tables_to_arrays`' output."""
    return EncodeParams(*quant_params(q_tables, device), *_on(
        device, _pack_tables(dc_sizes, dc_codes, ac_sizes, ac_codes)))


def _band_groups(scan_plan):
    """K6's launches: for each component, its AC-only band scans sorted
    by band start, in batches of at most 4; a lone tail band is left to
    K2, as ``tpuenc`` groups them."""
    groups: dict = {}
    for i, (stream_idx, spec, _) in enumerate(scan_plan):
        if spec.emit_ac and not spec.emit_dc and len(spec.ac_tab_pattern) == 1:
            groups.setdefault(stream_idx, []).append(i)
    batches = []
    for stream_idx, idxs in groups.items():
        order = sorted(idxs, key=lambda i: scan_plan[i][1].spectral_start)
        batches += [(stream_idx, order[k:k + 4])
                    for k in range(0, len(order), 4) if len(order[k:k + 4]) > 1]
    return batches


def pack_scans_p1(comp_streams, scan_plan, params: EncodeParams,
                  budget: int):
    """P1 of every scan of the plan: K6 for the grouped AC band scans, the
    DC path for DC-only scans, K2 for the rest.  Returns ``(words int32
    (R, capB), lens int32 (R,), overflow int32 (1,), scan_bits,
    seg_bits)``: every scan's block strings padded to one width and
    concatenated in plan order, and per scan its total bits and its
    unpadded segment bits (lists of int64 tensors)."""
    dev = comp_streams[0].device
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    banded = {}
    for stream_idx, batch in _band_groups(scan_plan):
        outs, ovf = scan_pack_blocks_acbands(
            comp_streams[stream_idx], [scan_plan[i][1] for i in batch],
            params.ac, budget)
        overflow = overflow | ovf
        banded.update(zip(batch, outs))

    strings = []
    scan_bits = []
    seg_bits = []
    for i, (stream_idx, spec, _) in enumerate(scan_plan):
        blocks = comp_streams[stream_idx]
        B = blocks.shape[1]
        if i in banded:
            words, lens = banded[i]
        else:
            if spec.emit_dc and not spec.emit_ac:
                words, lens, ovf = dc_only_pack_blocks(blocks, spec, params.dc)
            else:
                words, lens, ovf = scan_pack_blocks(blocks, spec, params.dc,
                                                    params.ac, budget)
            overflow = overflow | ovf
        seg = spec.seg_blocks if spec.seg_blocks > 0 else B
        n_seg = -(-B // seg)
        lens_real = torch.nn.functional.pad(lens[:B].to(torch.int64),
                                            (0, n_seg * seg - B))
        seg_bits.append(lens_real.view(n_seg, seg).sum(1))
        scan_bits.append(seg_bits[-1].sum().view(1))  # padding blocks: 0 bits
        strings.append((words, lens))

    if len(strings) == 1:
        W, L = strings[0]
    else:
        capB = max(w.shape[1] for w, _ in strings)
        W = torch.zeros((sum(w.shape[0] for w, _ in strings), capB),
                        dtype=torch.int32, device=dev)
        r = 0
        for w, _ in strings:
            W[r:r + w.shape[0], :w.shape[1]] = w
            r += w.shape[0]
        L = torch.cat([ln for _, ln in strings])
    return W, L, overflow, scan_bits, seg_bits


def _pack_scans_v2(comp_streams, scan_plan, params: EncodeParams,
                   budget: int):
    """Pack every scan of the plan: P1 per scan (:func:`pack_scans_p1`),
    then ONE shared P2-P4 merge over all scans' block strings.  Returns
    ``(stream_words int32, meta int64)`` with meta = [overflow,
    scan_bits..., seg_bits...] (unpadded segment bit counts, scans in plan
    order), both on the streams' device."""
    W, L, overflow, scan_bits, seg_bits = pack_scans_p1(
        comp_streams, scan_plan, params, budget)
    out, _, ovf2 = merge_pack_stream(W, L, budget)
    meta = torch.cat([(overflow | ovf2).to(torch.int64), *scan_bits,
                      *seg_bits])
    return out, meta


def _finish_scans_v2(buf_words, meta_np, n_scans: int,
                     seg_structure) -> List[bytes]:
    """Host finishing: copy the first ``total_words`` words of the raw
    stream (all scans' bits, concatenated in plan order) and realign /
    pad / stuff each scan's segments from its bit offset."""
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


def seg_structure(layout, scan_plan):
    """Each scan's number of restart segments, from the blocks of the
    stream it reads (the MCU stream, or its component's)."""
    if layout["interleaved"]:
        counts = [len(layout["mcu_block_comps"]) * layout["mcu_count"]]
    else:
        counts = list(layout["comp_block_counts"])
    return [_n_segments(counts[si], spec.seg_blocks)
            for si, spec, _ in scan_plan]


def device_encode_scans(pixels, width: int, height: int,
                        color_type: ColorType, config: EncoderConfig,
                        params: EncodeParams, comp_streams=None,
                        budget_hint: int = 0):
    """Encode every scan of ``pixels`` (an (H, W[, C]) uint8 tensor on the
    params' device).  ``comp_streams``: the coefficient streams when they
    are already on the device (the two-pass optimized-table flow), else
    they are computed here.  ``budget_hint`` (words per pack row): without
    a learned rung for this shape and config, the ladder starts at the
    first rung that covers it; a learned rung wins over the hint.
    Returns ``(scans, budget)``: the per-scan entropy byte strings
    (stuffed, RST markers in place) in plan order, and the budget rung
    that packed them."""
    from ..kernels.pipeline import fn_cm, scan_layout

    layout = scan_layout(width, height, color_type, config)
    scan_plan = build_scan_plan(layout, layout["components"], config)
    segs = seg_structure(layout, scan_plan)

    key = (width, height, color_type, config, pixels.device.type)
    budgets = list(BUDGET_LADDER)
    if key in _budget_memo:
        budgets = [b for b in budgets if b >= _budget_memo[key]]
    elif budget_hint > 0:
        budgets = [b for b in budgets if b >= budget_hint] or [budgets[-1]]

    if comp_streams is None:
        comp_streams = fn_cm(pixels, width, height, color_type, config,
                             params.reciprocals, params.corrections)
    for budget in budgets:
        buf, meta = _pack_scans_v2(comp_streams, scan_plan, params, budget)
        meta_np = meta.cpu().numpy()
        if meta_np[0]:  # overflow: next rung
            continue
        _memo_put(key, budget)
        return _finish_scans_v2(buf, meta_np, len(scan_plan), segs), budget
    raise RuntimeError(
        f"every budget rung overflowed ({width}x{height} {color_type})"
    )
