"""Device encode: pixels -> finished scan bytes.

Counterpart of ``tpuenc/entropy/device_encode.py``.  On the encode device:
the coefficient streams (``kernels.pipeline.fn_cm``), P1 of every scan of
the plan (``entropy.pallas_pack``: the DC path for DC-only scans, K6 for
groups of AC band scans of one component, K2 for the rest), one shared
P2-P4 merge of all scans' block strings in plan order, and a small
``meta`` vector.  On request (``fused_p1``), an interleaved scan instead
goes from its samples (``kernels.pipeline.fn_cm_samples``) through K8,
which transforms, quantizes and packs each block in one pass, to the same
merge.  The host reads ``meta`` (overflow flag, scan bits,
per-segment bits).  The scans are then finished on the encode device
(``entropy.device_stuff``: byte-align, 1-pad, 0xFF-stuff, RST markers),
and the host copies the finished bytes and splits them into scans.  A
batch's single program finishes the same way, in one pass over every
image: each image is a "scan" of its restart segments.

The two routes here take the call's ``plan.Plan`` (its layout, scan
plan, segment structure and route, decided once).  A batch of same-shape
images takes one of two routes, chosen up front (``plan.make_plan``): one
program over every image's blocks (:func:`device_encode_batch_single`),
or each image on its own through ``Encoder.encode``'s path.

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

from .. import tracing
from ..core.types import EncoderConfig
from .. import upload
from . import native
from .device_pack import ScanSpec
from .device_stuff import device_stuff as stuff_on_device
from .huffopt import progressive_bands
from .pallas_pack import (
    dc_only_pack_blocks,
    fused_sample_pack_blocks,
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
    out = []
    for a in arrays:
        with tracing.span("upload"):
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


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


def _segment_bits(lens, B: int, spec: ScanSpec):
    """A scan's total bits (1,) and its unpadded restart segments' bits
    from its P1 lengths (padding blocks carry 0 bits), int64."""
    seg = spec.seg_blocks if spec.seg_blocks > 0 else B
    n_seg = -(-B // seg)
    lens_real = torch.nn.functional.pad(lens[:B].to(torch.int64),
                                        (0, n_seg * seg - B))
    seg_bits = lens_real.view(n_seg, seg).sum(1)
    return seg_bits.sum().view(1), seg_bits


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
        bits, segs = _segment_bits(lens, B, spec)
        scan_bits.append(bits)
        seg_bits.append(segs)
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
    blocks = sum(comp_streams[si].shape[1] for si, _, _ in scan_plan)
    with tracing.span("pack", rung=budget, blocks=blocks):
        W, L, overflow, scan_bits, seg_bits = pack_scans_p1(
            comp_streams, scan_plan, params, budget)
        out, _, ovf2 = merge_pack_stream(W, L, budget)
        meta = torch.cat([(overflow | ovf2).to(torch.int64), *scan_bits,
                          *seg_bits])
        return out, meta


def qtab_pattern(layout):
    """The quantization table of each block of an interleaved MCU."""
    comps = layout["components"]
    return tuple(comps[c].quantization_table for c in layout["mcu_block_comps"])


def _pack_fused(samples, spec: ScanSpec, qtabs, params: EncodeParams,
                budget: int):
    """Pack one interleaved scan from its samples: K8, then the P2-P4
    merge.  Returns ``(stream_words int32, meta int64)`` in
    :func:`_pack_scans_v2`'s layout, [overflow, scan bits, seg bits...]."""
    with tracing.span("pack", rung=budget, blocks=samples.shape[1]):
        words, lens, ovf = fused_sample_pack_blocks(samples, spec, qtabs,
                                                    params, budget)
        out, _, ovf2 = merge_pack_stream(words, lens, budget)
        bits, segs = _segment_bits(lens, samples.shape[1], spec)
        return out, torch.cat([(ovf | ovf2).to(torch.int64), bits, segs])


def _finish_scans_v2(buf_words, seg_bits, seg_structure) -> List[bytes]:
    """The host finish, which no route runs: the reference that the tests
    and ``chip_smoke.py`` hold the device finish to.  Copy the used words
    of the raw stream (every scan's bits, concatenated in plan order) and
    realign / pad / stuff each scan's segments from its bit offset with
    the native realigner, one scan at a time.  ``seg_bits``: (S,) unpadded
    segment bit counts on the host; ``seg_structure``: each scan's number
    of segments."""
    seg_bits = np.asarray(seg_bits, np.int64)
    scan_bits = np.add.reduceat(seg_bits, np.cumsum([0, *seg_structure[:-1]]))
    total_words = (int(seg_bits.sum()) + 31) >> 5
    with tracing.span("finish.host"):
        w = buf_words[:total_words].cpu().numpy().view(np.uint32)
        scans = []
        bit_off = 0
        seg_off = 0
        for nseg, bits in zip(seg_structure, scan_bits):
            segs = seg_bits[seg_off:seg_off + nseg]
            seg_off += nseg
            bits = int(bits)
            data = w[bit_off >> 5:(bit_off + bits + 31) >> 5]
            data = data.astype(">u4").tobytes()
            scans.append(native.realign_segments(data, segs,
                                                 bit_offset=bit_off & 31))
            bit_off += bits
        return scans


def _finish_scans_device(buf_words, seg_bits, host_bits, seg_structure,
                         pinned=None) -> List[memoryview]:
    """Device finishing (``tpuenc``'s ``_finish_scans_v2_device``): both
    passes of :func:`entropy.device_stuff.device_stuff` on the stream's
    device over ``seg_bits``, the (S,) unpadded segment bit counts on that
    device, sized from ``host_bits``, the same counts that the host has
    already read; ``seg_structure``: each scan's number of segments.  Then
    one read of the (S,) final segment byte counts, one copy of the
    ``total`` finished bytes (into ``pinned``, a :class:`PinnedBuffer`,
    where given), and the split into scans on the host: each scan a
    read-only ``memoryview`` of that copy (:func:`split_scans`).  A view
    into ``pinned`` holds until the next finish into the same buffer
    overwrites it, so the caller copies what it keeps before then."""
    tracing.count("restart_segments", sum(seg_structure))
    out, seg_out, _ = stuff_on_device(buf_words, seg_bits, seg_structure,
                                      host_bits)
    with tracing.span("sync.counts"):
        seg_out_np = seg_out.cpu().numpy()
    total = int(seg_out_np.sum())
    with tracing.span("sync.bytes"):
        if pinned is None:
            data = out[:total].cpu().numpy()
        else:
            host = pinned.take(total, torch.uint8)
            host.copy_(out[:total])
            data = host.numpy()
    return split_scans(data, seg_out_np, seg_structure)


def split_scans(data, seg_out_bytes, seg_structure) -> List[memoryview]:
    """Each scan's bytes of the device finish's output ``data`` (uint8),
    from the final segment byte counts and the per-scan segment counts:
    read-only views of ``data``, no copy."""
    with tracing.span("finish.device"):
        first = np.cumsum([0, *seg_structure[:-1]])
        ends = np.cumsum(np.add.reduceat(seg_out_bytes, first))
        view = memoryview(data).toreadonly()
        return [view[a:b] for a, b in zip([0, *ends[:-1]], ends)]


def seg_structure(layout, scan_plan):
    """Each scan's number of restart segments, from the blocks of the
    stream it reads (the MCU stream, or its component's)."""
    if layout["interleaved"]:
        counts = [len(layout["mcu_block_comps"]) * layout["mcu_count"]]
    else:
        counts = list(layout["comp_block_counts"])
    return [_n_segments(counts[si], spec.seg_blocks)
            for si, spec, _ in scan_plan]


def _ladder(key, budget_hint: int = 0):
    """The rungs to try, in order: from the rung learned under ``key``,
    else from the first that covers ``budget_hint``, else all."""
    budgets = list(BUDGET_LADDER)
    if key in _budget_memo:
        return [b for b in budgets if b >= _budget_memo[key]]
    if budget_hint > 0:
        return [b for b in budgets if b >= budget_hint] or [budgets[-1]]
    return budgets


def device_encode_scans(pixels, plan, params: EncodeParams, comp_streams=None,
                        budget_hint: int = 0, pinned=None):
    """Encode every scan of ``plan`` (``plan.Plan``) from ``pixels`` (an
    (H, W[, C]) uint8 tensor on the params' device).  ``comp_streams``:
    the coefficient streams when they are already on the device (the
    two-pass optimized-table flow), else they are computed here.
    ``budget_hint`` (words per pack row): without a learned rung for this
    shape and config, the ladder starts at the first rung that covers it;
    a learned rung wins over the hint.  On the route "device-v2-fused" the
    one interleaved scan is packed straight from its samples with K8
    (:func:`_pack_fused`) in place of K1 and K2; the bytes, the overflow
    flags and so the rungs are the split path's.  That route raises
    ``ValueError`` for a plan that is not interleaved, and with
    ``comp_streams``.
    The scans are finished on the device (:func:`_finish_scans_device`,
    the finished bytes copied into ``pinned``, a :class:`PinnedBuffer`,
    where given).  Returns ``(scans, budget)``: the per-scan entropy bytes
    (stuffed, RST markers in place) in plan order, as views of the finish's
    output (:func:`_finish_scans_device`), and the budget rung that packed
    them."""
    from ..kernels.pipeline import fn_cm, fn_cm_samples
    from ..plan import V2_FUSED

    fused = plan.route == V2_FUSED
    if fused and (not plan.layout["interleaved"] or comp_streams is not None):
        raise ValueError("fused_p1 packs one interleaved scan from its pixels")

    args = (plan.width, plan.height, plan.color_type, plan.config)
    key = (*args, pixels.device.type)
    if fused:
        samples = fn_cm_samples(pixels, *args)
        ((_, spec, _),) = plan.scans
        qtabs = qtab_pattern(plan.layout)

        def pack(budget):
            return _pack_fused(samples, spec, qtabs, params, budget)
    else:
        if comp_streams is None:
            comp_streams = fn_cm(pixels, *args, params.reciprocals,
                                 params.corrections)

        def pack(budget):
            return _pack_scans_v2(comp_streams, plan.scans, params, budget)
    for budget in _ladder(key, budget_hint):
        buf, meta = pack(budget)
        with tracing.span("sync.meta"):
            meta_np = meta.cpu().numpy()
        if meta_np[0]:  # overflow: next rung
            tracing.count("ladder_retries")
            continue
        _memo_put(key, budget)
        n = len(plan.scans)
        return _finish_scans_device(buf, meta[1 + n:], meta_np[1 + n:],
                                    plan.seg_structure, pinned), budget
    raise RuntimeError(f"every budget rung overflowed ({plan.width}x"
                       f"{plan.height} {plan.color_type})")


# ---------------------------------------------------------------------------
# Batches of same-shape images (tpuenc/entropy/device_encode.py:747-892).
# ---------------------------------------------------------------------------

class PinnedBuffer:
    """A page-locked host buffer that the device finish copies its
    finished bytes into, grown to the power of two that holds the largest
    copy asked of it and reused after that: ``cudaHostAlloc`` of tens of
    MB costs milliseconds, and a copy into pageable memory runs several
    times slower than one into page-locked memory.  Each copy into it
    overwrites the last: a view of its bytes holds until the next one."""

    def __init__(self):
        self._buf = None

    def take(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        """The buffer's first ``n`` elements of ``dtype``."""
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        if self._buf is None or self._buf.numel() < nbytes:
            size = 1 << max(0, nbytes - 1).bit_length()
            self._buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        return self._buf[:nbytes].view(dtype)


def device_encode_batch_single(images, plan, params: EncodeParams,
                               pinned=None):
    """The single-program route: every image's scan in ONE interleaved
    stream (``tpuenc``'s ``device_encode_batch_fused``).

    ``images``: N (H, W[, C]) uint8 numpy arrays of one shape; ``plan``:
    the batch's ``plan.Plan``, whose route must be the single program,
    "device-batch", made for ``len(images)`` images (else ``ValueError``);
    ``pinned``: a :class:`PinnedBuffer` for the copy of the finished bytes
    on a CUDA device, None on the CPU.  Each image is uploaded into its
    slot of one (N, H, W[, C]) tensor (``upload.copy_into``), back to back
    through the device's page-locked buffer, each image's host copy beside
    the DMA of the one before; one coefficient pass over the batch (K1
    once per component), the DC differences and K2 over all N x mcu_count
    x blocks_per_mcu blocks, with restart segments of the interval or of
    one image, so the DC predictor resets at every image's first block,
    and one P2-P4 merge, at each rung of the batch's own ladder (memoised
    under the batch's size).  Then one ``meta`` read and one device finish
    over the whole stream (:func:`_finish_scans_device`), each image a
    "scan" of its segments, so no RST marker falls between images and each
    image's markers count from 0.  It never runs K8.  Returns
    ``(per-image [scan bytes], budget)``, each image's scan a view of the
    finish's output (:func:`_finish_scans_device`)."""
    from ..kernels.pipeline import fn_cm
    from ..plan import SINGLE_PROGRAM

    n = len(images)
    args = (plan.width, plan.height, plan.color_type, plan.config)
    if plan.route != SINGLE_PROGRAM or plan.n != n:
        raise ValueError(f"a batch of {n} {plan.width}x{plan.height} images "
                         f"does not take the single program on a plan of "
                         f"{plan.route} for {plan.n}")
    ((_, spec, _),) = plan.scans
    per_image = plan.layout["mcu_count"] * len(plan.layout["mcu_block_comps"])
    spec = spec._replace(seg_blocks=spec.seg_blocks or per_image)
    segs_per_image = per_image // spec.seg_blocks

    px = torch.empty((n, *images[0].shape), dtype=torch.uint8,
                     device=params.dc.device)
    for i, image in enumerate(images):
        with tracing.span("upload"):
            upload.copy_into(px[i], image)
    (stream,) = fn_cm(px, *args, params.reciprocals, params.corrections,
                      batched=True)
    key = ("batch", *args, n, px.device.type)
    for budget in _ladder(key):
        buf, meta = _pack_scans_v2((stream,), [(0, spec, None)], params,
                                   budget)
        with tracing.span("sync.meta"):
            meta_np = meta.cpu().numpy()
        if meta_np[0]:  # overflow: next rung
            tracing.count("ladder_retries")
            continue
        _memo_put(key, budget)
        # meta is [overflow, the stream's bits, its segments' bits...].
        scans = _finish_scans_device(buf, meta[2:], meta_np[2:],
                                     [segs_per_image] * n, pinned)
        return [[scan] for scan in scans], budget
    raise RuntimeError(f"every budget rung overflowed ({n} x {plan.width}x"
                       f"{plan.height} {plan.color_type})")
