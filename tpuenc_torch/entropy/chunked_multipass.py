"""Bounded-memory device encode of the multi-pass modes.

Counterpart of ``tpuenc/entropy/chunked_multipass.py``.  The reference
encodes images of any size in every mode: sequential and progressive
encodes materialize all quantized blocks once (encoder.rs:977-1056), then
write scan by scan (encoder.rs:810-864, 869-975), and the optimized-table
pass reads the same blocks (encoder.rs:1086-1200).  On the device that is:

1. **Coefficients.**  MCU-row chunks run the whole-image pipeline
   (``kernels.pipeline.fn_cm``) at the chunk's height and append each
   component's blocks to a device store, int16 (64, B) coefficient-major
   (128 bytes a block), padded to the component's pack chunk.  The
   optimized-table modes count each chunk's symbols there too (K7,
   ``entropy.device.scan_histograms``, each component's DC chain continued
   from the store's block before the chunk), summed on the device with no
   sync per chunk; then the host builds the K.2 tables.
2. **Pack.**  Each scan of the plan packs its store in chunks of
   ``pack_chunk`` blocks (``chunked.pack_chunks``: P1-P4 with the DC
   predecessor read from the store, the padding masked, lookahead one),
   each chunk finished on the device by a ``StreamingStuffer`` of the
   scan's own.

Transient device memory is O(chunk); the store is the image's blocks.
The tracer sees phase 1 as one ``multipass.store`` span, with the store's
bytes in the counter ``store_bytes``, and each scan of phase 2 as a
``multipass.scan`` span.
"""

from __future__ import annotations

from typing import List

import torch

from .. import tracing
from ..kernels.pipeline import fn_cm
from .chunked import StreamingStuffer, pack_chunks, read_rows
from .device import scan_histograms
from .device_encode import BUDGET_LADDER, EncodeParams, huffman_params
from .huffopt import tables_from_histograms
from .pallas_pack import dc_diffs_from_dc

# Blocks per pack chunk: the pack's transients are about 1 KB a block, so
# 1M blocks keeps them near 1 GB.
PACK_CHUNK_BLOCKS = 1 << 20


def encode_multipass_chunked(pixels, plan, huffman, params: EncodeParams,
                             chunk_mcu_rows: int = 64,
                             pack_chunk: int = PACK_CHUNK_BLOCKS,
                             ladder=None, pinned=None) -> List[list]:
    """Encode a sequential or progressive image of any size, default or
    optimized tables, on the params' device with O(chunk) transient
    memory.  Returns the per-scan entropy payloads (stuffed, RST markers
    inline) in plan order, each the list of the stuffer's pieces that
    joined make it (read-only views).

    ``pixels``: the whole array or a pull source (``chunked.read_rows``);
    ``plan``: the call's ``plan.Plan``, of a sequential or progressive
    mode; ``huffman``: the table list, replaced in place by the optimized
    tables when the config asks for them (the caller writes its DHTs);
    ``params``: the quantizers and default tables on the device;
    ``chunk_mcu_rows`` / ``pack_chunk``: the coefficient and pack chunk
    sizes (a component's pack chunk is never wider than the component,
    rounded up to 256 blocks); ``ladder``, ``pinned``: as
    ``chunked.iter_encode_interleaved_chunked`` takes them (one
    ``pinned`` for every scan's pieces)."""
    width, height = plan.width, plan.height
    color_type, config = plan.color_type, plan.config
    if config.mode() == "interleaved":
        raise ValueError("the chunked multipass path takes a sequential or "
                         "progressive config")
    layout = plan.layout
    components = plan.components
    counts = layout["comp_block_counts"]
    device = params.dc.device
    mcu_h = 8 * layout["max_v"]
    num_rows = -(-height // mcu_h)
    ladder = list(BUDGET_LADDER) if ladder is None else ladder

    # ----- Phase 1: coefficients (and symbol counts) into the store -----
    pack_chunks_of = [min(pack_chunk, -(-b // 256) * 256) for b in counts]
    with tracing.span("multipass.store"):
        stores = [torch.zeros((64, -(-b // pc) * pc), dtype=torch.int16,
                              device=device)
                  for b, pc in zip(counts, pack_chunks_of)]
        tracing.count("store_bytes", 128 * sum(s.shape[1] for s in stores))
        offsets = [0] * len(components)
        hist = None
        chunk_mcu_rows = min(chunk_mcu_rows, num_rows)
        for ci in range(-(-num_rows // chunk_mcu_rows)):
            y0 = ci * chunk_mcu_rows * mcu_h
            # Interior chunks are whole MCU rows; the last takes the rows
            # left, which fn_cm pads and crops as the whole-image pipeline
            # does.
            n = min(chunk_mcu_rows * mcu_h, height - y0)
            px = read_rows(pixels, y0, n, width, color_type, device)
            streams = fn_cm(px, width, n, color_type, config,
                            params.reciprocals, params.corrections)
            # The DC before each component's chunk, a view into the store:
            # the reference chains the counted differences over the whole
            # component (encoder.rs:1100-1117).
            dc_prev = ([store[0, o - 1] for store, o in zip(stores, offsets)]
                       if ci > 0 else None)
            for c, s in enumerate(streams):
                stores[c][:, offsets[c]:offsets[c] + s.shape[1]] = s
                offsets[c] += s.shape[1]
            if config.optimize_huffman_table:
                counted = scan_histograms(streams, components,
                                          config.progressive_scans, dc_prev)
                hist = counted if hist is None else hist + counted
    if tuple(offsets) != tuple(counts):
        raise RuntimeError(f"stored {offsets} blocks, want {counts}")

    # ----- The K.2 tables from the summed counts -----
    if config.optimize_huffman_table:
        with tracing.span("sync.hist"):
            hist = hist.cpu().numpy()
        with tracing.span("tables"):
            for i, pair in enumerate(tables_from_histograms(
                    [(h[0], h[1]) for h in hist])):
                huffman[i] = list(pair)
        dc, ac = huffman_params(huffman, device)
        params = params._replace(dc=dc, ac=ac)

    # ----- Phase 2: every scan packed in chunks of its store -----
    payloads = []
    for scan, (stream_idx, spec, _) in enumerate(plan.scans):
        B = counts[stream_idx]
        store = stores[stream_idx]
        cb = pack_chunks_of[stream_idx]

        def chunks(store=store, spec=spec, B=B, cb=cb):
            for b0 in range(0, B, cb):
                blocks = store[:, b0:b0 + cb]
                if spec.emit_dc:
                    # The previous block of the component: the store column
                    # before the chunk (reset by the segment logic at 0).
                    p = max(b0 - 1, 0)
                    dcdiff = dc_diffs_from_dc(blocks[0], spec,
                                              prev_tail=store[0, p:p + 1],
                                              global_offset=b0)
                else:
                    dcdiff = torch.zeros(cb, dtype=torch.int32, device=device)
                yield blocks, dcdiff, min(cb, B - b0)

        with tracing.span("multipass.scan", scan=scan):
            stuffer = StreamingStuffer(spec.seg_blocks or B, B, pinned)
            payloads.append(list(pack_chunks(chunks(), spec, params, stuffer,
                                             ladder)))
    return payloads
