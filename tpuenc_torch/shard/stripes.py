"""MCU-row stripes of the encode, one per rank of the ``stripe`` axis.

Counterpart of ``tpuenc/shard/stripes.py``.  The MCU-row grid of an image
is cut into ``n_stripes`` contiguous stripes of ``rows_per_stripe`` MCU
rows; stripe s belongs to the rank at stripe coordinate s of the mesh
(``shard.mesh``), which computes it on its own compute device.  Every
block's transform is independent and the entropy stream runs in MCU-row
raster order, so stripes need no halo; what crosses between them:

* the DC tails: each stream's last DC values of stripe s - 1 continue the
  DC chain of stripe s (``tpuenc``'s ``ppermute``, here one ``all_gather``
  of every stream's tail over the stripe group; stripe 0 gets zeros);
* the Huffman histograms of the two-pass mode, summed over the stripe
  group (``tpuenc``'s ``psum``), per image.

The image is edge-padded (the last real row replicated, encoder.rs:738-744)
up to ``n_stripes * rows_per_stripe`` MCU rows, but each rank pads only its
own stripe; the padding MCU rows (a tail of the image, so whole stripes
can be padding) add no symbols and no bits.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import ColorType, EncoderConfig, init_components, max_sampling
from ..entropy.device import scan_histograms
from ..entropy.pallas_pack import dc_diffs_from_dc, device_scan_pack
from ..kernels.pipeline import _cdiv, fn_cm
from .mesh import comm_device, stripe_counts


def stripe_geometry(width: int, height: int, color_type: ColorType,
                    config: EncoderConfig, n_stripes: int):
    """Static geometry of the striped layout (``tpuenc``'s, key for key)."""
    jct = ColorType(color_type).jpeg_color_type
    components = init_components(jct, config.sampling_factor)
    max_h, max_v = max_sampling(components)
    num_cols = _cdiv(width, 8 * max_h)
    num_rows = _cdiv(height, 8 * max_v)
    rows_per_stripe = _cdiv(num_rows, n_stripes)
    return {
        "components": components,
        "max_h": max_h,
        "max_v": max_v,
        "num_cols": num_cols,
        "num_rows": num_rows,
        "rows_per_stripe": rows_per_stripe,
        "pad_h": n_stripes * rows_per_stripe * 8 * max_v,
        "pad_w": num_cols * 8 * max_h,
    }


def stripe_pixel_rows(geo) -> int:
    """Pixel rows of one stripe."""
    return geo["rows_per_stripe"] * 8 * geo["max_v"]


def pad_stripe(images: Sequence[np.ndarray], geo, stripe: int,
               device) -> torch.Tensor:
    """Stripe ``stripe`` of each (H, W[, C]) uint8 image, edge-padded to
    the stripe's rows and the padded width: uint8 (N, rows, pad_w[, C]) on
    ``device``, equal to ``tpuenc``'s ``pad_for_stripes`` canvas cut at the
    stripe.  Only the stripe's own rows of each image are read and
    uploaded; a stripe below the image, all padding, replicates the
    image's last row."""
    rows = stripe_pixel_rows(geo)
    height, width = images[0].shape[:2]
    y0 = stripe * rows
    y1 = min(y0 + rows, height)
    if y0 >= height:
        y0, y1 = height - 1, height
    px = torch.empty((len(images), y1 - y0, *images[0].shape[1:]),
                     dtype=torch.uint8, device=device)
    for i, image in enumerate(images):
        slab = image[y0:y1]
        if not slab.flags.writeable:  # torch.from_numpy warns on read-only
            slab = slab.copy()
        px[i].copy_(torch.from_numpy(np.ascontiguousarray(slab)))
    if y1 - y0 != rows:
        px = px.index_select(1, torch.arange(rows, device=device)
                             .clamp_(max=y1 - y0 - 1))
    if width != geo["pad_w"]:
        px = px.index_select(2, torch.arange(geo["pad_w"], device=device)
                             .clamp_(max=width - 1))
    return px


class Stripe(NamedTuple):
    """This rank's stripe of its batch coordinate's N images, after the
    coefficient step.  Per stream (the interleaved MCU stream, or each
    component's): ``streams`` int16 (64, N * n_local) on the compute
    device, image after image; ``n_local`` blocks per image, of which the
    first ``valid`` lie in the image's MCU rows (the rest are padding);
    ``prev_tails`` int32 (N, pat), the DC values of the last ``pat``
    blocks of stripe ``index - 1`` (zeros for stripe 0), ``pat`` being the
    scan's DC pattern (the blocks of an MCU, or 1)."""

    index: int
    n_local: Tuple[int, ...]
    valid: Tuple[int, ...]
    streams: Tuple[torch.Tensor, ...]
    prev_tails: Tuple[torch.Tensor, ...]

    def image_stream(self, k: int, i: int) -> torch.Tensor:
        """Image ``i``'s blocks of stream ``k``, (64, n_local)."""
        n = self.n_local[k]
        return self.streams[k][:, i * n:(i + 1) * n]


def exchange_tails(tails: torch.Tensor, mesh) -> torch.Tensor:
    """Each stripe's ``tails`` (one row per local image) from stripe s - 1,
    zeros for stripe 0, by ONE ``all_gather`` over the stripe group: the
    ``ppermute`` of ``tpuenc`` (stripes.py:165, :362) for every stream at
    once, with no send/recv pairing to order."""
    s = mesh.get_local_rank("stripe")
    t = tails.to(comm_device(mesh))
    out = [torch.empty_like(t) for _ in range(stripe_counts(mesh)[1])]
    dist.all_gather(out, t, group=mesh.get_group("stripe"))
    prev = out[s - 1] if s > 0 else torch.zeros_like(t)
    return prev.to(tails.device, non_blocking=True)  # host to card: no sync


def reduce_histograms(hists: torch.Tensor, mesh) -> np.ndarray:
    """The per-image histograms summed over the stripe group
    (``tpuenc``'s ``psum``, stripes.py:171-173), on the host."""
    h = hists.to(comm_device(mesh))
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=mesh.get_group("stripe"))
    return h.cpu().numpy()


def stripe_encode_step(images: Sequence[np.ndarray], width: int, height: int,
                       color_type: ColorType, config: EncoderConfig, mesh,
                       params, *, with_histograms: bool = False):
    """This rank's part of ``tpuenc``'s striped coefficient step
    (stripes.py:82, :229): its stripe of each of ``images`` (the (H, W[,
    C]) uint8 arrays of its batch coordinate) padded and uploaded
    (:func:`pad_stripe`), the coefficient streams of the stripe as an
    MCU-aligned image of its own (``kernels.pipeline.fn_cm``, K1), and the
    DC tails from stripe s - 1 (:func:`exchange_tails`).

    ``params``: the quantizers (``EncodeParams``) on the compute device.
    With ``with_histograms``, also each image's (T, 2, 257) symbol
    histograms of its valid blocks, the DC chain continued from the tail
    (``entropy.device.scan_histograms``, K7), summed over the stripe group
    (:func:`reduce_histograms`): int64 (N, T, 2, 257) on the host.  The
    histograms serve the two-pass mode, whose scans are sequential or
    progressive; an interleaved config raises ``ValueError``.

    Returns ``(Stripe, histograms or None)``."""
    color_type = ColorType(color_type)
    interleaved = config.mode() == "interleaved"
    if with_histograms and interleaved:
        raise ValueError("histograms are counted for the two-pass mode, "
                         "whose scans are sequential or progressive")
    s = mesh.get_local_rank("stripe")
    geo = stripe_geometry(width, height, color_type, config,
                          stripe_counts(mesh)[1])
    components = geo["components"]
    n = len(images)
    px = pad_stripe(images, geo, s, params.reciprocals.device)
    streams = fn_cm(px, geo["pad_w"], stripe_pixel_rows(geo), color_type,
                    config, params.reciprocals, params.corrections,
                    batched=True)
    rows_local = geo["rows_per_stripe"]
    valid_rows = min(max(geo["num_rows"] - s * rows_local, 0), rows_local)
    n_local = tuple(st.shape[1] // n for st in streams)
    valid = tuple(valid_rows * (k // rows_local) for k in n_local)
    pats = ([sum(c.vertical_sampling_factor * c.horizontal_sampling_factor
                 for c in components)] if interleaved
            else [1] * len(components))

    tails = torch.cat([st.view(64, n, k)[0, :, k - p:]
                       for st, k, p in zip(streams, n_local, pats)],
                      dim=1).to(torch.int32)
    prev = exchange_tails(tails, mesh)
    bounds = np.cumsum([0, *pats])
    stripe = Stripe(s, n_local, valid, tuple(streams),
                    tuple(prev[:, a:b] for a, b in zip(bounds, bounds[1:])))
    if not with_histograms:
        return stripe, None
    hists = torch.stack([
        scan_histograms(
            [stripe.image_stream(k, i)[:, :valid[k]]
             for k in range(len(streams))],
            components, config.progressive_scans,
            dc_prev=[t[i, 0] for t in stripe.prev_tails])
        for i in range(n)])
    return stripe, reduce_histograms(hists, mesh)


def segment_bits(lens: torch.Tensor, valid: int, offset: int,
                 seg_blocks: int):
    """The bits of each restart segment of a scan that blocks ``[offset,
    offset + valid)`` of the scan touch, from the stripe's per-block bit
    lengths ``lens``: ``(first segment, int64 (n,))``, partial where a
    segment crosses the stripe's edge (the stripes' partials add up).
    ``seg_blocks`` 0: one segment, the whole scan."""
    lens = lens[:valid].to(torch.int64)
    if seg_blocks == 0:
        return 0, lens.sum().view(1)
    if valid == 0:
        return 0, lens
    lead = offset % seg_blocks
    n_seg = _cdiv(lead + valid, seg_blocks)
    lens = torch.nn.functional.pad(lens, (lead, n_seg * seg_blocks - lead - valid))
    return offset // seg_blocks, lens.view(n_seg, seg_blocks).sum(1)


class StripeScan(NamedTuple):
    """One scan's part packed by one stripe: ``stream`` int32 words (the
    raw bits, MSB first), ``bits`` int64 (), ``lens`` int32 (Bp,) each
    block's bits (0 from the first padding block on), its restart
    segments' bits from segment ``first_segment`` on
    (:func:`segment_bits`), and the overflow flag int32 (1,), all on the
    compute device."""

    stream: torch.Tensor
    bits: torch.Tensor
    lens: torch.Tensor
    first_segment: int
    segment_bits: torch.Tensor
    overflow: torch.Tensor


def general_pack(stripe: Stripe, image: int, plan, dc_packed, ac_packed,
                 budget: int):
    """This rank's part of every scan of ``plan`` for local image
    ``image`` of the stripe: ``tpuenc``'s general per-stripe pack
    (stripes.py:250, :334-371).  Per scan: the DC differences continued from stripe s - 1's
    tail with the scan's global block offset s * n_local, which fixes the
    restart segments (``dc_diffs_from_dc``'s mid-stream form), then P1-P4
    (``device_scan_pack``: the DC path or K2, then K3-K5) with the padding
    blocks masked to no bits.  Returns a :class:`StripeScan` per scan."""
    out = []
    for stream_idx, spec, _ in plan:
        n = stripe.n_local[stream_idx]
        blocks = stripe.image_stream(stream_idx, image)
        offset = stripe.index * n
        if spec.emit_dc:
            dcdiff = dc_diffs_from_dc(
                blocks[0], spec,
                prev_tail=stripe.prev_tails[stream_idx][image],
                global_offset=offset)
        else:
            dcdiff = torch.zeros(n, dtype=torch.int32, device=blocks.device)
        valid = stripe.valid[stream_idx]
        stream, bits, lens, ovf = device_scan_pack(
            blocks, spec, dc_packed, ac_packed, budget, dcdiff=dcdiff,
            valid_blocks=valid)
        first, segs = segment_bits(lens, valid, offset, spec.seg_blocks)
        out.append(StripeScan(stream, bits, lens, first, segs, ovf))
    return out


__all__ = ["stripe_geometry", "stripe_pixel_rows", "pad_stripe", "Stripe",
           "exchange_tails", "reduce_histograms", "stripe_encode_step",
           "segment_bits", "StripeScan", "general_pack"]
