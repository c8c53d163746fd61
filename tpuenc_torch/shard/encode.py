"""The mesh-sharded end-to-end encode: ``ShardedEncoder``.

Counterpart of ``tpuenc/shard/encode.py``.  Every rank of the mesh
(``shard.mesh``) calls the same method with the same arguments (SPMD)
and gets every file.  ``ShardedEncoder`` is an ``Encoder``: the entry
points it does not override (``encode_image``, ``encode_stream``) run
``Encoder``'s paths on this rank's compute device, as ``tpuenc``'s
inherited ones run on the default device.

The striped route, ``"sharded-general"``, takes MCU-aligned images, a
positive multiple of the batch axis (:meth:`ShardedEncoder.route`).  The
images are split over the batch axis in order, k = N / batch per
coordinate; each rank computes its stripe of its coordinate's images on
its own device (``shard.stripes``) and packs its part of every scan of
them (P1-P4 with the DC chain continued from the stripe before it and the
global restart geometry), the ranks agree on the budget rung (one
``all_reduce`` of the overflow flags per rung), the packed bits and
segment bit counts are gathered, and every rank joins each image's
stripes, realigns and stuffs its segments (``native.realign_segments``)
and writes the file.  A stripe of any size is packed whole: the
whole-image limits (``plan.DEVICE_BLOCK_LIMIT``) send the single-device
``Encoder`` to its chunked paths, and ``tpuenc``'s striped route does not
read them either.  Its bit counts do not wrap: the per-block, per-row and
per-run counts are int32 under the merge caps, which the overflow flag
holds them to, and every total, offset and segment count is int64.

``tpuenc``'s three striped methods are here with ``tpuenc``'s domains, on
the one route: ``encode_batch_packed_general`` (one image per batch
coordinate, else None), ``encode_batch_packed`` (its v1 conditions, else
None; the v1 packer itself is not ported, the general route gives the
same bytes) and ``encode_batch_sharded`` (any positive multiple of the
batch axis, else ``ValueError``).  ``encode_batch`` takes every batch
that ``Encoder.encode_batch`` takes: the striped route where it accepts
the batch, else ``Encoder``'s route on this rank's device
(:meth:`ShardedEncoder._plan`).

Optimized Huffman tables come from each image's histograms, counted per
stripe and summed over the stripe group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..api import Encoder, _validate_pixels
from ..core.types import ColorType
from ..entropy import device_encode as de
from ..entropy import native
from ..entropy.chunked import BitAccumulator
from ..entropy.huffopt import tables_from_histograms
from ..plan import Plan
from .mesh import comm_device, stripe_counts
from .stripes import (
    general_pack,
    stripe_encode_step,
    stripe_geometry,
)

SHARDED_GENERAL = "sharded-general"

# The dtypes a gathered tensor may have, by their code in the header.
_GATHER_DTYPES = (torch.uint8, torch.int16, torch.int32, torch.int64)


def gather(tensors: Sequence[torch.Tensor], mesh, dim=None
           ) -> List[List[np.ndarray]]:
    """Every rank's ``tensors`` on every rank: ``tpuenc``'s
    ``fetch_global`` / ``process_allgather`` (encode.py:32-61).  Each rank
    passes its own list (any number, of uint8/int16/int32/int64, on any
    one device); the result is, for each rank of the world (or of the
    mesh dimension ``dim``) in rank order, its tensors flattened, as numpy
    arrays.

    Two collectives: an ``all_gather`` of the payloads' sizes, then of
    the payloads padded to the largest: one uint8 tensor per rank, an
    int64 header (the count, then each tensor's dtype code and length)
    and the tensors' bytes, each padded to 8 bytes."""
    dev = comm_device(mesh)
    group = None if dim is None else mesh.get_group(dim)
    src = tensors[0].device if tensors else dev
    flat = [t.reshape(-1) for t in tensors]
    header = [len(flat)]
    for t in flat:
        header += [_GATHER_DTYPES.index(t.dtype), t.numel()]
    parts = [torch.tensor(header, dtype=torch.int64).view(torch.uint8)]
    for t in flat:
        b = t.contiguous().view(torch.uint8)
        parts.append(torch.nn.functional.pad(b, (0, -b.numel() % 8)))
    # Host parts go up without a sync (a pageable source is staged at
    # once); the payload comes down to a host communicator in one copy.
    payload = torch.cat([p.to(src, non_blocking=True) for p in parts]).to(dev)
    n = dist.get_world_size(group)
    size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(v) for v in torch.cat(sizes).cpu()]
    padded = torch.nn.functional.pad(payload, (0, max(sizes) - payload.numel()))
    outs = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(outs, padded, group=group)
    result = []
    for out, nbytes in zip(outs, sizes):
        buf = out[:nbytes].cpu().numpy()
        count = int(buf[:8].view(np.int64)[0])
        meta = buf[8:8 + 16 * count].view(np.int64).reshape(count, 2)
        pos = 8 + 16 * count
        arrays = []
        for code, numel in meta.tolist():
            dtype = np.dtype(str(_GATHER_DTYPES[code]).split(".")[1])
            nb = numel * dtype.itemsize
            arrays.append(buf[pos:pos + nb].view(dtype))
            pos += nb + (-nb % 8)
        result.append(arrays)
    return result


def agree_overflow(overflow: bool, budget: int, mesh):
    """One ``all_reduce(MAX)`` over the world of (overflow, budget): whether
    any rank overflowed at its rung, and the highest rung any tried.  Every
    rank sees every stripe's flag before any decides, as ``tpuenc``'s one
    global ``meta`` fetch lets it (encode.py:196-202), so the ranks climb
    the ladder together."""
    t = torch.tensor([int(overflow), budget], dtype=torch.int64).to(
        comm_device(mesh), non_blocking=True)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    flag, top = t.cpu().tolist()
    return bool(flag), top


def join_scan(parts, n_blocks: int, seg_blocks: int) -> bytes:
    """One scan's bytes from its stripes' parts, in stripe order: each a
    (words, bits, first segment, segment bits) of :func:`general_pack`'s
    output as gathered.  The stripes' bits are concatenated
    (``BitAccumulator``), their partial segment bits added up, and the
    segments realigned, 1-padded and stuffed with their RST markers
    (``native.realign_segments``); ``n_blocks`` is the scan's real block
    count."""
    acc = BitAccumulator()
    seg = seg_blocks if seg_blocks > 0 else n_blocks
    seg_bits = np.zeros(-(-n_blocks // seg), dtype=np.int64)
    for words, bits, first, partial in parts:
        acc.append_words(words.view(np.uint32), bits)
        seg_bits[first:first + partial.size] += partial
    return native.realign_segments(bytes(acc.buf), seg_bits)


def _block_counts(layout):
    """Real blocks of each stream: the MCU stream's, or each component's."""
    if layout["interleaved"]:
        return [layout["mcu_count"] * len(layout["mcu_block_comps"])]
    return list(layout["comp_block_counts"])


class ShardedEncoder(Encoder):
    """Encoder whose images are striped over a mesh of ranks.

    ``ShardedEncoder(quality, mesh, device=...)``: the settings of
    :class:`tpuenc_torch.Encoder`; ``mesh`` from ``shard.mesh.make_mesh``;
    ``device``, the compute device of this rank, explicit as for
    ``Encoder``.  Every rank calls the same methods with the same images
    and gets every file.  ``encode`` takes one image on the striped route
    (:meth:`route`), ``encode_batch`` same-shape images on the route of
    :meth:`_plan`, named in ``last_encode_path``; the budget
    rung goes to ``last_budget``.  ``encode_image`` and ``encode_stream``
    are ``Encoder``'s, on this rank's device.  ``new_file`` and
    ``new_writer`` raise ``TypeError``, as ``tpuenc``'s do: the sinks have
    no mesh.
    """

    def __init__(self, quality: int, mesh, *, device):
        super().__init__(quality, device=device)
        self._mesh = mesh

    def _geometry(self, width: int, height: int, color_type: ColorType):
        """The striped layout of an image of this size on this mesh."""
        return stripe_geometry(width, height, ColorType(color_type),
                               self._config(), stripe_counts(self._mesh)[1])

    def _refusal(self, n_images: int, width: int, height: int,
                 color_type: ColorType) -> Optional[str]:
        """Why the striped route refuses ``n_images`` images of this size,
        or None where it takes them."""
        geo = self._geometry(width, height, color_type)
        n_b = stripe_counts(self._mesh)[0]
        mcu_w, mcu_h = 8 * geo["max_h"], 8 * geo["max_v"]
        if width % mcu_w or height % mcu_h:
            return ("sharded encode requires MCU-aligned dimensions "
                    f"(multiples of {mcu_w}x{mcu_h}); got {width}x{height}")
        if n_images < 1 or n_images % n_b:
            return (f"batch {n_images} is not a positive multiple of the "
                    f"mesh batch axis {n_b}")
        return None

    def route(self, n_images: int, width: int, height: int,
              color_type: ColorType) -> str:
        """The striped route of ``n_images`` images of this size:
        :data:`SHARDED_GENERAL` for MCU-aligned images, a positive multiple
        of the batch axis, of any size.  Raises ``ValueError`` otherwise,
        as ``tpuenc``'s ``encode_batch_sharded`` does."""
        why = self._refusal(n_images, width, height, color_type)
        if why is not None:
            raise ValueError(why)
        return SHARDED_GENERAL

    def _plan(self, width: int, height: int, color_type: ColorType,
              n: Optional[int] = None, stream: bool = False) -> Plan:
        """``Encoder``'s plan of the call, chosen up front, with the route
        :data:`SHARDED_GENERAL` for a batch of ``n`` images that
        :meth:`route` takes.  Any other call keeps ``Encoder``'s route
        ("device-batch" or "device-batch-per-image" for a batch) on this
        rank's device: images that are not MCU-aligned, a batch that is
        not a multiple of the batch axis, or none."""
        plan = super()._plan(width, height, color_type, n, stream)
        if n is not None and self._refusal(n, width, height,
                                           plan.color_type) is None:
            return plan._replace(route=SHARDED_GENERAL)
        return plan

    def encode(self, data, width: int, height: int,
               color_type: ColorType) -> bytes:
        """One image over the mesh (``tpuenc/shard/encode.py:79``): the
        striped route, or its ``ValueError``."""
        return self.encode_batch_sharded([data], width, height,
                                         color_type)[0]

    def _encode_batch(self, pixel_arrays, plan: Plan) -> List[bytes]:
        """``encode_batch``'s files on ``plan``'s route: the striped route,
        or ``Encoder``'s on this rank's device (every rank encodes every
        image).  A failure inside the route raises."""
        if plan.route == SHARDED_GENERAL:
            return self._encode_striped(pixel_arrays, plan)
        return super()._encode_batch(pixel_arrays, plan)

    def encode_batch_sharded(self, images, width: int, height: int,
                             color_type: ColorType) -> List[bytes]:
        """``tpuenc``'s ``encode_batch_sharded`` (encode.py:372): any
        positive multiple of the batch axis, MCU-aligned, on the striped
        route; ``ValueError`` otherwise."""
        color_type = ColorType(color_type)
        pixels = [_validate_pixels(d, width, height, color_type)
                  for d in images]
        self.route(len(pixels), width, height, color_type)
        return self._encode_striped(
            pixels, self._plan(width, height, color_type, n=len(pixels)))

    def encode_batch_packed_general(self, images, width: int, height: int,
                                    color_type: ColorType
                                    ) -> Optional[List[bytes]]:
        """``tpuenc``'s ``encode_batch_packed_general`` (encode.py:91): the
        striped route's files for MCU-aligned images, one per batch
        coordinate; None for any other batch."""
        images = list(images)
        if (len(images) != stripe_counts(self._mesh)[0]
                or self._refusal(len(images), width, height,
                                 color_type) is not None):
            return None
        return self.encode_batch_sharded(images, width, height, color_type)

    def encode_batch_packed(self, images, width: int, height: int,
                            color_type: ColorType) -> Optional[List[bytes]]:
        """``tpuenc``'s ``encode_batch_packed`` (encode.py:262): the
        striped route's files where ``tpuenc``'s v1 packer takes the batch
        (the interleaved mode with a restart interval, MCU-aligned images,
        MCU rows dividing by the stripe count, the restart interval
        dividing each stripe's MCUs, one image per batch coordinate); None
        otherwise.  ``tpuenc``'s v1 packer also returns None where its
        fixed budget overflows; the general route climbs its ladder."""
        config = self._config()
        interval = config.restart_interval
        if config.mode() != "interleaved" or not interval:
            return None
        geo = self._geometry(width, height, color_type)
        if (geo["num_rows"] % stripe_counts(self._mesh)[1]
                or geo["rows_per_stripe"] * geo["num_cols"] % interval):
            return None
        return self.encode_batch_packed_general(images, width, height,
                                                color_type)

    def _file(self, scans, plan: Plan, huffman):
        q_tables, _, _ = self._default_tables(plan.config)
        return self._assemble_scans(plan, self._head(plan, q_tables, huffman),
                                    [[scan] for scan in scans])

    def _huffman(self, config, hist):
        """One image's Huffman tables: the K.2 tables of its reduced
        (T, 2, 257) histograms, or the default tables where ``hist`` is
        None."""
        _, huffman, _ = self._default_tables(config)
        if hist is not None:
            for t, pair in enumerate(tables_from_histograms(
                    [(h[0], h[1]) for h in hist])):
                huffman[t] = list(pair)
        return huffman

    def _encode_striped(self, pixels, plan: Plan) -> List[bytes]:
        """The striped route (``tpuenc``'s ``encode_batch_packed_general``,
        encode.py:91, for k images a batch coordinate) of the validated
        ``pixels`` on ``plan``: image k * b + i on batch coordinate b,
        every scan of it packed by the stripes on their devices, the bits
        gathered once and each file assembled on every rank."""
        width, height = plan.width, plan.height
        color_type, config = plan.color_type, plan.config
        mesh = self._mesh
        n_b, n_s = stripe_counts(mesh)
        per = len(pixels) // n_b
        b = mesh.get_local_rank("batch")
        _, _, params = self._default_tables(config)
        stripe, hists = stripe_encode_step(
            pixels[b * per:(b + 1) * per], width, height, color_type, config,
            mesh, params, with_histograms=config.optimize_huffman_table)
        tables = ([(params.dc, params.ac)] * per if hists is None else
                  [de.huffman_params(self._huffman(config, h), self.device)
                   for h in hists])

        key = (SHARDED_GENERAL, len(pixels), width, height, color_type,
               config, n_b, n_s, self.device.type)
        budget = de._ladder(key)[0]
        while True:
            scans = [s for i, (dc, ac) in enumerate(tables)
                     for s in general_pack(stripe, i, plan.scans, dc, ac,
                                           budget)]
            # One read of every scan's overflow flag and bits.
            meta = torch.cat([torch.cat([s.overflow for s in scans]).max()
                              .view(1).to(torch.int64),
                              torch.stack([s.bits for s in scans])]).cpu()
            overflow, top = agree_overflow(bool(meta[0]), budget, mesh)
            if not overflow:
                break
            higher = [r for r in de.BUDGET_LADDER if r > top]
            if not higher:
                raise RuntimeError(f"every budget rung overflowed ({width}x"
                                   f"{height} {color_type}, {n_b}x{n_s} mesh)")
            budget = higher[0]
        de._memo_put(key, budget)
        self.last_encode_path, self.last_budget = SHARDED_GENERAL, top

        sent = []
        for s, nbits in zip(scans, meta[1:].tolist()):
            sent += [s.stream[:(nbits + 31) >> 5],
                     torch.tensor([nbits, s.first_segment], dtype=torch.int64),
                     s.segment_bits]
        if hists is not None:  # every rank builds every image's tables
            sent.append(torch.from_numpy(hists))
        got = gather(sent, mesh)

        counts = _block_counts(plan.layout)
        files = []
        for ranks in mesh.mesh.tolist():  # the batch coordinates in order
            for i in range(per):
                payloads = []
                for k, (stream_idx, spec, _) in enumerate(plan.scans):
                    j = 3 * (i * len(plan.scans) + k)
                    parts = [(got[r][j], *got[r][j + 1].tolist(),
                              got[r][j + 2]) for r in ranks]
                    payloads.append(join_scan(parts, counts[stream_idx],
                                              spec.seg_blocks))
                huffman = self._huffman(
                    config, None if hists is None else
                    got[ranks[0]][-1].reshape(hists.shape)[i])
                files.append(self._file(payloads, plan, huffman))
        return files


def sharded_encode(image, width: int, height: int, color_type: ColorType,
                   mesh, *, device, quality: int = 90, configure=None
                   ) -> bytes:
    """One-shot striped encode of a single image over ``mesh``
    (``tpuenc/shard/encode.py:531``)."""
    enc = ShardedEncoder(quality, mesh, device=device)
    if configure is not None:
        configure(enc)
    return enc.encode(image, width, height, color_type)
