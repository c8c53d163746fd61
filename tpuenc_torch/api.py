"""Public encoder API.

Counterpart of ``tpuenc/api.py``: an ``Encoder`` with the reference's
surface (``encoder.rs:212-567``: quality 1-100 with 4:2:0 below 90, every
setter, APP/ICC/EXIF metadata, ``encode`` / ``encode_image`` /
``new_file`` / ``new_writer``), running on an explicit PyTorch device.
On a CUDA device the coefficient stage and the entropy packer run as the
port's CUDA kernels; on the CPU the same path runs their plain PyTorch
versions.  Either way the bytes are the same.

It encodes every mode: interleaved, sequential and progressive (2-64
scans), with default or two-pass optimized Huffman tables, every color
type and sampling factor, restart intervals and metadata.  Images past
the whole-image limits go through the bounded-memory chunked paths
(``entropy.chunked``, ``entropy.chunked_multipass``); ``encode_batch``
encodes batches of same-shape images on one of two routes, each file byte
for byte what ``encode`` gives; ``encode_stream`` yields the file in
pieces as they are made, from an array or a pull source of pixel rows.
"""

from __future__ import annotations

import abc
import sys
import types
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from . import plan as planning
from . import tracing
from .core import errors
from .core.tables import default_tables, quantization_table
from .core.types import (
    ColorType,
    EncoderConfig,
    JpegColorType,
    PixelDensity,
    SamplingFactor,
)
from .entropy import device_encode as de
from .entropy.chunked import PinnedPieces, iter_encode_interleaved_chunked
from .entropy.chunked_multipass import encode_multipass_chunked
from .entropy.device import scan_histograms
from .entropy.huffopt import (
    budget_hint_from_bits,
    exact_stream_bits,
    tables_from_histograms,
)
from .jfif import markers, segments
from .kernels.pipeline import fn_cm
from .plan import (
    CHUNKED,
    CHUNKED_MULTIPASS,
    CHUNKED_STREAM,
    PER_IMAGE,
    Plan,
    make_plan,
)
from . import upload

__all__ = ["Encoder", "ImageBuffer"]

# A streamed plan of more scans comes as one body piece (tpuenc/api.py:416).
STREAM_MAX_SCANS = 48


class _Api(types.ModuleType):
    """``api.DEVICE_BLOCK_LIMIT`` and ``api.DEVICE_PACK_ROWS_LIMIT``, the
    names ``tpuenc`` gives the whole-image limits, read and set
    ``plan``'s: lowering them sends small images to the chunked paths.
    The port's own code and tests use ``plan``'s names; these are kept for
    callers from outside the port."""


for _name in ("DEVICE_BLOCK_LIMIT", "DEVICE_PACK_ROWS_LIMIT"):
    setattr(_Api, _name, property(
        lambda _, name=_name: getattr(planning, name),
        lambda _, value, name=_name: setattr(planning, name, value)))
sys.modules[__name__].__class__ = _Api


def _check_dims(width: int, height: int) -> None:
    """Reference dimension domain: non-zero (encoder.rs:521-526) and
    within the u16 range its API types enforce (encoder.rs:443-446)."""
    if width == 0 or height == 0:
        raise errors.ZeroImageDimensions(width, height)
    if width > 65535 or height > 65535:
        raise errors.DimensionsTooLarge(width, height)


def _validate_pixels(
    data, width: int, height: int, color_type: ColorType
) -> np.ndarray:
    """Length/dimension validation shared by the encode entry points
    (reference encoder.rs:447-454); returns the (H, W[, C]) pixel array.
    The u16 range check comes first, as a type-level constraint does in
    the reference (encoder.rs:443-446)."""
    if width > 65535 or height > 65535:
        raise errors.DimensionsTooLarge(width, height)
    bpp = color_type.bytes_per_pixel
    flat = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)
    ) else np.asarray(data, dtype=np.uint8).reshape(-1)
    required = width * height * bpp
    if flat.size < required:
        raise errors.BadImageData(flat.size, required)
    _check_dims(width, height)
    pixels = flat[:required].reshape(height, width, bpp)
    if bpp == 1:
        pixels = pixels[..., 0]
    return pixels


class ImageBuffer(abc.ABC):
    """User-extensible pixel source (reference image_buffer.rs:86-98):
    implementations return whole component planes at once."""

    @abc.abstractmethod
    def get_jpeg_color_type(self) -> JpegColorType: ...

    @abc.abstractmethod
    def width(self) -> int: ...

    @abc.abstractmethod
    def height(self) -> int: ...

    @abc.abstractmethod
    def to_planes(self) -> Tuple[np.ndarray, ...]:
        """Per-component (H, W) planes of 0..255 values in JPEG colorspace
        (Luma: 1 plane; Ycbcr: 3; Cmyk/Ycck: 4, already sign-converted)."""

    def color_type(self) -> Optional[ColorType]:
        """Optional input color type of the planes: when it returns a
        :class:`ColorType`, ``to_planes()`` returns planes in that input
        colorspace and :meth:`Encoder.encode_image` runs the same color
        conversion as :meth:`Encoder.encode`.  ``None``: the planes are
        already in JPEG colorspace."""
        return None


class Encoder:
    """The JPEG encoder (reference encoder.rs:212-435) on ``device``.

    ``Encoder(quality, device=...)`` mirrors ``Encoder::new``: quality
    1..100; below 90 the default sampling factor is 2x2 (4:2:0), otherwise
    1x1.  ``device`` is any PyTorch device spec ("cuda", "cuda:1", "cpu");
    the encoder never picks one itself.

    ``fused_p1=True`` routes the interleaved mode through K8, which
    transforms, quantizes and packs each block in one pass, in place of K1
    then K2 (``last_encode_path`` "device-v2-fused"); the bytes are the
    same.  It is routing by mode: sequential, progressive and
    optimized-table encodes (optimized tables make the scans sequential)
    take the split path as ever ("device-v2").

    Every route finishes its scans on the encode device
    (``entropy.device_stuff``: byte alignment, 1-padding, 0xFF stuffing
    and RST markers) and copies back only the finished bytes: the
    whole-image routes, ``encode_batch``'s per-image route and its single
    program in one finish, the chunked paths chunk by chunk (``tpuenc``
    finishes those on the host).

    Each call makes one :class:`plan.Plan` (:meth:`_plan`), which names
    its route and holds its scan plan, and hands it down.
    """

    def __init__(self, quality: int, *, device, fused_p1: bool = False,
                 _path: Optional[str] = None, _writer=None):
        self.quality = int(quality)
        self.device = torch.device(device)
        self.fused_p1 = bool(fused_p1)
        self._sampling_factor = (
            SamplingFactor.F_2_2 if self.quality < 90 else SamplingFactor.F_1_1
        )
        self._density = PixelDensity()
        self._quantization: Tuple[object, object] = ("default", "default")
        self._progressive_scans: Optional[int] = None
        self._restart_interval: Optional[int] = None
        self._optimize_huffman_table = False
        self._app_segments: List[Tuple[int, bytes]] = []
        self._path = _path
        self._writer = _writer
        # Quantizer tensors on self.device, keyed by (quantization,
        # quality), and the default Huffman tables' tensors.
        self._quant: dict = {}
        self._default_huffman = None
        # The page-locked buffer on a CUDA device for the device finish's
        # bytes, made at its first use (entropy.device_encode.PinnedBuffer),
        # and the chunked routes' (entropy.chunked.PinnedPieces).
        self._pinned = None
        self._pieces = None
        # Which path produced the last output: encode()'s "device-v2" (the
        # counterpart of tpuenc's v2 device packer), "device-v2-fused"
        # (with K8), "device-chunked" or "device-chunked-multipass" (past
        # the whole-image limits), encode_stream's "device-chunked-stream",
        # or encode_batch's route; and the budget rung (words per block)
        # its packer used, the highest of a chunked encode's.
        self.last_encode_path: Optional[str] = None
        self.last_budget: Optional[int] = None

    @classmethod
    def new_file(cls, path, quality: int, *, device,
                 fused_p1: bool = False) -> "Encoder":
        """Encoder writing to a file (reference encoder.rs:1203-1220)."""
        return cls(quality, device=device, fused_p1=fused_p1, _path=str(path))

    @classmethod
    def new_writer(cls, writer, quality: int, *, device,
                   fused_p1: bool = False) -> "Encoder":
        """Encoder writing into any object with a ``write(bytes)`` method
        (reference writer.rs:76-106)."""
        return cls(quality, device=device, fused_p1=fused_p1, _writer=writer)

    # ------------------------------------------------------------------
    # Setters (reference encoder.rs:277-435)
    # ------------------------------------------------------------------

    def set_density(self, density: PixelDensity) -> None:
        self._density = density

    def density(self) -> PixelDensity:
        return self._density

    def set_sampling_factor(self, sampling: SamplingFactor) -> None:
        self._sampling_factor = sampling

    def sampling_factor(self) -> SamplingFactor:
        return self._sampling_factor

    def set_quantization_tables(self, luma, chroma) -> None:
        """Preset name (see ``core.tables.QUANT_PRESET_NAMES``) or a custom
        64-entry sequence per table."""
        self._quantization = (_freeze_qspec(luma), _freeze_qspec(chroma))

    def quantization_tables(self):
        return self._quantization

    def set_progressive(self, progressive: bool) -> None:
        self._progressive_scans = 4 if progressive else None

    def set_progressive_scans(self, scans: int) -> None:
        if not 2 <= scans <= 64:
            raise ValueError(f"Invalid number of scans: {scans}")
        self._progressive_scans = scans

    def progressive_scans(self) -> Optional[int]:
        return self._progressive_scans

    def set_restart_interval(self, interval: int) -> None:
        self._restart_interval = None if interval == 0 else int(interval)

    def restart_interval(self) -> Optional[int]:
        return self._restart_interval

    def set_optimized_huffman_tables(self, optimize: bool) -> None:
        self._optimize_huffman_table = bool(optimize)

    def optimized_huffman_tables(self) -> bool:
        return self._optimize_huffman_table

    def add_app_segment(self, segment_nr: int, data: bytes) -> None:
        """Reference encoder.rs:374-383."""
        if segment_nr == 0 or segment_nr > 15:
            raise errors.InvalidAppSegment(segment_nr)
        if len(data) > 65533:
            raise errors.AppSegmentTooLarge(len(data))
        self._app_segments.append((segment_nr, bytes(data)))

    def add_icc_profile(self, data: bytes) -> None:
        """ICC chunking into APP2 (reference encoder.rs:392-417)."""
        icc_marker = b"ICC_PROFILE\0"
        max_chunk = 65535 - 2 - 12 - 2
        num_chunks = -(-len(data) // max_chunk)
        if num_chunks >= 255:
            raise errors.IccTooLarge(len(data))
        for i in range(num_chunks):
            chunk = data[i * max_chunk : (i + 1) * max_chunk]
            payload = icc_marker + bytes((i + 1, num_chunks)) + chunk
            self.add_app_segment(2, payload)

    def add_exif_metadata(self, data: bytes) -> None:
        """EXIF into APP1 (reference encoder.rs:426-435)."""
        self.add_app_segment(1, b"Exif\0\0" + bytes(data))

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------

    def _config(self) -> EncoderConfig:
        return EncoderConfig(
            quality=self.quality,
            sampling_factor=self._sampling_factor,
            quantization=self._quantization,
            progressive_scans=self._progressive_scans,
            restart_interval=self._restart_interval,
            optimize_huffman_table=self._optimize_huffman_table,
            density=self._density,
        )

    def _plan(self, width: int, height: int, color_type: ColorType,
              n: Optional[int] = None, stream: bool = False) -> Plan:
        """The call's plan on the encoder's settings
        (:func:`plan.make_plan`): ``encode``'s, ``encode_stream``'s with
        ``stream``, or ``encode_batch``'s for ``n`` images."""
        return make_plan(width, height, color_type, self._config(),
                         fused_p1=self.fused_p1, n=n, stream=stream)

    def encode(
        self,
        data: Union[bytes, np.ndarray],
        width: int,
        height: int,
        color_type: ColorType,
    ) -> bytes:
        """Encode raw interleaved pixel data (reference encoder.rs:440-503)."""
        with tracing.request("encode"):
            color_type = ColorType(color_type)
            pixels = _validate_pixels(data, width, height, color_type)
            return self._finish(self._encode_pixels(
                pixels, self._plan(width, height, color_type)))

    def encode_image(self, image: ImageBuffer) -> bytes:
        """Encode a user-supplied :class:`ImageBuffer`
        (reference encoder.rs:506-515)."""
        with tracing.request("encode_image"):
            width, height = image.width(), image.height()
            _check_dims(width, height)
            jct = image.get_jpeg_color_type()
            ct_in = getattr(image, "color_type", lambda: None)()
            if ct_in is not None:
                # Converting buffer (reference image_buffer.rs:135-204).
                ct_in = ColorType(ct_in)
                if ct_in.jpeg_color_type is not jct:
                    raise ValueError(
                        f"ImageBuffer.color_type() {ct_in} encodes as "
                        f"{ct_in.jpeg_color_type}, but get_jpeg_color_type() "
                        f"returned {jct}"
                    )
                stacked = np.stack(
                    [np.asarray(p, dtype=np.uint8) for p in image.to_planes()],
                    axis=-1,
                )
                if ct_in.bytes_per_pixel == 1:
                    stacked = stacked[..., 0]
                return self._finish(self._encode_pixels(
                    stacked, self._plan(width, height, ct_in)))
            # Planes already in JPEG colorspace: reuse the passthrough types.
            ct = {
                JpegColorType.LUMA: ColorType.LUMA,
                JpegColorType.YCBCR: ColorType.YCBCR,
                JpegColorType.CMYK: ColorType.CMYK,
                JpegColorType.YCCK: ColorType.YCCK,
            }[jct]
            stacked = np.stack(
                [np.asarray(p, dtype=np.uint8) for p in image.to_planes()],
                axis=-1,
            )
            if jct is JpegColorType.CMYK:
                # CMYK planes are already inverted; undo so the ingest
                # inversion (image_buffer.rs:250-255) round-trips.
                stacked = 255 - stacked
            if jct is JpegColorType.LUMA:
                stacked = stacked[..., 0]
            return self._finish(self._encode_pixels(
                stacked, self._plan(width, height, ct)))

    def encode_stream(
        self,
        data,
        width: int,
        height: int,
        color_type: ColorType,
        chunk_mcu_rows: int = 64,
    ):
        """Streaming encode (tpuenc/api.py:295-389): a generator of byte
        pieces whose concatenation is :meth:`encode`'s output, made and
        released as the encode goes (the reference's streaming sink,
        writer.rs:76-106, and MCU-row encode loop, encoder.rs:699-807).

        ``data`` is laid out as for :meth:`encode`, or is a pull source: a
        callable ``(y0, n) -> rows`` or an object with a ``get_rows(y0,
        n)`` method, returning ``n`` rows from row ``y0`` as bytes, an
        array, or a uint8 tensor already on the encoder's device
        (``entropy.chunked.read_rows``).

        The interleaved mode with default tables streams MCU-row bands of
        ``chunk_mcu_rows`` through the chunked path, with O(chunk) device
        memory, host memory and retained output: the prefix (leading
        segments, frame header, SOS), one piece per band that has final
        bytes, then EOI (``last_encode_path`` "device-chunked-stream").
        Every other mode materializes the coefficients by design: a pull
        source is drained once, and the file comes one scan per piece, the
        first carrying the prefix, then EOI; a plan of more than
        :data:`STREAM_MAX_SCANS` scans comes as one body piece.  The
        pieces go to the caller only, not to the encoder's sink.
        """
        return tracing.stream("encode_stream", self._encode_stream(
            data, width, height, color_type, chunk_mcu_rows))

    def _encode_stream(self, data, width, height, color_type, chunk_mcu_rows):
        color_type = ColorType(color_type)
        if callable(data) or hasattr(data, "get_rows"):
            _check_dims(width, height)
            source = data.get_rows if hasattr(data, "get_rows") else data
            pixels = None
        else:
            source = None
            pixels = _validate_pixels(data, width, height, color_type)
        plan = self._plan(width, height, color_type, stream=True)
        if plan.route != CHUNKED_STREAM:
            if pixels is None:  # multi-pass needs the whole image
                pixels = _validate_pixels(_drain_source(source, height),
                                          width, height, color_type)
            yield from self._stream_multipass(pixels, plan)
            return

        q_tables, huffman, params = self._default_tables(plan.config)
        ((_, _, spectral),) = plan.scans
        yield (self._head(plan, q_tables, huffman)
               + segments.sos(list(plan.components), spectral))

        self.last_encode_path = plan.route
        ladder = list(de.BUDGET_LADDER)
        for piece in iter_encode_interleaved_chunked(
                pixels if source is None else source, plan, params,
                chunk_mcu_rows, ladder):
            yield bytes(piece)
        self.last_budget = ladder[0]
        yield segments.marker(markers.EOI)

    def _stream_multipass(self, pixels, plan: Plan):
        """Per-scan streaming of the multi-pass modes (tpuenc/api.py:391-476):
        the coefficients are materialized by design (encoder.rs:810-864,
        869-975), but each scan goes to the caller as it is written:
        leading segments and frame header with the first scan, then each
        further scan's SOS and payload, then EOI."""
        if len(plan.scans) > STREAM_MAX_SCANS:
            yield self._encode_pixels(pixels, plan)
            return
        q_tables, huffman, params = self._default_tables(plan.config)
        scans = self._scan_payloads(pixels, plan, huffman, params)
        head = [self._head(plan, q_tables, huffman)]
        # Every piece is made before the first goes out: a payload may view
        # the encoder's reused buffer, which a call between pieces refills.
        pieces = []
        for (stream_idx, _, spectral), payload in zip(plan.scans, scans):
            pieces.append(b"".join(
                [*head, segments.sos([plan.components[stream_idx]], spectral),
                 *payload]))
            head = []
        yield from pieces
        yield segments.marker(markers.EOI)

    def encode_batch(
        self,
        images,
        width: int,
        height: int,
        color_type: ColorType,
    ) -> List[bytes]:
        """Encode a batch of same-shape images, each byte for byte what
        :meth:`encode` gives it: ``tpuenc``'s serving path
        (tpuenc/api.py:533-629).

        ``images``: an iterable of pixel buffers (bytes or arrays), each
        laid out as for :meth:`encode` and checked as it is.  The route
        is chosen up front from the batch's size, shape and settings
        (:func:`plan.make_plan`) and named in ``last_encode_path``:

        * ``"device-batch"``: interleaved, default tables, at most 3M
          blocks, a restart interval (if any) that divides each image's
          MCUs: ONE program over the whole batch.  It packs with K1 and
          K2 even when ``fused_p1`` is set, as in ``tpuenc``, where the
          fused kernel reaches only the per-image program, and finishes
          all of its images in one device finish.
        * ``"device-batch-per-image"``: any other batch (another mode,
          optimized tables, a larger batch, a restart interval that does
          not divide the MCUs), each image as :meth:`encode` runs it,
          through K8 where ``fused_p1`` reaches it there, and through the
          device finish.

        A failure inside a route raises; no route gives way to another.
        ``last_budget`` is the single program's rung, or the highest rung
        any image used.  Each file goes to the encoder's sink
        (``new_file`` / ``new_writer``) as :meth:`encode` sends it.
        """
        with tracing.request("encode_batch"):
            color_type = ColorType(color_type)
            pixel_arrays = [_validate_pixels(data, width, height, color_type)
                            for data in images]
            if not pixel_arrays:
                _check_dims(width, height)
                return []
            return self._encode_batch(pixel_arrays, self._plan(
                width, height, color_type, n=len(pixel_arrays)))

    def _encode_batch(self, pixel_arrays, plan: Plan) -> List[bytes]:
        """The validated images' files on ``plan``'s route."""
        if plan.route == PER_IMAGE:
            image = plan._replace(route=plan.image_route)
            results, rungs = [], []
            for px in pixel_arrays:
                results.append(self._finish(self._encode_pixels(px, image)))
                rungs.append(self.last_budget)
            self.last_encode_path, self.last_budget = plan.route, max(rungs)
            return results

        q_tables, huffman, params = self._default_tables(plan.config)
        batch_scans, budget = de.device_encode_batch_single(
            pixel_arrays, plan, params, self._pinned_buffer())
        self.last_encode_path, self.last_budget = plan.route, budget
        head = self._head(plan, q_tables, huffman)
        return [self._finish(self._assemble_scans(
            plan, head, [[scan] for scan in scans])) for scans in batch_scans]

    def _finish(self, payload: bytes) -> bytes:
        try:
            if self._path is not None:
                with open(self._path, "wb") as f:
                    f.write(payload)
            if self._writer is not None:
                self._writer.write(payload)
        except OSError as e:
            raise errors.WriteError(str(e)) from e
        return payload

    def _pinned_buffer(self):
        """The encoder's page-locked buffer on a CUDA device, else None."""
        if self.device.type == "cuda" and self._pinned is None:
            self._pinned = de.PinnedBuffer()
        return self._pinned

    def _pinned_pieces(self):
        """The encoder's page-locked memory for a chunked call's pieces on
        a CUDA device, emptied for the call, else None."""
        if self.device.type != "cuda":
            return None
        if self._pieces is None:
            self._pieces = PinnedPieces()
        self._pieces.reset()
        return self._pieces

    def _head(self, plan: Plan, q_tables, huffman) -> bytes:
        """Everything before the first SOS: SOI, JFIF APP0, (Adobe APP14),
        the user APP segments (reference encoder.rs:536-554), then the
        frame header: SOF, DQTs, DHTs and the optional DRI
        (encoder.rs:633-667)."""
        config, components = plan.config, plan.components
        jct = plan.color_type.jpeg_color_type
        out = bytearray()
        out += segments.marker(markers.SOI)
        out += segments.app0_jfif(config.density)
        if jct is JpegColorType.CMYK:
            out += segments.app14_adobe(0)
        elif jct is JpegColorType.YCCK:
            out += segments.app14_adobe(2)
        for nr, data in self._app_segments:
            out += segments.segment(markers.APP(nr), data)
        out += segments.sof(plan.width, plan.height, components,
                            config.progressive_scans is not None)
        out += segments.dqt(0, q_tables[0])
        out += segments.dqt(1, q_tables[1])
        out += segments.dht(0, 0, huffman[0][0])
        out += segments.dht(1, 0, huffman[0][1])
        if len(components) >= 3:
            out += segments.dht(0, 1, huffman[1][0])
            out += segments.dht(1, 1, huffman[1][1])
        if config.restart_interval is not None:
            out += segments.dri(config.restart_interval)
        return bytes(out)

    def _default_tables(self, config):
        """The (luma, chroma) quantization tables, the default Huffman
        tables and the encode parameters with both on ``self.device``
        (the quantizers cached by (quantization, quality))."""
        with tracing.span("plan"):
            q_tables = [
                quantization_table(config.quantization[0], config.quality,
                                   luma=True),
                quantization_table(config.quantization[1], config.quality,
                                   luma=False),
            ]
            key = (config.quantization, config.quality)
            if key not in self._quant:
                self._quant[key] = de.quant_params(q_tables, self.device)
            if self._default_huffman is None:
                self._default_huffman = de.huffman_params(
                    [list(pair) for pair in default_tables()], self.device)
            return (q_tables, [list(pair) for pair in default_tables()],
                    de.EncodeParams(*self._quant[key], *self._default_huffman))

    def _encode_pixels(self, pixels: np.ndarray, plan: Plan) -> bytes:
        """One image's file on ``plan``'s route."""
        q_tables, huffman, params = self._default_tables(plan.config)
        scans = self._scan_payloads(pixels, plan, huffman, params)
        return self._assemble_scans(plan, self._head(plan, q_tables, huffman),
                                    scans)

    def _scan_payloads(self, pixels, plan: Plan, huffman,
                       params) -> List[list]:
        """Every scan's entropy payload in plan order, on ``plan``'s route,
        which goes to ``last_encode_path`` with the budget rung to
        ``last_budget``: each the list of bytes-like parts that joined make
        it, as the route's finish left them (one view of the device
        finish's output, or the streaming stuffer's pieces, views valid
        until the encoder's next encode).  ``huffman`` is replaced in place by
        the optimized tables when the config asks for them."""
        config = plan.config
        if plan.route in (CHUNKED, CHUNKED_MULTIPASS):
            ladder = list(de.BUDGET_LADDER)
            pinned = self._pinned_pieces()
            if plan.route == CHUNKED:
                scans = [list(iter_encode_interleaved_chunked(
                    pixels, plan, params, ladder=ladder, pinned=pinned))]
            else:
                scans = encode_multipass_chunked(pixels, plan, huffman,
                                                 params, ladder=ladder,
                                                 pinned=pinned)
            self.last_encode_path, self.last_budget = plan.route, ladder[0]
            return scans

        with tracing.span("upload"):
            px = upload.to_device(pixels, self.device)
        pinned = self._pinned_buffer()
        if config.optimize_huffman_table:
            # Two passes (tpuenc/api.py:776-825): coefficients and
            # histograms on the device, one small copy of the counts, the
            # K.2 build per table on the host, and the same device streams
            # packed with the new tables, the ladder starting at the rung
            # that the exact stream size covers.
            streams = fn_cm(px, plan.width, plan.height, plan.color_type,
                            config, params.reciprocals, params.corrections)
            hists = scan_histograms(streams, plan.components,
                                    config.progressive_scans)
            with tracing.span("sync.hist"):
                hists = hists.cpu().numpy()
            hint = optimize_tables(hists, huffman, plan)
            dc, ac = de.huffman_params(huffman, self.device)
            params = params._replace(dc=dc, ac=ac)
            scans, budget = de.device_encode_scans(
                px, plan, params, comp_streams=streams, budget_hint=hint,
                pinned=pinned)
        else:
            scans, budget = de.device_encode_scans(px, plan, params,
                                                   pinned=pinned)
        self.last_encode_path, self.last_budget = plan.route, budget
        return [[scan] for scan in scans]

    def _assemble_scans(self, plan: Plan, head, scan_payloads) -> bytes:
        """The whole file, gathered in one copy: ``head`` (everything
        before the first SOS, :meth:`_head`), then per scan of ``plan`` its
        SOS and the parts of its payload (``scan_payloads``: each scan's
        list of bytes-like parts), then EOI."""
        with tracing.span("assemble"):
            parts = [head]
            components = plan.components
            interleaved = plan.layout["interleaved"]
            for (stream_idx, _, spectral), payload in zip(plan.scans,
                                                           scan_payloads):
                sos_comps = (list(components) if interleaved
                             else [components[stream_idx]])
                parts.append(segments.sos(sos_comps, spectral))
                parts += payload
            parts.append(segments.marker(markers.EOI))
            out = b"".join(parts)
            tracing.count("assembled_bytes", len(out))
            return out


def optimize_tables(hists, huffman, plan: Plan) -> int:
    """The host half of the two-pass mode: replace ``huffman``'s leading
    (dc, ac) pairs in place with the K.2 tables built from ``hists`` (the
    (T, 2, 257) device counts, the reserved symbol not yet seeded) and
    return the ladder's budget hint from the exact stream size and
    ``plan``'s pack rows."""
    with tracing.span("tables"):
        pairs = [(h[0], h[1]) for h in np.asarray(hists, dtype=np.int64)]
        for i, tables in enumerate(tables_from_histograms(pairs)):
            huffman[i] = list(tables)
        return budget_hint_from_bits(
            exact_stream_bits(pairs, huffman[:len(pairs)]), plan.pack_rows)


def _drain_source(source, height: int):
    """The whole image from a pull source, in one request
    (tpuenc/api.py:478-482)."""
    rows = source(0, height)
    if isinstance(rows, torch.Tensor):
        with tracing.span("sync.rows"):
            return rows.cpu().numpy()
    if isinstance(rows, (bytes, bytearray, memoryview)):
        return np.frombuffer(rows, np.uint8)
    return np.asarray(rows, dtype=np.uint8)


def _freeze_qspec(spec):
    if isinstance(spec, str):
        return spec
    return tuple(int(v) for v in spec)
