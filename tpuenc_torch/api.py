"""Public encoder API.

Counterpart of ``tpuenc/api.py``: an ``Encoder`` with the reference's
surface (``encoder.rs:212-567``: quality 1-100 with 4:2:0 below 90, every
setter, APP/ICC/EXIF metadata, ``encode`` / ``encode_image`` /
``new_file`` / ``new_writer``), running on an explicit PyTorch device.
On a CUDA device the coefficient stage and the entropy packer run as the
port's CUDA kernels; on the CPU the same path runs their plain PyTorch
versions.  Either way the bytes are the same.

It encodes every mode of the whole-image path: interleaved, sequential
and progressive (2-64 scans), with default or two-pass optimized Huffman
tables, every color type and sampling factor, restart intervals and
metadata.  ``encode_batch`` and ``encode_stream``, and images past the
whole-image limits, raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core import errors
from .core.tables import QuantizationTable, default_tables, quantization_table
from .core.types import (
    ColorType,
    Component,
    EncoderConfig,
    JpegColorType,
    PixelDensity,
    SamplingFactor,
    init_components,
)
from .entropy import device_encode as de
from .entropy.device import scan_histograms
from .entropy.huffopt import (
    budget_hint_from_bits,
    exact_stream_bits,
    tables_from_histograms,
)
from .jfif import markers, segments
from .kernels.pipeline import fn_cm, scan_layout

__all__ = ["Encoder", "ImageBuffer"]

# Routing limits of the whole-image device path (tpuenc/api.py:60-68).
# Larger images need the bounded-memory chunked paths (ROADMAP M9).
DEVICE_BLOCK_LIMIT = 3_000_000
DEVICE_PACK_ROWS_LIMIT = 12_000_000


def _plan_pack_rows(width, height, color_type, config) -> int:
    """Pack rows of the encode's shared P2-P4 merge: one per block per
    scan (tpuenc/api.py:71-83)."""
    layout = scan_layout(width, height, color_type, config)
    if layout["interleaved"]:
        return len(layout["mcu_block_comps"]) * layout["mcu_count"]
    scans_per_comp = config.progressive_scans or 1  # 1 DC + (n-1) AC bands
    return sum(layout["comp_block_counts"]) * scans_per_comp


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
    """

    def __init__(self, quality: int, *, device, _path: Optional[str] = None,
                 _writer=None):
        self.quality = int(quality)
        self.device = torch.device(device)
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
        # Which path produced the last encode() output ("device-v2", the
        # counterpart of tpuenc's v2 device packer), and the budget rung
        # (words per block) its packer used.
        self.last_encode_path: Optional[str] = None
        self.last_budget: Optional[int] = None

    @classmethod
    def new_file(cls, path, quality: int, *, device) -> "Encoder":
        """Encoder writing to a file (reference encoder.rs:1203-1220)."""
        return cls(quality, device=device, _path=str(path))

    @classmethod
    def new_writer(cls, writer, quality: int, *, device) -> "Encoder":
        """Encoder writing into any object with a ``write(bytes)`` method
        (reference writer.rs:76-106)."""
        return cls(quality, device=device, _writer=writer)

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

    def encode(
        self,
        data: Union[bytes, np.ndarray],
        width: int,
        height: int,
        color_type: ColorType,
    ) -> bytes:
        """Encode raw interleaved pixel data (reference encoder.rs:440-503)."""
        color_type = ColorType(color_type)
        pixels = _validate_pixels(data, width, height, color_type)
        return self._finish(self._encode_pixels(pixels, width, height, color_type))

    def encode_image(self, image: ImageBuffer) -> bytes:
        """Encode a user-supplied :class:`ImageBuffer`
        (reference encoder.rs:506-515)."""
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
            return self._finish(
                self._encode_pixels(stacked, width, height, ct_in)
            )
        # Planes already in JPEG colorspace: reuse the passthrough types.
        ct = {
            JpegColorType.LUMA: ColorType.LUMA,
            JpegColorType.YCBCR: ColorType.YCBCR,
            JpegColorType.CMYK: ColorType.CMYK,
            JpegColorType.YCCK: ColorType.YCCK,
        }[jct]
        stacked = np.stack(
            [np.asarray(p, dtype=np.uint8) for p in image.to_planes()], axis=-1
        )
        if jct is JpegColorType.CMYK:
            # CMYK planes are already inverted; undo so the ingest
            # inversion (image_buffer.rs:250-255) round-trips.
            stacked = 255 - stacked
        if jct is JpegColorType.LUMA:
            stacked = stacked[..., 0]
        return self._finish(self._encode_pixels(stacked, width, height, ct))

    def encode_stream(self, *args, **kwargs):
        raise NotImplementedError(
            "encode_stream (bounded-memory streaming) is not ported yet: "
            "ROADMAP M9"
        )

    def encode_batch(self, *args, **kwargs):
        raise NotImplementedError("encode_batch is not ported yet: ROADMAP M8")

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

    def _leading_segments(self, config, jct) -> bytearray:
        """SOI + JFIF APP0 + (Adobe APP14) + user APP segments — everything
        before the frame header (reference encoder.rs:536-554)."""
        out = bytearray()
        out += segments.marker(markers.SOI)
        out += segments.app0_jfif(config.density)
        if jct is JpegColorType.CMYK:
            out += segments.app14_adobe(0)
        elif jct is JpegColorType.YCCK:
            out += segments.app14_adobe(2)
        for nr, data in self._app_segments:
            out += segments.segment(markers.APP(nr), data)
        return out

    def _check_supported(self, config, width, height, color_type) -> None:
        if (
            (width // 8 + 1) * (height // 8 + 1) > DEVICE_BLOCK_LIMIT
            or _plan_pack_rows(width, height, color_type, config)
            > DEVICE_PACK_ROWS_LIMIT
        ):
            raise NotImplementedError(
                "images over the whole-image device limits need the chunked "
                "paths, not ported yet: ROADMAP M9"
            )

    def _quant_params(self, config, q_tables):
        key = (config.quantization, config.quality)
        if key not in self._quant:
            self._quant[key] = de.quant_params(q_tables, self.device)
        return self._quant[key]

    def _encode_pixels(
        self, pixels: np.ndarray, width: int, height: int, color_type: ColorType
    ) -> bytes:
        config = self._config()
        self._check_supported(config, width, height, color_type)
        jct = color_type.jpeg_color_type
        components = init_components(jct, config.sampling_factor)
        q_tables = [
            quantization_table(config.quantization[0], config.quality, luma=True),
            quantization_table(config.quantization[1], config.quality, luma=False),
        ]
        recip, corr = self._quant_params(config, q_tables)
        huffman = [list(pair) for pair in default_tables()]

        if not pixels.flags.writeable:
            pixels = pixels.copy()
        px = torch.from_numpy(np.ascontiguousarray(pixels)).to(self.device)
        if config.optimize_huffman_table:
            # Two passes (tpuenc/api.py:776-825): coefficients and
            # histograms on the device, one small copy of the counts, the
            # K.2 build per table on the host, and the same device streams
            # packed with the new tables, the ladder starting at the rung
            # that the exact stream size covers.
            streams = fn_cm(px, width, height, color_type, config, recip, corr)
            hists = scan_histograms(streams, components,
                                    config.progressive_scans).cpu().numpy()
            hint = optimize_tables(hists, huffman, width, height, color_type,
                                   config)
            dc, ac = de.huffman_params(huffman, self.device)
            params = de.EncodeParams(recip, corr, dc, ac)
            scans, budget = de.device_encode_scans(
                px, width, height, color_type, config, params,
                comp_streams=streams, budget_hint=hint,
            )
        else:
            if self._default_huffman is None:
                self._default_huffman = de.huffman_params(huffman, self.device)
            params = de.EncodeParams(recip, corr, *self._default_huffman)
            scans, budget = de.device_encode_scans(
                px, width, height, color_type, config, params
            )
        self.last_encode_path = "device-v2"
        self.last_budget = budget

        out = self._leading_segments(config, jct)
        out += self._assemble_scans(
            scans, width, height, color_type, config, components, q_tables,
            huffman,
        )
        out += segments.marker(markers.EOI)
        return bytes(out)

    def _assemble_scans(
        self, scan_payloads, width, height, color_type, config, components,
        q_tables, huffman,
    ) -> bytes:
        """Frame header + per-scan SOS + entropy payloads, following the
        scan plan shared with the device path."""
        layout = scan_layout(width, height, color_type, config)
        plan = de.build_scan_plan(layout, components, config)
        out = bytearray()
        out += self._frame_header(
            width, height, components, q_tables, huffman, config,
            len(components),
        )
        interleaved = layout["interleaved"]
        for (stream_idx, spec, spectral), payload in zip(plan, scan_payloads):
            sos_comps = (
                list(components) if interleaved else [components[stream_idx]]
            )
            out += segments.sos(sos_comps, spectral)
            out += payload
        return bytes(out)

    def _frame_header(
        self,
        width: int,
        height: int,
        components: Sequence[Component],
        q_tables: Sequence[QuantizationTable],
        huffman,
        config: EncoderConfig,
        num_components: int,
    ) -> bytes:
        """SOF + DQTs + DHTs + optional DRI (reference encoder.rs:633-667)."""
        out = bytearray()
        out += segments.sof(
            width, height, components, config.progressive_scans is not None
        )
        out += segments.dqt(0, q_tables[0])
        out += segments.dqt(1, q_tables[1])
        out += segments.dht(0, 0, huffman[0][0])
        out += segments.dht(1, 0, huffman[0][1])
        if num_components >= 3:
            out += segments.dht(0, 1, huffman[1][0])
            out += segments.dht(1, 1, huffman[1][1])
        if config.restart_interval is not None:
            out += segments.dri(config.restart_interval)
        return bytes(out)


def optimize_tables(hists, huffman, width, height, color_type, config) -> int:
    """The host half of the two-pass mode: replace ``huffman``'s leading
    (dc, ac) pairs in place with the K.2 tables built from ``hists`` (the
    (T, 2, 257) device counts, the reserved symbol not yet seeded) and
    return the ladder's budget hint from the exact stream size."""
    pairs = [(h[0], h[1]) for h in np.asarray(hists, dtype=np.int64)]
    for i, tables in enumerate(tables_from_histograms(pairs)):
        huffman[i] = list(tables)
    return budget_hint_from_bits(
        exact_stream_bits(pairs, huffman[:len(pairs)]),
        _plan_pack_rows(width, height, color_type, config),
    )


def _freeze_qspec(spec):
    if isinstance(spec, str):
        return spec
    return tuple(int(v) for v in spec)
