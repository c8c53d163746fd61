"""The plan of one encode call: its route and its scan plan, decided once.

Each entry point of ``api.Encoder`` makes one :class:`Plan` for its call
(:func:`make_plan`) and hands it down.  The route modules
(``entropy.device_encode``, ``entropy.chunked``,
``entropy.chunked_multipass``, ``shard.encode``) and the file's assembly
read the layout, the scan plan and the route from it and derive none of
them again.  The rules are ``tpuenc``'s (tpuenc/api.py:60-91, 700-750;
tpuenc/entropy/device_encode.py:775-777, 833-838).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from . import tracing
from .core.types import ColorType, EncoderConfig
from .entropy.device_encode import build_scan_plan, seg_structure
from .kernels.pipeline import scan_layout

# Routing limits of the whole-image device path (tpuenc/api.py:60-68):
# past either, an image goes through the bounded-memory chunked paths.
DEVICE_BLOCK_LIMIT = 3_000_000
DEVICE_PACK_ROWS_LIMIT = 12_000_000
# The single program packs at most this many blocks, counted as
# n * (w // 8 + 1) * (h // 8 + 1) (tpuenc/entropy/device_encode.py:836).
BATCH_BLOCK_LIMIT = 3_000_000

# The routes, as ``Encoder.last_encode_path`` names them.
V2 = "device-v2"
V2_FUSED = "device-v2-fused"
CHUNKED = "device-chunked"
CHUNKED_MULTIPASS = "device-chunked-multipass"
CHUNKED_STREAM = "device-chunked-stream"
SINGLE_PROGRAM = "device-batch"
PER_IMAGE = "device-batch-per-image"


class Plan(NamedTuple):
    """What one call encodes and how: the image's size, color type and
    settings, the number ``n`` of images of a batch (None for one image),
    its scan layout (``kernels.pipeline.scan_layout``'s dict) and
    components, its scans (``build_scan_plan``'s (stream index, ScanSpec,
    spectral) in plan order), each scan's number of restart segments, the
    call's ``route`` and ``image_route``, the route ``encode`` takes for one
    image of this shape (a per-image batch's images take it)."""

    width: int
    height: int
    color_type: ColorType
    config: EncoderConfig
    n: Optional[int]
    layout: dict
    components: tuple
    scans: tuple
    seg_structure: tuple
    route: str
    image_route: str

    @property
    def pack_rows(self) -> int:
        """Pack rows of the encode's shared P2-P4 merge: one per block per
        scan (tpuenc/api.py:71-83)."""
        layout = self.layout
        if layout["interleaved"]:
            return len(layout["mcu_block_comps"]) * layout["mcu_count"]
        return (sum(layout["comp_block_counts"])
                * (self.config.progressive_scans or 1))


def make_plan(width: int, height: int, color_type: ColorType,
              config: EncoderConfig, *, fused_p1: bool = False,
              n: Optional[int] = None, stream: bool = False) -> Plan:
    """The plan of ``encode`` for one image, of ``encode_stream`` with
    ``stream``, or of ``encode_batch`` for ``n`` images.

    ``encode``: past the whole-image limits the interleaved mode takes
    :data:`CHUNKED` (even under ``fused_p1``: there is no fused chunked
    path) and every other mode :data:`CHUNKED_MULTIPASS`; within them the
    interleaved mode under ``fused_p1`` takes :data:`V2_FUSED`, anything
    else :data:`V2`.  ``encode_stream``: the interleaved mode streams on
    :data:`CHUNKED_STREAM`, other modes take ``encode``'s route.
    ``encode_batch``: :data:`SINGLE_PROGRAM` for interleaved images (so
    with default tables) within the whole-image limits, at most
    :data:`BATCH_BLOCK_LIMIT` blocks in the batch, whose restart interval,
    if any, divides each image's MCUs; :data:`PER_IMAGE` for any other
    batch, each image on ``encode``'s route."""
    color_type = ColorType(color_type)
    with tracing.span("plan"):
        layout = scan_layout(width, height, color_type, config)
        scans = tuple(build_scan_plan(layout, layout["components"], config))
        plan = Plan(width, height, color_type, config, n, layout,
                    layout["components"], scans,
                    tuple(seg_structure(layout, scans)), V2, V2)
        interleaved = layout["interleaved"]
        blocks = (width // 8 + 1) * (height // 8 + 1)
        over = (blocks > DEVICE_BLOCK_LIMIT
                or plan.pack_rows > DEVICE_PACK_ROWS_LIMIT)
        if over:
            image = CHUNKED if interleaved else CHUNKED_MULTIPASS
        else:
            image = V2_FUSED if fused_p1 and interleaved else V2
        route = image
        if stream and interleaved:
            route = CHUNKED_STREAM
        elif n is not None:
            interval = config.restart_interval
            single = (not over and interleaved
                      and n * blocks <= BATCH_BLOCK_LIMIT
                      # a restart segment must not cross an image boundary
                      and not (interval and layout["mcu_count"] % interval))
            route = SINGLE_PROGRAM if single else PER_IMAGE
        return plan._replace(route=route, image_route=image)
