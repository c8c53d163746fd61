"""Cases of the striped encode, run on every rank of a process group.

The CPU tests (``tests/test_torch_shard.py``) describe each case as plain
data, launch :func:`run_cases` on the ranks (``testing.dist.launch``) and
hold each rank's results against ``tpuenc`` and the single-device
``Encoder``.  The runner lives here, in a package that imports no JAX,
because each rank imports it afresh.

A case is a dict: ``name``; ``kind`` (below); ``quality``; ``settings``,
a list of ``(setter name, argument)`` applied to the encoder, where a
string argument names a ``SamplingFactor``; ``w``, ``h``; ``color_type``
(a ``ColorType`` name); ``seeds``, one image per seed
(:func:`case_images`).  Kinds:

* ``"encode"``: the encoder's ``method`` (``"encode_batch"`` unless the
  case names another: ``"encode"`` of the first image, or one of the
  striped methods ``tpuenc`` names) on the images: the files (None where
  the method declines, ``"ValueError: ..."`` where it raises), the route,
  the rung and this rank's kernel launches over the call (every
  wrapper's count, set to 0 just before it);
* ``"entry"``: ``encode_image`` of the first image's channels as YCbCr
  planes (:func:`planes_buffer`) and ``encode_stream`` of it, each with
  the route it took;
* ``"step"``: the coefficient step with histograms
  (``shard.stripes.stripe_encode_step``): every stripe's streams,
  gathered (``shard.encode.gather``), and the reduced histograms;
* ``"pack"``: this rank's general pack of its image at ``budget``: each
  scan's bits, block lengths and words;
* ``"route"``: for ``n`` images, the route of ``encode_batch``'s plan
  (``ShardedEncoder._plan``), ``ShardedEncoder.route`` or the
  ``ValueError`` it raises, and for ``n`` 0 ``encode_batch([])``;
* ``"dryrun"``: ``shard.dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import ImageBuffer
from ..core.types import ColorType, JpegColorType, SamplingFactor
from ..shard.dryrun import dryrun_multichip
from ..shard.encode import ShardedEncoder, gather
from ..shard.mesh import make_mesh
from ..shard.stripes import general_pack, stripe_encode_step
from ..tracing import kernel_wrappers


def case_images(case):
    """The case's images: ``default_rng(seed)`` uint8 pixels, (h, w) for
    LUMA, else (h, w, channels)."""
    ct = ColorType[case["color_type"]]
    bpp = ct.bytes_per_pixel
    shape = (case["h"], case["w"]) + (() if bpp == 1 else (bpp,))
    return [np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
            for seed in case["seeds"]]


def apply_settings(encoder, settings, sampling_factor=SamplingFactor):
    """Call each ``(setter, argument)`` of ``settings`` on ``encoder``; a
    string argument is a member of ``sampling_factor``."""
    for name, arg in settings:
        if isinstance(arg, str):
            arg = getattr(sampling_factor, arg)
        getattr(encoder, name)(arg)


def planes_buffer(image, image_buffer=ImageBuffer,
                  jpeg_color_type=JpegColorType.YCBCR, color_type=None):
    """An ``image_buffer`` (the port's ``ImageBuffer`` or ``tpuenc``'s)
    whose planes are the channels of the (h, w, c) ``image``: already in
    ``jpeg_color_type``, or in the input ``color_type`` where one is given
    (a converting buffer, which ``encode_image`` converts as ``encode``
    converts that color type)."""

    class Planes(image_buffer):
        def get_jpeg_color_type(self):
            return jpeg_color_type

        def color_type(self):
            return color_type

        def width(self):
            return image.shape[1]

        def height(self):
            return image.shape[0]

        def to_planes(self):
            return tuple(image[..., c] for c in range(image.shape[2]))

    return Planes()


def _refused(call):
    """``call()``, or the ``ValueError`` it raises as a string."""
    try:
        return call()
    except ValueError as e:
        return f"ValueError: {e}"


def _run(case, mesh, device):
    kind = case["kind"]
    if kind == "dryrun":
        return dryrun_multichip(device)
    ct = ColorType[case["color_type"]]
    w, h = case["w"], case["h"]
    enc = ShardedEncoder(case["quality"], mesh, device=device)
    apply_settings(enc, case["settings"])
    if kind == "route":
        n = case["n"]
        return (enc._plan(w, h, ct, n=n).route,
                _refused(lambda: enc.route(n, w, h, ct)),
                enc.encode_batch([], w, h, ct) if n == 0 else None)
    images = case_images(case)
    if kind == "entry":
        image = images[0]
        coded = enc.encode_image(planes_buffer(image))
        out = {"encode_image": (coded, enc.last_encode_path)}
        stream = b"".join(enc.encode_stream(image, w, h, ct))
        out["encode_stream"] = (stream, enc.last_encode_path)
        return out
    if kind == "encode":
        method = case.get("method", "encode_batch")

        def call():
            if method == "encode":
                return [enc.encode(images[0], w, h, ct)]
            return getattr(enc, method)(images, w, h, ct)

        for fn in kernel_wrappers():
            fn.launches = 0
        files = _refused(call)
        launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
        return files, enc.last_encode_path, enc.last_budget, launches
    config = enc._config()
    _, _, params = enc._default_tables(config)
    n_b = mesh.size(0)
    per = len(images) // n_b
    b = mesh.get_local_rank("batch")
    stripe, hists = stripe_encode_step(
        images[b * per:(b + 1) * per], w, h, ct, config, mesh, params,
        with_histograms=kind == "step")
    if kind == "step":
        return gather(stripe.streams, mesh), hists, stripe.n_local
    if kind == "pack":
        scans = general_pack(stripe, 0, enc._plan(w, h, ct).scans, params.dc,
                             params.ac, case["budget"])
        return [(int(s.bits), s.lens.cpu().numpy(),
                 s.stream[:(int(s.bits) + 31) >> 5].cpu().numpy())
                for s in scans]
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(batch: int, cases, device, mesh_device: str = "cpu") -> dict:
    """Every case on this rank over a (batch, world // batch) mesh whose
    collectives run on ``mesh_device`` ("cpu": gloo, "cuda": NCCL), in
    order (every rank runs the same list), computed on ``device``:
    {name: result}."""
    mesh = make_mesh(mesh_device, batch)
    with torch.no_grad():
        return {case["name"]: _run(case, mesh, device) for case in cases}


def fail_on_rank(rank: int) -> int:
    """Raise on ``rank``; the other ranks wait in a collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()
