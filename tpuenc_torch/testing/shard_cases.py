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

* ``"encode"``: ``ShardedEncoder.encode_batch`` of the images: the files,
  the route, the rung and this rank's kernel launches over the encode
  (every wrapper's count, set to 0 just before it);
* ``"step"``: the coefficient step with histograms
  (``shard.stripes.stripe_encode_step``): every stripe's streams,
  gathered (``shard.encode.gather``), and the reduced histograms;
* ``"pack"``: this rank's general pack of its image at ``budget``: each
  scan's bits, block lengths and words;
* ``"route"``: ``ShardedEncoder.route`` for ``n`` images, or the
  ``ValueError`` it raises;
* ``"dryrun"``: ``shard.dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import ColorType, SamplingFactor
from ..entropy import device_encode as de
from ..kernels.pipeline import scan_layout
from ..shard.dryrun import dryrun_multichip
from ..shard.encode import ShardedEncoder, gather
from ..shard.mesh import make_mesh
from ..shard.stripes import general_pack, stripe_encode_step


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


def kernel_wrappers():
    """Every kernel wrapper, with its launch counter (K1-K9)."""
    from ..entropy import pallas_hist as ph
    from ..entropy import pallas_pack as pk
    from ..kernels import pallas_fdct

    return [pallas_fdct.fdct_quantize, pk.pack_blocks, pk.merge_chunks,
            pk.fold_rows, pk.concat_rows, pk.pack_acbands, ph.hist_count,
            pk.fused_sample_pack, ph.hist_sym]


def _run(case, mesh, device):
    kind = case["kind"]
    if kind == "dryrun":
        return dryrun_multichip(device)
    ct = ColorType[case["color_type"]]
    w, h = case["w"], case["h"]
    enc = ShardedEncoder(case["quality"], mesh, device=device)
    apply_settings(enc, case["settings"])
    if kind == "route":
        try:
            return enc.route(case["n"], w, h, ct)
        except ValueError as e:
            return f"ValueError: {e}"
    images = case_images(case)
    if kind == "encode":
        for fn in kernel_wrappers():
            fn.launches = 0
        files = enc.encode_batch(images, w, h, ct)
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
        layout = scan_layout(w, h, ct, config)
        plan = de.build_scan_plan(layout, layout["components"], config)
        scans = general_pack(stripe, 0, plan, params.dc, params.ac,
                             case["budget"])
        return [(int(s.bits), s.lens.cpu().numpy(),
                 s.stream[:(int(s.bits) + 31) >> 5].cpu().numpy())
                for s in scans]
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(batch: int, cases, device) -> dict:
    """Every case on this rank over a (batch, world // batch) gloo mesh,
    in order (every rank runs the same list), computed on ``device``:
    {name: result}."""
    mesh = make_mesh("cpu", batch)
    with torch.no_grad():
        return {case["name"]: _run(case, mesh, device) for case in cases}


def fail_on_rank(rank: int) -> int:
    """Raise on ``rank``; the other ranks wait in a collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()
