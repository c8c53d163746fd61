"""The striped encode's compile-and-run check on a mesh of ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:28``),
which builds an n-device ("batch", "stripe") mesh and runs the sharded
step on tiny shapes.  :func:`dryrun_multichip` runs on every rank of an
initialized process group (``testing.dist.launch``) with the same asserts:
a (2, n/2) mesh (or (1, n) for fewer than 4 or an odd number of ranks);
the stripe step with histograms, every image's DC counts non-zero; then,
each file byte for byte the port's single-device ``Encoder``'s, the
general route with optimized tables, with restart interval 1 (``tpuenc``
runs its v1 route there, which the port leaves out: the general route
gives the same bytes), and progressive with 3 scans.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..api import Encoder
from ..core.types import ColorType, EncoderConfig, SamplingFactor
from .encode import ShardedEncoder
from .mesh import make_mesh, stripe_counts
from .stripes import stripe_encode_step


def dryrun_multichip(device) -> dict:
    """Run the checks on this rank's ``device``, over a gloo mesh (the
    collectives on the host); returns what was checked."""
    world = dist.get_world_size()
    batch_axis = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh("cpu", batch=batch_axis)
    n_stripes = stripe_counts(mesh)[1]

    # Tiny image: one MCU row per stripe at 2x2 sampling.
    w, h = 32, 16 * n_stripes
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(batch_axis)]
    config = EncoderConfig(quality=80, sampling_factor=SamplingFactor.F_2_2,
                           optimize_huffman_table=True)
    enc = Encoder(80, device=device)
    _, _, params = enc._default_tables(config)
    b = mesh.get_local_rank("batch")
    _, hists = stripe_encode_step(imgs[b:b + 1], w, h, ColorType.RGB, config,
                                  mesh, params, with_histograms=True)
    if not (hists[:, :, 0].sum(-1) > 0).all():
        raise AssertionError("an empty DC histogram")

    def check(quality, setup):
        senc = ShardedEncoder(quality, mesh, device=device)
        ref = Encoder(quality, device=device)
        for e in (senc, ref):
            e.set_sampling_factor(SamplingFactor.F_2_2)
            setup(e)
        outs = senc.encode_batch(imgs, w, h, ColorType.RGB)
        if senc.last_encode_path != "sharded-general":
            raise AssertionError(f"ran on {senc.last_encode_path}")
        for img, out in zip(imgs, outs):
            if out != ref.encode(img, w, h, ColorType.RGB):
                raise AssertionError("sharded output differs from the "
                                     "single-device encoder")
        return [len(o) for o in outs]

    return {
        "mesh": [batch_axis, n_stripes],
        "optimized": check(80, lambda e: e.set_optimized_huffman_tables(True)),
        "restart1": check(80, lambda e: e.set_restart_interval(1)),
        "progressive3": check(75, lambda e: e.set_progressive_scans(3)),
    }
