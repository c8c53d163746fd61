"""The (batch, stripe) device mesh on ``torch.distributed``.

Counterpart of ``tpuenc/shard/mesh.py``.  The encode has two parallel
axes:

* ``batch``: data parallelism over images;
* ``stripe``: contiguous MCU-row stripes of one image, one per rank.

Every rank runs the same program (SPMD), one process per rank, joined in
the default process group that the caller initializes
(``init_process_group`` with its address, world size and rank;
``testing.dist.launch`` does it for tests and ``chip_smoke.py``).  Only
the Huffman histograms (``all_reduce`` over the stripe group), the DC
tails of the stripes (``all_gather`` over the stripe group), the budget
rung's overflow flags (``all_reduce`` over the world) and the packed
bytes (``encode.gather``) cross between ranks.

The mesh's device type is where the collectives run: ``"cpu"`` for gloo,
whose tensors are on the host, ``"cuda"`` for NCCL.  It is not the
compute device, which ``ShardedEncoder`` takes on its own: gloo ranks may
all compute on one card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(device_type: str, batch: int = 1) -> DeviceMesh:
    """A ("batch", "stripe") mesh over every rank of the default process
    group: ``batch`` rows of ``world // batch`` stripes, rank r at
    (r // stripes, r % stripes).  ``batch=1`` gives pure stripe
    parallelism.  Raises ``ValueError`` when the world size is not a
    multiple of ``batch`` (``tpuenc/shard/mesh.py:40``)."""
    world = dist.get_world_size()
    if world % batch != 0:
        raise ValueError(f"{world} ranks not divisible by batch={batch}")
    return init_device_mesh(device_type, (batch, world // batch),
                            mesh_dim_names=("batch", "stripe"))


def stripe_counts(mesh: DeviceMesh) -> Tuple[int, int]:
    """(batch, stripe) sizes of the mesh."""
    return mesh.size(0), mesh.size(1)


def comm_device(mesh: DeviceMesh) -> torch.device:
    """The device of the mesh's collectives' tensors: the host for gloo,
    this rank's current card for NCCL."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())
