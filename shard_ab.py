"""Time the striped encode of BASELINE config 1 in another checkout and in
this one, on one card.

    python3 shard_ab.py DIR [REPS]

DIR is another checkout of the repository, such as an earlier commit
unpacked with ``git archive`` into a git-ignored directory.  The script runs
``ShardedEncoder.encode_batch`` of BASELINE config 1 (16 x 512x512 RGB at
q90, ``chip_smoke.make_rgb``'s images, seeds 0-15) over a (2, 2) gloo mesh
of four ranks, each computing on cuda:0, with DIR's ``tpuenc_torch`` and
with this one's, in turns (DIR, this, this, DIR), one child process each.
Every rank starts each encode together with the others (a barrier, the
card idle) and times it on the host clock to the card's end.  A turn
prints one JSON line: the tree, the card's name and power limit, the
route and rung, each rank's wall in ms of the first (cold) encode and of
REPS warm ones (default 7), the median warm wall of the slowest rank, and
the sha256 of the files joined.
"""

import json
import os
import subprocess
import sys
import time

BASELINE1 = (16, 512, 512)


def make_rgb(w, h, seed):
    """``chip_smoke.make_rgb``: gradients plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [xx * 255 // max(w, 1), yy * 255 // max(h, 1), (xx + yy) * 255 // (w + h)],
        axis=2,
    ).astype(np.int16)
    noise = rng.integers(-24, 24, size=base.shape, dtype=np.int16)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def rank_turn(reps):
    """One rank's encodes: the first and ``reps`` warm ones."""
    import hashlib

    import torch
    import torch.distributed as dist

    from tpuenc_torch import ColorType
    from tpuenc_torch.shard.encode import ShardedEncoder
    from tpuenc_torch.shard.mesh import make_mesh

    n, w, h = BASELINE1
    images = [make_rgb(w, h, seed) for seed in range(n)]
    enc = ShardedEncoder(90, make_mesh("cpu", 2), device="cuda:0")
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        files = enc.encode_batch(images, w, h, ColorType.RGB)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"path": enc.last_encode_path, "rung": enc.last_budget,
            "first_ms": walls[0], "warm_ms": walls[1:],
            "sha256": hashlib.sha256(b"".join(files)).hexdigest()}


def turn(root, reps):
    sys.path.insert(0, root)
    import statistics

    from tpuenc_torch.testing.dist import launch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    ranks = launch(rank_turn, 4, (reps,), cuda_device=0, timeout=600)
    slowest = [max(r["warm_ms"][i] for r in ranks) for i in range(reps)]
    print(json.dumps({"tree": root, "card": card,
                      "path": ranks[0]["path"], "rung": ranks[0]["rung"],
                      "first_ms": [r["first_ms"] for r in ranks],
                      "warm_ms": [r["warm_ms"] for r in ranks],
                      "slowest_median_ms": statistics.median(slowest),
                      "sha256": sorted({r["sha256"] for r in ranks})}),
          flush=True)


def main():
    if sys.argv[1] == "--turn":
        turn(sys.argv[2], int(sys.argv[3]))
        return
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.abspath(__file__))
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    for root in (other, here, here, other):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                        root, str(reps)], check=True)


if __name__ == "__main__":
    main()
