"""The control of the benchmark's check: a run must come out not correct.

    python3 encbench/control.py --workload <name> --seeds 1,2,3 [--seconds 2]

puts the plain reference, computing its transform with 8 fractional bits
in place of 13 (the lower-precision transform of libjpeg's fast integer
DCT), in the program's place and runs the cell as ``run.py`` does, at the
cell's own sizes, one short window a seed.  It prints one JSON line a
seed with ``correct`` and the numbers compared; every line should read
``correct: false``.  The benchmark's own runs never run it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

LOW_CONST_BITS = 8


class Control:
    """The reference in the program's place, in lower precision."""

    def __init__(self, config, traffic, device, const_bits=LOW_CONST_BITS):
        self.config, self.traffic = config, traffic
        self.device, self.const_bits = device, const_bits

    def __call__(self, images):
        from harness import check

        return [check.reference_file(im, self.config, self.traffic,
                                     self.device, self.const_bits)
                for im in images]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()

    import torch

    from harness import bench, cells

    cell = cells.cell(cells.load_benchmark(), args.workload, False)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        program = Control(cell["config"], cell["traffic"], "cuda:0")
        result, notes = bench.run_cell(cell, seed, args.seconds, False,
                                       "cuda:0", time.perf_counter(),
                                       program=program)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"], "notes": notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
