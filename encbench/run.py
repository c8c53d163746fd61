"""The benchmark of ``tpuenc_torch``: one run of one cell.

    python3 encbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It prints the cell's metrics as one JSON
line, last on standard output (``--trace 0``: the end-to-end metrics,
``--trace 1``: the per-layer ones), and the numbers that decide
``correct``, each beside its limit, last on standard error and under
``checks`` in that line.  It exits with another code than 0, and prints
no result, without enough CUDA devices, or where ``jax``, ``jaxlib``,
``flax`` or ``tpuenc`` were loaded.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    from harness import bench, cells, check

    spec = cells.load_benchmark()
    cell = cells.cell(spec, args.workload, bool(args.trace))
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA device(s): torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, notes = bench.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda:0", T_PROCESS,
                                   chips=chips)
    for note in notes:
        print(note, file=sys.stderr)
    found = bench.banned_loaded(sys.modules)
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    check.print_checks(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
