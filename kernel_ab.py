"""Hold K2, K3, K4, K5 and K8 of another checkout against this one's on
one card.

    python3 kernel_ab.py DIR

DIR is another checkout of the repository, such as an earlier commit
unpacked with ``git archive`` into a git-ignored directory.  The script
times ``chip_smoke.py``'s phase-3 cases of K2, K3, K4, K5 and K8 (the
flagship's shapes, K8 also on the 4K 4:2:0 restart-64 scan and K5 also on
the no-P3 shape) with DIR's ``tpuenc_torch`` and with this one's, in turns
(DIR, this, this, DIR), one child process each, and prints one JSON line
per turn.  Each case has three times in ms: ``ms``, CUDA events around the
call with the card idle (phase 3's "ms", the wrapper's host time in it);
``device_ms``, the call queued behind a spin (phase 3's device time); and
``profiler_ms``, the kernel alone from ``torch.profiler`` (null where the
profiler did not see every launch); and its ``bound_ms``.
"""

import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs

KERNEL_NAMES = {"K2": "pack_blocks_kernel", "K3": "merge_rows_kernel",
                "K4": "merge_rows_kernel", "K5": "concat_rows_kernel",
                "K8": "fused_sample_pack_kernel"}


def profiled_ms(fn, kernel_name, reps=10):
    """The mean device time in ms of the kernels named ``kernel_name`` over
    ``reps`` warm calls of ``fn``, from ``torch.profiler``; None where the
    profiler did not see each launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            us += getattr(ev, "self_device_time_total", None) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            count += ev.count
    return us / count / 1e3 if count == reps else None


def turn(dev):
    """One turn: the K2-K5 and K8 cases on this process's
    ``tpuenc_torch``, each timed three ways, as one JSON line."""
    from tpuenc_torch import cuda_lib

    inputs = cs.flagship_inputs(dev)
    out = {"checkout": os.path.dirname(os.path.dirname(cuda_lib.__file__)),
           "card": cs.card_line()}
    cases = [case[:4] for case in cs.p1_merge_cases(*inputs[:5])]
    cases += [case[:4] for case in cs.fused_concat_cases(
        dev, *inputs, log=lambda line: None)]
    for key, kernel, _, read_bytes in cases:
        got = kernel()
        out[key] = {
            "ms": cs.cuda_ms(kernel),
            "device_ms": cs.cuda_ms(kernel, queued=True),
            "profiler_ms": profiled_ms(kernel, KERNEL_NAMES[key[:2]]),
            "bound_ms": cs.bound_ms(read_bytes, got),
        }
    print(json.dumps(out), flush=True)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        # tpuenc_torch from that checkout, ahead of this one's.
        sys.path.insert(0, sys.argv[2])
        return turn(torch.device("cuda:0"))
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    if not os.path.isdir(os.path.join(other, "tpuenc_torch")):
        raise SystemExit(f"{other} holds no tpuenc_torch")
    for checkout in (other, cs.HERE, cs.HERE, other):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                        checkout], check=True)


if __name__ == "__main__":
    main()
