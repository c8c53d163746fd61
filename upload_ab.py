"""Time the pixel upload's designs on one card.

    python3 upload_ab.py [REPS]

At the sizes the benchmark's cells upload (a 2000x1800 RGB photo, 10.8
MB; a 3840x2160 RGB frame, 24.9 MB; a batch of 8 photos into the slots of
one tensor, 86.4 MB; a 64-MCU-row chunk of a 16384-wide CMYK page, 64
MiB) the script times

* ``pageable``: ``torch.from_numpy(a).to(device)`` (slot by slot for the
  batch), the port's upload before staging;
* ``pinned``: one copy of the whole array into a page-locked buffer made
  beforehand (torch's copy), then one DMA, one after the other;
* ``staged``: ``tpuenc_torch.upload.StagedUpload``, the port's upload: a
  host copy by ``upload.CopyPool`` into a part of one page-locked buffer,
  then one DMA of it on a copy stream (a batch's images take the buffer's
  parts in turn, so each image's DMA overlaps the next image's copy);

each the median of REPS (default 15) warm calls: ``host_ms``, until the
call returns, and ``done_ms``, until the bytes are on the card
(``torch.cuda.synchronize``); ``cpu_ms``, the process's CPU time a call
over the same calls, every thread's (torch's own parallel copy, in
``pinned``, leaves its OpenMP threads spinning after it).  ``behind_ms``
is ``host_ms`` with 2 ms of work queued on the stream before the call,
which a pageable copy waits for.  It also prints the host's copy rate
into page-locked memory (torch's copy at its thread count and at one
thread), the DMA rate alone, the thread count and the card.  One JSON
line a case, then a summary line.

Each case uploads the same arrays again and again, back to back: the
host copy then runs faster than between the encodes of a real call,
where the host's other work lets the copy's threads go idle.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpuenc_torch import upload

MIB = 1 << 20


def _median(xs):
    return float(np.median(xs))


def _timed(fn, reps, behind=False):
    """(host ms, done ms) medians of ``reps`` warm calls of ``fn``, and the
    process's CPU ms a call over them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    host, done = [], []
    cpu0 = time.process_time()
    for _ in range(reps):
        if behind:
            torch.cuda._sleep(2_000_000)  # ~1-2 ms of spinning
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        done.append((t2 - t0) * 1e3)
    cpu_ms = (time.process_time() - cpu0) * 1e3 / reps
    return _median(host), _median(done), cpu_ms


def _cases(dev):
    rng = np.random.default_rng(2024)
    photo = rng.integers(0, 256, (1800, 2000, 3), np.uint8)
    frame = rng.integers(0, 256, (2160, 3840, 3), np.uint8)
    chunk = rng.integers(0, 256, (1024, 16384, 4), np.uint8)
    batch = [rng.integers(0, 256, (1800, 2000, 3), np.uint8)
             for _ in range(8)]
    slots = torch.empty((8, 1800, 2000, 3), dtype=torch.uint8, device=dev)
    return {"photo": [photo], "uhd": [frame], "batch8": batch,
            "chunk64": [chunk]}, slots


def _designs(dev, arrays, slots, pinned):
    batch = len(arrays) > 1

    def pageable():
        if batch:
            for i, a in enumerate(arrays):
                slots[i].copy_(torch.from_numpy(a))
        else:
            torch.from_numpy(arrays[0]).to(dev)

    def plain_pinned():
        if batch:
            host = pinned[:slots.numel()].view(slots.shape)
            for i, a in enumerate(arrays):
                host[i].copy_(torch.from_numpy(a))
            slots.copy_(host, non_blocking=True)
        else:
            a = arrays[0]
            host = pinned[:a.size].view(a.shape)
            host.copy_(torch.from_numpy(a))
            host.to(dev, non_blocking=True)

    stager = upload.StagedUpload(dev)

    def staged():
        if batch:
            for i, a in enumerate(arrays):
                stager.upload_into(slots[i], a)
        else:
            stager.upload(arrays[0])

    return {"pageable": pageable, "pinned": plain_pinned, "staged": staged}


def _rates(dev, pinned, reps):
    """GB/s: host copy into page-locked memory at torch's threads and at
    one, the pinned DMA alone, and the pageable copy."""
    n = 64 * MIB
    src = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, n, np.uint8))
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    out = {}
    threads = torch.get_num_threads()
    for label, th in (("host_to_pinned", threads), ("host_to_pinned_1t", 1)):
        torch.set_num_threads(th)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pinned[:n].copy_(src)
            ts.append(time.perf_counter() - t0)
        out[label] = n / _median(ts) / 1e9
    torch.set_num_threads(threads)
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(pinned[:n], non_blocking=True)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    out["dma_pinned"] = n / _median(ts) / 1e9
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    out["pageable"] = n / _median(ts) / 1e9
    return out


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 15
    if not torch.cuda.is_available():
        raise SystemExit("upload_ab.py times the card: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"card": card.strip(), "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "threads": torch.get_num_threads(),
            "cpus": os.cpu_count()}
    pinned = torch.empty(96 * MIB, dtype=torch.uint8, pin_memory=True)
    head["rates_gb_s"] = _rates(dev, pinned, reps)
    print(json.dumps(head), flush=True)
    cases, slots = _cases(dev)
    summary = {}
    for name, arrays in cases.items():
        nbytes = sum(a.nbytes for a in arrays)
        for design, fn in _designs(dev, arrays, slots, pinned).items():
            host_ms, done_ms, cpu_ms = _timed(fn, reps)
            behind_ms, _, _ = _timed(fn, reps, behind=True)
            row = {"case": name, "bytes": nbytes, "design": design,
                   "host_ms": round(host_ms, 4), "done_ms": round(done_ms, 4),
                   "behind_ms": round(behind_ms, 4),
                   "cpu_ms": round(cpu_ms, 3),
                   "gb_s": round(nbytes / done_ms / 1e6, 3)}
            summary[f"{name}/{design}"] = row["done_ms"]
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary_done_ms": summary}), flush=True)


if __name__ == "__main__":
    main()
