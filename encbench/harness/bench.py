"""One run of one cell: set-up, the timed window, the check, the result.

The loop is closed: one client calls the program back to back.  Call i
takes images ``(i * k + j) % pool`` for j < k, the k images a call of the
traffic mix; pixels go in as host numpy arrays and JPEG bytes come out.
Set-up makes the pool on the device from the seed, builds the encoder and
runs every distinct call of the schedule (twice where there are several,
so that the packer's learned budget rung has settled), then resets the
peak memory.  The window runs from the first timed call's start to the end
of the first call that ends after ``seconds``, so no call is cut.  With
``trace`` the program's functions run inside spans for the whole window,
and a sub-window of calls from the window's middle on runs under
``torch.profiler``.
"""

from __future__ import annotations

import gc
import math
import os
import subprocess
import time
import traceback

import torch

from . import cells, check, inputs
from .spans import Spans
from .trace import Profiled, warm_profiler

BANNED = ("jax", "jaxlib", "flax", "tpuenc")
# Seconds of calls that a traced run profiles, from a quarter into the window.
PROFILE_SECONDS = 1.0
TRACE_PATH = os.path.join(cells.BENCH, "out", "trace.json")


def banned_loaded(modules):
    """The top-level names of ``modules`` that are JAX's or the JAX
    package's, each compared whole (``tpuenc_torch`` is not ``tpuenc``)."""
    return sorted({m.split(".")[0] for m in modules} & set(BANNED))


def settings(config, traffic) -> dict:
    """The encoder's settings, in the order they are made: the
    configuration's ``encoder``, then the traffic mix's."""
    return {**config["encoder"], **traffic.get("encoder", {})}


def resolve(value, namespace):
    """A setting's value: ``{"<attribute path>": [args]}`` calls that
    attribute of ``namespace`` with the arguments; anything else is the
    value itself."""
    if isinstance(value, dict):
        ((path, args),) = value.items()
        target = namespace
        for part in path.split("."):
            target = getattr(target, part)
        return target(*args)
    return value


class Port:
    """The program under test: ``tpuenc_torch.Encoder(quality, device,
    **options)``, then ``set_<key>(value)`` for every other key of the
    settings, in order; each call hands the entry named by the traffic mix
    one image (``"takes": "image"``, one file back) or the call's images
    (``"images"``, a list of files back).  A mix whose calls need more
    code brings ``traffic/<mix>.py`` with a ``program(config, traffic,
    device)`` of its own."""

    def __init__(self, config, traffic, device):
        import tpuenc_torch as tt

        kept = settings(config, traffic)
        self.enc = tt.Encoder(kept.pop("quality"), device=device,
                              **traffic.get("options", {}))
        for key, value in kept.items():
            getattr(self.enc, f"set_{key}")(resolve(value, tt))
        self.entry = getattr(self.enc, traffic["entry"])
        self.each = {"image": True, "images": False}[traffic["takes"]]
        self.shape = (config["width"], config["height"],
                      tt.ColorType(config["color_type"]))

    def __call__(self, images):
        if self.each:
            return [self.entry(im, *self.shape) for im in images]
        return self.entry(images, *self.shape)


def scan_bytes(jpeg: bytes) -> int:
    """Entropy-coded bytes of a file: after each SOS header up to the next
    SOS or the EOI (stuffed scan bytes never hold 0xFF 0xDA)."""
    parts = jpeg.split(b"\xff\xda")[1:]
    return sum(len(p) - ((p[0] << 8) | p[1]) for p in parts) - 2


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def megapixels_per_call(self):
        return self.pixels_per_call / 1e6


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed, seconds, trace, device, t_process, program=None,
             chips=1):
    """One run: the result's line (a dict) and notes for standard error."""
    config, traffic = cell["config"], cell["traffic"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    pool = inputs.make(config, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    k = int(traffic["images_per_call"])
    groups = len(pool) // math.gcd(len(pool), k)

    def images(i):
        return [(i * k + j) % len(pool) for j in range(k)]

    program = program or cell.get("program", Port)(config, traffic, device)
    for i in range(groups * (2 if groups > 1 else 1)):
        program([pool[j] for j in images(i)])
    if trace and cuda:
        warm_profiler()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    spans = {}
    for _, _, reader in cell["metrics"]:
        for name, targets in getattr(reader, "SPANS", {}).items():
            spans.setdefault(name, [])
            spans[name] += [t for t in targets if t not in spans[name]]
    span_ctx = Spans(spans) if trace else None
    sample = check.Reservoir(int(traffic["check_sample"]), seed)
    latencies, failed, first_error = [], 0, None
    profiler, profiled, profiled_files, prof_calls = None, None, [], 0
    if span_ctx:
        span_ctx.__enter__()
    i = 0
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    try:
        while True:
            idx = images(i)
            if (trace and cuda and profiled is None and profiler is None
                    and time.perf_counter() - t_start >= 0.25 * seconds):
                profiler = Profiled(TRACE_PATH)
                profiler.__enter__()
                t_prof = time.perf_counter()
            t0 = time.perf_counter()
            try:
                files = program([pool[j] for j in idx])
                ok = isinstance(files, list) and len(files) == k
            except Exception:  # a failed call is counted, the loop goes on
                files, ok = None, False
                first_error = first_error or traceback.format_exc()
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            if ok:
                sample.offer((idx, files))
            else:
                failed += 1
            i += 1
            if profiler is not None:
                prof_calls += 1
                if ok:
                    profiled_files.extend(files)
                if (t1 - t_prof >= PROFILE_SECONDS
                        or t1 - t_start >= seconds):
                    profiler.__exit__(None, None, None)
                    profiled, profiler = profiler, None
            if t1 - t_start >= seconds:
                break
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        if span_ctx:
            span_ctx.__exit__(None, None, None)
    window_s = t1 - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    device_trace = profiled.read() if profiled is not None else None

    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, checked, ref_s, bpp = check.compare(sample, pool, config,
                                                traffic, device, failed)
    run = Run(
        config=config, traffic=traffic, calls=i, images_per_call=k,
        pixels_per_call=k * config["width"] * config["height"],
        window_s=window_s, latencies=latencies, setup_s=setup_s,
        peak_bytes=peak, spans=dict(span_ctx.seconds) if span_ctx else {},
        trace=device_trace,
        profiled_calls=prof_calls,
        profiled_scan_bytes=(sum(scan_bytes(f) for f in profiled_files)
                             / max(prof_calls, 1)),
    )
    metrics = {}
    for name, entry, reader in cell["metrics"]:
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": chips, "memory_peak_bytes": peak}
    if cuda:
        dev_info["power"] = power_limit()
    result = {"correct": check.correct(checks), "attempted": i,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        t0, t1 = run.trace.window
        dev_info["busy_s"] = run.trace.busy_us() * 1e-6
        dev_info["window_s"] = (t1 - t0) * 1e-6
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in run.trace.top_ops()],
            "idle_gaps": [list(kv) for kv in run.trace.idle_gaps()]}
    notes = [f"window {window_s:.6f} s, {i} calls; {checked} files checked "
             f"against the reference in {ref_s:.3f} s; the reference's files "
             f"{bpp:.4f} bits a pixel"]
    if run.trace is not None:
        notes.append(f"profiled {prof_calls} calls: "
                     f"{len(run.trace.window_ops())} device operations, "
                     f"{run.trace.unattributed()} with no launch in the trace")
    if first_error:
        notes.append("first failed call:\n" + first_error)
    result["checks"] = checks
    return result, notes
