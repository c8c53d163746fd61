"""Drive tpuenc_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing its own lines and its wall seconds:

1. environment: the card (nvidia-smi name and power limit), torch, nvcc;
   no CUDA device is an error;
2. build the CUDA kernels from ``tpuenc_torch/csrc`` (one nvcc per source,
   all started together) and time the build;
3. each kernel (K1-K7, K9) against its plain PyTorch version on the same
   CUDA tensors, at the flagship's shapes (2000x1800 RGB, 56,250 blocks per
   component): K1 on the luma plane; K2 on the interleaved stream at block
   budgets 16 and 48; K3-K5 at budget rungs 5 and 16; K6 on the
   progressive luma stream with the 4-scan plan's three bands at block
   budgets 16 and 48; K7 on the same stream and bands; K9 on its band
   (1, 64).  Bit-exact (tolerance 0), with both times (CUDA events, median
   of 10 warm runs);
4. the 26 frozen fixtures encoded on the card, byte for byte;
5. the interleaved flagship, ``Encoder(90, device="cuda").encode(rgb,
   2000, 1800, ColorType.RGB)``: the same bytes as the CPU path, K1-K5
   launched, the budget rung, warm end-to-end MP/s (median of 7) and
   per-stage times;
6. the same image and encoder switched to progressive scans with two-pass
   optimized tables (``set_progressive(True)``,
   ``set_optimized_huffman_tables(True)``): the same bytes as the CPU path
   (run in a child process, timed, its peak memory reported), K1, K3-K7
   launched and K2 not, the budget rung and the hint, warm end-to-end MP/s
   (median of 7) and per-stage times.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failure raises, so the
exit code is not 0 and no result line is printed.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_W, FLAGSHIP_H = 2000, 1800


def make_rgb(w, h, seed=42):
    """The flagship input (bench.py:make_rgb): gradients plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [xx * 255 // max(w, 1), yy * 255 // max(h, 1), (xx + yy) * 255 // (w + h)],
        axis=2,
    ).astype(np.int16)
    noise = rng.integers(-24, 24, size=base.shape, dtype=np.int16)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]


def cuda_ms(fn, reps=10):
    """Median device time of ``fn`` in ms over ``reps`` warm runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want):
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def phase_env():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    from tpuenc_torch import cuda_lib

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(run([cuda_lib._nvcc(), "--version"]).strip().splitlines()[-1])
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def phase_build():
    from tpuenc_torch import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"build: {cuda_lib.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernels(dev):
    """Each kernel against its plain version on the flagship's tensors."""
    from tpuenc_torch import params_from_numpy
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType, EncoderConfig
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.entropy.device_encode import build_scan_plan, tables_to_arrays
    from tpuenc_torch.entropy.huffopt import progressive_bands
    from tpuenc_torch.kernels import pallas_fdct, pipeline
    from tpuenc_torch.kernels.color_convert import to_planes

    config = EncoderConfig(quality=90)
    q_tables = [quantization_table("default", 90, True),
                quantization_table("default", 90, False)]
    huffman = [list(p) for p in default_tables()]
    params = params_from_numpy(q_tables, *tables_to_arrays(huffman), dev)
    px = torch.from_numpy(make_rgb(FLAGSHIP_W, FLAGSHIP_H)).to(dev)
    layout = pipeline.scan_layout(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    ((_, spec, _),) = build_scan_plan(layout, layout["components"], config)

    results = {}

    def check(key, kernel, plain, reps=10):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from plain, max |err| {err}")
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, reps)
        print(f"  {key:28s} max|err| {err}  kernel {ms:9.4f} ms  "
              f"plain {plain_ms:9.4f} ms")
        results[key] = (err, ms, plain_ms)
        return got

    # K1 on the luma plane's (64, 56,250) blocks, as fn_cm launches it.
    y = to_planes(px, ColorType.RGB)[0]
    x_cm = pipeline._blockify_cm(y, 1, 1)
    r, c = params.reciprocals[0], params.corrections[0]
    check("K1 fdct_quantize",
          lambda: pallas_fdct.fdct_quantize(x_cm, r, c),
          lambda: pallas_fdct.fdct_quantize_ref(x_cm, r, c))

    (stream,) = pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB,
                               config, params.reciprocals, params.corrections)
    B = stream.shape[1]
    Bp = -(-B // 512) * 512
    print(f"  flagship stream: {B} blocks, padded to {Bp}")
    dcdiff = pk.dc_diffs_from_dc(stream[0], spec)
    strings = {}
    for block_budget in (16, 48):
        strings[block_budget] = check(
            f"K2 pack_blocks budget {block_budget}",
            lambda: pk.pack_blocks(stream, dcdiff, params.dc, params.ac, spec,
                                   Bp, block_budget),
            lambda: pk.pack_blocks_ref(stream, dcdiff, params.dc, params.ac,
                                       spec, Bp, block_budget),
        )
    # Rungs 5 and 16 both pack their blocks at block budget max(rung, 16).
    words, lens, _ = strings[16]
    n_sub = 128
    for rung in (5, 16):
        capB = words.shape[1]
        chunk, n2, caps, caps_f = pk.merge_plan(Bp, capB, rung, n_sub)
        rows, row_bits, _ = check(
            f"K3 merge_chunks rung {rung}",
            lambda: pk.merge_chunks(words, lens, chunk, n_sub * n2, caps, caps[-1]),
            lambda: pk.merge_rows_ref(words, lens, chunk, n_sub * n2, caps, caps[-1]),
        )
        if caps_f is None:
            raise AssertionError(f"rung {rung}: the flagship has no P3 fold")
        print(f"  rung {rung}: capB {capB}, chunk {chunk}, n2 {n2}, "
              f"P2 cap {caps[-1]}, P3 cap {caps_f[-1]}")
        frows, fbits, _ = check(
            f"K4 fold_rows rung {rung}",
            lambda: pk.fold_rows(rows, row_bits, n2, n_sub, caps_f, caps_f[-1]),
            lambda: pk.merge_rows_ref(rows, row_bits, n2, n_sub, caps_f, caps_f[-1]),
        )
        pos = torch.cumsum(fbits.to(torch.int64), 0) - fbits
        capW = -(-(n_sub * caps_f[-1] + caps_f[-1] + 256) // 128) * 128
        check(f"K5 concat_rows rung {rung}",
              lambda: pk.concat_rows(frows, pos, fbits, capW),
              lambda: pk.concat_rows_ref(frows, pos, fbits, capW))

    # K6, K7, K9 on the progressive flagship's luma stream.
    pconfig = progressive_encoder(dev)._config()
    luma = pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, pconfig,
                          params.reciprocals, params.corrections)[0]
    B = luma.shape[1]
    Bp = -(-B // 512) * 512
    bands = tuple(progressive_bands(pconfig.progressive_scans))
    print(f"  progressive luma stream: {B} blocks, padded to {Bp}, "
          f"bands {bands}")
    for block_budget in (16, 48):
        got = check(
            f"K6 pack_acbands budget {block_budget}",
            lambda: pk.pack_acbands(luma, bands, params.ac, 0, Bp, block_budget),
            lambda: pk.pack_acbands_ref(luma, bands, params.ac, 0, Bp,
                                        block_budget),
        )
        print(f"  K6 budget {block_budget}: cap_f {got[0].shape[2]}, "
              f"overflow {int(got[2].item())}")
    check("K7 hist_count", lambda: ph.hist_count(luma, bands),
          lambda: ph.hist_count_ref(luma, bands))
    check("K9 hist_sym", lambda: ph.hist_sym(luma, 1, 64, Bp),
          lambda: ph.hist_sym_ref(luma, 1, 64, Bp))
    return results


def phase_fixtures(dev):
    from tpuenc_torch.testing.fixtures import build_cases, img

    cases = build_cases(dev)
    for name, (build, ct, ch, seed, w, h) in cases.items():
        want = open(os.path.join(HERE, "tests", "fixtures", f"{name}.jpg"),
                    "rb").read()
        got = build().encode(img(ch, seed, w, h), w, h, ct)
        if got != want:
            raise AssertionError(f"fixture {name}: bytes differ on {dev}")
    if len(cases) != 26:
        raise AssertionError(f"{len(cases)} fixtures, want 26")
    print(f"fixtures: all {len(cases)} fixtures byte-identical on {dev}")


def stage_times(dev, rgb, budget):
    """Device ms of each stage of one flagship encode (CUDA events, median
    of 10), and the host finish in ms (host clock)."""
    from tpuenc_torch import Encoder
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType, EncoderConfig
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline

    config = Encoder(90, device=dev)._config()
    q_tables = [quantization_table("default", 90, True),
                quantization_table("default", 90, False)]
    huffman = [list(p) for p in default_tables()]
    params = de.params_from_numpy(q_tables, *de.tables_to_arrays(huffman), dev)
    layout = pipeline.scan_layout(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    ((_, spec, _),) = de.build_scan_plan(layout, layout["components"], config)
    host = torch.from_numpy(rgb)
    px = host.to(dev)
    st = {}
    st["h2d pixels"] = cuda_ms(lambda: host.to(dev))
    st["coefficients (color, pad, blockify, K1 x3, MCU order)"] = cuda_ms(
        lambda: pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB,
                               config, params.reciprocals, params.corrections))
    (stream,) = pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB,
                               config, params.reciprocals, params.corrections)
    st["P1: DC diffs + K2"] = cuda_ms(
        lambda: pk.scan_pack_blocks(stream, spec, params.dc, params.ac, budget))
    words, lens, _ = pk.scan_pack_blocks(stream, spec, params.dc, params.ac, budget)
    st["P2-P4: K3 + K4 + K5"] = cuda_ms(
        lambda: pk.merge_pack_stream(words, lens, budget))
    plan = [(0, spec, None)]
    st["pack + meta (P1-P4, seg bits)"] = cuda_ms(
        lambda: de._pack_scans_v2((stream,), plan, params, budget))
    buf, meta = de._pack_scans_v2((stream,), plan, params, budget)
    meta_np = meta.cpu().numpy()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        de._finish_scans_v2(buf, meta_np, 1, [1])
        times.append((time.perf_counter() - t0) * 1e3)
    st["host: d2h stream + realign/stuff (host clock)"] = statistics.median(times)
    for k, v in st.items():
        print(f"  {k:50s} {v:9.4f} ms")


def counted_kernels():
    """Every kernel wrapper, with its launch counter."""
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pallas_fdct

    return [pallas_fdct.fdct_quantize, pk.pack_blocks, pk.merge_chunks,
            pk.fold_rows, pk.concat_rows, pk.pack_acbands, ph.hist_count,
            ph.hist_sym]


def drive(enc, rgb, required, absent=()):
    """One encode of ``rgb`` with every launch count set to 0 just before
    it; returns (bytes, {wrapper name: launches}) and checks that each
    ``required`` wrapper launched and each ``absent`` one did not."""
    from tpuenc_torch import ColorType

    counted = counted_kernels()
    for fn in counted:
        fn.launches = 0
    out = enc.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"  {len(out)} bytes, path {enc.last_encode_path}, budget rung "
          f"{enc.last_budget}, launches {launches}")
    if enc.last_encode_path != "device-v2":
        raise AssertionError(f"encode ran on {enc.last_encode_path}")
    idle = [k for k in required if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the path: {idle}")
    extra = [k for k in absent if launches[k] != 0]
    if extra:
        raise AssertionError(f"kernels launched off the path: {extra}")
    if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
        raise AssertionError("output is not a JPEG stream")
    return out, launches


def e2e(enc, rgb):
    from tpuenc_torch import ColorType

    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        enc.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    mp = FLAGSHIP_W * FLAGSHIP_H / 1e6
    print(f"  e2e (host pixels -> bytes, warm, median of 7): "
          f"{med * 1e3:.3f} ms = {mp / med:.1f} MP/s "
          f"(runs ms: {' '.join(f'{t * 1e3:.3f}' for t in times)})")


def phase_flagship(dev):
    from tpuenc_torch import ColorType, Encoder

    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    enc = Encoder(90, device=dev)
    out, launches = drive(enc, rgb, ["fdct_quantize", "pack_blocks",
                                     "merge_chunks", "fold_rows",
                                     "concat_rows"])
    t0 = time.perf_counter()
    want = Encoder(90, device="cpu").encode(rgb, FLAGSHIP_W, FLAGSHIP_H,
                                            ColorType.RGB)
    print(f"  the CPU path: {len(want)} bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    if out != want:
        raise AssertionError("flagship bytes differ between cuda and cpu")
    print("  cuda bytes == cpu bytes")
    e2e(enc, rgb)
    stage_times(dev, rgb, enc.last_budget)
    return launches


def progressive_encoder(device):
    """The flagship's encoder switched to progressive scans (4: the
    default of set_progressive) with two-pass optimized tables."""
    from tpuenc_torch import Encoder

    enc = Encoder(90, device=device)
    enc.set_progressive(True)
    enc.set_optimized_huffman_tables(True)
    return enc


# The CPU half of phase 6, in a child process so that its time and peak
# memory are its own: JPEG bytes to stdout, "seconds peak_rss_kib" to
# stderr.
CPU_PROGRESSIVE = """
import resource, sys, time
import chip_smoke as c
from tpuenc_torch import ColorType
rgb = c.make_rgb(c.FLAGSHIP_W, c.FLAGSHIP_H)
t0 = time.perf_counter()
out = c.progressive_encoder("cpu").encode(rgb, c.FLAGSHIP_W, c.FLAGSHIP_H,
                                          ColorType.RGB)
sys.stderr.write(f"{time.perf_counter() - t0} "
                 f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}")
sys.stdout.buffer.write(out)
"""


def progressive_stage_times(dev, rgb, budget):
    """Device ms of each stage of one progressive optimized-table encode
    (CUDA events, median of 10) and the host stages (host clock, median of
    5).  Returns the budget hint."""
    from tpuenc_torch.api import optimize_tables
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.entropy.device import scan_histograms
    from tpuenc_torch.kernels import pipeline

    config = progressive_encoder(dev)._config()
    layout = pipeline.scan_layout(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    comps = layout["components"]
    plan = de.build_scan_plan(layout, comps, config)
    seg_structure = de.seg_structure(layout, plan)
    q_tables = [quantization_table("default", 90, True),
                quantization_table("default", 90, False)]
    recip, corr = de.quant_params(q_tables, dev)
    px = torch.from_numpy(rgb).to(dev)

    def coefficients():
        return pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB,
                              config, recip, corr)

    def histograms():
        return scan_histograms(streams, comps, config.progressive_scans).cpu()

    def host_times(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    st = {}
    st["coefficients (color, pad, blockify, K1 x3, crop)"] = cuda_ms(coefficients)
    streams = coefficients()
    st["histograms (DC + K7 x3) + D2H of 2x2x257 counts"] = cuda_ms(histograms)
    hists = histograms().numpy()
    huffman = [list(p) for p in default_tables()]
    hint = optimize_tables(hists, huffman, FLAGSHIP_W, FLAGSHIP_H,
                           ColorType.RGB, config)
    st["host: K.2 build x4 + exact bits (host clock)"] = host_times(
        lambda: optimize_tables(hists, [list(p) for p in default_tables()],
                                FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config))
    params = de.EncodeParams(recip, corr, *de.huffman_params(huffman, dev))
    st["P1: DC path x3 + K6 x3 + concat"] = cuda_ms(
        lambda: de.pack_scans_p1(streams, plan, params, budget))
    W, L, _, _, _ = de.pack_scans_p1(streams, plan, params, budget)
    chunk, n2, _, caps_f = pk.merge_plan(W.shape[0], W.shape[1], budget)
    print(f"  {len(plan)} scans, {W.shape[0]} pack rows of {W.shape[1]} words, "
          f"P2 chunk {chunk}, n2 {n2}, P3 fold {caps_f is not None}")
    st["P2-P4: K3 + K4 + K5"] = cuda_ms(lambda: pk.merge_pack_stream(W, L, budget))
    buf, meta = de._pack_scans_v2(streams, plan, params, budget)
    meta_np = meta.cpu().numpy()
    st["host: d2h stream + realign/stuff x12 (host clock)"] = host_times(
        lambda: de._finish_scans_v2(buf, meta_np, len(plan), seg_structure))
    for k, v in st.items():
        print(f"  {k:50s} {v:9.4f} ms")
    return hint


def phase_progressive(dev):
    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    enc = progressive_encoder(dev)
    out, launches = drive(
        enc, rgb,
        ["fdct_quantize", "merge_chunks", "fold_rows", "concat_rows",
         "pack_acbands", "hist_count"],
        absent=["pack_blocks", "hist_sym"])
    if b"\xff\xc2" not in out:
        raise AssertionError("no progressive frame header (SOF2)")
    res = subprocess.run([sys.executable, "-c", CPU_PROGRESSIVE], cwd=HERE,
                         capture_output=True, check=True)
    seconds, rss_kib = res.stderr.decode().split()[-2:]
    print(f"  the CPU path (child process): {len(res.stdout)} bytes in "
          f"{float(seconds):.2f} s, peak RSS {int(rss_kib) / 2**20:.2f} GiB")
    if out != res.stdout:
        raise AssertionError("progressive bytes differ between cuda and cpu")
    print("  cuda bytes == cpu bytes")
    e2e(enc, rgb)
    hint = progressive_stage_times(dev, rgb, enc.last_budget)
    print(f"  budget hint {hint} words per pack row, rung {enc.last_budget}")
    return launches


KERNELS = [
    # (name, counter key, results key, source, replaces)
    ("K1 fdct_quantize", "fdct_quantize", "K1 fdct_quantize",
     "tpuenc_torch/csrc/fdct_quantize.cu", "tpuenc/kernels/pallas_fdct.py:105"),
    ("K2 pack_blocks", "pack_blocks", "K2 pack_blocks budget 16",
     "tpuenc_torch/csrc/pack_blocks.cu", "tpuenc/entropy/pallas_pack.py:345"),
    ("K3 merge_chunks", "merge_chunks", "K3 merge_chunks rung 5",
     "tpuenc_torch/csrc/merge_rows.cu", "tpuenc/entropy/pallas_pack.py:1116"),
    ("K4 fold_rows", "fold_rows", "K4 fold_rows rung 5",
     "tpuenc_torch/csrc/merge_rows.cu", "tpuenc/entropy/pallas_pack.py:1227"),
    ("K5 concat_rows", "concat_rows", "K5 concat_rows rung 5",
     "tpuenc_torch/csrc/concat_rows.cu", "tpuenc/entropy/pallas_pack.py:1342"),
    ("K6 pack_acbands", "pack_acbands", "K6 pack_acbands budget 16",
     "tpuenc_torch/csrc/pack_acbands.cu", "tpuenc/entropy/pallas_pack.py:629"),
    ("K7 hist_count", "hist_count", "K7 hist_count",
     "tpuenc_torch/csrc/hist_count.cu", "tpuenc/entropy/pallas_hist.py:134"),
    ("K9 hist_sym", "hist_sym", "K9 hist_sym",
     "tpuenc_torch/csrc/hist_sym.cu", "tpuenc/entropy/pallas_hist.py:44"),
]


def main():
    phases = [("1. environment", phase_env), ("2. build", phase_build),
              ("3. kernels vs plain versions (flagship shapes, tolerance 0)",
               phase_kernels),
              ("4. fixtures", phase_fixtures),
              ("5. flagship, interleaved", phase_flagship),
              ("6. flagship, progressive with optimized tables",
               phase_progressive)]
    dev = torch.device("cuda:0")
    out = {}
    for title, fn in phases:
        print(f"== {title}")
        t0 = time.perf_counter()
        out[title] = fn(dev) if fn not in (phase_env, phase_build) else fn()
        if fn is phase_kernels:
            tests_only = {k.__name__: k.launches for k in counted_kernels()}
        print(f"   ({time.perf_counter() - t0:.2f} s)")
    results = out[phases[2][0]]
    paths = {"interleaved": out[phases[4][0]],
             "progressive_optimized": out[phases[5][0]]}

    kernels = []
    for name, counter, key, source, replaces in KERNELS:
        _, ms, plain_ms = results[key]
        errs = [v[0] for k, v in results.items() if k.startswith(name)]
        by_path = {p: n[counter] for p, n in paths.items() if n[counter]}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "path": "+".join(by_path), "launches_by_path": by_path,
        }
        if not by_path:  # K9: no encode path runs it (tpuenc's tests only)
            entry.update(launches=tests_only[counter], path="tests only")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
