"""Drive tpuenc_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing its own lines and its wall seconds:

1. environment: the card (nvidia-smi name and power limit), torch, nvcc;
   no CUDA device is an error;
2. build the CUDA kernels from ``tpuenc_torch/csrc`` (one nvcc per source,
   all started together) and time the build; beside it, ``nvcc -Xptxas -v``
   reports the registers, stack, spills and static shared memory of K1, K2,
   K3/K4, K5, K6, K7 and K8;
3. each kernel (K1-K9) against its plain PyTorch version on the same CUDA
   tensors, at the flagship's shapes (2000x1800 RGB, 56,250 blocks per
   component): K1 on the luma plane; K2 on the interleaved stream at block
   budgets 16 and 48; K8 on the interleaved sample stream at the same
   budgets, and on a 3840x2160 q80 4:2:0 image with restart interval 64
   at budget 16, each also equal to K1 -> DC differences -> K2, with its
   dynamic shared memory; K3 and K4 at budget rungs 5, 16 and 48, K5 at 5
   and 16 and on synthetic rows of the no-P3 shape at the whole-image
   limit; K6 on the progressive luma stream with the 4-scan plan's three
   bands at block budgets 16, 48 and 224, with its dynamic shared memory;
   K7 on the same stream and bands; K9 on its band (1, 64).  Bit-exact
   (tolerance 0), with the kernel's time
   and the plain version's, both timed the same way (CUDA events around
   the call with the card idle, so the wrapper's host time is in it), the
   kernel's device time (its call queued behind a spin; see ``cuda_ms``),
   the K2-K4 lines also with their first designs' times and the K5-K8
   lines with the device times of the designs they replaced, from
   PERF.md, and the kernel's bound: the bytes it must move (each input
   read once, each output written once; bit strings read only up to their
   lengths) over the H100's 3.35 TB/s, with its share of the device time;
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
   (median of 7) and per-stage times;
7. the interleaved flagship through K8, ``Encoder(90, device="cuda",
   fused_p1=True)``, the budget memo cleared first: phase 5's bytes at
   phase 5's rung, K8 and K3-K5 launched and K1 and K2 not, warm
   end-to-end MP/s (median of 7) in turns with phase 5's encoder (split,
   fused, fused, split), and per-stage times.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failure raises, so the
exit code is not 0 and no result line is printed.  ``kernel_ab.py`` holds
K2-K8 against another checkout's on one card.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_W, FLAGSHIP_H = 2000, 1800
# BASELINE.md's "4:2:0 restart64 4K" configuration.
UHD_W, UHD_H = 3840, 2160
# H100 SXM HBM3 bandwidth (NVIDIA's data sheet): every kernel here is
# integer work with no matrix product, bounded by the bytes it moves.
HBM_BYTES_PER_S = 3.35e12


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


# SM clock cycles of the spin that holds the card ahead of a queued
# timing (about 1 ms); a timing doubles it while the host's enqueue
# outlasts half of it.
SPIN_CYCLES = 2_000_000


def cuda_ms(fn, reps=10, queued=False):
    """Median time of ``fn`` in ms over ``reps`` warm runs, from CUDA
    events recorded around it on the current stream.

    By default the card is idle when the first event is recorded, so the
    time includes the host's work in ``fn`` up to its last launch (a
    wrapper's checks and allocations).  With ``queued`` the card first
    spins (``torch.cuda._sleep``) while the host enqueues both events and
    everything ``fn`` launches, so the time is the device work alone: for
    a kernel's wrapper, its kernel and the wrapper's small fills."""
    spin = SPIN_CYCLES
    fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            s = torch.cuda.Event(enable_timing=True)
            s.record()
            torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if queued and host_ms > 0.5 * s.elapsed_time(a):
            spin *= 2  # the card may have caught up with the host
            continue
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def string_bytes(lens):
    """Bytes of the words that hold bit strings of ``lens`` bits: what a
    merge must read of its input rows."""
    return 4 * int(((lens.to(torch.int64) + 31) // 32).sum().item())


def bound_ms(read_bytes, outputs):
    """The least time of a kernel: its reads plus every output written
    once, over the card's memory rate."""
    if not isinstance(outputs, tuple):
        outputs = (outputs,)
    return (read_bytes + nbytes(*outputs)) / HBM_BYTES_PER_S * 1e3


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


PTXAS_REPORTED = ("fdct_quantize.cu", "pack_blocks.cu", "merge_rows.cu",
                  "concat_rows.cu", "pack_acbands.cu", "hist_count.cu",
                  "fused_sample_pack.cu")


def phase_build():
    """The library build, and beside it one ``-Xptxas -v`` compile of each
    of K1, K2, K3/K4, K5, K6, K7 and K8 for their registers, stack, spills
    and static shared memory (K2's, K6's and K8's tiles and K3/K4's prefix
    are dynamic shared memory, sized at launch, which ptxas does not see;
    phase 3 prints K6's and K8's)."""
    import tempfile

    from tpuenc_torch import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cuda_lib.BUILD_DIR)
    flags = [f for f in cuda_lib.NVCC_FLAGS if f != "-shared"]
    reports = {
        src: subprocess.Popen(
            [cuda_lib._nvcc(), *flags, "-Xptxas", "-v", "-I", cuda_lib.CSRC,
             "-c", "-o", os.path.join(tmp, src + ".o"),
             os.path.join(cuda_lib.CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_REPORTED}
    try:
        t0 = time.perf_counter()
        cuda_lib.library()
        print(f"build: {cuda_lib.library_path()} in "
              f"{time.perf_counter() - t0:.2f} s")
        for src, proc in reports.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v {src}:\n{out}")
            lines = [ln.split("ptxas info    :")[-1].strip()
                     for ln in out.splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  ptxas {src}: {' | '.join(lines)}")
    finally:
        for proc in reports.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp)


# PR 4's ms of the first designs of K2 (one thread per block writing its
# row to device memory) and K3/K4 (one thread block per run, atomicOr
# scatter), from PERF.md section 6: the measure of phase 3's "ms" (CUDA
# events around the wrapper, ``cuda_ms`` without ``queued``), NVIDIA H100
# 80GB HBM3 at 700 W, PR 4's calls 2 / 3 where both ran.
PR4_MS = {
    "K2 pack_blocks budget 16": "0.1377 / 0.1115",
    "K2 pack_blocks budget 48": "0.2930",
    "K3 merge_chunks rung 5": "0.0825 / 0.0910",
    "K3 merge_chunks rung 16": "0.0988",
    "K4 fold_rows rung 5": "0.0622 / 0.0533",
    "K4 fold_rows rung 16": "0.0867",
}

# Device ms of the designs K5 (one thread block per row, atomicOr into a
# zero-filled output), K6 and K8 (a serial bit writer storing each block's
# row to device memory; K6 walking the slots once per band) and K7 (a walk
# per band, a shared atomic per symbol) replaced, from PERF.md section 6:
# the measure of phase 3's device time (``cuda_ms`` queued), NVIDIA H100
# 80GB HBM3 at 700 W.
REPLACED_DEVICE_MS = {
    "K5 concat_rows rung 5": "0.0140",
    "K5 concat_rows rung 16": "0.0170",
    "K6 pack_acbands budget 16": "0.0681",
    "K6 pack_acbands budget 48": "0.1054",
    "K7 hist_count": "0.0210",
    "K8 fused_sample_pack budget 16": "0.0839",
    "K8 fused_sample_pack budget 48": "0.1901",
    "K8 fused_sample_pack 4K 4:2:0 restart 64 budget 16": "0.0982",
}


def flagship_inputs(dev):
    """What phase 3 and ``kernel_ab.py`` feed K2-K4: the packed tables, the
    interleaved scan's spec and (64, B) coefficient stream, its DC
    differences and Bp, with the pixels, layout and config they came from."""
    from tpuenc_torch import params_from_numpy
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType, EncoderConfig
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline

    config = EncoderConfig(quality=90)
    q_tables = [quantization_table("default", 90, True),
                quantization_table("default", 90, False)]
    huffman = [list(p) for p in default_tables()]
    params = params_from_numpy(q_tables, *de.tables_to_arrays(huffman), dev)
    px = torch.from_numpy(make_rgb(FLAGSHIP_W, FLAGSHIP_H)).to(dev)
    layout = pipeline.scan_layout(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    ((_, spec, _),) = de.build_scan_plan(layout, layout["components"], config)
    (stream,) = pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB,
                               config, params.reciprocals, params.corrections)
    B = stream.shape[1]
    Bp = -(-B // 512) * 512
    dcdiff = pk.dc_diffs_from_dc(stream[0], spec)
    return params, spec, stream, dcdiff, Bp, px, layout, config


def p1_merge_cases(params, spec, stream, dcdiff, Bp):
    """Phase 3's K2, K3 and K4 cases on the flagship stream: yields
    ``(key, kernel, plain, read_bytes)`` in order, each case's inputs made
    by running the kernel of the case before it.  K2 at block budgets 16
    and 48; K3 and K4 at budget rungs 5 and 16, which pack their blocks at
    block budget max(rung, 16) = 16, and 48."""
    from tpuenc_torch.entropy import pallas_pack as pk

    tables = nbytes(params.dc, params.ac)
    strings = {}
    for bb in (16, 48):
        def k2(bb=bb):
            return pk.pack_blocks(stream, dcdiff, params.dc, params.ac, spec,
                                  Bp, bb)

        def k2_plain(bb=bb):
            return pk.pack_blocks_ref(stream, dcdiff, params.dc, params.ac,
                                      spec, Bp, bb)

        yield f"K2 pack_blocks budget {bb}", k2, k2_plain, \
            nbytes(stream, dcdiff) + tables
        strings[bb] = k2()
    n_sub = 128
    for rung in (5, 16, 48):
        words, lens, _ = strings[max(rung, 16)]
        chunk, n2, caps, caps_f = pk.merge_plan(Bp, words.shape[1], rung, n_sub)
        if caps_f is None:
            raise AssertionError(f"rung {rung}: the flagship has no P3 fold")
        args = (words, lens, chunk, n_sub * n2, caps, caps[-1])
        yield f"K3 merge_chunks rung {rung}", \
            lambda a=args: pk.merge_chunks(*a), \
            lambda a=args: pk.merge_rows_ref(*a), \
            string_bytes(lens) + nbytes(lens)
        rows, row_bits, _ = pk.merge_chunks(*args)
        fargs = (rows, row_bits, n2, n_sub, caps_f, caps_f[-1])
        yield f"K4 fold_rows rung {rung}", \
            lambda a=fargs: pk.fold_rows(*a), \
            lambda a=fargs: pk.merge_rows_ref(*a), \
            string_bytes(row_bits) + nbytes(row_bits)


# Blocks a K6 thread block packs (kRows in csrc/pack_acbands.cu).
K6_ROWS = 64


def progressive_luma(dev, params, px):
    """The progressive flagship's luma stream, as phase 3 and
    ``kernel_ab.py`` feed K6, K7 and K9: (64, B) coefficients, Bp and the
    4-scan plan's AC bands."""
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.entropy.huffopt import progressive_bands
    from tpuenc_torch.kernels import pipeline

    config = progressive_encoder(dev)._config()
    luma = pipeline.fn_cm(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config,
                          params.reciprocals, params.corrections)[0]
    Bp = -(-luma.shape[1] // 512) * 512
    return luma, Bp, tuple(progressive_bands(config.progressive_scans))


def acband_hist_cases(params, luma, Bp, bands):
    """Phase 3's K6 and K7 cases on the progressive luma stream: yields
    ``(key, kernel, plain, read_bytes)``.  K6 at block budgets 16 (the
    flagship's), 48 and 224 (a tile past the default 48 KB of shared
    memory); K7 on the same bands."""
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.entropy import pallas_pack as pk

    for bb in (16, 48, 224):
        yield f"K6 pack_acbands budget {bb}", \
            lambda bb=bb: pk.pack_acbands(luma, bands, params.ac, 0, Bp, bb), \
            lambda bb=bb: pk.pack_acbands_ref(luma, bands, params.ac, 0, Bp,
                                              bb), \
            nbytes(luma, params.ac[0])
    yield "K7 hist_count", lambda: ph.hist_count(luma, bands), \
        lambda: ph.hist_count_ref(luma, bands), nbytes(luma)


def uhd_inputs(dev):
    """BASELINE.md's "4:2:0 restart64 4K" scan (3840x2160 q80): its
    params, spec, quantizer pattern, (64, B) samples and coefficients, and
    Bp."""
    from tpuenc_torch import params_from_numpy
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType, EncoderConfig, SamplingFactor
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.kernels import pipeline

    config = EncoderConfig(quality=80, sampling_factor=SamplingFactor.F_2_2,
                           restart_interval=64)
    q_tables = [quantization_table("default", 80, True),
                quantization_table("default", 80, False)]
    huffman = [list(p) for p in default_tables()]
    params = params_from_numpy(q_tables, *de.tables_to_arrays(huffman), dev)
    px = torch.from_numpy(make_rgb(UHD_W, UHD_H)).to(dev)
    layout = pipeline.scan_layout(UHD_W, UHD_H, ColorType.RGB, config)
    ((_, spec, _),) = de.build_scan_plan(layout, layout["components"], config)
    samples = pipeline.fn_cm_samples(px, UHD_W, UHD_H, ColorType.RGB, config)
    (stream,) = pipeline.fn_cm(px, UHD_W, UHD_H, ColorType.RGB, config,
                               params.reciprocals, params.corrections)
    Bp = -(-samples.shape[1] // 512) * 512
    return params, spec, de.qtab_pattern(layout), samples, stream, Bp


# The no-P3 shape of K5 at the whole-image limit (api.py's 3,000,000
# blocks): P2's 128 x n2 rows, n2 = ceil(ceil(Bp / 128) / 256) = 92, of
# its rung-5 cap, each row 256 blocks of 109-146 bits (the flagship's mean
# at rung 5 is 137); 2% of the rows empty.
NO_P3_ROWS = 128 * 92


def no_p3_rows(dev, seed=7):
    """Synthetic P2 rows of the no-P3 shape, made on the card from
    ``seed``: (rows int32 (R, W) zero past their lengths, bits int32
    (R,))."""
    from tpuenc_torch.entropy import pallas_pack as pk

    W = pk.chunk_caps(pk.final_block_cap(16), 256, 5)[-1]
    g = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(256 * 109, 256 * 146, (NO_P3_ROWS,), generator=g,
                         device=dev, dtype=torch.int32).clamp(max=32 * W)
    bits[torch.rand(NO_P3_ROWS, generator=g, device=dev) < 0.02] = 0
    words = torch.randint(-2**31, 2**31, (NO_P3_ROWS, W), generator=g,
                          device=dev, dtype=torch.int64)
    have = (bits[:, None].to(torch.int64)
            - 32 * torch.arange(W, device=dev)[None, :]).clamp(0, 32)
    keep = torch.where(have >= 32, 0xFFFFFFFF, ((1 << have) - 1) << (32 - have))
    rows = (words & keep).to(torch.int32)
    return rows, bits


def fused_concat_cases(dev, params, spec, stream, dcdiff, Bp, px, layout,
                       config, log=print):
    """Phase 3's K8 and K5 cases: yields ``(key, kernel, plain,
    read_bytes, split)`` in order.  K8 on the flagship's interleaved
    samples at block budgets 16 and 48 and on the 4K 4:2:0 restart-64
    scan at 16, ``split`` giving K1 -> DC differences -> K2 of the same
    blocks; K5 on K4's rows at budget rungs 5 and 16, and on synthetic
    rows of the no-P3 shape (``no_p3_rows``); ``split`` None.  Each
    input's shape goes to ``log``."""
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline

    tables = nbytes(params.dc, params.ac)
    quant = nbytes(params.reciprocals, params.corrections)
    samples = pipeline.fn_cm_samples(px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB,
                                     config)
    qtabs = de.qtab_pattern(layout)
    for bb in (16, 48):
        args = (samples, spec, qtabs, params.reciprocals, params.corrections,
                params.dc, params.ac, Bp, bb)
        yield f"K8 fused_sample_pack budget {bb}", \
            lambda a=args: pk.fused_sample_pack(*a), \
            lambda a=args: pk.fused_sample_pack_ref(*a), \
            nbytes(samples) + quant + tables, \
            lambda bb=bb: pk.pack_blocks(stream, dcdiff, params.dc, params.ac,
                                         spec, Bp, bb)

    # The 4K 4:2:0 image with restart interval 64: 384-block segments
    # whose starts fall inside thread blocks and on their edges.
    uparams, uspec, uqtabs, usamples, ustream, uBp = uhd_inputs(dev)
    log(f"  4K 4:2:0 stream: {usamples.shape[1]} blocks, padded to {uBp}, "
          f"pattern {len(uqtabs)}, segments of {uspec.seg_blocks} blocks")
    uargs = (usamples, uspec, uqtabs, uparams.reciprocals,
             uparams.corrections, uparams.dc, uparams.ac, uBp, 16)
    yield "K8 fused_sample_pack 4K 4:2:0 restart 64 budget 16", \
        lambda: pk.fused_sample_pack(*uargs), \
        lambda: pk.fused_sample_pack_ref(*uargs), \
        nbytes(usamples) + quant + tables, \
        lambda: pk.scan_pack_blocks(ustream, uspec, uparams.dc, uparams.ac, 16)

    # K5 on K4's rows: P2 and P3 of the rung's plan on K2's strings at
    # block budget max(rung, 16) = 16.
    words, lens, _ = pk.pack_blocks(stream, dcdiff, params.dc, params.ac, spec,
                                    Bp, 16)
    n_sub = 128
    for rung in (5, 16):
        chunk, n2, caps, caps_f = pk.merge_plan(Bp, words.shape[1], rung, n_sub)
        rows, row_bits, _ = pk.merge_chunks(words, lens, chunk, n_sub * n2,
                                            caps, caps[-1])
        frows, fbits, _ = pk.fold_rows(rows, row_bits, n2, n_sub, caps_f,
                                       caps_f[-1])
        pos = torch.cumsum(fbits.to(torch.int64), 0) - fbits
        capW = -(-(n_sub * caps_f[-1] + caps_f[-1] + 256) // 128) * 128
        args = (frows, pos, fbits, capW)
        yield f"K5 concat_rows rung {rung}", \
            lambda a=args: pk.concat_rows(*a), \
            lambda a=args: pk.concat_rows_ref(*a), \
            string_bytes(fbits) + nbytes(pos, fbits), None

    rows, bits = no_p3_rows(dev)
    R, W = rows.shape
    pos = torch.cumsum(bits.to(torch.int64), 0) - bits
    capW = -(-(R * W + W + 256) // 128) * 128
    log(f"  K5 no-P3 shape: {R} rows of {W} words, capW {capW}")
    args = (rows, pos, bits, capW)
    yield f"K5 concat_rows no-P3 {R} rows", \
        lambda: pk.concat_rows(*args), \
        lambda: pk.concat_rows_ref(*args), \
        string_bytes(bits) + nbytes(pos, bits), None


def phase_kernels(dev):
    """Each kernel against its plain version on the flagship's tensors."""
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pallas_fdct, pipeline
    from tpuenc_torch.kernels.color_convert import to_planes

    params, spec, stream, dcdiff, Bp, px, layout, config = flagship_inputs(dev)
    results = {}

    def check(key, kernel, plain, read_bytes, reps=10):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{key}: kernel differs from plain, max |err| {err}")
        ms = cuda_ms(kernel, reps)
        device_ms = cuda_ms(kernel, reps, queued=True)
        plain_ms = cuda_ms(plain, reps)
        bound = bound_ms(read_bytes, got)
        pr4 = PR4_MS.get(key)
        before = REPLACED_DEVICE_MS.get(key)
        print(f"  {key:44s} max|err| {err}  kernel {ms:9.4f} ms"
              + (f" (PR 4 {pr4} ms)" if pr4 else "")
              + f"  plain {plain_ms:9.4f} ms ({plain_ms / ms:.1f}x)"
              f"  device {device_ms:9.4f} ms"
              + (f" (before {before} ms)" if before else "")
              + f"  bound {bound:8.5f} ms ({bound / device_ms:.1%} of device)")
        results[key] = {"err": err, "ms": ms, "device_ms": device_ms,
                        "plain_ms": plain_ms, "bound": bound}
        return got

    def same_as_split(key, got, split):
        err = max_abs_err(got, split)
        if err != 0:
            raise AssertionError(f"{key}: K8 differs from K1 -> K2, max |err| {err}")
        print(f"  {key}: equal to K1 -> DC differences -> K2")

    # K1 on the luma plane's (64, 56,250) blocks, as fn_cm launches it.
    y = to_planes(px, ColorType.RGB)[0]
    x_cm = pipeline._blockify_cm(y, 1, 1)
    r, c = params.reciprocals[0], params.corrections[0]
    check("K1 fdct_quantize",
          lambda: pallas_fdct.fdct_quantize(x_cm, r, c),
          lambda: pallas_fdct.fdct_quantize_ref(x_cm, r, c),
          nbytes(x_cm, r, c))

    print(f"  flagship stream: {stream.shape[1]} blocks, padded to {Bp}")
    strings = {}
    for key, kernel, plain, read_bytes in p1_merge_cases(params, spec, stream,
                                                         dcdiff, Bp):
        got = check(key, kernel, plain, read_bytes)
        if key.startswith("K2"):
            strings[int(key.split()[-1])] = got

    # The merge plans of K3/K4's rungs.
    n_sub = 128
    for rung in (5, 16, 48):
        capB = strings[max(rung, 16)][0].shape[1]
        chunk, n2, caps, caps_f = pk.merge_plan(Bp, capB, rung, n_sub)
        print(f"  rung {rung}: capB {capB}, chunk {chunk}, n2 {n2}, "
              f"P2 cap {caps[-1]}, P3 cap {caps_f[-1]}")

    n_ac = max(spec.ac_tab_pattern) + 1
    for key, kernel, plain, read_bytes, split in fused_concat_cases(
            dev, params, spec, stream, dcdiff, Bp, px, layout, config):
        got = check(key, kernel, plain, read_bytes)
        if split is not None:
            same_as_split(key, got, split())
            capB = got[0].shape[1]
            print(f"  {key}: dynamic shared memory "
                  f"{4 * (256 * n_ac + 128 + 128 * capB)} bytes "
                  f"({n_ac} AC tables, 128 DC entries, tile 128 x {capB} "
                  f"words)")

    # K6, K7, K9 on the progressive flagship's luma stream.
    luma, Bp, bands = progressive_luma(dev, params, px)
    print(f"  progressive luma stream: {luma.shape[1]} blocks, padded to {Bp}, "
          f"bands {bands}")
    for key, kernel, plain, read_bytes in acband_hist_cases(params, luma, Bp,
                                                            bands):
        got = check(key, kernel, plain, read_bytes)
        if key.startswith("K6"):
            cap_f = got[0].shape[2]
            smem = 4 * (256 + len(bands) * K6_ROWS * cap_f) + 2 * 64 * K6_ROWS
            print(f"  {key}: cap_f {cap_f}, overflow {int(got[2].item())}, "
                  f"dynamic shared memory {smem} bytes (AC table, 64 x "
                  f"{K6_ROWS} coefficients, tile {len(bands)} x {K6_ROWS} x "
                  f"{cap_f} words)")
    check("K9 hist_sym", lambda: ph.hist_sym(luma, 1, 64, Bp),
          lambda: ph.hist_sym_ref(luma, 1, 64, Bp), nbytes(luma))
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


def stage_times(dev, rgb, budget, fused=False):
    """Device ms of each stage of one interleaved flagship encode, split
    (K1 x3, K2) or ``fused`` (K8) (CUDA events, median of 10), and the
    host finish in ms (host clock)."""
    from tpuenc_torch import Encoder
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType
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
    shape = (px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    st = {}
    st["h2d pixels"] = cuda_ms(lambda: host.to(dev))
    if fused:
        qtabs = de.qtab_pattern(layout)
        st["samples (color, pad, blockify, MCU order)"] = cuda_ms(
            lambda: pipeline.fn_cm_samples(*shape))
        samples = pipeline.fn_cm_samples(*shape)
        st["P1: K8"] = cuda_ms(lambda: pk.fused_sample_pack_blocks(
            samples, spec, qtabs, params, budget))
        words, lens, _ = pk.fused_sample_pack_blocks(samples, spec, qtabs,
                                                     params, budget)

        def pack():
            return de._pack_fused(samples, spec, qtabs, params, budget)
    else:
        coeffs = (*shape, params.reciprocals, params.corrections)
        st["coefficients (color, pad, blockify, K1 x3, MCU order)"] = cuda_ms(
            lambda: pipeline.fn_cm(*coeffs))
        (stream,) = pipeline.fn_cm(*coeffs)
        st["P1: DC diffs + K2"] = cuda_ms(
            lambda: pk.scan_pack_blocks(stream, spec, params.dc, params.ac,
                                        budget))
        words, lens, _ = pk.scan_pack_blocks(stream, spec, params.dc,
                                             params.ac, budget)
        plan = [(0, spec, None)]

        def pack():
            return de._pack_scans_v2((stream,), plan, params, budget)
    st["P2-P4: K3 + K4 + K5"] = cuda_ms(
        lambda: pk.merge_pack_stream(words, lens, budget))
    st["pack + meta (P1-P4, seg bits)"] = cuda_ms(pack)
    buf, meta = pack()
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
            pk.fused_sample_pack, ph.hist_sym]


def drive(enc, rgb, required, absent=(), path="device-v2"):
    """One encode of ``rgb`` with every launch count set to 0 just before
    it; returns (bytes, {wrapper name: launches}) and checks that it ran
    on ``path``, that each ``required`` wrapper launched and that each
    ``absent`` one did not."""
    from tpuenc_torch import ColorType

    counted = counted_kernels()
    for fn in counted:
        fn.launches = 0
    out = enc.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"  {len(out)} bytes, path {enc.last_encode_path}, budget rung "
          f"{enc.last_budget}, launches {launches}")
    if enc.last_encode_path != path:
        raise AssertionError(f"encode ran on {enc.last_encode_path}, want {path}")
    idle = [k for k in required if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the path: {idle}")
    extra = [k for k in absent if launches[k] != 0]
    if extra:
        raise AssertionError(f"kernels launched off the path: {extra}")
    if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
        raise AssertionError("output is not a JPEG stream")
    return out, launches


def e2e(enc, rgb, label=""):
    from tpuenc_torch import ColorType

    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        enc.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    mp = FLAGSHIP_W * FLAGSHIP_H / 1e6
    print(f"  e2e{label} (host pixels -> bytes, warm, median of 7): "
          f"{med * 1e3:.3f} ms = {mp / med:.1f} MP/s "
          f"(runs ms: {' '.join(f'{t * 1e3:.3f}' for t in times)})")


def phase_flagship(dev):
    from tpuenc_torch import ColorType, Encoder

    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    enc = Encoder(90, device=dev)
    out, launches = drive(enc, rgb, ["fdct_quantize", "pack_blocks",
                                     "merge_chunks", "fold_rows",
                                     "concat_rows"],
                          absent=["fused_sample_pack"])
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
    return launches, out, enc.last_budget


def phase_fused(dev, want, rung):
    """The interleaved flagship through K8: the budget ladder learns its
    rung afresh, and the bytes and the rung must be phase 5's."""
    from tpuenc_torch import Encoder
    from tpuenc_torch.entropy import device_encode as de

    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    de._budget_memo.clear()
    enc = Encoder(90, device=dev, fused_p1=True)
    out, launches = drive(enc, rgb, ["fused_sample_pack", "merge_chunks",
                                     "fold_rows", "concat_rows"],
                          absent=["fdct_quantize", "pack_blocks"],
                          path="device-v2-fused")
    if out != want:
        raise AssertionError("fused flagship bytes differ from phase 5's")
    if enc.last_budget != rung:
        raise AssertionError(f"fused rung {enc.last_budget}, phase 5's {rung}")
    print(f"  bytes == phase 5's (== the CPU path's), rung {rung} == phase 5's")
    split = Encoder(90, device=dev)
    for e, label in ((split, " split"), (enc, " fused"), (enc, " fused"),
                     (split, " split")):
        e2e(e, rgb, label)
    stage_times(dev, rgb, enc.last_budget, fused=True)
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
        absent=["pack_blocks", "hist_sym", "fused_sample_pack"])
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
    ("K8 fused_sample_pack", "fused_sample_pack",
     "K8 fused_sample_pack budget 16", "tpuenc_torch/csrc/fused_sample_pack.cu",
     "tpuenc/entropy/pallas_pack.py:1703"),
    ("K9 hist_sym", "hist_sym", "K9 hist_sym",
     "tpuenc_torch/csrc/hist_sym.cu", "tpuenc/entropy/pallas_hist.py:44"),
]


def main():
    dev = torch.device("cuda:0")
    flagship = {}

    def phase_5():
        launches, flagship["bytes"], flagship["rung"] = phase_flagship(dev)
        return launches

    phases = [("1. environment", phase_env), ("2. build", phase_build),
              ("3. kernels vs plain versions (flagship shapes, tolerance 0)",
               lambda: phase_kernels(dev)),
              ("4. fixtures", lambda: phase_fixtures(dev)),
              ("5. flagship, interleaved", phase_5),
              ("6. flagship, progressive with optimized tables",
               lambda: phase_progressive(dev)),
              ("7. flagship, interleaved, fused P1 (K8)",
               lambda: phase_fused(dev, flagship["bytes"], flagship["rung"]))]
    out = {}
    for title, fn in phases:
        print(f"== {title}")
        t0 = time.perf_counter()
        out[title] = fn()
        if title.startswith("3."):
            tests_only = {k.__name__: k.launches for k in counted_kernels()}
        print(f"   ({time.perf_counter() - t0:.2f} s)")
    results = out[phases[2][0]]
    paths = {"interleaved": out[phases[4][0]],
             "progressive_optimized": out[phases[5][0]],
             "interleaved_fused": out[phases[6][0]]}

    kernels = []
    for name, counter, key, source, replaces in KERNELS:
        r = results[key]
        errs = [v["err"] for k, v in results.items() if k.startswith(name)]
        by_path = {p: n[counter] for p, n in paths.items() if n[counter]}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            # ms and plain_ms: the call with the card idle, the wrapper's
            # host time in it, as the caller sees it; device_ms: the kernel
            # and its wrapper's small fills alone (cuda_ms queued).
            "max_abs_err": max(errs), "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            # Integer work, no matrix product: the bytes bound it.
            "bound_ms": r["bound"], "bound_by": "bytes",
            # No single PyTorch call computes any of these functions.
            "library_ms": None,
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
