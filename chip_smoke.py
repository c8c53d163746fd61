"""Drive tpuenc_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing its own lines and its wall seconds:

1. environment: the card (nvidia-smi name and power limit), torch, nvcc;
   no CUDA device is an error;
2. build the CUDA kernels from ``tpuenc_torch/csrc`` (one nvcc per source,
   all started together) and time the build; beside it, ``nvcc -Xptxas -v``
   reports the registers, stack, spills and static shared memory of K1-K9;
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
   the K2-K4 lines also with their first designs' times and the K1 and
   K5-K9 lines with the device times of the designs they replaced, from
   PERF.md, and the kernel's bound: the bytes it must move (each input
   read once, each output written once; bit strings read only up to their
   lengths) over the H100's 3.35 TB/s, with its share of the device time;
4. the 26 frozen fixtures encoded on the card, byte for byte;
5. the interleaved flagship, ``Encoder(90, device="cuda").encode(rgb,
   2000, 1800, ColorType.RGB)``: the same bytes as the CPU path, K1-K5
   launched, the budget rung, warm end-to-end MP/s (median of 7) and
   per-stage times, the host finish in its three steps (a) the pageable
   D2H of the stream, (b) big-endian bytes per scan, (c) the native
   realigner per scan (host clock, median of 5; also in phases 6 and 7);
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
   fused, fused, split), and per-stage times;
8. ``encode_batch`` on each of its routes, the budget memo cleared before
   each case: (a) 8 flagship images (``make_rgb`` seeds 42-49) on the
   single program, image 0 equal to phase 5's bytes, K1 launched 3 times
   per batch, K2, K3 and K5 once per rung tried and K4 once per rung whose
   merge folds, its per-stage times (its upload beside one staged in
   page-locked memory); (b) BASELINE.md's config 1, 16 x 512x512 RGB q90,
   on the single program; (c) 4 flagship images in progressive mode, image
   by image (K6 per image); (d) 4 flagship images with ``fused_p1=True``
   and restart interval 64 (which does not divide 56,250 MCUs), image by
   image through K8, equal to the split encoder's files; (e) BASELINE.md's
   config 3, 2 x 3840x2160 with optimized tables, image by image (K7).
   Each case: every file equal to its own ``encode`` on the card, the
   route's kernels launched and no other, the peak device memory of its
   first batch, warm MP/s (median of 5) in turns with a loop of per-image
   encodes (batch, loop, loop, batch), and the device's busy share and
   its H2D / D2H copies over one batch (``torch.profiler``).  Then the
   kernels at the shapes no earlier phase gives them, against their plain
   versions as in phase 3: K1 on (a)'s and (b)'s luma blocks, K2, K3, K4
   (where the plan folds) and K5 at (a)'s and (b)'s rungs over the whole
   batch, and K7 on one of (e)'s 4K luma streams.

9. bounded memory and streaming, at BASELINE config 5 (16384x16384
   CMYK_AS_YCCK, q90, 4:2:0; ``make_ycck_rows``): (a) ``encode`` on the
   chunked path, its rung, launches (K1 4 per chunk, K2, K3 and K5 once
   per chunk and rung, K4 where the chunk's merge folds), warm MP/s
   (median of 3), the stages of one encode beside its wall time, and peak
   device memory; (b) ``encode_stream`` from a pull source at 37 MCU rows a
   chunk, its pieces equal to (a)'s bytes, and again in a child process
   that makes the rows on demand and reports its peak RSS growth; (c) the
   top 16384x4096 of the image, its peak device memory within 10% of
   (a)'s; (d) the image with optimized tables on the chunked multipass
   path (4 sequential scans, K7 on every chunk), MP/s and peak memory
   beside the coefficient store's size; (e) the chunked paths held to the
   whole-image path's bytes (phases 5 and 6, the 4K 4:2:0 restart-64
   image, ``encode`` with the block limit at 0); (f) a row source of
   CUDA tensors, (c)'s bytes with no pixel copy to the card; (g) K1, K2
   (mid-stream DC chain), K3, K4 where it folds, K5, K2 on a masked
   1,048,576-block pack chunk and K7 at the path's shapes against their
   plain versions, as phase 3;
10. the device finish (``entropy.device_stuff``), which the whole-image
   routes and the single-program batch run, beside the host finish it
   replaced, on the three flagship routes (split, fused, progressive +
   optimized): on each route's stream from phases 5-7, the host finish's
   steps (a)-(c) beside the device finish's parts (the device ms of pass 1
   and of both passes, the read of the final segment byte counts, the
   page-locked copy of the finished bytes, the split into scans, the whole
   finish, its peak memory); one
   encode on "device-v2" / "device-v2-fused" with the launch counts at 0
   just before it, its bytes and rung (budget memo cleared) equal to the
   host finish's; warm end to end in turns (host, device, device, host);
   the 26 fixtures, split and fused, each file and rung equal to the host
   finish's and to the frozen file; and the largest whole-image encode,
   13824x13824 RGB (the flagship tiled) at q90, with the finish's peak
   device memory held to its bound;
11. the striped encode over ranks (``tpuenc_torch.shard``), its ranks
   processes of their own (``tpuenc_torch.testing.dist.launch``) that
   import this file afresh: (a) BASELINE config 5 through
   ``ShardedEncoder`` over a (1, 4) gloo mesh, every rank computing on
   cuda:0 and memory-mapping phase 9's input (written once to a ``.npy``
   in the temporary directory), each rank's file equal to phase 9 (a)'s
   by sha256, per rank the stripe's upload, the coefficient, histogram
   and pack device spans, each collective (DC tails, histograms, ladder
   flags, gather), the host assembly, the rung, the peak device memory,
   the wall and MP/s (first and warm), and the synchronizing calls of the
   warm encode (``set_sync_debug_mode("warn")``); (d) the same with
   optimized tables, equal to phase 9 (d)'s file, the reduced histograms
   equal to phase 9 (d)'s single-device ones; (e) BASELINE config 1 over
   a (2, 2) mesh, 8 images a batch coordinate, each file equal to
   ``encode``'s;
   (f) the port's ``dryrun_multichip`` on the four ranks; (g) the
   interleaved flagship over a one-rank NCCL mesh on "cuda", equal to
   phase 5's bytes; (h) config 5 (a) over a (1, 2) gloo mesh, two ranks on
   cuda:0, a 16384x8192 stripe of 5,242,880 blocks each (past the
   whole-image limits), each rank's file equal to phase 9 (a)'s, with (a)'s
   per-rank records and the counts of the kept rung; (i) on (e)'s ranks,
   what ``ShardedEncoder`` inherits from ``Encoder``: ``encode_batch`` of 3
   config-1 images (``Encoder.encode_batch``'s files and route),
   ``encode_image`` (RGB planes) and ``encode_stream`` of the flagship
   (phase 5's bytes), and ``encode_batch_sharded`` of 4 config-1 images
   (``encode``'s files); then K1, K2 (stripe 1, its DC chain from stripe
   0's tail), K3, K4, K5 and K7 at the (1, 4) stripes' shapes, and K1, K2
   and K3-K5 at (h)'s, against their plain versions, as phase 3, with
   (h)'s counts beside their widths (int32 or int64) and headroom.  The
   ranks share one card: no figure of phase 11 is a scaling figure.

It prints a JSON line of the kernels (with every shape each was checked
at), the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  Any failure raises, so the exit code is not 0 and no result
line is printed.  ``kernel_ab.py`` holds
K2-K8 against another checkout's on one card.
"""

import contextlib
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
            if spin > SPIN_CYCLES << 10:
                raise RuntimeError("a queued timing waited on the card: "
                                   "the timed function synchronises")
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
                  "fused_sample_pack.cu", "hist_sym.cu")


def phase_build():
    """The library build, and beside it one ``-Xptxas -v`` compile of each
    of K1-K9 for their registers, stack, spills and static shared memory
    (K2's, K6's, K8's and K9's tiles and K3/K4's prefix are dynamic shared
    memory, sized at launch, which ptxas does not see; phase 3 prints K6's
    and K8's)."""
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
# row to device memory; K6 walking the slots once per band), K7 (a walk
# per band, a shared atomic per symbol), K1 and K9 (one thread per block,
# K1 with its 64 samples in registers, K9 over all 64 slots with 1-byte
# stores) replaced, from PERF.md section 6: the measure of phase 3's device
# time (``cuda_ms`` queued), NVIDIA H100 80GB HBM3 at 700 W (K1 and K9: the
# mean of the replaced design's two turns of ``kernel_ab.py``).
REPLACED_DEVICE_MS = {
    "K1 fdct_quantize": "0.0131",
    "K1 fdct_quantize batch (a)": "0.0687",
    "K1 fdct_quantize batch (b)": "0.0117",
    "K1 fdct_quantize config 5 chunk": "0.0434",
    "K5 concat_rows rung 5": "0.0140",
    "K5 concat_rows rung 16": "0.0170",
    "K6 pack_acbands budget 16": "0.0681",
    "K6 pack_acbands budget 48": "0.1054",
    "K7 hist_count": "0.0210",
    "K8 fused_sample_pack budget 16": "0.0839",
    "K8 fused_sample_pack budget 48": "0.1901",
    "K8 fused_sample_pack 4K 4:2:0 restart 64 budget 16": "0.0982",
    "K9 hist_sym": "0.0124",
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
    from tpuenc_torch.plan import make_plan

    config = EncoderConfig(quality=90)
    q_tables = [quantization_table("default", 90, True),
                quantization_table("default", 90, False)]
    huffman = [list(p) for p in default_tables()]
    params = params_from_numpy(q_tables, *de.tables_to_arrays(huffman), dev)
    px = torch.from_numpy(make_rgb(FLAGSHIP_W, FLAGSHIP_H)).to(dev)
    plan = make_plan(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    layout, ((_, spec, _),) = plan.layout, plan.scans
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


def k1_case(key, x_cm, params):
    """A K1 case on the luma table: ``(key, kernel, plain, read_bytes)``
    for ``x_cm`` int32 (64, B), as phase 3, 8 and 9 and ``kernel_ab.py``
    time it."""
    from tpuenc_torch.kernels import pallas_fdct

    r, c = params.reciprocals[0], params.corrections[0]
    return key, lambda: pallas_fdct.fdct_quantize(x_cm, r, c), \
        lambda: pallas_fdct.fdct_quantize_ref(x_cm, r, c), nbytes(x_cm, r, c)


def flagship_luma(px):
    """The flagship's luma plane as K1's (64, 56,250) input, as fn_cm
    launches it."""
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.kernels.color_convert import to_planes

    return pipeline._blockify_cm(to_planes(px, ColorType.RGB)[0], 1, 1)


def batch_luma(enc, px, w, h):
    """The single program's K1 input for the batch's luma blocks."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.kernels import pipeline

    return pipeline._sample_streams(px, w, h, ColorType.RGB, enc._config(),
                                    batched=True)[3][0]


def config5_chunk_y(dev, rows_px):
    """K1's input for the Y blocks of one config-5 chunk (64 MCU rows)."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.kernels import pipeline

    h = rows_px.shape[0]
    return pipeline._sample_streams(rows_px, CONFIG5, h, ColorType.CMYK_AS_YCCK,
                                    config5_encoder(dev)._config())[3][0]


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
    """Phase 3's K6, K7 and K9 cases on the progressive luma stream: yields
    ``(key, kernel, plain, read_bytes)``.  K6 at block budgets 16 (the
    flagship's), 48 and 224 (a tile past the default 48 KB of shared
    memory); K7 on the same bands; K9 on the band (1, 64), Lp = Bp."""
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
    yield "K9 hist_sym", lambda: ph.hist_sym(luma, 1, 64, Bp), \
        lambda: ph.hist_sym_ref(luma, 1, 64, Bp), nbytes(luma)


def uhd_inputs(dev):
    """BASELINE.md's "4:2:0 restart64 4K" scan (3840x2160 q80): its
    params, spec, quantizer pattern, (64, B) samples and coefficients, and
    Bp."""
    from tpuenc_torch import params_from_numpy
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType, EncoderConfig, SamplingFactor
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.plan import make_plan

    config = EncoderConfig(quality=80, sampling_factor=SamplingFactor.F_2_2,
                           restart_interval=64)
    q_tables = [quantization_table("default", 80, True),
                quantization_table("default", 80, False)]
    huffman = [list(p) for p in default_tables()]
    params = params_from_numpy(q_tables, *de.tables_to_arrays(huffman), dev)
    px = torch.from_numpy(make_rgb(UHD_W, UHD_H)).to(dev)
    plan = make_plan(UHD_W, UHD_H, ColorType.RGB, config)
    ((_, spec, _),) = plan.scans
    samples = pipeline.fn_cm_samples(px, UHD_W, UHD_H, ColorType.RGB, config)
    (stream,) = pipeline.fn_cm(px, UHD_W, UHD_H, ColorType.RGB, config,
                               params.reciprocals, params.corrections)
    Bp = -(-samples.shape[1] // 512) * 512
    return params, spec, de.qtab_pattern(plan.layout), samples, stream, Bp


# The no-P3 shape of K5 at the whole-image limit (plan.py's 3,000,000
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


def check_kernel(results, key, kernel, plain, read_bytes, reps=10):
    """One kernel case: the kernel's output against its plain version's
    (tolerance 0), its time and device time, the plain version's time and
    the bound, printed and kept in ``results[key]``.  Returns the
    kernel's output."""
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
          + (f" (first design {pr4} ms)" if pr4 else "")
          + f"  plain {plain_ms:9.4f} ms ({plain_ms / ms:.1f}x)"
          f"  device {device_ms:9.4f} ms"
          + (f" (before {before} ms)" if before else "")
          + f"  bound {bound:8.5f} ms ({bound / device_ms:.1%} of device)")
    results[key] = {"err": err, "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound": bound}
    return got


def phase_kernels(dev):
    """Each kernel against its plain version on the flagship's tensors."""
    from tpuenc_torch.entropy import pallas_pack as pk

    params, spec, stream, dcdiff, Bp, px, layout, config = flagship_inputs(dev)
    results = {}

    def check(*case):
        return check_kernel(results, *case)

    def same_as_split(key, got, split):
        err = max_abs_err(got, split)
        if err != 0:
            raise AssertionError(f"{key}: K8 differs from K1 -> K2, max |err| {err}")
        print(f"  {key}: equal to K1 -> DC differences -> K2")

    # K1 on the luma plane's (64, 56,250) blocks, as fn_cm launches it.
    check(*k1_case("K1 fdct_quantize", flagship_luma(px), params))

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
    host finish's three steps in ms (:func:`host_finish_parts`).  Returns
    the finish's inputs, (stream words, meta, meta on the host, scans,
    segments per scan)."""
    from tpuenc_torch import Encoder
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.plan import make_plan

    config = Encoder(90, device=dev)._config()
    q_tables = [quantization_table("default", 90, True),
                quantization_table("default", 90, False)]
    huffman = [list(p) for p in default_tables()]
    params = de.params_from_numpy(q_tables, *de.tables_to_arrays(huffman), dev)
    plan = make_plan(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    ((_, spec, _),) = plan.scans
    host = torch.from_numpy(rgb)
    px = host.to(dev)
    shape = (px, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    st = {}
    st["h2d pixels"] = cuda_ms(lambda: host.to(dev))
    if fused:
        qtabs = de.qtab_pattern(plan.layout)
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
    finish = (buf, meta, meta.cpu().numpy(), 1, [1])
    st.update(host_finish_parts(*finish)[0])
    for k, v in st.items():
        print(f"  {k:50s} {v:9.4f} ms")
    return finish


def host_median(fn, reps=5):
    """Median host-clock seconds of ``reps`` warm calls of ``fn``, each
    ended by a synchronise, and the runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def host_finish_parts(buf, meta, meta_np, n_scans, seg_structure):
    """The host finish (``device_encode._finish_scans_v2``) in its three
    steps, each summed over the scans, on the host clock, median of 5
    warm runs: (a) the pageable copy of the stream's used words, (b) each
    scan's words to big-endian bytes, (c) ``native.realign_segments`` per
    scan (``os.cpu_count()`` threads, started per call).  Checks that the
    steps give ``_finish_scans_v2``'s bytes; returns ({step: ms}, the
    scans' bytes)."""
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import native

    scan_bits = meta_np[1:1 + n_scans]
    seg_bits = meta_np[1 + n_scans:].astype(np.int64)
    total_words = (int(scan_bits.sum()) + 31) >> 5
    runs = {"a": [], "b": [], "c": []}
    for _ in range(6):
        t0 = time.perf_counter()
        w = buf[:total_words].cpu().numpy().view(np.uint32)
        runs["a"].append(time.perf_counter() - t0)
        scans, tb, tc = [], 0.0, 0.0
        bit_off = seg_off = 0
        for i in range(n_scans):
            segs = seg_bits[seg_off:seg_off + seg_structure[i]]
            seg_off += seg_structure[i]
            bits = int(scan_bits[i])
            t0 = time.perf_counter()
            data = w[bit_off >> 5:(bit_off + bits + 31) >> 5]
            data = data.astype(">u4").tobytes()
            t1 = time.perf_counter()
            scans.append(native.realign_segments(data, segs,
                                                 bit_offset=bit_off & 31))
            tc += time.perf_counter() - t1
            tb += t1 - t0
            bit_off += bits
        runs["b"].append(tb)
        runs["c"].append(tc)
    if scans != de._finish_scans_v2(buf, seg_bits, seg_structure):
        raise AssertionError("the host finish's steps differ from the finish")
    ms = {k: statistics.median(v[1:]) * 1e3 for k, v in runs.items()}
    return {"host (a): pageable D2H of the stream (host clock)": ms["a"],
            f"host (b): big-endian bytes x{n_scans} (host clock)": ms["b"],
            f"host (c): native realign/stuff x{n_scans} (host clock)": ms["c"],
            "host finish, (a) + (b) + (c)": sum(ms.values())}, scans


def device_finish_parts(buf, meta, meta_np, n_scans, seg_structure, want):
    """The device finish (``device_encode._finish_scans_device``) in its
    parts: the device ms (CUDA events, median of 10, with the card idle
    and queued behind a spin) of pass 1 alone (``entropy.device_stuff``'s
    ``realign`` over every window) and of both passes with the markers
    (``device_stuff``); then on the host clock (median of 5): both passes
    and the read of the (S,) final segment byte counts, that read alone,
    the copy of the ``total`` finished bytes into page-locked memory, the
    split into scans, and the whole finish.  Checks its bytes against
    ``want``, the host finish's, and prints the finish's peak device
    memory beside its output's size; returns {part: ms}."""
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import device_stuff as ds

    seg_bits, host_bits = meta[1 + n_scans:], meta_np[1 + n_scans:]
    n1 = int(((host_bits + 7) >> 3).sum())
    tables = ds.segment_tables(seg_bits)[1:]

    def pass1():
        for j0 in range(0, n1, ds._WINDOW):
            ds.realign(buf, *tables, j0, min(n1, j0 + ds._WINDOW))

    def passes():
        return ds.device_stuff(buf, seg_bits, seg_structure, host_bits)

    passes()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    passes()
    torch.cuda.set_sync_debug_mode("default")
    print("  the passes enqueue without waiting for the card "
          "(torch.cuda.set_sync_debug_mode)")

    windows = -(-n1 // ds._WINDOW)
    pinned = de.PinnedBuffer()
    st = {}
    st[f"pass 1: realign, {windows} windows (events, card idle)"] = cuda_ms(
        pass1)
    st["pass 1: realign (device, queued)"] = cuda_ms(pass1, queued=True)
    st["passes 1 + 2 + markers (events, card idle)"] = cuda_ms(passes)
    st["passes 1 + 2 + markers (device, queued)"] = cuda_ms(passes,
                                                            queued=True)

    def passes_and_read():
        out, seg_out, _ = passes()
        return out, seg_out.cpu().numpy()

    st["passes + read of seg_out_bytes (host clock)"] = host_median(
        passes_and_read)[0] * 1e3
    out, seg_out_np = passes_and_read()
    seg_out = torch.from_numpy(seg_out_np).to(buf.device)
    st["read of seg_out_bytes alone (host clock)"] = host_median(
        lambda: seg_out.cpu())[0] * 1e3
    total = int(seg_out_np.sum())

    def copy():
        host = pinned.take(total, torch.uint8)
        host.copy_(out[:total])
        return host.numpy()

    st[f"page-locked D2H of {total} bytes (host clock)"] = host_median(
        copy)[0] * 1e3
    data = copy()
    st["host split into scans (host clock)"] = host_median(
        lambda: de.split_scans(data, seg_out_np, seg_structure))[0] * 1e3
    finish = (buf, seg_bits, host_bits, seg_structure, pinned)
    st["device finish, whole (host clock)"] = host_median(
        lambda: de._finish_scans_device(*finish))[0] * 1e3
    del out, seg_out
    peak, scans = finish_peak(lambda: de._finish_scans_device(*finish))
    if scans != want:
        raise AssertionError("the device finish differs from the host finish")
    print(f"  {n1} realigned bytes in {len(host_bits)} segments -> "
          f"{total} finished bytes; == the host finish's bytes; peak device "
          f"memory of the finish {peak / 2**20:.1f} MiB, its output "
          f"{(2 * n1 + 2 * len(host_bits)) / 2**20:.1f} MiB")
    return st


def finish_peak(fn):
    """The device memory that ``fn`` adds at its peak, in bytes, and what
    it returns."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    result = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, result


@contextlib.contextmanager
def host_finish():
    """Every route that finishes on the device with the host finish
    (``device_encode._finish_scans_v2``) in the device finish's place,
    for phase 10's comparisons."""
    from tpuenc_torch.entropy import device_encode as de

    device = de._finish_scans_device

    def host(buf, seg_bits, host_bits, segs, pinned=None):
        return de._finish_scans_v2(buf, host_bits, segs)

    de._finish_scans_device = host
    try:
        yield
    finally:
        de._finish_scans_device = device


def counted_kernels():
    """Every kernel wrapper, with its launch counter."""
    from tpuenc_torch.tracing import kernel_wrappers

    return kernel_wrappers()


def counted(run):
    """``run()`` with every launch count set to 0 just before it; returns
    (its result, {wrapper name: launches})."""
    kernels = counted_kernels()
    for fn in kernels:
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {fn.__name__: fn.launches for fn in kernels}


def check_launches(launches, required, absent):
    idle = [k for k in required if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the path: {idle}")
    extra = [k for k in absent if launches[k] != 0]
    if extra:
        raise AssertionError(f"kernels launched off the path: {extra}")


def check_jpeg(out):
    if out[:2] != b"\xff\xd8" or out[-2:] != b"\xff\xd9":
        raise AssertionError("output is not a JPEG stream")


def drive(enc, rgb, required, absent=(), path="device-v2"):
    """One encode of ``rgb`` with every launch count set to 0 just before
    it; returns (bytes, {wrapper name: launches}) and checks that it ran
    on ``path``, that each ``required`` wrapper launched and that each
    ``absent`` one did not."""
    from tpuenc_torch import ColorType

    out, launches = counted(
        lambda: enc.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB))
    print(f"  {len(out)} bytes, path {enc.last_encode_path}, budget rung "
          f"{enc.last_budget}, launches {launches}")
    if enc.last_encode_path != path:
        raise AssertionError(f"encode ran on {enc.last_encode_path}, want {path}")
    check_launches(launches, required, absent)
    check_jpeg(out)
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
    finish = stage_times(dev, rgb, enc.last_budget)
    return launches, out, enc.last_budget, finish


def phase_fused(dev, want, rung, finishes):
    """The interleaved flagship through K8: the budget ladder learns its
    rung afresh, and the bytes and the rung must be phase 5's.  Keeps the
    finish's inputs in ``finishes["fused"]``."""
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
    finishes["fused"] = stage_times(dev, rgb, enc.last_budget, fused=True)
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
    5; the finish in its three steps, :func:`host_finish_parts`).  Returns
    the budget hint and the finish's inputs (as :func:`stage_times`)."""
    from tpuenc_torch.api import optimize_tables
    from tpuenc_torch.core.tables import default_tables, quantization_table
    from tpuenc_torch.core.types import ColorType
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.entropy.device import scan_histograms
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.plan import make_plan

    config = progressive_encoder(dev)._config()
    whole = make_plan(FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB, config)
    comps, plan = whole.components, whole.scans
    seg_structure = whole.seg_structure
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
    hint = optimize_tables(hists, huffman, whole)
    st["host: K.2 build x4 + exact bits (host clock)"] = host_times(
        lambda: optimize_tables(hists, [list(p) for p in default_tables()],
                                whole))
    params = de.EncodeParams(recip, corr, *de.huffman_params(huffman, dev))
    st["P1: DC path x3 + K6 x3 + concat"] = cuda_ms(
        lambda: de.pack_scans_p1(streams, plan, params, budget))
    W, L, _, _, _ = de.pack_scans_p1(streams, plan, params, budget)
    chunk, n2, _, caps_f = pk.merge_plan(W.shape[0], W.shape[1], budget)
    print(f"  {len(plan)} scans, {W.shape[0]} pack rows of {W.shape[1]} words, "
          f"P2 chunk {chunk}, n2 {n2}, P3 fold {caps_f is not None}")
    st["P2-P4: K3 + K4 + K5"] = cuda_ms(lambda: pk.merge_pack_stream(W, L, budget))
    buf, meta = de._pack_scans_v2(streams, plan, params, budget)
    finish = (buf, meta, meta.cpu().numpy(), len(plan), seg_structure)
    st.update(host_finish_parts(*finish)[0])
    for k, v in st.items():
        print(f"  {k:50s} {v:9.4f} ms")
    return hint, finish


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
    hint, finish = progressive_stage_times(dev, rgb, enc.last_budget)
    print(f"  budget hint {hint} words per pack row, rung {enc.last_budget}")
    return launches, out, enc.last_budget, finish


# Phase 8's BASELINE.md configurations (benchmarks/baseline_configs.py):
# config 1, 16 x 512x512 RGB q90 (:26-36), and config 3, optimized tables
# on a batch of 4K images (:59-75).
BASELINE1 = (16, 512, 512)
BASELINE3 = (2, UHD_W, UHD_H)


def batch_vs_loop(enc, loop_enc, imgs, w, h):
    """Warm MP/s of ``enc.encode_batch(imgs)`` and of a loop of
    ``loop_enc.encode`` over the same images, in turns (batch, loop,
    loop, batch), each turn the median of 5 host-clock runs."""
    from tpuenc_torch import ColorType

    runs = {"batch": lambda: enc.encode_batch(imgs, w, h, ColorType.RGB),
            "loop": lambda: [loop_enc.encode(im, w, h, ColorType.RGB)
                             for im in imgs]}
    mp = len(imgs) * w * h / 1e6
    out = {"batch": [], "loop": []}
    for turn in ("batch", "loop", "loop", "batch"):
        med, times = host_median(runs[turn])
        out[turn].append(mp / med)
        print(f"    {turn:5s} (warm, median of 5) {med * 1e3:9.3f} ms = "
              f"{mp / med:7.1f} MP/s (runs ms: "
              f"{' '.join(f'{t * 1e3:.3f}' for t in times)})")
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_timeline(run, label="tpuenc batch"):
    """One call of ``run`` under ``torch.profiler``: the device's busy
    share of the call's host span (the union of every kernel, copy and
    fill on the card over the span), its kernels, and the number and time
    of its host-to-device and device-to-host copies.  None where the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            run()
            torch.cuda.synchronize()
    events = prof.events()
    span = [e.time_range for e in events
            if e.name == label and e.device_type == DeviceType.CPU]
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and e.name != label]
    if not span or not device:
        return None
    t0, t1 = span[0].start, span[0].end
    busy = sum(max(0.0, min(t1, b) - max(t0, a))
               for a, b in _union([(a, b) for _, a, b in device]))
    out = {"span_ms": (t1 - t0) / 1e3, "busy": busy / (t1 - t0),
           "kernels": sum(1 for n, _, _ in device
                          if not n.startswith(("Memcpy", "Memset")))}
    for kind in ("HtoD", "DtoH"):
        copies = [b - a for n, a, b in device
                  if n.startswith("Memcpy") and kind in n]
        out[kind] = (len(copies), sum(copies) / 1e3)
    return out


def batch_stream(dev, enc, imgs, w, h):
    """The single program's inputs for ``imgs`` as the route makes them:
    the (N, H, W, 3) pixels uploaded image by image, the params, the
    interleaved spec with segments of the interval or of one image, the
    segments per image and the batch's MCU stream."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.plan import make_plan

    config = enc._config()
    params = enc._default_tables(config)[2]
    plan = make_plan(w, h, ColorType.RGB, config)
    layout, ((_, spec, _),) = plan.layout, plan.scans
    per_image = layout["mcu_count"] * len(layout["mcu_block_comps"])
    spec = spec._replace(seg_blocks=spec.seg_blocks or per_image)
    px = upload_pageable(dev, imgs)
    (stream,) = pipeline.fn_cm(px, w, h, ColorType.RGB, config,
                               params.reciprocals, params.corrections,
                               batched=True)
    return px, params, spec, per_image // spec.seg_blocks, stream


def upload_pageable(dev, imgs):
    """The single program's upload: each image from its pageable array
    into its slot of one (N, H, W, 3) tensor on ``dev``."""
    px = torch.empty((len(imgs), *imgs[0].shape), dtype=torch.uint8,
                     device=dev)
    for i, im in enumerate(imgs):
        px[i].copy_(torch.from_numpy(im))
    return px


def upload_staged(dev, imgs, pinned):
    """The upload it was measured against: each image copied into the
    page-locked ``pinned`` (N, H, W, 3) buffer on the host, then sent
    without blocking, so one image's copy to the card overlaps the next
    one's host copy."""
    px = torch.empty((len(imgs), *imgs[0].shape), dtype=torch.uint8,
                     device=dev)
    for i, im in enumerate(imgs):
        np.copyto(pinned[i].numpy(), im)
        px[i].copy_(pinned[i], non_blocking=True)
    return px


def batch_stage_times(dev, enc, imgs, w, h):
    """Stage times of the single-program route on ``imgs`` at its learned
    rung: the upload of the batch (the route's pageable one beside one
    staged in page-locked memory), the batch's coefficients (K1 x3), P1
    (DC differences + K2), P2-P4, pack + meta (CUDA events, median of 10),
    the meta copy, then the route's device finish of the whole batch into
    the encoder's page-locked buffer beside the host finish it replaced
    (the stream's pageable copy and the realigner image by image), each on
    the host clock (median of 5), and their bytes equal."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline

    n = len(imgs)
    budget = enc.last_budget
    px, params, spec, spi, stream = batch_stream(dev, enc, imgs, w, h)
    pinned = torch.empty(px.shape, dtype=torch.uint8, pin_memory=True)
    st = {}
    for turn in ("", " again"):
        st[f"upload: pageable, image by image (the route's){turn}"] = \
            cuda_ms(lambda: upload_pageable(dev, imgs))
        st[f"upload: staged in page-locked memory{turn}"] = cuda_ms(
            lambda: upload_staged(dev, imgs, pinned))
    coeffs = (px, w, h, ColorType.RGB, enc._config(), params.reciprocals,
              params.corrections)
    st["coefficients (color, pad, blockify, K1 x3, MCU order)"] = cuda_ms(
        lambda: pipeline.fn_cm(*coeffs, batched=True))
    st["P1: DC diffs + K2"] = cuda_ms(
        lambda: pk.scan_pack_blocks(stream, spec, params.dc, params.ac, budget))
    words, lens, _ = pk.scan_pack_blocks(stream, spec, params.dc, params.ac,
                                         budget)
    st["P2-P4: K3 + K4 + K5"] = cuda_ms(
        lambda: pk.merge_pack_stream(words, lens, budget))
    plan = [(0, spec, None)]
    st["pack + meta (P1-P4, seg bits)"] = cuda_ms(
        lambda: de._pack_scans_v2((stream,), plan, params, budget))
    buf, meta = de._pack_scans_v2((stream,), plan, params, budget)
    st["meta: D2H of the overflow flag and segment bits"] = cuda_ms(meta.cpu)
    meta_np = meta.cpu().numpy()
    seg_bits, host_bits, segs = meta[2:], meta_np[2:], [spi] * n

    def device():
        return de._finish_scans_device(buf, seg_bits, host_bits, segs,
                                       enc._pinned)

    def host():
        return de._finish_scans_v2(buf, host_bits, segs)

    st["device finish of the batch, the route's (host clock)"] = \
        host_median(device)[0] * 1e3
    st["host finish of the batch, the one replaced (host clock)"] = \
        host_median(host)[0] * 1e3
    if device() != host():
        raise AssertionError("the batch's device finish differs from the "
                             "host finish")
    for k, v in st.items():
        print(f"    {k:56s} {v:9.4f} ms")


def pack_merge_cases(params, spec, stream, budget, label, dcdiff=None,
                     valid=None, widths=None):
    """K2, K3, K4 (where the merge plan folds) and K5 on ``stream`` as
    ``_pack_scans_v2`` runs them at ``budget``, or as ``device_scan_pack``
    runs them on a chunk given its mid-stream ``dcdiff`` and ``valid``
    blocks (the strings past it zeroed before the merge): yields ``(key,
    kernel, plain, read_bytes)`` in order, each case's inputs made by the
    kernel of the case before it.  Into ``widths``, where given: the
    largest value of each count the kernels pass on, with its width."""
    def keep(key, value, width="int32"):
        if widths is not None:
            widths[key] = (int(value), width)

    from tpuenc_torch.entropy import pallas_pack as pk

    Bp = -(-stream.shape[1] // 512) * 512
    if dcdiff is None:
        dcdiff = pk.dc_diffs_from_dc(stream[0], spec)
    args = (stream.contiguous(), dcdiff, params.dc, params.ac, spec, Bp,
            max(budget, 16))
    yield f"K2 pack_blocks {label}", lambda: pk.pack_blocks(*args), \
        lambda: pk.pack_blocks_ref(*args), \
        nbytes(stream, dcdiff, params.dc, params.ac)
    words, lens, _ = pk.pack_blocks(*args)
    if valid is not None:
        live = torch.arange(Bp, device=lens.device) < valid
        lens = torch.where(live, lens, 0)
        words = torch.where(live[:, None], words, 0)
    keep("K2 lens: one block's bits", lens.max())
    n_sub = 128
    chunk, n2, caps, caps_f = pk.merge_plan(Bp, words.shape[1], budget, n_sub)
    margs = (words, lens, chunk, n_sub * n2, caps, caps[-1])
    yield f"K3 merge_chunks {label}", lambda: pk.merge_chunks(*margs), \
        lambda: pk.merge_rows_ref(*margs), string_bytes(lens) + nbytes(lens)
    rows, bits, _ = pk.merge_chunks(*margs)
    keep("K3 out_len: one P2 row's bits (K5's bits without P3)", bits.max())
    cap = caps[-1]
    if caps_f is not None:
        fargs = (rows, bits, n2, n_sub, caps_f, caps_f[-1])
        yield f"K4 fold_rows {label}", lambda: pk.fold_rows(*fargs), \
            lambda: pk.merge_rows_ref(*fargs), \
            string_bytes(bits) + nbytes(bits)
        rows, bits, _ = pk.fold_rows(*fargs)
        keep("K4 out_len: one P3 row's bits (K5's bits)", bits.max())
        cap = caps_f[-1]
    pos = torch.cumsum(bits.to(torch.int64), 0) - bits
    keep("K5 pos: the stripe's scan bits", pos[-1] + bits[-1], "int64")
    cargs = (rows, pos, bits, -(-(rows.shape[0] * cap + cap + 256) // 128) * 128)
    yield f"K5 concat_rows {label}", lambda: pk.concat_rows(*cargs), \
        lambda: pk.concat_rows_ref(*cargs), string_bytes(bits) + nbytes(pos, bits)


def batch_kernel_checks(dev, enc, imgs, w, h, results, label):
    """The single program's kernels at the batch's shapes against their
    plain versions (tolerance 0): K1 on the batch's luma blocks, then K2,
    K3, K4 (where the plan folds) and K5 at the route's rung."""
    px, params, spec, _, stream = batch_stream(dev, enc, imgs, w, h)
    luma = batch_luma(enc, px, w, h)
    print(f"  kernels at the batch's shapes: luma {luma.shape[1]} blocks, "
          f"stream {stream.shape[1]} blocks, rung {enc.last_budget}")
    check_kernel(results, *k1_case(f"K1 fdct_quantize {label}", luma, params))
    for case in pack_merge_cases(params, spec, stream, enc.last_budget, label):
        check_kernel(results, *case)


def batch_case(dev, title, make, imgs, w, h, path, required, absent,
               check=None):
    """One batch through ``make(dev).encode_batch``, the budget memo
    cleared first and every launch count set to 0 just before it: the
    route is ``path``, each ``required`` wrapper launched and each
    ``absent`` one did not, and every file equals its own ``encode`` on
    the card (``check(enc, files, launches)`` adds the case's own
    checks).  Then the peak device memory of that first batch, warm MP/s
    of the batch beside a loop of per-image encodes, and the device's
    busy share and copies over one batch (``torch.profiler``).
    Returns the encoder and the launches."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.entropy import device_encode as de

    de._budget_memo.clear()
    enc = make(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches = counted(
        lambda: enc.encode_batch(imgs, w, h, ColorType.RGB))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  ({title}) {len(imgs)} x {w}x{h}: path {enc.last_encode_path}, "
          f"budget rung {enc.last_budget}, {sum(map(len, out))} bytes, peak "
          f"device memory {peak / 2**20:.1f} MiB, launches per batch "
          f"{launches}")
    if enc.last_encode_path != path:
        raise AssertionError(f"({title}) batch ran on {enc.last_encode_path}, "
                             f"want {path}")
    check_launches(launches, required, absent)
    for f in out:
        check_jpeg(f)
    loop_enc = make(dev)
    if out != [loop_enc.encode(im, w, h, ColorType.RGB) for im in imgs]:
        raise AssertionError(f"({title}) batch differs from per-image encodes")
    print("  every file == its own encode on the card")
    if check is not None:
        check(enc, out, launches)
    batch_vs_loop(enc, loop_enc, imgs, w, h)
    tl = device_timeline(lambda: enc.encode_batch(imgs, w, h, ColorType.RGB))
    if tl is None:
        print("    device timeline: not measured (the profiler saw no "
              "device activity)")
    else:
        print(f"    device timeline of one batch ({tl['span_ms']:.3f} ms "
              f"host span, {tl['kernels']} kernels): busy {tl['busy']:.1%}; "
              + "; ".join(f"{k} {tl[k][0]} copies {tl[k][1]:.3f} ms"
                          for k in ("HtoD", "DtoH")))
    return enc, launches


def check_single_program(n_blocks):
    """The single program's launches: K1 once per component for the whole
    batch, K2, K3 and K5 once per rung tried, K4 once per rung whose
    merge plan folds."""
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk

    def check(enc, out, launches):
        # A batch climbs from a cleared memo: every rung up to its own.
        rungs = [b for b in de.BUDGET_LADDER if b <= enc.last_budget]
        Bp = -(-n_blocks // 512) * 512
        folds = sum(pk.merge_plan(Bp, pk.final_block_cap(max(b, 16)),
                                  b)[3] is not None for b in rungs)
        want = {"fdct_quantize": 3, "pack_blocks": len(rungs),
                "merge_chunks": len(rungs), "fold_rows": folds,
                "concat_rows": len(rungs)}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"single program launches {got}, want {want}")
        print(f"  {n_blocks} blocks in one P1; launches as the route's: "
              f"{want} (rungs tried {rungs})")
    return check


def phase_batch(dev, flagship_bytes):
    """``encode_batch`` on the card, on each of its two routes, and the
    kernels at the batches' shapes against their plain versions.  Returns
    ``(launches by path, kernel results)``."""
    from tpuenc_torch import ColorType, Encoder
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.kernels import pipeline

    paths = {}
    results = {}
    absent_single = ["pack_acbands", "hist_count", "fused_sample_pack",
                     "hist_sym"]
    merge = ["merge_chunks", "concat_rows"]

    # (a) 8 flagship images on the single program.
    flag = [make_rgb(FLAGSHIP_W, FLAGSHIP_H, seed=42 + i) for i in range(8)]
    single = check_single_program(8 * 3 * -(-FLAGSHIP_W // 8)
                                  * -(-FLAGSHIP_H // 8))

    def check_a(enc, out, launches):
        if out[0] != flagship_bytes:
            raise AssertionError("(a) image 0 differs from phase 5's bytes")
        print("  image 0 == phase 5's bytes (== the CPU path's)")
        single(enc, out, launches)

    enc, paths["batch_single_flagship_x8"] = batch_case(
        dev, "a", lambda d: Encoder(90, device=d), flag, FLAGSHIP_W,
        FLAGSHIP_H, "device-batch", ["fdct_quantize", "pack_blocks", *merge],
        absent_single, check_a)
    batch_stage_times(dev, enc, flag, FLAGSHIP_W, FLAGSHIP_H)
    batch_kernel_checks(dev, enc, flag, FLAGSHIP_W, FLAGSHIP_H, results,
                        "batch (a)")

    # (b) BASELINE config 1 on the single program.
    n, w, h = BASELINE1
    imgs = [make_rgb(w, h, seed=i) for i in range(n)]
    enc, paths["batch_single_baseline1_x16"] = batch_case(
        dev, "b", lambda d: Encoder(90, device=d), imgs, w, h, "device-batch",
        ["fdct_quantize", "pack_blocks", *merge], absent_single,
        check_single_program(n * (w // 8) * (h // 8) * 3))
    batch_kernel_checks(dev, enc, imgs, w, h, results, "batch (b)")

    # (c) progressive, default tables: image by image, K6 per image.
    def progressive(d):
        e = Encoder(90, device=d)
        e.set_progressive(True)
        return e

    _, paths["batch_per_image_progressive_x4"] = batch_case(
        dev, "c", progressive, flag[:4], FLAGSHIP_W, FLAGSHIP_H,
        "device-batch-per-image", ["fdct_quantize", "pack_acbands", *merge],
        ["pack_blocks", "hist_count", "fused_sample_pack", "hist_sym"])

    # (d) fused_p1 with restart interval 64, which does not divide the
    # flagship's 56,250 MCUs: image by image through K8.
    def fused(d, fused_p1=True):
        e = Encoder(90, device=d, fused_p1=fused_p1)
        e.set_restart_interval(64)
        return e

    def check_d(enc, out, launches):
        split = fused(dev, fused_p1=False)
        if out != [split.encode(im, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
                   for im in flag[:4]]:
            raise AssertionError("(d) K8 batch differs from the split encoder")
        print("  every file == the split encoder's")

    _, paths["batch_per_image_fused_x4"] = batch_case(
        dev, "d", fused, flag[:4], FLAGSHIP_W, FLAGSHIP_H,
        "device-batch-per-image", ["fused_sample_pack", *merge],
        ["fdct_quantize", "pack_blocks", "pack_acbands", "hist_count",
         "hist_sym"], check_d)

    # (e) BASELINE config 3: optimized tables, image by image.
    def optimized(d):
        e = Encoder(90, device=d)
        e.set_optimized_huffman_tables(True)
        return e

    n, w, h = BASELINE3
    imgs = [make_rgb(w, h, seed=i) for i in range(n)]
    enc, paths["batch_per_image_baseline3_x2"] = batch_case(
        dev, "e", optimized, imgs, w, h, "device-batch-per-image",
        ["fdct_quantize", "pack_blocks", "hist_count", *merge],
        ["pack_acbands", "fused_sample_pack", "hist_sym"])
    # K7 at (e)'s shape: one 4K image's luma stream, sequential band.
    config = enc._config()
    params = enc._default_tables(config)[2]
    luma = pipeline.fn_cm(torch.from_numpy(imgs[0]).to(dev), w, h,
                          ColorType.RGB, config, params.reciprocals,
                          params.corrections)[0].contiguous()
    print(f"  kernels at (e)'s shape: luma {luma.shape[1]} blocks, band (1, 64)")
    check_kernel(results, "K7 hist_count batch (e)",
                 lambda: ph.hist_count(luma, [(1, 64)]),
                 lambda: ph.hist_count_ref(luma, [(1, 64)]), nbytes(luma))
    return paths, results


# BASELINE config 5 (BASELINE.md:37; benchmarks/config5_device.py:24-51): a
# 4-component CMYK image encoded as YCCK, 16K x 16K, q90, 4:2:0 (10 blocks
# per MCU, 1,024 MCU rows, 10,485,760 blocks).  (c) and (f) take its top
# 4,096 rows.
CONFIG5 = 16384
CONFIG5_C_ROWS = 4096
CONFIG5_CHUNKS = -(-CONFIG5 // (64 * 16))  # 64 MCU rows of 16 pixel rows


def make_ycck_rows(w, h, y0, n):
    """Rows [y0, y0 + n) of ``benchmarks/config5_device.py``'s
    ``make_ycck(w, h)`` input: the planes x * 255 // w, y * 255 // h,
    (x + y) * 255 // (w + h) and (x ^ y) % 160 with +-20 noise, the noise
    drawn per row from ``default_rng((42, y))`` (not the script's one draw
    for the whole image), so that the whole array and a pull source give
    the same pixels with O(band) host memory."""
    x = np.arange(w)
    plane0 = (x * 255 // w).astype(np.int16)
    plane2 = (np.arange(w + h) * 255 // (w + h)).astype(np.int16)
    out = np.empty((n, w, 4), np.uint8)
    row = np.empty((w, 4), np.int16)
    for i, y in enumerate(range(y0, y0 + n)):
        row[:, 0] = plane0
        row[:, 1] = y * 255 // h
        row[:, 2] = plane2[y:y + w]
        row[:, 3] = (x ^ y) % 160
        row += np.random.default_rng((42, y)).integers(-20, 20, (w, 4),
                                                        dtype=np.int16)
        np.clip(row, 0, 255, out=row)
        out[i] = row
    return out


def make_ycck(w, h):
    return make_ycck_rows(w, h, 0, h)


def config5_encoder(device, optimized=False):
    from tpuenc_torch import Encoder, SamplingFactor

    enc = Encoder(90, device=device)
    enc.set_sampling_factor(SamplingFactor.F_2_2)
    enc.set_optimized_huffman_tables(optimized)
    return enc


def scan_payloads(jpeg):
    """The entropy payload of each scan of a file of this encoder: after
    each SOS header, up to the next SOS or EOI (every DHT comes before the
    first SOS, and entropy bytes never hold 0xFF 0xDA)."""
    out = [p[(p[0] << 8) | p[1]:] for p in jpeg.split(b"\xff\xda")[1:]]
    out[-1] = out[-1][:-2]
    return out


def traced(run):
    """``run()`` with the port's tracer on (``tpuenc_torch.tracing``):
    (its result, the last request it made)."""
    from tpuenc_torch import tracing

    tracing.enable(keep=16)
    try:
        out = run()
    finally:
        tracing.disable()
    return out, tracing.requests()[-1]


def stage_report(req, wall_s):
    """A request's host stages beside its wall time: each stage's self
    time (host clock: its spans less their child spans), its spans'
    count, the counters and the chunks' packs."""
    self_ns, n = {}, {}
    for s in req.spans:
        self_ns[s.name] = self_ns.get(s.name, 0) + s.ns
        n[s.name] = n.get(s.name, 0) + 1
        if s.parent is not None:
            parent = req.spans[s.parent].name
            self_ns[parent] -= s.ns
    packs = [s for s in req.spans if s.name == "pack"]
    print(f"    host stages (tracer, self ms x spans) over a wall of "
          f"{wall_s * 1e3:.3f} ms: " + ", ".join(
              f"{k} {v * 1e-6:.3f} x {n[k]}" for k, v in sorted(
                  self_ns.items(), key=lambda kv: -kv[1])))
    print(f"    syncs {req.counters.get('syncs', 0)}, ladder retries "
          f"{req.counters.get('ladder_retries', 0)}, packs (blocks, rung) "
          f"{[(s.ints['blocks'], s.ints['rung']) for s in packs]}")


def expected_pack_launches(packs):
    """K2, K3, K5 once per pack and K4 once per pack whose merge folds."""
    from tpuenc_torch.entropy import pallas_pack as pk

    folds = sum(pk.merge_plan(-(-b // 512) * 512,
                              pk.final_block_cap(max(budget, 16)),
                              budget)[3] is not None for b, budget in packs)
    return {"pack_blocks": len(packs), "merge_chunks": len(packs),
            "fold_rows": folds, "concat_rows": len(packs)}


def peak_encode(dev, run):
    """``run()`` with every launch count set to 0 and the peak device
    memory reset just before it: (result, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches = counted(run)
    return out, launches, torch.cuda.max_memory_allocated(dev)


def h2d_copies(run):
    """The number and time of host-to-device copies over one ``run()``
    (``torch.profiler``)."""
    tl = device_timeline(run, "tpuenc config 5")
    if tl is None:
        raise AssertionError("the profiler saw no device activity")
    return tl["HtoD"]


# The streaming child of phase 9 (b): rows made on demand by the pull
# source, the pieces hashed and dropped; prints one JSON line.
STREAM_CHILD = """
import hashlib, json, sys, threading, time

def rss_kib():
    for line in open("/proc/self/status"):
        if line.startswith("VmRSS:"):
            return int(line.split()[1])

def sample(most, done):
    while not done.wait(0.002):
        most[0] = max(most[0], rss_kib())

rss = {"start": rss_kib()}
import torch
import chip_smoke as c
from tpuenc_torch import ColorType
rss["torch imported"] = rss_kib()
torch.zeros(1, device="cuda")
rss["CUDA context"] = rss_kib()
w = h = c.CONFIG5
enc = c.config5_encoder("cuda")
small = c.make_ycck_rows(512, 64, 0, 64)
b"".join(enc.encode_stream(small, 512, 64, ColorType.CMYK_AS_YCCK))
rss["small encode"] = before = rss_kib()
digest, n_bytes, n_pieces = hashlib.sha256(), 0, 0
most, done = [before], threading.Event()
sampler = threading.Thread(target=sample, args=(most, done))
sampler.start()
t0 = time.perf_counter()
try:
    for piece in enc.encode_stream(lambda y0, n: c.make_ycck_rows(w, h, y0, n),
                                   w, h, ColorType.CMYK_AS_YCCK,
                                   chunk_mcu_rows=37):
        digest.update(piece)
        n_bytes += len(piece)
        n_pieces += 1
finally:
    done.set()
    sampler.join()
rss["after the stream"] = rss_kib()
print(json.dumps({"seconds": time.perf_counter() - t0, "bytes": n_bytes,
                  "pieces": n_pieces, "sha256": digest.hexdigest(),
                  "rss_before_kib": before, "peak_kib": most[0],
                  "rss_kib": rss}))
"""


def config5_chunked(dev, img, keep):
    """Phase 9 (a): ``img``, config 5, encoded on the chunked path, its
    chunks, packs and launches checked, then three warm encodes, the
    third's stages from the tracer.  Keeps the input and the file's
    (length, sha256) in ``keep``; returns (the encoder, the file, its peak
    device memory, its launches)."""
    import hashlib

    from tpuenc_torch import ColorType

    ct = ColorType.CMYK_AS_YCCK
    w = h = CONFIG5
    mp = w * h / 1e6
    enc = config5_encoder(dev)
    (out_a, launches, peak_a), req = traced(lambda: peak_encode(
        dev, lambda: enc.encode(img, w, h, ct)))
    n_chunks = sum(s.name == "transform" for s in req.spans)
    packs = [(s.ints["blocks"], s.ints["rung"]) for s in req.spans
             if s.name == "pack"]
    print(f"  (a) {len(out_a)} bytes, path {enc.last_encode_path}, rung "
          f"{enc.last_budget}, {n_chunks} chunks, packs (blocks, rung) "
          f"{packs}, peak device memory {peak_a / 2**20:.1f} MiB, "
          f"launches {launches}")
    if enc.last_encode_path != "device-chunked":
        raise AssertionError(f"(a) ran on {enc.last_encode_path}")
    check_jpeg(out_a)
    keep.update(img=img, a=(len(out_a), hashlib.sha256(out_a).hexdigest()))
    want = {"fdct_quantize": 4 * n_chunks, **expected_pack_launches(packs)}
    got = {k: launches[k] for k in want}
    if got != want or n_chunks != CONFIG5_CHUNKS:
        raise AssertionError(f"(a) launches {got}, want {want} over "
                             f"{CONFIG5_CHUNKS} chunks")
    if req.launches != launches:
        raise AssertionError(f"(a) the request's launches {req.launches}, "
                             f"the wrappers' {launches}")
    check_launches(launches, ["fdct_quantize", "pack_blocks", "merge_chunks",
                              "concat_rows"],
                   ["pack_acbands", "hist_count", "fused_sample_pack",
                    "hist_sym"])
    times = []
    for i in range(3):  # the third run records its stages
        t0 = time.perf_counter()
        if i == 2:
            _, req = traced(lambda: enc.encode(img, w, h, ct))
        else:
            enc.encode(img, w, h, ct)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"  (a) encode warm, median of 3: {med * 1e3:.1f} ms = {mp / med:.1f} "
          f"MP/s (runs ms: {' '.join(f'{t * 1e3:.1f}' for t in times)}); the "
          f"stages of the third:")
    stage_report(req, times[-1])
    return enc, out_a, peak_a, launches


def phase_config5(dev, flagship_bytes, progressive_bytes, keep):
    """Phase 9: bounded memory and streaming at BASELINE config 5.  Keeps
    in ``keep`` what phase 11 holds its striped encode to: the input
    ("img"), (a)'s and (d)'s (length, sha256) and (d)'s histograms."""
    import hashlib

    from tpuenc_torch.entropy import chunked_multipass as cm

    from tpuenc_torch import ColorType
    from tpuenc_torch import plan as planning
    from tpuenc_torch.plan import make_plan

    ct = ColorType.CMYK_AS_YCCK
    w = h = CONFIG5
    mp = w * h / 1e6
    t0 = time.perf_counter()
    img = make_ycck(w, h)
    print(f"  input {w}x{h}x4, {img.nbytes / 2**30:.2f} GiB, made in "
          f"{time.perf_counter() - t0:.2f} s")
    paths = {}

    # (a) encode on the chunked path.
    enc, out_a, peak_a, paths["config5_interleaved"] = config5_chunked(
        dev, img, keep)

    # (b) streaming from a pull source at another chunk height.
    pieces = list(enc.encode_stream(lambda y0, n: img[y0:y0 + n], w, h, ct,
                                    chunk_mcu_rows=37))
    if b"".join(pieces) != out_a:
        raise AssertionError("(b) the streamed pieces differ from (a)'s bytes")
    print(f"  (b) encode_stream, 37 MCU rows a chunk: {len(pieces)} pieces, "
          f"joined == (a)'s bytes (path {enc.last_encode_path})")
    res = subprocess.run([sys.executable, "-c", STREAM_CHILD], cwd=HERE,
                         capture_output=True, text=True, check=True)
    child = json.loads(res.stdout.strip().splitlines()[-1])
    if child["sha256"] != hashlib.sha256(out_a).hexdigest():
        raise AssertionError("(b) the child's stream differs from (a)'s bytes")
    growth = child["peak_kib"] - child["rss_before_kib"]
    print(f"  (b) child, rows made on demand: {child['pieces']} pieces, "
          f"{child['bytes']} bytes == (a)'s, {child['seconds']:.2f} s; RSS "
          f"{child['rss_before_kib'] / 2**10:.1f} MiB before the stream, its "
          f"peak over the stream (sampled every 2 ms) "
          f"{child['peak_kib'] / 2**10:.1f} MiB: growth {growth / 2**10:.1f} "
          f"MiB against the {img.nbytes / 2**20:.0f} MiB input it never "
          f"holds; RSS MiB at " + ", ".join(
              f"{k} {v / 2**10:.1f}" for k, v in child["rss_kib"].items()))

    # (c) a quarter of the rows: the same chunks, so the same peak.  The
    # image is within the whole-image limits, so the chunked path is taken
    # with the block limit at 0, and the whole-image path beside it.
    img_c = img[:CONFIG5_C_ROWS]
    enc_c = config5_encoder(dev)
    whole_c, _, peak_whole = peak_encode(
        dev, lambda: enc_c.encode(img_c, w, CONFIG5_C_ROWS, ct))
    limit = planning.DEVICE_BLOCK_LIMIT
    planning.DEVICE_BLOCK_LIMIT = 0
    try:
        out_c, _, peak_c = peak_encode(
            dev, lambda: enc_c.encode(img_c, w, CONFIG5_C_ROWS, ct))
    finally:
        planning.DEVICE_BLOCK_LIMIT = limit
    print(f"  (c) {w}x{CONFIG5_C_ROWS}, block limit 0: {len(out_c)} bytes, "
          f"path {enc_c.last_encode_path}, rung {enc_c.last_budget}, peak "
          f"device memory {peak_c / 2**20:.1f} MiB ({peak_c / peak_a:.3f} of "
          f"(a)'s); the whole-image path: the same bytes, peak "
          f"{peak_whole / 2**20:.1f} MiB")
    if enc_c.last_encode_path != "device-chunked" or out_c != whole_c:
        raise AssertionError("(c) the chunked path differs from the whole image")
    if abs(peak_c - peak_a) > 0.1 * peak_a:
        raise AssertionError("(c) not within 10% of (a)'s peak device memory")

    # (f) a row source of CUDA tensors at (c)'s size.
    dimg = torch.from_numpy(img_c).to(dev)
    h2d_c = h2d_copies(lambda: b"".join(enc_c.encode_stream(
        img_c, w, CONFIG5_C_ROWS, ct)))

    def from_device():
        return b"".join(enc_c.encode_stream(lambda y0, n: dimg[y0:y0 + n], w,
                                            CONFIG5_C_ROWS, ct))

    if from_device() != out_c:
        raise AssertionError("(f) the device row source differs from (c)'s bytes")
    h2d_f = h2d_copies(from_device)
    print(f"  (f) CUDA-tensor rows: == (c)'s bytes; H2D copies over one "
          f"encode: {h2d_f[0]} ({h2d_f[1]:.3f} ms), beside (c)'s host array "
          f"{h2d_c[0]} ({h2d_c[1]:.3f} ms)")
    # The chunk finish uploads each chunk's small table of segment pieces;
    # a copy of the pixels would add one copy more a chunk.
    if h2d_f[0] > CONFIG5_C_ROWS * CONFIG5_CHUNKS // CONFIG5:
        raise AssertionError("(f) copied pixels to the card")
    del dimg

    # (d) optimized tables: the chunked multipass path.
    enc_d = config5_encoder(dev, optimized=True)
    tables = cm.tables_from_histograms

    def kept_tables(pairs):  # the image's histograms, DC counts corrected
        keep["d_hists"] = np.stack([np.stack(p) for p in pairs])
        return tables(pairs)

    cm.tables_from_histograms = kept_tables
    try:
        out_d, launches_d, peak_d = peak_encode(
            dev, lambda: enc_d.encode(img, w, h, ct))
    finally:
        cm.tables_from_histograms = tables
    keep["d"] = (len(out_d), hashlib.sha256(out_d).hexdigest())
    store = 128 * sum(make_plan(w, h, ct, enc_d._config())
                      .layout["comp_block_counts"])
    print(f"  (d) {len(out_d)} bytes, path {enc_d.last_encode_path}, rung "
          f"{enc_d.last_budget}, peak device memory {peak_d / 2**20:.1f} MiB "
          f"beside the store's {store / 2**20:.1f} MiB, launches {launches_d}")
    if enc_d.last_encode_path != "device-chunked-multipass" or \
            out_d.count(b"\xff\xda") != 4:
        raise AssertionError("(d) not 4 scans on the chunked multipass path")
    check_jpeg(out_d)
    if launches_d["hist_count"] != 4 * CONFIG5_CHUNKS or \
            launches_d["fdct_quantize"] != 4 * CONFIG5_CHUNKS:
        raise AssertionError("(d) K1 and K7 not 4 per chunk")
    check_launches(launches_d, ["fdct_quantize", "hist_count", "pack_blocks",
                                "merge_chunks", "concat_rows"],
                   ["pack_acbands", "fused_sample_pack", "hist_sym"])
    paths["config5_multipass"] = launches_d
    med, times = host_median(lambda: enc_d.encode(img, w, h, ct), 3)
    print(f"  (d) encode warm, median of 3: {med * 1e3:.1f} ms = {mp / med:.1f} "
          f"MP/s (runs ms: {' '.join(f'{t * 1e3:.1f}' for t in times)})")

    config5_anchors(dev, flagship_bytes, progressive_bytes)
    results = config5_kernel_checks(dev, img, enc.last_budget,
                                    enc_d.last_budget)
    return paths, results


def config5_anchors(dev, flagship_bytes, progressive_bytes):
    """Phase 9 (e): the chunked paths against the whole-image path."""
    from tpuenc_torch import ColorType, Encoder, SamplingFactor
    from tpuenc_torch import plan as planning
    from tpuenc_torch.entropy.chunked import encode_interleaved_chunked
    from tpuenc_torch.entropy.chunked_multipass import encode_multipass_chunked
    from tpuenc_torch.jfif import segments
    from tpuenc_torch.plan import make_plan

    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    shape = (FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
    enc = Encoder(90, device=dev)
    config = enc._config()
    got = encode_interleaved_chunked(rgb, make_plan(*shape, config),
                                     enc._default_tables(config)[2],
                                     chunk_mcu_rows=16)
    if [got] != scan_payloads(flagship_bytes):
        raise AssertionError("(e) chunked flagship differs from phase 5's scan")
    print("  (e) flagship, 16 MCU rows a chunk: == phase 5's scan payload")

    enc = progressive_encoder(dev)
    config = enc._config()
    _, huffman, params = enc._default_tables(config)
    got = [b"".join(pieces) for pieces in encode_multipass_chunked(
        rgb, make_plan(*shape, config), huffman, params, chunk_mcu_rows=16,
        pack_chunk=1 << 16)]
    head = progressive_bytes[:progressive_bytes.index(b"\xff\xda")]
    dhts = [segments.dht(k, i, t) for i, pair in enumerate(huffman[:2])
            for k, t in enumerate(pair)]
    if got != scan_payloads(progressive_bytes) or \
            not all(d in head for d in dhts):
        raise AssertionError("(e) chunked multipass differs from phase 6's file")
    print(f"  (e) progressive + optimized flagship, 16 MCU rows and 65,536-block "
          f"pack chunks: == phase 6's {len(got)} scan payloads and DHTs")

    uhd = make_rgb(UHD_W, UHD_H)
    enc = Encoder(80, device=dev)
    enc.set_sampling_factor(SamplingFactor.F_2_2)
    enc.set_restart_interval(64)
    config = enc._config()
    whole = enc.encode(uhd, UHD_W, UHD_H, ColorType.RGB)
    got = encode_interleaved_chunked(
        uhd, make_plan(UHD_W, UHD_H, ColorType.RGB, config),
        enc._default_tables(config)[2], chunk_mcu_rows=7)
    if [got] != scan_payloads(whole):
        raise AssertionError("(e) chunked 4K 4:2:0 restart 64 differs")
    print("  (e) 4K 4:2:0 restart 64, 7 MCU rows a chunk (segments across "
          "chunk edges): == its whole-image scan payload")

    limit = planning.DEVICE_BLOCK_LIMIT
    planning.DEVICE_BLOCK_LIMIT = 0
    try:
        enc = Encoder(90, device=dev)
        out = enc.encode(rgb, *shape)
    finally:
        planning.DEVICE_BLOCK_LIMIT = limit
    if out != flagship_bytes or enc.last_encode_path != "device-chunked":
        raise AssertionError("(e) encode over a lowered limit differs")
    print(f"  (e) encode with DEVICE_BLOCK_LIMIT 0: path "
          f"{enc.last_encode_path}, == phase 5's file")


def config5_kernel_checks(dev, img, rung, rung_d):
    """Phase 9 (g): the kernels at the chunked paths' shapes against their
    plain versions, as phase 3 holds them."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.plan import make_plan

    ct = ColorType.CMYK_AS_YCCK
    w = CONFIG5
    rows = 64 * 16  # one chunk: 64 MCU rows of 16 pixels
    results = {}
    enc = config5_encoder(dev)
    config = enc._config()
    params = enc._default_tables(config)[2]
    px0 = torch.from_numpy(img[:rows]).to(dev)
    px1 = torch.from_numpy(img[rows:2 * rows]).to(dev)

    y = config5_chunk_y(dev, px1)
    print(f"  (g) K1 on a chunk's Y blocks: {y.shape[1]}")
    check_kernel(results, *k1_case("K1 fdct_quantize config 5 chunk", y,
                                   params), reps=5)
    del y

    # Chunk 1's MCU stream, its DC chain continued from chunk 0's last MCU,
    # under a restart interval of 100 MCUs (1,000 blocks), which the
    # chunk's offset of 655,360 blocks is not a multiple of.
    (mcu0,) = pipeline.fn_cm(px0, w, rows, ct, config, params.reciprocals,
                             params.corrections)
    (mcu1,) = pipeline.fn_cm(px1, w, rows, ct, config, params.reciprocals,
                             params.corrections)
    ((_, spec, _),) = make_plan(w, w, ct, config).scans
    pat = len(spec.dc_tab_pattern)
    spec = spec._replace(seg_blocks=100 * pat)
    tail = mcu0[0, -pat:]
    dcdiff = pk.dc_diffs_from_dc(mcu1[0], spec, prev_tail=tail,
                                 global_offset=mcu0.shape[1])
    print(f"  (g) chunk 1: {mcu1.shape[1]} blocks at offset {mcu0.shape[1]}, "
          f"DC tail {tail.tolist()}, segments of {spec.seg_blocks} blocks, "
          f"rung {rung}")
    for case in pack_merge_cases(params, spec, mcu1, rung, "config 5 chunk",
                                 dcdiff=dcdiff):
        check_kernel(results, *case, reps=5)
    del mcu0, mcu1, px0, dcdiff

    # A pack chunk of the multipass store: the Y blocks of the top 4,096
    # rows (1,048,576), as the chunk at offset 2^20 with its predecessor's
    # DC and the last 4,321 blocks masked.
    config_d = config5_encoder(dev, optimized=True)._config()
    px = torch.from_numpy(img[:CONFIG5_C_ROWS]).to(dev)
    store_y = pipeline.fn_cm(px, w, CONFIG5_C_ROWS, ct, config_d,
                             params.reciprocals, params.corrections)[0]
    spec_y = make_plan(w, w, ct, config_d).scans[0][1]
    B = store_y.shape[1]
    dcdiff = pk.dc_diffs_from_dc(store_y[0], spec_y,
                                 prev_tail=store_y[0, -1:], global_offset=B)
    print(f"  (g) pack chunk: {B} blocks, {B - 4321} valid, rung {rung_d}")
    for case in pack_merge_cases(params, spec_y, store_y, rung_d,
                                 "config 5 pack chunk", dcdiff=dcdiff,
                                 valid=B - 4321):
        check_kernel(results, *case, reps=5)
    del store_y, px

    luma = pipeline.fn_cm(px1, w, rows, ct, config_d, params.reciprocals,
                          params.corrections)[0].contiguous()
    print(f"  (g) K7 on a chunk's Y stream: {luma.shape[1]} blocks, band (1, 64)")
    check_kernel(results, "K7 hist_count config 5 chunk",
                 lambda: ph.hist_count(luma, [(1, 64)]),
                 lambda: ph.hist_count_ref(luma, [(1, 64)]), nbytes(luma),
                 reps=5)
    return results


def phase_device_finish(dev, flagship):
    """The device finish, which the whole-image routes run, beside the
    host finish it replaced (:func:`host_finish`) on the three flagship
    routes: for each, the host finish's steps beside the device finish's
    parts on the same stream (``flagship["finish"]``, kept by phases
    5-7), one encode with every launch count at 0 just before it, its
    bytes and rung (the budget memo cleared first) equal to the host
    finish's, and warm end to end in turns (host, device, device, host).
    Then the 26 fixtures, split and fused, each file and rung equal to the
    host finish's and to the frozen file, and the largest whole-image
    stream (:func:`near_limit_finish`).  Returns {path: launches}."""
    from tpuenc_torch import ColorType, Encoder
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.testing.fixtures import build_cases, img

    split_kernels = ["fdct_quantize", "pack_blocks", "merge_chunks",
                     "fold_rows", "concat_rows"]
    routes = [
        ("split", lambda: Encoder(90, device=dev), "device-v2",
         split_kernels, ["fused_sample_pack"]),
        ("fused", lambda: Encoder(90, device=dev, fused_p1=True),
         "device-v2-fused",
         ["fused_sample_pack", "merge_chunks", "fold_rows", "concat_rows"],
         ["fdct_quantize", "pack_blocks"]),
        ("progressive", lambda: progressive_encoder(dev), "device-v2",
         ["fdct_quantize", "merge_chunks", "fold_rows", "concat_rows",
          "pack_acbands", "hist_count"],
         ["pack_blocks", "hist_sym", "fused_sample_pack"]),
    ]
    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    paths = {}
    for name, make, path, required, absent in routes:
        print(f"  -- {name}")
        finish = flagship["finish"][name]
        parts, scans = host_finish_parts(*finish)
        parts.update(device_finish_parts(*finish, scans))
        for k, v in parts.items():
            print(f"  {k:50s} {v:9.4f} ms")
        de._budget_memo.clear()
        host = make()
        with host_finish():
            want = host.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
        de._budget_memo.clear()
        enc = make()
        out, paths[f"{name}_device_finish"] = drive(enc, rgb, required,
                                                    absent, path=path)
        if out != want:
            raise AssertionError(f"{name}: device finish bytes differ from "
                                 f"the host finish's")
        if enc.last_budget != host.last_budget:
            raise AssertionError(f"{name}: rung {enc.last_budget}, the host "
                                 f"finish's {host.last_budget}")
        print(f"  {len(out)} bytes at rung {enc.last_budget} == the host "
              f"finish's")
        for device, label in ((False, " host finish"), (True, " device finish"),
                              (True, " device finish"), (False, " host finish")):
            with contextlib.nullcontext() if device else host_finish():
                e2e(enc if device else host, rgb, label)

    for fused in (False, True):
        cases = build_cases(dev, fused_p1=fused)
        for name, (build, ct, ch, seed, w, h) in cases.items():
            px = img(ch, seed, w, h)
            de._budget_memo.clear()
            host = build()
            with host_finish():
                want = host.encode(px, w, h, ct)
            de._budget_memo.clear()
            enc = build()
            got = enc.encode(px, w, h, ct)
            frozen = open(os.path.join(HERE, "tests", "fixtures",
                                       f"{name}.jpg"), "rb").read()
            if got != want or got != frozen:
                raise AssertionError(f"fixture {name} (fused_p1={fused}): "
                                     f"device finish bytes differ")
            if enc.last_budget != host.last_budget:
                raise AssertionError(f"fixture {name}: rung {enc.last_budget}"
                                     f", the host finish's {host.last_budget}")
            if not enc.last_encode_path.startswith("device-v2"):
                raise AssertionError(f"fixture {name} ran on "
                                     f"{enc.last_encode_path}")
        print(f"  fixtures (fused_p1={fused}): all {len(cases)} through the "
              f"device finish == the host finish's files and rungs")
    near_limit_finish(dev)
    return paths


# The largest whole-image encode: the most blocks the limit lets through
# ((w // 8 + 1) * (h // 8 + 1) = 2,989,441 <= 3,000,000; 2,985,984 MCUs
# of three blocks at 4:4:4), the flagship's content tiled, at q90.
NEAR_LIMIT = 13824


def near_limit_finish(dev):
    """One encode of the largest whole-image image on "device-v2": the
    encode's peak device memory and the device finish's (which must stay
    within its output, 2 bytes per realigned byte and per segment, and
    sixteen int64 window temporaries), the finish's scans equal to the
    host finish's on the same stream, and each finish once on the host
    clock."""
    from tpuenc_torch import ColorType, Encoder
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import device_stuff as ds

    w = h = NEAR_LIMIT
    px = np.tile(make_rgb(FLAGSHIP_W, FLAGSHIP_H),
                 (-(-h // FLAGSHIP_H), -(-w // FLAGSHIP_W), 1))[:h, :w]
    px = np.ascontiguousarray(px)
    print(f"  -- {w}x{h} RGB, the flagship tiled, q90")
    seen = []
    device = de._finish_scans_device

    def recorded(*args):
        peak, scans = finish_peak(lambda: device(*args))
        seen.append((args, peak))
        return scans

    enc = Encoder(90, device=dev)
    de._finish_scans_device = recorded
    try:
        encode_peak, out = finish_peak(
            lambda: enc.encode(px, w, h, ColorType.RGB))
    finally:
        de._finish_scans_device = device
    ((args, peak),) = seen
    if enc.last_encode_path != "device-v2":
        raise AssertionError(f"ran on {enc.last_encode_path}")
    check_jpeg(out)
    buf, _, host_bits, segs, pinned = args
    seg_bits = host_bits.astype(np.int64)
    n1, S = int(((seg_bits + 7) >> 3).sum()), len(seg_bits)
    bound = 2 * n1 + 2 * S + 16 * 8 * ds._WINDOW
    t0 = time.perf_counter()
    scans = device(*args)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = de._finish_scans_v2(buf, host_bits, segs)
    host_s = time.perf_counter() - t0
    if scans != want:
        raise AssertionError("near the limit: the device finish differs")
    print(f"  {len(out)} bytes at rung {enc.last_budget}; {n1} realigned "
          f"bytes in {S} segments; peak device memory: the encode "
          f"{encode_peak / 2**20:.1f} MiB, the device finish "
          f"{peak / 2**20:.1f} MiB (bound {bound / 2**20:.1f} MiB: output "
          f"{(2 * n1 + 2 * S) / 2**20:.1f} + windows)")
    print(f"  the device finish's scans == the host finish's; host clock, "
          f"one run each: device finish {dev_s * 1e3:.3f} ms, host finish "
          f"{host_s * 1e3:.3f} ms")
    if peak > bound:
        raise AssertionError("the device finish's memory is past its bound")


# ---------------------------------------------------------------------------
# Phase 11: the striped encode over ranks (tpuenc_torch.shard).  The rank
# functions run in processes of their own (tpuenc_torch.testing.dist.launch,
# the spawn method), which import this file afresh as their main module.
# ---------------------------------------------------------------------------

SHARD_RANKS = 4


class ShardStages:
    """One rank's stages of a striped encode, from wrappers around the
    functions ``tpuenc_torch.shard`` calls (restored on exit): on the card
    (CUDA events), the coefficient step (``fn_cm``), the histograms and the
    pack of every scan (each rung tried); on the host clock, the stripe's
    upload (to the end of its copy), each collective (the DC tails, the
    histograms, the ladder's overflow flags, the gather of the bits or
    files), and the host assembly (joining the stripes' bits, realigning
    and writing the file); and the reduced histograms."""

    def __init__(self):
        from tpuenc_torch.shard import encode, stripes

        self.targets = [(stripes, "pad_stripe", "upload", "host"),
                        (stripes, "fn_cm", "coefficients", "device"),
                        (stripes, "scan_histograms", "histograms", "device"),
                        (stripes, "exchange_tails", "tails", "host"),
                        (stripes, "reduce_histograms", "reduce", "host"),
                        (encode, "general_pack", "pack", "device"),
                        (encode, "agree_overflow", "ladder", "host"),
                        (encode, "gather", "gather", "host"),
                        (encode, "join_scan", "assembly", "host"),
                        (encode.ShardedEncoder, "_file", "assembly", "host")]
        self.real = [getattr(obj, name) for obj, name, _, _ in self.targets]
        self.host = {}
        self.events = {}
        self.calls = {}
        self.hists = None
        self.packs = []  # each pack call's StripeScans (the last rung last)

    def __enter__(self):
        for (obj, name, key, kind), real in zip(self.targets, self.real):
            setattr(obj, name, self._wrap(real, key, kind))
        return self

    def _wrap(self, real, key, kind):
        def timed(*args, **kwargs):
            self.calls[key] = self.calls.get(key, 0) + 1
            if kind == "device":
                a = torch.cuda.Event(enable_timing=True)
                a.record()
                out = real(*args, **kwargs)
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                self.events.setdefault(key, []).append((a, b))
                if key == "pack":
                    self.packs.append(out)
                return out
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if key == "upload":
                torch.cuda.synchronize()
            if key == "reduce":
                self.hists = out
            self.host[key] = self.host.get(key, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def __exit__(self, *exc):
        for (obj, name, _, _), real in zip(self.targets, self.real):
            setattr(obj, name, real)
        torch.cuda.synchronize()

    def summary(self):
        out = {k: v * 1e3 for k, v in self.host.items()}
        for key, pairs in self.events.items():
            out[key] = sum(a.elapsed_time(b) for a, b in pairs)
        return out

    def widths(self):
        """The counts of this rank's last pack (the rung kept): the most
        bits of one block (int32 ``lens``), of one restart segment's part
        and of the stripe's part of one scan (both int64)."""
        scans = self.packs[-1]

        def most(ts):
            return max((int(t.max()) for t in ts if t.numel()), default=0)

        return {"block_bits": most(s.lens for s in scans),
                "segment_bits": most(s.segment_bits for s in scans),
                "scan_bits": most(s.bits for s in scans)}


def count_syncs(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result, the number of synchronizing CUDA calls and where they were
    made (file:line of the caller)."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in syncs)
    return out, len(syncs), dict(where)


def shard_encode(enc, images, w, h, ct, stages=True):
    """One ``encode_batch`` on this rank, with every launch count set to
    0 and the peak device memory reset just before it: the files, its
    wall seconds, its launches, its peak device memory, and its stages
    (:class:`ShardStages`, or None)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ShardStages() if stages else contextlib.nullcontext() as st:
        t0 = time.perf_counter()
        files, launches = counted(lambda: enc.encode_batch(images, w, h, ct))
        wall = time.perf_counter() - t0
    return files, wall, launches, torch.cuda.max_memory_allocated(), st


def shard_record(files, wall, launches, peak, st, enc, syncs=None):
    import hashlib

    return {"sha256": [hashlib.sha256(f).hexdigest() for f in files],
            "bytes": [len(f) for f in files], "wall_s": wall,
            "launches": launches, "peak": peak, "path": enc.last_encode_path,
            "rung": enc.last_budget,
            "stages": None if st is None else st.summary(),
            "widths": None if st is None or not st.packs else st.widths(),
            "calls": None if st is None else st.calls,
            "hists": None if st is None else st.hists, "syncs": syncs}


def phase11_rank(npy):
    """Phase 11 (a), (d), (e), (f) and (i) on one of four gloo ranks, each
    computing on cuda:0."""
    from tpuenc_torch import ColorType, Encoder, SamplingFactor
    from tpuenc_torch.shard.dryrun import dryrun_multichip
    from tpuenc_torch.shard.encode import ShardedEncoder
    from tpuenc_torch.shard.mesh import make_mesh

    dev = torch.device("cuda:0")
    out = {}
    ct = ColorType.CMYK_AS_YCCK
    img = np.load(npy, mmap_mode="r")
    w = h = CONFIG5
    mesh = make_mesh("cpu", 1)
    for key, optimized in (("a", False), ("d", True)):
        enc = ShardedEncoder(90, mesh, device=dev)
        enc.set_sampling_factor(SamplingFactor.F_2_2)
        enc.set_optimized_huffman_tables(optimized)
        out[key] = shard_runs(enc, [img], w, h, ct)

    # (e) BASELINE config 1 over a (2, 2) mesh: 8 images a batch coordinate.
    n, w1, h1 = BASELINE1
    imgs = [make_rgb(w1, h1, seed=i) for i in range(n)]
    enc = ShardedEncoder(90, make_mesh("cpu", 2), device=dev)
    files, wall, launches, peak, st = shard_encode(enc, imgs, w1, h1,
                                                   ColorType.RGB)
    out["e"] = shard_record(files, wall, launches, peak, st, enc)
    if dist_rank() == 0:
        out["e"]["want"] = [Encoder(90, device=dev).encode(im, w1, h1,
                                                           ColorType.RGB)
                            for im in imgs]
        out["e"]["files"] = files
    out["f"] = dryrun_multichip(dev)
    out["i"] = phase11i(enc, dev)
    return out


def phase11i(enc, dev):
    """Phase 11 (i) on (e)'s (2, 2) ranks: what ``ShardedEncoder`` does
    beside its striped ``encode_batch``, each call with the launch counts
    at 0 just before it: ``encode_batch`` of 3 config-1 images (not a
    multiple of the batch axis: ``Encoder.encode_batch``'s route),
    ``encode_image`` of the flagship as RGB planes and ``encode_stream`` of
    it, and ``encode_batch_sharded`` of 4 config-1 images.  Returns each
    call's files' sha256, route and launches, and on rank 0 the references:
    ``Encoder.encode_batch`` of the 3 and ``Encoder.encode`` of the 4."""
    import hashlib

    from tpuenc_torch import ColorType, Encoder, JpegColorType
    from tpuenc_torch.testing.shard_cases import planes_buffer

    def sha(files):
        return [hashlib.sha256(f).hexdigest() for f in files]

    _, w1, h1 = BASELINE1
    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    three = [make_rgb(w1, h1, seed=100 + i) for i in range(3)]
    four = [make_rgb(w1, h1, seed=200 + i) for i in range(4)]
    calls = {
        "batch3": lambda: enc.encode_batch(three, w1, h1, ColorType.RGB),
        "encode_image": lambda: [enc.encode_image(planes_buffer(
            rgb, jpeg_color_type=JpegColorType.YCBCR,
            color_type=ColorType.RGB))],
        "encode_stream": lambda: [b"".join(enc.encode_stream(
            rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB))],
        "sharded4": lambda: enc.encode_batch_sharded(four, w1, h1,
                                                     ColorType.RGB),
    }
    out = {}
    for key, call in calls.items():
        files, launches = counted(call)
        out[key] = {"sha256": sha(files), "path": enc.last_encode_path,
                    "launches": launches}
    if dist_rank() == 0:
        ref = Encoder(90, device=dev)
        out["batch3_want"] = {
            "sha256": sha(ref.encode_batch(three, w1, h1, ColorType.RGB)),
            "path": ref.last_encode_path}
        out["sharded4_want"] = {"sha256": sha(
            [ref.encode(im, w1, h1, ColorType.RGB) for im in four])}
    return out


def phase11h_rank(npy):
    """Phase 11 (h) on one of two gloo ranks, each computing on cuda:0:
    BASELINE config 5 (a) over a (1, 2) mesh, a 16384x8192 stripe of
    5,242,880 blocks a rank, past the whole-image limits."""
    from tpuenc_torch import ColorType, SamplingFactor
    from tpuenc_torch.shard.encode import ShardedEncoder
    from tpuenc_torch.shard.mesh import make_mesh

    enc = ShardedEncoder(90, make_mesh("cpu", 1), device=torch.device("cuda:0"))
    enc.set_sampling_factor(SamplingFactor.F_2_2)
    img = np.load(npy, mmap_mode="r")
    return shard_runs(enc, [img], CONFIG5, CONFIG5, ColorType.CMYK_AS_YCCK)


def shard_runs(enc, images, w, h, ct):
    """Three encodes on this rank: the first (cold), a warm one with its
    stages (the record), and a third under :func:`count_syncs`; each one's
    files' sha256 in "sha_runs"."""
    first = shard_record(*shard_encode(enc, images, w, h, ct), enc)
    rec = shard_record(*shard_encode(enc, images, w, h, ct), enc)
    (files, wall, _, _, _), n, where = count_syncs(
        lambda: shard_encode(enc, images, w, h, ct, stages=False))
    third = shard_record(files, wall, {}, 0, None, enc)
    rec.update(first=first, syncs=(n, where), third_wall_s=wall,
               sha_runs=[first["sha256"], rec["sha256"], third["sha256"]])
    return rec


def dist_rank():
    import torch.distributed as dist

    return dist.get_rank()


def phase11_nccl_rank():
    """Phase 11 (g) on a one-rank NCCL mesh on "cuda": the interleaved
    flagship through ``ShardedEncoder``."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.shard.encode import ShardedEncoder
    from tpuenc_torch.shard.mesh import make_mesh

    enc = ShardedEncoder(90, make_mesh("cuda", 1), device="cuda")
    rgb = make_rgb(FLAGSHIP_W, FLAGSHIP_H)
    rec = shard_runs(enc, [rgb], FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
    rec["file"] = enc.encode(rgb, FLAGSHIP_W, FLAGSHIP_H, ColorType.RGB)
    return rec


def print_shard_ranks(label, recs, mp):
    """Each rank's line of a phase 11 case."""
    for r, rec in enumerate(recs):
        st = rec["stages"]
        print(f"    rank {r}: wall {rec['wall_s'] * 1e3:.1f} ms, rung "
              f"{rec['rung']}, peak device memory {rec['peak'] / 2**20:.1f} "
              f"MiB; stripe upload {st.get('upload', 0):.3f} ms; device "
              f"(events) coefficients {st.get('coefficients', 0):.3f}, "
              f"histograms {st.get('histograms', 0):.3f}, pack "
              f"{st.get('pack', 0):.3f} ms in {rec['calls'].get('pack', 0)} "
              f"call(s) (an image a rung); collectives (host clock) tails "
              f"{st.get('tails', 0):.3f}, histograms {st.get('reduce', 0):.3f}, "
              f"ladder flags {st.get('ladder', 0):.3f}, gather "
              f"{st.get('gather', 0):.3f} ms; host assembly "
              f"{st.get('assembly', 0):.3f} ms")
    walls = [rec["wall_s"] for rec in recs]
    print(f"    {label} wall, slowest rank: {max(walls) * 1e3:.1f} ms = "
          f"{mp / max(walls):.1f} MP/s (ranks share one card: no scaling "
          f"figure)")
    if "first" in recs[0]:
        print(f"    {label} per rank: the first (cold) encode's wall "
              + ", ".join(f"{rec['first']['wall_s'] * 1e3:.1f}" for rec in recs)
              + " ms, a third's " + ", ".join(f"{rec['third_wall_s'] * 1e3:.1f}"
                                              for rec in recs)
              + f" ms with {[rec['syncs'][0] for rec in recs]} synchronizing "
              f"calls (sync debug mode \"warn\"; one is the harness's "
              f"torch.cuda.synchronize), rank 0's at {recs[0]['syncs'][1]}")


def sum_launches(*launch_dicts):
    total = {}
    for d in launch_dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_sharded(dev, flagship_bytes, config5):
    """Phase 11: ``ShardedEncoder`` over ranks: BASELINE config 5 over a
    (1, 4) gloo mesh on cuda:0 ((a) default, (d) optimized tables),
    BASELINE config 1 over a (2, 2) mesh (e), the dryrun twin (f), the
    inherited entry points on (e)'s ranks (i), the flagship over a
    one-rank NCCL mesh (g), and config 5 (a) over a (1, 2) mesh (h); then
    the kernels at the stripes' shapes against their plain versions.
    Returns ({"sharded": launches}, kernel results)."""
    import hashlib
    import tempfile

    from tpuenc_torch.testing.dist import launch

    w = h = CONFIG5
    mp = w * h / 1e6
    tmp = tempfile.mkdtemp(prefix="tpuenc-phase11-")
    npy = os.path.join(tmp, "config5.npy")
    t0 = time.perf_counter()
    np.save(npy, config5["img"])
    print(f"  phase 9's input written to {npy} in "
          f"{time.perf_counter() - t0:.2f} s; {SHARD_RANKS} gloo ranks, each "
          f"computing on cuda:0")
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        ranks = launch(phase11_rank, SHARD_RANKS, (npy,), cuda_device=0,
                       timeout=600)
        print(f"  the four ranks ran in {time.perf_counter() - t0:.2f} s "
              f"(spawn and process group included)")
        t0 = time.perf_counter()
        ranks_h = launch(phase11h_rank, 2, (npy,), cuda_device=0,
                         timeout=600)
        print(f"  (h)'s two ranks ran in {time.perf_counter() - t0:.2f} s "
              f"(spawn and process group included)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    required = ["fdct_quantize", "pack_blocks", "merge_chunks", "concat_rows"]
    absent = ["pack_acbands", "fused_sample_pack", "hist_sym"]
    counted_runs = []
    for key, title in (("a", "(a) config 5, default tables"),
                       ("d", "(d) config 5, optimized tables")):
        recs = [r[key] for r in ranks]
        want_len, want_sha = config5[key]
        print(f"  {title}: path {recs[0]['path']}, {recs[0]['bytes'][0]} "
              f"bytes, rung {recs[0]['rung']}")
        for r, rec in enumerate(recs):
            if rec["path"] != "sharded-general":
                raise AssertionError(f"{key}: rank {r} ran on {rec['path']}")
            for (sha,) in rec["sha_runs"]:
                if sha != want_sha or rec["bytes"][0] != want_len:
                    raise AssertionError(f"{key}: rank {r}'s file differs "
                                         f"from phase 9 ({key})'s")
            L = rec["launches"]
            packs = rec["calls"]["pack"]
            scans = 1 if key == "a" else 4
            if L["fdct_quantize"] != 4 or L["pack_blocks"] != packs * scans \
                    or L["hist_count"] != (0 if key == "a" else 4):
                raise AssertionError(f"{key}: rank {r} launches {L}")
            check_launches(L, required + (["hist_count"] if key == "d" else []),
                           absent + (["hist_count"] if key == "a" else []))
            counted_runs.append(L)
        print(f"    == phase 9 ({key})'s {want_len} bytes (sha256) on every "
              f"rank, in each of three encodes; per-rank launches of the "
              f"second {recs[0]['launches']}; the second, warm, per rank:")
        print_shard_ranks(f"({key})", recs, mp)
        if key == "d":
            for r, rec in enumerate(recs):
                if not np.array_equal(rec["hists"][0], config5["d_hists"]):
                    raise AssertionError(f"(d) rank {r}'s reduced histograms "
                                         f"differ from the single device's")
            print("    the stripes' histograms, reduced, == the single-device "
                  "histograms of the image (phase 9 (d))")

    recs = [r["e"] for r in ranks]
    e = ranks[0]["e"]
    want = [hashlib.sha256(f).hexdigest() for f in e["want"]]
    if any(rec["sha256"] != want or rec["path"] != "sharded-general"
           for rec in recs):
        raise AssertionError("(e) a file differs from encode()'s")
    for r, rec in enumerate(recs):
        check_launches(rec["launches"], required, absent + ["hist_count"])
        counted_runs.append(rec["launches"])
    n, w1, h1 = BASELINE1
    print(f"  (e) BASELINE config 1, {n} x {w1}x{h1}, (2, 2) mesh: path "
          f"{e['path']}, every rank's {n} files == Encoder(90, "
          f"device=\"cuda\").encode's ({sum(e['bytes'])} bytes)")
    print_shard_ranks("(e)", recs, n * w1 * h1 / 1e6)
    if any(r["f"] != ranks[0]["f"] for r in ranks):
        raise AssertionError("(f) the ranks' dryruns differ")
    print(f"  (f) dryrun_multichip on 4 ranks: {ranks[0]['f']}")
    counted_runs += check_phase11i([r["i"] for r in ranks], flagship_bytes)

    g = launch(phase11_nccl_rank, 1, backend="nccl", cuda_device=0,
               timeout=300)[0]
    if g["file"] != flagship_bytes or g["path"] != "sharded-general":
        raise AssertionError("(g) the NCCL flagship differs from phase 5's")
    check_launches(g["launches"], required, absent + ["hist_count"])
    counted_runs.append(g["launches"])
    if any(sha != [hashlib.sha256(flagship_bytes).hexdigest()]
           for sha in g["sha_runs"]):
        raise AssertionError("(g) an NCCL encode differs from phase 5's")
    print(f"  (g) one-rank NCCL mesh on \"cuda\": the flagship == phase 5's "
          f"{len(g['file'])} bytes in each of four encodes, rung {g['rung']}; "
          f"the second, warm:")
    print_shard_ranks("(g)", [g], FLAGSHIP_W * FLAGSHIP_H / 1e6)

    recs = ranks_h
    want_len, want_sha = config5["a"]
    for r, rec in enumerate(recs):
        if rec["path"] != "sharded-general" or any(
                sha != want_sha for (sha,) in rec["sha_runs"]) \
                or rec["bytes"][0] != want_len:
            raise AssertionError(f"(h) rank {r}'s file differs from phase 9 "
                                 f"(a)'s or ran on {rec['path']}")
        L = rec["launches"]
        if L["fdct_quantize"] != 4 or L["pack_blocks"] != rec["calls"]["pack"]:
            raise AssertionError(f"(h) rank {r} launches {L}")
        check_launches(L, required, absent + ["hist_count"])
        counted_runs.append(L)
    print(f"  (h) config 5 (a) over a (1, 2) mesh, two gloo ranks on cuda:0, "
          f"a 16384x8192 stripe of 5,242,880 blocks a rank: path "
          f"{recs[0]['path']}, == phase 9 (a)'s {want_len} bytes (sha256) on "
          f"both ranks in each of three encodes, rung {recs[0]['rung']}; "
          f"per-rank launches of the second {recs[0]['launches']}; the "
          f"second, warm, per rank:")
    print_shard_ranks("(h)", recs, mp)
    for r, rec in enumerate(recs):
        print(f"    rank {r}: the first (cold) encode's peak device memory "
              f"{rec['first']['peak'] / 2**20:.1f} MiB; the kept rung's "
              f"counts: {rec['widths']}")

    launches = sum_launches(*counted_runs)
    check_launches(launches, required + ["fold_rows", "hist_count"], absent)
    results = shard_kernel_checks(dev, config5["img"], ranks[0]["a"]["rung"],
                                  ranks[0]["d"]["rung"])
    widths = {}
    results.update(shard_kernel_checks(dev, config5["img"], recs[0]["rung"],
                                       None, n_stripes=2, widths=widths))
    print_widths(widths, recs)
    return {"sharded": launches}, results


def check_phase11i(recs, flagship_bytes):
    """Phase 11 (i)'s checks on the four ranks' records: every rank's
    files equal rank 0's references and phase 5's flagship; returns the
    calls' launches."""
    import hashlib

    flagship = [hashlib.sha256(flagship_bytes).hexdigest()]
    want = {"batch3": (recs[0]["batch3_want"]["sha256"],
                       recs[0]["batch3_want"]["path"]),
            "encode_image": (flagship, "device-v2"),
            "encode_stream": (flagship, "device-chunked-stream"),
            "sharded4": (recs[0]["sharded4_want"]["sha256"],
                         "sharded-general")}
    runs = []
    for r, rec in enumerate(recs):
        for key, (sha, path) in want.items():
            if (rec[key]["sha256"], rec[key]["path"]) != (sha, path):
                raise AssertionError(f"(i) rank {r}'s {key} differs: "
                                     f"{rec[key]['path']}, want {path}")
            check_launches(rec[key]["launches"],
                           ["fdct_quantize", "pack_blocks", "merge_chunks",
                            "concat_rows"],
                           ["pack_acbands", "fused_sample_pack", "hist_sym",
                            "hist_count"])
            runs.append(rec[key]["launches"])
    print(f"  (i) on (e)'s ranks: encode_batch of 3 config-1 images == "
          f"Encoder.encode_batch's files on its route {want['batch3'][1]}; "
          f"encode_image (RGB planes) and encode_stream of the flagship == "
          f"phase 5's {len(flagship_bytes)} bytes; encode_batch_sharded of 4 "
          f"config-1 images == Encoder.encode's; on every rank")
    return runs


def print_widths(widths, recs):
    """Phase 11 (h)'s counts: each field's largest value in this run, its
    width, and 2^31 - 1 over it (the headroom of an int32; where the
    field is int64, how far an int32 in its place would have been from
    wrapping)."""
    rows = dict(widths)
    for key, width in (("block_bits", "int32"), ("segment_bits", "int64"),
                       ("scan_bits", "int64")):
        rows[f"ranks' {key} (StripeScan)"] = (
            max(rec["widths"][key] for rec in recs), width)
    print("  (h) counts on the stripe path at the kept rung: largest value, "
          "width, (2^31 - 1) / value")
    for key, (value, width) in rows.items():
        print(f"    {key}: {value} {width} "
              f"{(2**31 - 1) / max(value, 1):.2f}x")


def shard_kernel_checks(dev, img, rung, rung_d, n_stripes=SHARD_RANKS,
                        widths=None):
    """Phase 11's kernels at the shapes of config 5's stripes over
    ``n_stripes`` against their plain versions, as phase 3 holds them: K1
    on a stripe's Y blocks; K2 on stripe 1's MCU stream, its DC chain
    continued from stripe 0's tail, then K3, K4 where the merge folds, and
    K5, at (a)'s ``rung`` (their counts into ``widths``); unless
    ``rung_d`` is None, K7 on stripe 1's Y stream, and K2-K5 on it as
    (d)'s Y scan packs it, at (d)'s rung (with the default tables)."""
    from tpuenc_torch import ColorType
    from tpuenc_torch.entropy import pallas_hist as ph
    from tpuenc_torch.entropy import pallas_pack as pk
    from tpuenc_torch.kernels import pipeline
    from tpuenc_torch.shard import stripes
    from tpuenc_torch.plan import make_plan

    ct = ColorType.CMYK_AS_YCCK
    results = {}
    enc = config5_encoder(dev)
    config = enc._config()
    params = enc._default_tables(config)[2]
    label = ("sharded stripe" if n_stripes == SHARD_RANKS
             else f"sharded stripe (1, {n_stripes})")
    geo = stripes.stripe_geometry(CONFIG5, CONFIG5, ct, config, n_stripes)
    rows = stripes.stripe_pixel_rows(geo)
    px0 = stripes.pad_stripe([img], geo, 0, dev)[0]
    px1 = stripes.pad_stripe([img], geo, 1, dev)[0]
    y = config5_chunk_y(dev, px1)
    print(f"  kernels at the shapes of config 5 over {n_stripes} stripes: "
          f"K1 on a stripe's Y blocks, {y.shape[1]}")
    check_kernel(results, *k1_case(f"K1 fdct_quantize {label}", y, params),
                 reps=5)
    del y
    (mcu0,) = pipeline.fn_cm(px0, CONFIG5, rows, ct, config,
                             params.reciprocals, params.corrections)
    (mcu1,) = pipeline.fn_cm(px1, CONFIG5, rows, ct, config,
                             params.reciprocals, params.corrections)
    ((_, spec, _),) = make_plan(CONFIG5, CONFIG5, ct, config).scans
    pat = len(spec.dc_tab_pattern)
    dcdiff = pk.dc_diffs_from_dc(mcu1[0], spec, prev_tail=mcu0[0, -pat:],
                                 global_offset=mcu0.shape[1])
    print(f"  stripe 1: {mcu1.shape[1]} blocks at offset {mcu0.shape[1]}, "
          f"its DC chain from stripe 0's tail, rung {rung}")
    for case in pack_merge_cases(params, spec, mcu1, rung, label,
                                 dcdiff=dcdiff, valid=mcu1.shape[1],
                                 widths=widths):
        check_kernel(results, *case, reps=5)
    del mcu0, mcu1, dcdiff
    if rung_d is None:
        return results
    config_d = config5_encoder(dev, optimized=True)._config()
    luma = pipeline.fn_cm(px1, CONFIG5, rows, ct, config_d, params.reciprocals,
                          params.corrections)[0].contiguous()
    print(f"  K7 on a stripe's Y stream: {luma.shape[1]} blocks, band (1, 64)")
    check_kernel(results, "K7 hist_count sharded stripe",
                 lambda: ph.hist_count(luma, [(1, 64)]),
                 lambda: ph.hist_count_ref(luma, [(1, 64)]), nbytes(luma),
                 reps=5)
    spec_y = make_plan(CONFIG5, CONFIG5, ct, config_d).scans[0][1]
    prev = pipeline.fn_cm(px0, CONFIG5, rows, ct, config_d, params.reciprocals,
                          params.corrections)[0][0, -1:]
    dcdiff = pk.dc_diffs_from_dc(luma[0], spec_y, prev_tail=prev,
                                 global_offset=luma.shape[1])
    print(f"  (d)'s Y scan of stripe 1: {luma.shape[1]} blocks, rung {rung_d}")
    for case in pack_merge_cases(params, spec_y, luma, rung_d,
                                 "sharded stripe (d) Y", dcdiff=dcdiff,
                                 valid=luma.shape[1]):
        check_kernel(results, *case, reps=5)
    return results


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
    sys.stdout.reconfigure(line_buffering=True)
    dev = torch.device("cuda:0")
    flagship = {"finish": {}}
    config5 = {}

    def phase_5():
        (launches, flagship["bytes"], flagship["rung"],
         flagship["finish"]["split"]) = phase_flagship(dev)
        return launches

    def phase_6():
        (launches, flagship["progressive"], flagship["progressive_rung"],
         flagship["finish"]["progressive"]) = phase_progressive(dev)
        return launches

    phases = [("1. environment", phase_env), ("2. build", phase_build),
              ("3. kernels vs plain versions (flagship shapes, tolerance 0)",
               lambda: phase_kernels(dev)),
              ("4. fixtures", lambda: phase_fixtures(dev)),
              ("5. flagship, interleaved", phase_5),
              ("6. flagship, progressive with optimized tables", phase_6),
              ("7. flagship, interleaved, fused P1 (K8)",
               lambda: phase_fused(dev, flagship["bytes"], flagship["rung"],
                                   flagship["finish"])),
              ("8. batch (encode_batch: single program, per image)",
               lambda: phase_batch(dev, flagship["bytes"])),
              ("9. bounded memory and streaming (BASELINE config 5, "
               "16384x16384 YCCK)",
               lambda: phase_config5(dev, flagship["bytes"],
                                     flagship["progressive"], config5)),
              ("10. the device finish beside the host finish on the "
               "flagship routes, the fixtures and near the block limit",
               lambda: phase_device_finish(dev, flagship)),
              ("11. striped encode over ranks (BASELINE config 5 over 4 "
               "gloo ranks on cuda:0, config 1 over (2, 2), the dryrun "
               "twin, a one-rank NCCL mesh, config 5 over 2 ranks, the "
               "inherited entry points)",
               lambda: phase_sharded(dev, flagship["bytes"], config5))]
    out = {}
    for title, fn in phases:
        print(f"== {title}")
        t0 = time.perf_counter()
        out[title] = fn()
        if title.startswith("3."):
            tests_only = {k.__name__: k.launches for k in counted_kernels()}
        print(f"   ({time.perf_counter() - t0:.2f} s)")
    batch_paths, batch_results = out[phases[7][0]]
    config5_paths, config5_results = out[phases[8][0]]
    sharded_paths, sharded_results = out[phases[10][0]]
    results = {**out[phases[2][0]], **batch_results, **config5_results,
               **sharded_results}
    paths = {"interleaved": out[phases[4][0]],
             "progressive_optimized": out[phases[5][0]],
             "interleaved_fused": out[phases[6][0]],
             **batch_paths, **config5_paths, **out[phases[9][0]]}

    kernels = []
    for name, counter, key, source, replaces in KERNELS:
        r = results[key]
        cases = {k: v for k, v in results.items() if k.startswith(name)}
        by_path = {p: n[counter] for p, n in paths.items() if n[counter]}
        # Phase 11's ranks, summed: every row names the path, 0 included.
        by_path["sharded"] = sharded_paths["sharded"][counter]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            # ms and plain_ms: the call with the card idle, the wrapper's
            # host time in it, as the caller sees it; device_ms: the kernel
            # and its wrapper's small fills alone (cuda_ms queued).
            "max_abs_err": max(v["err"] for v in cases.values()),
            "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            # Integer work, no matrix product: the bytes bound it.
            "bound_ms": r["bound"], "bound_by": "bytes",
            # No single PyTorch call computes any of these functions.
            "library_ms": None,
            "path": "+".join(p for p, n in by_path.items() if n),
            "launches_by_path": by_path,
            # Every shape the kernel was held against its plain version
            # at (phase 3's, the batches' of phase 8 and phase 9's).
            "checks": [{"case": k, "max_abs_err": v["err"], "ms": v["ms"],
                        "device_ms": v["device_ms"], "plain_ms": v["plain_ms"],
                        "bound_ms": v["bound"]} for k, v in cases.items()],
        }
        if not any(by_path.values()):  # K9: tpuenc's tests only
            entry.update(launches=tests_only[counter], path="tests only")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
