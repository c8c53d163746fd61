"""tpuenc_torch.upload on the CPU: each array's place in the page-locked
buffer, the host-copy pool copies every byte once from any number of
threads, one copy after another, and on the CPU an upload stages nothing
(the array itself, or a plain copy into a batch slot)."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from tpuenc_torch import tracing, upload

BUF = upload.BUFFER_BYTES


@pytest.mark.parametrize("used,capacity,nbytes,want", [
    (0, BUF, 0, (0, BUF)),
    (0, BUF, 1, (0, BUF)),
    (5, BUF, BUF - 5, (5, BUF)),
    (5, BUF, BUF - 4, (0, BUF)),
    (0, BUF, BUF, (0, BUF)),
    (0, BUF, BUF + 1, (0, BUF + 1)),
    (BUF, BUF, 1, (0, BUF)),
    (7, BUF, 3 * BUF, (0, 3 * BUF)),
], ids=["empty", "one", "fills", "one-over", "whole", "grows", "full",
        "grows-from-used"])
def test_place_after_the_last_or_at_the_head(used, capacity, nbytes, want):
    """An array goes right after those staged before where it fits, else
    at the head of a buffer that grows only for an array larger than it."""
    assert upload.place(used, capacity, nbytes) == want


def test_place_a_batch_back_to_back():
    """Eight 2000x1800 RGB photos take the buffer's parts in turn, so
    each image's host copy runs beside the DMA of the one before; the
    buffer holds nine, and the tenth starts again at the head."""
    photo = 2000 * 1800 * 3
    used, capacity, offsets = 0, BUF, []
    for _ in range(16):
        at, capacity = upload.place(used, capacity, photo)
        offsets.append(at)
        used = at + photo
    assert offsets[:10] == [i * photo for i in range(9)] + [0]
    assert offsets[10:] == offsets[1:7] and capacity == BUF


PIECE = 512 << 10  # csrc/host_copy.cpp's kPiece


@pytest.mark.parametrize("helpers", [0, 1, 3, 15])
def test_copy_pool_copies_every_byte(helpers):
    """Sizes around a piece and many pieces, then many small copies back
    to back (each a new generation of the pool's ticket), with more
    threads than cores: every copy lands whole."""
    rng = np.random.default_rng(helpers)
    sizes = [0, 1, PIECE - 1, PIECE, PIECE + 1, 5 * PIECE + 3]
    sizes += [int(n) for n in rng.integers(0, 3 * PIECE, 200)]
    errors = []

    def run():
        pool = upload.CopyPool(helpers)
        for n in sizes:
            src = rng.integers(0, 256, n, np.uint8)
            dst = np.zeros(n, np.uint8)
            pool.copy(dst, src)
            if not np.array_equal(dst, src):
                errors.append(n)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and not errors


def test_copy_pool_refuses_mismatched_arrays():
    pool = upload.CopyPool(1)
    a = np.zeros(8, np.uint8)
    for dst, src in ((a, np.zeros(9, np.uint8)), (a, np.zeros(8, np.int8)),
                     (np.zeros((4, 4), np.uint8)[:, :2], a)):
        with pytest.raises(ValueError):
            pool.copy(dst, src)


def test_copy_pool_alternating_sizes_with_more_threads_than_cores():
    """Copies of one and of many pieces in turn, back to back, with more
    helper threads than cores, so that helpers are preempted between
    reading the ticket and taking a piece: a helper late from one copy
    never takes a piece of the next, and each copy is whole when it
    returns (a fresh fill value each time, so a stale byte shows)."""
    helpers = 2 * (os.cpu_count() or 4) + 1
    sizes = (1, PIECE + 1, 1, 9 * PIECE - 5, PIECE, 2 * PIECE + 7)
    src = np.empty(9 * PIECE, np.uint8)
    dst = np.empty(9 * PIECE, np.uint8)
    errors = []

    def run():
        pool = upload.CopyPool(helpers)
        for i in range(3000):
            n = sizes[i % len(sizes)]
            fill = i % 251 + 1
            src[:n] = fill
            dst[:n] = 0
            pool.copy(dst[:n], src[:n])
            if dst[0] != fill or dst[n - 1] != fill or (
                    i % 16 == 0 and not (dst[:n] == fill).all()):
                errors.append(i)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and not errors


def test_cpu_upload_is_the_array_itself():
    px = np.random.default_rng(1).integers(0, 256, (6, 5, 3), np.uint8)
    t = upload.to_device(px, "cpu")
    assert t.device.type == "cpu" and t.dtype == torch.uint8
    assert t.data_ptr() == px.ctypes.data  # no copy, no staging
    assert not upload._stagers  # no ring on the CPU


@pytest.mark.parametrize("layout", ["read_only", "strided"])
def test_cpu_upload_of_other_layouts(layout):
    px = np.random.default_rng(2).integers(0, 256, (6, 10, 3), np.uint8)
    src = px[:, ::2] if layout == "strided" else px.copy()
    if layout == "read_only":
        src.flags.writeable = False
    t = upload.to_device(src, torch.device("cpu"))
    assert t.is_contiguous() and np.array_equal(t.numpy(), src)
    slots = torch.zeros((2, *src.shape), dtype=torch.uint8)
    upload.copy_into(slots[1], src)
    assert np.array_equal(slots[1].numpy(), src) and not slots[0].any()


def test_cpu_upload_counts_no_slab():
    px = np.zeros((4, 4), np.uint8)
    tracing.enable()
    try:
        with tracing.request("encode"), tracing.span("upload"):
            upload.to_device(px, "cpu")
            upload.copy_into(torch.zeros(16, dtype=torch.uint8), px)
        (req,) = tracing.requests()
    finally:
        tracing.disable()
    assert "upload_slabs" not in req.counters
