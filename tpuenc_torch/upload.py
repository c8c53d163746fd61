"""The pixel upload: a caller's host pixels onto the encode device.

A pageable host-to-device copy (``torch.from_numpy(a).to("cuda")``) is
staged by the CUDA runtime through its own page-locked buffer on one
thread, and waits for the work queued on the stream before it.  On a
CUDA device :func:`to_device` and :func:`copy_into` copy the pixels
instead through the device's one :class:`StagedUpload`: a host copy of
the whole array into a part of one page-locked buffer on several threads
(:class:`CopyPool`), then one DMA of that part on a copy stream of its
own.  Arrays staged back to back take the buffer's parts in turn, so the
host copy of one (a batch's next image) runs beside the DMA of the one
before; the host waits only for the buffer's DMAs, and only when it
starts again from the buffer's head.  A new tensor's copy waits for no
compute work on the device either.  On the CPU the pixels are used where
they are, with no copy.

The host copy runs on threads of its own, as many in all as torch's
intra-op threads, the calling thread among them (``csrc/host_copy.cpp``).
Torch's parallel copy would do the same work on its OpenMP pool, whose
threads spin for milliseconds after each copy: between the encodes of a
call they kept seven cores busy and slowed the calling thread's launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .entropy import native

# The page-locked buffer's size, in bytes: room for a batch of eight
# 2000x1800 RGB photos (86.4 MB) back to back.  A larger array grows it.
BUFFER_BYTES = 96 << 20


def place(used: int, capacity: int, nbytes: int) -> Tuple[int, int]:
    """Where ``nbytes`` go in a buffer of ``capacity`` bytes whose first
    ``used`` hold arrays staged before: ``(offset, capacity)``.  Right
    after them where they fit, else at the head (once every earlier DMA
    has read the buffer), in a buffer grown to ``nbytes`` where it is
    smaller."""
    if used + nbytes <= capacity:
        return used, capacity
    return 0, max(capacity, nbytes)


_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "host_copy.cpp")
_lock = threading.Lock()
_lib = None


def _library():
    """The host-copy library, built with g++ into the port's build
    directory under a name keyed on its source's hash (as
    ``entropy.native`` builds its own) and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            path = os.path.join(native.BUILD_DIR,
                                f"libtpuenc_host_copy-{digest}.so")
            if not os.path.exists(path):
                native._build(_SRC, path)
            lib = ctypes.CDLL(path)
            lib.tpuenc_copy_pool_new.restype = ctypes.c_void_p
            lib.tpuenc_copy_pool_new.argtypes = [ctypes.c_int32]
            lib.tpuenc_copy_pool_free.restype = None
            lib.tpuenc_copy_pool_free.argtypes = [ctypes.c_void_p]
            lib.tpuenc_copy.restype = ctypes.c_int32
            lib.tpuenc_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
    return _lib


class CopyPool:
    """``helpers`` threads that, with the calling thread, copy host
    buffers piece by piece; they sleep between copies, after at most 0.5
    ms of spinning (which spans the gap between a batch's images).  One
    copy at a time; the threads end with the object."""

    def __init__(self, helpers: int):
        self._lib = _library()
        self._handle = self._lib.tpuenc_copy_pool_new(int(helpers))
        weakref.finalize(self, self._lib.tpuenc_copy_pool_free, self._handle)

    def copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        """Copy ``src`` into ``dst``: two C-contiguous uint8 arrays of one
        size that do not overlap."""
        if (dst.dtype != np.uint8 or src.dtype != np.uint8
                or dst.size != src.size or not dst.flags.c_contiguous
                or not src.flags.c_contiguous or not dst.flags.writeable):
            raise ValueError("copy takes two contiguous uint8 arrays of one "
                             "size, the first writable")
        if self._lib.tpuenc_copy(self._handle, dst.ctypes.data,
                                 src.ctypes.data, src.size):
            raise ValueError(f"cannot copy {src.size} bytes")


def _host_tensor(pixels: np.ndarray) -> torch.Tensor:
    """``pixels`` as a C-contiguous uint8 CPU tensor, copied only where
    the array is read-only (``torch.from_numpy`` warns on one) or not
    contiguous."""
    if not pixels.flags.writeable:
        pixels = pixels.copy()
    return torch.from_numpy(np.ascontiguousarray(pixels))


class StagedUpload:
    """Host pixels onto one CUDA device through one page-locked buffer of
    :data:`BUFFER_BYTES` (or the largest array staged), one copy stream,
    an event for the buffer's last DMA and a :class:`CopyPool` of
    ``torch.get_num_threads() - 1`` threads, made at the first upload and
    reused for the life of the object.  :func:`stager` keeps one a device
    for the whole process.

    Each upload returns once the whole host array has been read, so the
    caller may then overwrite or free it; the device tensor is ready for
    work queued on the current stream after the call.  One upload at a
    time (a lock): a part of the buffer is refilled only after the DMAs
    that read it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._buffer: Optional[torch.Tensor] = None
        self._used = 0
        self._last_dma = None
        self._stream = None
        self._copier: Optional[CopyPool] = None

    def upload(self, pixels: np.ndarray) -> torch.Tensor:
        """``pixels`` (uint8, any layout) as a new tensor of its shape on
        the device.

        The tensor is allocated on the copy stream, whose queue holds
        only the buffer's DMAs, and marked as used by the current stream
        (``record_stream``): its memory goes back to the copy stream only
        after the current stream's work on it, so the copy waits for no
        compute work."""
        host = _host_tensor(pixels)
        with self._lock:
            self._make()
            with torch.cuda.stream(self._stream):
                dst = torch.empty(host.shape, dtype=torch.uint8,
                                  device=self.device)
            self._stage(dst, host)
        dst.record_stream(torch.cuda.current_stream(self.device))
        return dst

    def upload_into(self, dst: torch.Tensor, pixels: np.ndarray) -> None:
        """Copy ``pixels`` into ``dst``, a contiguous uint8 tensor of its
        byte size on the device (a slot of a batch).  ``dst`` is the
        caller's, from the current stream's memory, so the copy first
        waits on the device for the work queued there before it."""
        host = _host_tensor(pixels)
        with self._lock:
            self._make()
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._stage(dst, host)

    def _make(self) -> None:
        if self._stream is None:
            self._last_dma = torch.cuda.Event()
            self._stream = torch.cuda.Stream(self.device)
            self._copier = CopyPool(torch.get_num_threads() - 1)

    def _stage(self, dst: torch.Tensor, host: torch.Tensor) -> None:
        if not dst.is_contiguous() or dst.numel() != host.numel():
            raise ValueError(f"cannot stage {host.numel()} bytes into a "
                             f"{tuple(dst.shape)} tensor")
        n = host.numel()
        if n == 0:
            return
        capacity = BUFFER_BYTES if self._buffer is None else \
            self._buffer.numel()
        at, capacity = place(self._used, capacity, n)
        if at < self._used:
            self._last_dma.synchronize()  # every DMA from the buffer
        if self._buffer is None or self._buffer.numel() < capacity:
            self._buffer = torch.empty(capacity, dtype=torch.uint8,
                                       pin_memory=True)
        part = self._buffer[at:at + n]
        self._used = at + n
        self._copier.copy(part.numpy(), host.numpy().reshape(-1))
        with torch.cuda.stream(self._stream):
            dst.view(-1).copy_(part, non_blocking=True)
        self._last_dma.record(self._stream)
        tracing.count("upload_slabs")
        torch.cuda.current_stream(self.device).wait_stream(self._stream)


_stagers: Dict[torch.device, StagedUpload] = {}


def stager(device) -> StagedUpload:
    """The process's :class:`StagedUpload` for a CUDA ``device``, made at
    its first use; ``"cuda"`` is the current device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        if device not in _stagers:
            _stagers[device] = StagedUpload(device)
        return _stagers[device]


def to_device(pixels: np.ndarray, device) -> torch.Tensor:
    """``pixels`` (uint8, any layout) as a tensor of its shape on
    ``device``: on a CUDA device staged through :func:`stager`'s ring; on
    the CPU the array itself, where it is contiguous and writable."""
    device = torch.device(device)
    if device.type != "cuda":
        return _host_tensor(pixels).to(device)
    return stager(device).upload(pixels)


def copy_into(dst: torch.Tensor, pixels: np.ndarray) -> None:
    """Copy ``pixels`` into ``dst``, a contiguous uint8 tensor of its byte
    size (a slot of a batch), staged as :func:`to_device` stages."""
    if dst.device.type != "cuda":
        dst.copy_(_host_tensor(pixels).view(dst.shape))
        return
    stager(dst.device).upload_into(dst, pixels)
