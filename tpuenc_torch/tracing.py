"""The encoder's own tracing: requests, stage spans and counters.

Off by default.  While off, :func:`span` and :func:`request` return one
shared null context and :func:`count` returns at once: nothing reads a
clock or enters ``torch.profiler.record_function``.  :func:`enable`
turns it on for the whole process; then

* each public entry call (``Encoder.encode``, ``encode_image``,
  ``encode_batch``, ``encode_stream``) is a :class:`Request` with an id;
* each stage the call runs through is a :class:`Span`: its name, the index
  of its parent span in the request, its start and end from
  ``time.perf_counter_ns`` and the request's id;
* counters add up per request, and each request keeps the kernel
  wrappers' launches over it (the wrappers' ``launches`` attributes, the
  one count of kernel launches);
* the last ``keep`` finished requests are kept, and :func:`requests`
  returns them, oldest first.

With ``annotate`` set, every span opened while ``torch.profiler``
records also runs inside ``torch.profiler.record_function(annotate +
name)``, so that each stage sits on the profiler's clock beside the
device's kernels and copies, and an idle stretch of the device can be
put down to the stage the host was in.  While no profiler records, the
annotation would show nowhere and cost some 15 us a span, so it is not
entered.

A span records into the request open on its thread: span stacks are
thread-local, so concurrent callers' spans never interleave, and a span
opened where no request is open (a stage called on its own) records
nothing.  A request opened inside another is a span named ``encode`` of
the outer one.  Kernel launches are counted process-wide, so a request's
``launches`` include other threads' launches made while it ran.

The spans, where they open (each inside the function it measures):

``encode``
    the request: each public entry call (each resumption of a stream).
``plan``
    the per-call set-up: tables, route and scan plan.
``upload``
    a host-to-device copy: the pixels, the slots of a batch, a chunk's
    rows (on a CUDA device through ``upload.StagedUpload``'s page-locked
    buffer), small tables.
``transform``
    the coefficient stage, launched (``kernels.pipeline.fn_cm``,
    ``fn_cm_samples``).
``histograms``, ``tables``
    the two-pass mode: the symbol counts, launched, and the host's K.2
    build.
``pack``
    one attempt of the packer's ladder, launched; ints ``rung`` and
    ``blocks``.
``sync.<what>``
    a blocking read of a device result: ``meta``, ``hist``, ``counts``,
    ``bytes``, ``rows``.
``finish.device``, ``finish.host``, ``finish.stream``
    the finish without its reads: the device finish's launches and the
    split into scans; the host realigner (the tests' reference finish, on
    no route); the chunked routes' finish of a chunk, its segment walk
    and launches (and the check at a scan's end).
``assemble``
    the file's assembly: its segments and scan payloads gathered in one
    copy.
``multipass.store``, ``multipass.scan``
    the chunked multipass route's two passes: every chunk's rows read,
    transformed, written into the coefficient store and counted, launched
    (once a call; ``upload``, ``transform`` and ``histograms`` inside);
    one scan packed from its store in chunks and finished, with the int
    ``scan`` (once a scan; ``pack``, ``sync.*`` and ``finish.stream``
    inside).

The counters: ``syncs``, one for every host-blocking device operation,
which is each ``upload`` (the staged upload waits on the host for the
DMAs from its page-locked buffer when it starts again from the buffer's
head; a table's small copy is pageable) and each ``sync.*`` span, counted
as they would block on a CUDA device; ``upload_slabs``, one for each host
array staged through the page-locked buffer on a CUDA device, one host
copy and one DMA: an image, a batch's slot or a chunk's rows (none on the
CPU, nor for rows already on the device); ``ladder_retries``, one for
each pack whose overflow sends it to the next rung; ``restart_segments``,
one for each restart segment a finish closes (the device finish's, each
scan's segments summed, and the streaming stuffer's, once a scan), so a
scan with no restart interval counts one; ``device_finished_chunks``, one
for each chunk of a chunked route finished on the device;
``assembled_bytes``, the bytes of each file that the assembly gathers (a
stream's pieces are handed over as they are made, and count none);
``store_bytes``, the bytes of the chunked multipass route's coefficient
store, 128 a block of each component padded to its pack chunk.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from collections import deque
from time import perf_counter_ns
from typing import Dict, List, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NULL = contextlib.nullcontext()

# Span names that block the host on a CUDA device: each adds one to the
# request's ``syncs``.
_BLOCKING_PREFIX = "sync."
_UPLOAD = "upload"

_on = False
_annotate: Optional[str] = None
_kept: deque = deque(maxlen=65536)
_ids = itertools.count(1)
_local = threading.local()
_wrappers: list = []


class Span:
    """One stage of a request: ``name``, ``parent`` (the index of the
    enclosing span in the request's ``spans``, None for the request's own
    ``encode``), ``start`` and ``end`` (``time.perf_counter_ns``),
    ``request`` (the request's id) and ``ints`` (the stage's sizes)."""

    __slots__ = ("name", "parent", "start", "end", "request", "ints")

    def __init__(self, name, parent, request, ints):
        self.name = name
        self.parent = parent
        self.request = request
        self.ints = ints
        self.start = self.end = 0

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, "
                f"ns={self.ns}, ints={self.ints})")


class Request:
    """One public entry call: ``id``, ``entry`` (the method's name),
    ``spans`` in the order they opened, ``counters`` and ``launches``
    (kernel wrapper name -> launches while the request ran)."""

    __slots__ = ("id", "entry", "spans", "counters", "launches")

    def __init__(self, entry):
        self.id = next(_ids)
        self.entry = entry
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}


def kernel_wrappers():
    """Every kernel wrapper, K1-K9, each with its ``launches`` counter."""
    from .entropy import pallas_hist as ph
    from .entropy import pallas_pack as pk
    from .kernels import pallas_fdct

    return [pallas_fdct.fdct_quantize, pk.pack_blocks, pk.merge_chunks,
            pk.fold_rows, pk.concat_rows, pk.pack_acbands, ph.hist_count,
            pk.fused_sample_pack, ph.hist_sym]


def _launches() -> Dict[str, int]:
    if not _wrappers:
        _wrappers.extend(kernel_wrappers())
    return {fn.__name__: fn.launches for fn in _wrappers}


def enable(keep: int = 65536, annotate: Optional[str] = None) -> None:
    """Turn tracing on, keeping the last ``keep`` finished requests (the
    ones kept so far are dropped).  ``annotate``: a prefix; where given,
    each span opened while a profiler records also enters
    ``record_function(annotate + name)``."""
    global _on, _annotate, _kept
    if keep < 1:
        raise ValueError(f"keep must be positive, got {keep}")
    _kept = deque(maxlen=int(keep))
    _annotate = annotate
    _on = True


def disable() -> None:
    """Turn tracing off; the requests kept so far stay readable."""
    global _on, _annotate
    _on = False
    _annotate = None


def requests() -> List[Request]:
    """The finished requests kept, oldest first."""
    return list(_kept)


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.request = None
        return _local.stack


class _Span:
    __slots__ = ("name", "ints", "record", "annotation")

    def __init__(self, name, ints):
        self.name = name
        self.ints = ints
        self.record = self.annotation = None

    def __enter__(self):
        stack = _stack()
        req = _local.request
        if req is None:
            return self
        if self.name.startswith(_BLOCKING_PREFIX) or self.name == _UPLOAD:
            req.counters["syncs"] = req.counters.get("syncs", 0) + 1
        self.record = Span(self.name, stack[-1] if stack else None, req.id,
                           self.ints)
        stack.append(len(req.spans))
        req.spans.append(self.record)
        if _annotate is not None and _profiler_enabled():
            self.annotation = record_function(_annotate + self.name)
            self.annotation.__enter__()
        self.record.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.record is None:
            return
        self.record.end = perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _local.stack.pop()


def span(name: str, **ints):
    """A context manager around one stage of the open request; ``ints``:
    the stage's sizes.  While tracing is off, the shared null context."""
    if not _on:
        return _NULL
    return _Span(name, ints)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the request open on this thread."""
    if not _on:
        return
    req = getattr(_local, "request", None)
    if req is not None:
        req.counters[name] = req.counters.get(name, 0) + n


class _Request:
    """A request, entered once and finished on exit (:func:`request`), or
    entered once per resumption of a stream and finished by :meth:`close`
    (:func:`stream`)."""

    __slots__ = ("req", "launched", "once", "outer", "top")

    def __init__(self, entry, once):
        self.req = Request(entry)
        self.launched = _launches()
        self.once = once

    def __enter__(self):
        _stack()
        self.outer = (_local.request, _local.stack)
        _local.request, _local.stack = self.req, []
        self.top = _Span("encode", {})
        self.top.__enter__()
        return self.req

    def __exit__(self, *exc):
        self.top.__exit__(*exc)
        _local.request, _local.stack = self.outer
        if self.once:
            self.close()

    def close(self):
        self.req.launches = {k: v - self.launched[k]
                             for k, v in _launches().items()}
        _kept.append(self.req)


def request(entry: str):
    """A context manager around one public entry call.  Inside an open
    request it is a span named ``encode`` of that request; while tracing
    is off, the shared null context."""
    if not _on:
        return _NULL
    if getattr(_local, "request", None) is not None:
        return _Span("encode", {})
    return _Request(entry, once=True)


def stream(entry: str, pieces):
    """Yield from the generator ``pieces`` as one request ``entry``: the
    request is entered for each resumption and left at each yield, so no
    span stays open across a yield, and it is finished when ``pieces``
    ends or the caller closes the stream."""
    if not _on or getattr(_local, "request", None) is not None:
        yield from pieces
        return
    req = _Request(entry, once=False)
    try:
        while True:
            with req:
                try:
                    piece = next(pieces)
                except StopIteration:
                    return
            yield piece
    finally:
        pieces.close()
        req.close()
