"""Run a function on every rank of a process group, each rank a process.

``launch(target, world_size, ...)`` starts ``world_size`` processes with
the ``spawn`` method (a fresh interpreter each: a fork after CUDA's
initialization fails), joins them in one ``torch.distributed`` process
group over a ``FileStore`` in a directory of the caller's (no fixed TCP
port, so several launches can run at once), calls ``target(*args)`` on
each, and returns the results in rank order.  The tests and
``chip_smoke.py`` share it.

It never hangs its caller: the process group has a timeout, and the
parent waits for the ranks until a deadline.  A rank that raises, or that
has not finished by the deadline, makes the launch kill every rank and
raise ``RuntimeError`` with each failed rank's traceback.  ``target`` must
be importable by name from a module that imports no JAX (``tpuenc_torch``
or the caller's ``__main__``), since each rank imports it afresh; its
results come back through one pickle file per rank.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional

# Seconds a collective waits for its peers before it raises.
PG_TIMEOUT_S = 60


def _rank_main(target, args, rank: int, world_size: int, backend: str,
               store: str, out: str, cuda_device: Optional[int]) -> None:
    import torch
    import torch.distributed as dist

    # Ranks share the host's cores: torch's intra-op thread pool in each
    # would spin against the others' (a small CPU encode ran 25x slower
    # with 4 ranks of 8 threads on 8 cores).
    torch.set_num_threads(1)
    try:
        if cuda_device is not None:
            torch.cuda.set_device(cuda_device)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            result = ("ok", target(*args))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(out + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".part", out)
    if result[0] != "ok":
        raise SystemExit(1)


def _failure(proc, out: str) -> Optional[str]:
    """What went wrong on the rank of ``proc``, or None if it returned."""
    if os.path.exists(out):
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        return None if status == "ok" else value
    return f"exited with code {proc.exitcode} and no result"


def launch(target, world_size: int, args=(), *, backend: str = "gloo",
           timeout: float = 300.0, workdir: Optional[str] = None,
           cuda_device: Optional[int] = None) -> list:
    """``target(*args)`` on each of ``world_size`` ranks joined in one
    process group of ``backend``; returns the ranks' results in rank order.

    ``timeout``: seconds from the start until every rank must have
    returned; ``workdir``: where the store and the result files go (a new
    temporary directory by default, under ``TMPDIR``); ``cuda_device``:
    each rank's ``torch.cuda.set_device`` before the group is made (NCCL
    needs it).  The kernels and the native library are built here, in the
    parent, first: the ranks load them and never build."""
    from ..entropy import native

    native._load()
    if cuda_device is not None:
        from .. import cuda_lib

        cuda_lib.library()
    workdir = tempfile.mkdtemp(prefix="tpuenc-dist-", dir=workdir)
    store = os.path.join(workdir, "store")
    outs = [os.path.join(workdir, f"rank{r}.pkl") for r in range(world_size)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, tuple(args), r, world_size, backend,
                               store, outs[r], cuda_device))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            # A failed rank leaves its peers waiting in a collective:
            # stop at the first failure, not at the deadline.
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        _stop(procs)
        errors, results = _collect(procs, outs, timeout)
    finally:
        _stop(procs)
        shutil.rmtree(workdir, ignore_errors=True)
    if errors:
        raise RuntimeError(f"{len(errors)} of {world_size} ranks failed:\n"
                           + "\n".join(errors))
    return results


def _stop(procs) -> None:
    """Kill the ranks still running and reap every started one."""
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        if p.pid is not None:
            p.join(10)


def _collect(procs, outs, timeout):
    """(each failed rank's report, the results in rank order)."""
    errors = []
    for r, p in enumerate(procs):
        why = _failure(p, outs[r])
        if why is not None:
            if p.exitcode == -9 and not os.path.exists(outs[r]):
                why = f"killed: no result within {timeout} s, or a peer failed"
            errors.append(f"rank {r}: {why}")
    if errors:
        return errors, None
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f)[1])
    return errors, results
