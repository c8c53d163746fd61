"""``restart_segments_per_call`` on the CPU: the port's counter over the
window's calls, nothing from a port that lacks the counter, and the count
that each new cell's files fix, in a traced run at a small size."""

import importlib
import math
import time

import pytest

from harness import bench, cells
from tpuenc_torch import tracing

SPEC = cells.load_benchmark()


@pytest.fixture(autouse=True)
def program():
    try:
        yield importlib.import_module("harness.program")
    finally:
        tracing.disable()


def run_of(calls):
    return bench.Run(calls=calls, pixels_per_call=1_000_000,
                     images_per_call=1, traffic={"takes": "image"})


def requests(counters):
    out = []
    for c in counters:
        req = tracing.Request("encode")
        req.counters.update(c)
        out.append(req)
    return out


def test_the_reader_sums_the_counter_and_is_silent_without_it(monkeypatch):
    reader = cells.metric_reader("restart_segments_per_call")
    kept = requests([{"restart_segments": 507, "syncs": 4}] * 2
                    + [{"restart_segments": 12}])
    monkeypatch.setattr(tracing, "requests", lambda: list(kept))
    assert reader.read(run_of(3)) == pytest.approx((507 * 2 + 12) / 3)
    # a port from before the counter: its requests count other things only
    kept[:] = requests([{"syncs": 4}] * 3)
    assert reader.read(run_of(3)) is None
    assert reader.read(run_of(4)) is None  # fewer requests kept than calls


@pytest.mark.parametrize("workload,size", [
    ("uhd-420-rst64", (258, 172)),   # 17 x 11 = 187 MCUs at 64: 3 segments
    ("photo-fused", (48, 32)),       # no restart interval: one a scan
])
def test_a_traced_cpu_cell_counts_its_segments(workload, size):
    cell = cells.cell(SPEC, workload, True)
    w, h = size
    config = dict(cell["config"], width=w, height=h)
    config["content"] = dict(config["content"], pool=2)
    interval = config["encoder"].get("restart_interval", 0)
    want = math.ceil(math.ceil(w / 16) * math.ceil(h / 16) / interval) \
        if interval else 1
    tracing.enable()
    result, _ = bench.run_cell(dict(cell, config=config), 2**31 + 23, 0.2,
                               True, "cpu", time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    got = result["metrics"]["restart_segments_per_call"]
    assert got == {"value": want, "unit": "segments/call"}
