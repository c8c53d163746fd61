"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

* the configuration: the ``file`` that ``configs`` gives it;
* the traffic mix: ``encbench/traffic/<traffic>.json``, and where its
  calls need code, ``encbench/traffic/<traffic>.py`` with a
  ``program(config, traffic, device)`` that builds the program under test
  (a callable from a call's images to their files) in place of
  ``harness.bench.Port``;
* each metric: ``encbench/metrics/<name>.py``, a reader with ``read(run)``
  (the metric's number, or None where the run has nothing to read) and,
  where it reads spans, ``SPANS``: span name -> the program's functions
  (``module:qualified.name``) that the span goes around.

A metric goes to a cell when it lists the cell under ``workloads``, or has
no such list.  ``--trace 0`` reports the ``end_to_end`` metrics,
``--trace 1`` the ``per_layer`` ones.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: str = BENCH):
    return _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                   f"encbench_metric_{name}")


def cell(bench: dict, name: str, trace: bool, root: str = ROOT) -> dict:
    """The workload ``name`` with its configuration, traffic mix and the
    metrics it reports (name, entry of BENCHMARK.json, reader)."""
    (work,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (conf,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    bench_dir = os.path.join(root, bench["paths"][0])
    metrics = []
    for entry in bench["per_layer" if trace else "end_to_end"]:
        if name in entry.get("workloads", [name]):
            metrics.append((entry["name"], entry,
                            metric_reader(entry["name"], bench_dir)))
    traffic = os.path.join(bench_dir, "traffic", work["traffic"])
    out = {
        "workload": work,
        "config": _json(os.path.join(root, conf["file"])),
        "traffic": _json(traffic + ".json"),
        "metrics": metrics,
    }
    if os.path.exists(traffic + ".py"):
        out["program"] = _module(traffic + ".py",
                                 f"encbench_traffic_{work['traffic']}").program
    return out
