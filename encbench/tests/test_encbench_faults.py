"""A whole run with the timed path broken underneath must come out not
correct, and with it whole, correct.

Each test skips only the harness's look for a card: it drives
``bench.run_cell`` on the CPU at a small size through the port's
``Encoder`` (or the control in its place), with a fault planted where the
answer is produced."""

import json
import os
import shutil
import time

import pytest

import tpuenc_torch as tt
from control import Control
from harness import bench, cells
from tpuenc_torch import api

SPEC = cells.load_benchmark()


def small(workload, width=48, height=32):
    cell = cells.cell(SPEC, workload, False)
    config = dict(cell["config"], width=width, height=height)
    config["content"] = dict(config["content"])
    return dict(cell, config=config)


def run(cell, program=None, seconds=0.3):
    result, _ = bench.run_cell(cell, 2**31 + 99, seconds, False, "cpu",
                               time.perf_counter(), program=program)
    return result, result["checks"]


class Broken(bench.Port):
    """The port, with ``fault`` applied to what each call returns."""

    def __init__(self, cell, fault):
        super().__init__(cell["config"], cell["traffic"], "cpu")
        self.fault, self.last = fault, None

    def __call__(self, images):
        files = super().__call__(images)
        out, self.last = self.fault(files, self.last), files
        return out


def flip_a_byte(files, last):
    f = bytearray(files[0])
    f[len(f) // 2] ^= 0x10
    return [bytes(f)] + files[1:]


def stale(files, last):
    """The state left unchanged: the previous call's answer."""
    return last or files


def half_the_batch(files, last):
    return files[:len(files) // 2]


def half_the_batch_repeated(files, last):
    half = files[:len(files) // 2]
    return half + half


def truncated(files, last):
    return [f[:-3] + b"\xff\xd9" for f in files]


WORKLOADS = ["photo-baseline", "photo-progressive-opt", "photo-batch8",
             "ycck16k-chunked"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_port_is_correct(workload, monkeypatch):
    if workload == "ycck16k-chunked":
        monkeypatch.setattr(api, "DEVICE_BLOCK_LIMIT", 0)
    cell = small(workload)
    result, checks = run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert checks["differing_files"]["value"] == 0


@pytest.mark.parametrize("fault", [flip_a_byte, stale, truncated])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_altered_answer_is_not_correct(workload, fault, monkeypatch):
    if workload == "ycck16k-chunked":
        monkeypatch.setattr(api, "DEVICE_BLOCK_LIMIT", 0)
    cell = small(workload)
    result, checks = run(cell, Broken(cell, fault))
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", [half_the_batch, half_the_batch_repeated])
def test_half_the_batch_left_out_is_not_correct(fault):
    cell = small("photo-batch8")
    result, checks = run(cell, Broken(cell, fault))
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell = small(workload, 64, 48)
    control = Control(cell["config"], cell["traffic"], "cpu")
    result, checks = run(cell, control, seconds=0.2)
    assert not result["correct"], checks
    assert checks["differing_files"]["value"] > 0
    assert checks["failed_calls"]["value"] == 0


def test_a_raising_call_is_failed_not_fatal():
    cell = small("photo-baseline")

    class Raising(bench.Port):
        n = 0

        def __call__(self, images):
            self.n += 1
            if self.n > 32:  # after the warm-up, twice the pool
                raise RuntimeError("planted")
            return super().__call__(images)

    result, checks = run(cell, Raising(cell["config"], cell["traffic"],
                                       "cpu"))
    assert not result["correct"] and result["failed"] > 0
    assert tt.Encoder  # the port itself was not touched


def cell_of_files(tmp_path, traffic, code=None):
    """A new cell made of files alone: a traffic mix (and its module) in a
    copy of the benchmark's folder, beside the photo configuration."""
    bench = os.path.join(tmp_path, "encbench")
    for sub in ("configs", "metrics"):
        shutil.copytree(os.path.join(cells.BENCH, sub),
                        os.path.join(bench, sub))
    os.makedirs(os.path.join(bench, "traffic"))
    with open(os.path.join(bench, "traffic", "new.json"), "w") as f:
        json.dump(traffic, f)
    if code:
        with open(os.path.join(bench, "traffic", "new.py"), "w") as f:
            f.write(code)
    spec = dict(SPEC, paths=["encbench"], workloads=[
        {"name": "photo-new", "config": "photo-2000x1800", "traffic": "new",
         "chips": 1, "why": "a test"}])
    cell = cells.cell(spec, "photo-new", False, root=str(tmp_path))
    cell["config"] = dict(cell["config"], width=45, height=37)
    cell["config"]["content"] = dict(cell["config"]["content"], pool=3)
    return cell


RESTART = {"entry": "encode", "takes": "image", "images_per_call": 1,
           "encoder": {"sampling_factor": {"SamplingFactor.from_factors":
                                           [2, 2]},
                       "restart_interval": 2},
           "options": {"fused_p1": True}, "check_sample": 4,
           "about": "a test: 4:2:0, restart 2, K8"}


def test_a_cell_of_data_files_runs_and_is_checked(tmp_path):
    cell = cell_of_files(tmp_path, RESTART)
    port = bench.Port(cell["config"], cell["traffic"], "cpu")
    assert port.enc.restart_interval() == 2 and port.enc.fused_p1
    result, checks = run(cell)
    assert result["correct"], checks
    result, checks = run(cell, Broken(cell, stale))
    assert not result["correct"], checks


STREAM = """
import tpuenc_torch as tt
from harness import bench


def program(config, traffic, device):
    port = bench.Port(config, traffic, device)

    def call(images):
        return [b"".join(port.enc.encode_stream(
            im, config["width"], config["height"],
            tt.ColorType(config["color_type"]), chunk_mcu_rows=1))
            for im in images]
    return call
"""


def test_a_mix_with_code_brings_its_program(tmp_path):
    cell = cell_of_files(tmp_path, dict(RESTART, encoder={}, options={}),
                         STREAM)
    assert "program" in cell
    result, checks = run(cell)
    assert result["correct"], checks
    assert checks["differing_files"]["value"] == 0
