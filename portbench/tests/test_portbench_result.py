"""A run's result line, and `correct` coming out false under each fault
the cells can have, at a tiny size on the CPU (the chip's check skipped);
the lower-precision control on the card."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import faults, run as bench_run
from portbench.tests.small import ROOT, bench, run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


#: a sound tiny run: four carriers of the wideband cell, this seed
SOUND = dict(workload="wideband64-steady", channels=4, seconds=3.0,
             seed=777)
CHECKED = {"wrong_share", "missed_share", "spurious_share", "timing_bias",
           "cfo_bias_hz", "metric_gap"}


def test_result_line_keys():
    b = bench()
    names = bench_run.metrics_of(b, SOUND["workload"], False)
    out = run(**SOUND, readers=[(n, bench_run.reader(n)) for n in names])
    device = dict(platform="gpu", kind="cpu", count=1,
                  memory_peak_bytes=out["memory_peak_bytes"])
    line = bench_run.result_line(out, device)
    assert set(line) == KEYS and list(line)[-1] == "check"
    assert set(line["metrics"]) == set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["check"]) == CHECKED
    for v in line["check"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(line)
    assert line["correct"] is True


#: the number each fault fails
FAILS = {"half_left_out": "missed_share", "answer_altered": "wrong_share",
         "state_unchanged": "wrong_share", "spurious_frames": "spurious_share",
         "timing_biased": "timing_bias", "cfo_biased": "cfo_bias_hz"}


def test_every_fault_is_tried():
    assert set(FAILS) == set(faults.FAULTS)


@pytest.mark.parametrize("fault,number", sorted(FAILS.items()))
def test_fault_makes_correct_false(fault, number):
    out = run(**SOUND, fault=faults.FAULTS[fault])
    value, limit = out["check"]["numbers"][number]
    assert value > limit
    assert out["check"]["correct"] is False


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "locked64-ptt", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["wideband64-steady", "locked64-ptt"])
def test_control_is_not_correct(workload):
    """The configuration's lower-precision path at the cell's own size on
    three seeds: every run reads correct false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell's own size)")
    r = subprocess.run([sys.executable, "-m", "portbench.control",
                        "--workload", workload, "--seconds", "3",
                        "--control-seeds", "4000000001", "4000000002",
                        "4000000003"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200, check=True)
    rows = [json.loads(x) for x in r.stdout.splitlines() if x.strip()]
    assert len(rows) == 3 and not any(x["correct"] for x in rows)
