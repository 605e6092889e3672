"""The port's bench tools (stage_bench, tx_bench, wideband_bench,
modem_bench, scaling_bench) through main(argv) on the CPU at tiny sizes:
their records' keys, their decode counts, "device": "cpu" with no figure
measured, and DeviceError for --device cuda without a card.  The figures
themselves come from the card (chip_smoke.py phase 16)."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from opv_tpu_torch.cli._device import DeviceError
from opv_tpu_torch.tools import (modem_bench, scaling_bench, stage_bench,
                                 timing, tx_bench, wideband_bench)

REPO = pathlib.Path(__file__).resolve().parents[1]
NOT_MEASURED = timing.NOT_MEASURED
HEADER = {"tool", "command", "device", "card", "device_count", "commit"}


def run(tool, argv, tmp_path) -> dict:
    """tool.main(argv + --device cpu --json FILE): exit 0 and the record,
    whose header says cpu, no card and no peaks."""
    path = tmp_path / "record.json"
    assert tool.main([*argv, "--device", "cpu", "--json", str(path)]) == 0
    rec = json.loads(path.read_text())
    assert HEADER <= rec.keys()
    assert rec["device"] == "cpu" and rec["card"] is None
    assert "peaks" not in rec
    assert rec["command"].startswith(
        f"python -m opv_tpu_torch.tools.{tool.__name__.rsplit('.', 1)[1]} ")
    return rec


def test_stage_bench_cpu(tmp_path):
    rec = run(stage_bench, ["--channels", "2", "--frames", "2"], tmp_path)
    assert rec["checks"] == {"passed": True, "failures": []}
    assert rec["decoded_per_block"] == 4
    rows = ("float32", "int8", "float64")
    want = ({f"{s}[{r}]" for s in ("soft", "soft_kernel", "steady")
             for r in rows} | {"extract"}
            | {f"{s}[r{x}]" for s in ("viterbi", "finish") for x in (4, 2)})
    assert set(rec["stages"]) == want
    for name, st in rec["stages"].items():
        assert st["timing"] == {"clock": NOT_MEASURED}, name
        assert st["roofline"]["bytes"] > 0 and st["roofline"]["ops"] > 0
        assert st["roofline"]["share"] == NOT_MEASURED
    assert rec["stages"]["steady[int8]"]["msamples_s"] == NOT_MEASURED
    # the check call and the one untimed call
    assert rec["stages"]["steady[float32]"]["blocks_checked"] == 2
    assert rec["stages"]["soft_kernel[float32]"]["library"]["call"] == \
        "torch.bmm"


def test_tx_bench_cpu(tmp_path):
    rec = run(tx_bench, ["--channels", "2", "--frames", "2"], tmp_path)
    assert rec["checks"] == {"passed": True, "failures": []}
    assert rec["out_samples"] == 2 * 2 * 86_720
    assert set(rec["stages"]) == {"modulate", "tx_chain", "exact"}
    assert rec["modulate_msps"] == rec["modulate_vs_baseline"] == \
        rec["tx_chain_msps"] == NOT_MEASURED
    assert rec["stages"]["exact"]["ms_per_frame"] == NOT_MEASURED
    assert rec["baseline_msps"] == 10.7


def test_wideband_bench_cpu(tmp_path):
    rec = run(wideband_bench, ["--k", "4", "--active", "2", "--frames",
                               "2", "--block-frames", "1"], tmp_path)
    assert rec["checks"] == {"passed": True, "failures": []}
    (row,) = rec["rows"]
    f = row["frames_per_chan_per_cycle"]
    assert row["k"] == 4 and row["active_channels"] == 2
    assert row["scenario"] == "steady" and row["quantum_frames"] == 1
    # the one untimed window: every active channel its cycle's frames,
    # byte-exact and metric 0
    assert row["expected_per_active_per_window"] == f
    assert row["transmitted_per_active"] == [[f], [f]]
    assert row["perfect_per_active"] == [[f], [f]]
    for key in ("wideband_msps", "x_realtime", "device_wait_ms_mean",
                "host_ms_mean"):
        assert row[key] == NOT_MEASURED, key
    assert row["channelize"]["timing"] == {"clock": NOT_MEASURED}


def test_wideband_cycle_repeats_without_a_glitch():
    """periodic_bits: frames 1..f hold an even number of one bits, so the
    modulator's sign state after the cycle is the one frame 1 began
    with."""
    from opv_tpu_torch.tx.modulator import mod_reset, modulate_bits_fast
    f, bits, frames = wideband_bench.periodic_bits(2, 1, torch.device("cpu"))
    assert len(frames) == f >= 2
    _, st1 = modulate_bits_fast(bits[:2168], mod_reset())
    _, st2 = modulate_bits_fast(bits, mod_reset())
    assert (int(st1.t_xor), int(st1.b_n)) == (int(st2.t_xor), int(st2.b_n))


def test_modem_bench_cpu(tmp_path):
    rec = run(modem_bench, ["--fast", "--frames", "3", "--burst", "3"],
              tmp_path)
    assert rec["bench"] == "modem_loopback_serving"
    (r,) = rec["runs"]
    assert r["engine"] == "fast" and r["clock"] == "host"
    assert (r["cadence_frames"], r["burst_frames"], r["burst_windows"]) == \
        (3, 3, timing.WINDOWS)
    for key in ("server_ready_s", "cold_start_s", "cadence_ms", "burst_fps",
                "burst_x_realtime", "burst_msps"):
        assert r[key] == NOT_MEASURED, key


def test_modem_bench_frames_match_the_jax_tool():
    """The frame builder and parser are tools/modem_bench.py's."""
    spec = importlib.util.spec_from_file_location(
        "jax_modem_bench", REPO / "tools" / "modem_bench.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for seq in (0, 1, 255, 500_123, 2**31 + 7):
        frame = modem_bench.build_frame(seq)
        assert frame == jax_tool._build_frame(seq)
        assert modem_bench.seq_of(frame) == jax_tool._seq_of(frame) == seq


def test_scaling_bench_cpu(tmp_path):
    rec = run(scaling_bench, ["--devices", "1", "2", "--frames-per-dev",
                              "2"], tmp_path)
    assert rec["checks"] == {"passed": True, "failures": []}
    assert [(r["devices"], r["decoded"], r["expected"])
            for r in rec["weak_scaling"]] == [(1, 2, 2), (2, 4, 4)]
    assert all(r["one_device"] and r["msps"] == NOT_MEASURED
               and r["efficiency"] == NOT_MEASURED
               for r in rec["weak_scaling"])
    assert rec["measures"].startswith("the cost of sharding")
    assert "halo_sweep" not in rec and "shard_cost" not in rec


def test_timing_record_helpers():
    """rate() takes its min from the slowest window; roofline() shares
    the bound of its larger term."""
    t = dict(clock="cuda_events", median_ms=2.0, min_ms=1.0, max_ms=4.0)
    assert timing.rate(1e6, t) == {"median": 500.0, "min": 250.0,
                                   "max": 1000.0}
    assert timing.rate(1e6, {"clock": NOT_MEASURED}) == NOT_MEASURED
    rl = timing.roofline(3.35e9, [(67e9, timing.PEAK_OPS_PER_S["f32"])], t)
    assert rl["bound_by"] == "bytes" and rl["bound_ms"] == pytest.approx(1.0)
    assert rl["share"] == pytest.approx(0.5)
    nbytes, nops = timing.viterbi_work(1)
    assert (nbytes, nops) == (2144 * 4 + 1072 + 4, 1072 * (64 * 4 + 4))
    assert timing.spread([3, 1, 2]) == {"median": 2, "min": 1, "max": 3}
    assert timing.spread(np.array([1.0, 5.0, 3.0])) == {
        "median": 3.0, "min": 1.0, "max": 5.0}


@pytest.mark.parametrize("tool", [stage_bench, tx_bench, wideband_bench,
                                  modem_bench, scaling_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_cuda_without_a_card_raises(tool):
    """No figure falls back to the CPU: --device cuda (the default)
    without a card raises DeviceError before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceError):
        tool.main([])
    with pytest.raises(DeviceError):
        tool.main(["--device", "cuda"])

