"""The port's batch receiver (opv_tpu_torch/rx/pipeline.py: rx_batch,
rx_block) against opv_tpu/rx/pipeline.py and the reference binary's
golden frames, on the CPU.  Frames, metrics, symbol indices, symbol
counts, the CFO estimate and the tracker state must be equal; sync
quality and the final AFC offset within Q_TOL / AFC_TOL (ratios and
loop values of float64 sums taken in another order)."""

import numpy as np
import pytest
import torch

from opv_tpu.rx.pipeline import rx_batch as rx_batch_j
from opv_tpu_torch.rx.pipeline import rx_batch

Q_TOL = 1e-12
AFC_TOL = 1e-6        # Hz


def _load(golden_dir, name):
    raw = np.fromfile(golden_dir / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    return raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)


def _golden(golden_dir, name):
    return np.frombuffer((golden_dir / name).read_bytes(),
                         dtype=np.uint8).reshape(-1, 134)


def _same(got, want):
    for k in ("frames", "metrics", "t_idx", "frame_valid"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("n_symbols", "samples_used", "est_offset", "tracker_state",
              "decoded", "perfect"):
        assert got[k] == want[k], k
    assert np.abs(got["sync_q"] - want["sync_q"]).max(initial=0) <= Q_TOL
    assert abs(float(got["freq_offset"]) - float(want["freq_offset"])) <= AFC_TOL


@pytest.mark.parametrize("name,gold,opts", [
    ("bert3", "bert3.frames", {}),
    ("raw3", "raw3.bin", {}),
    ("raw3", "raw3.bin", {"init_offset": -340.0, "afc_alpha": 0.01}),
])
def test_rx_batch_matches_jax_and_golden(golden_dir, name, gold, opts):
    """The reference's frames byte for byte, and JAX's result dict."""
    s = _load(golden_dir, name)
    got = rx_batch(s, device="cpu", **opts)
    assert np.array_equal(got["frames"], _golden(golden_dir, gold))
    assert got["perfect"] == 3
    _same(got, rx_batch_j(s, **opts))


def test_rx_batch_on_a_tensor_and_short_input():
    """A CPU tensor in gives the numpy result dict; a capture shorter than
    the 64-sample window decodes nothing and raises nothing."""
    x = torch.zeros(50, dtype=torch.complex128)
    out = rx_batch(x, init_offset=0.0, device="cpu")
    assert out["decoded"] == 0 and out["n_symbols"] == 0
    assert out["frames"].shape == (0, 134)


def test_unported_options_name_item_11b():
    """dtype="float32" (item 11b) runs, in float32; a dtype the JAX
    package has no mode for is refused by name."""
    out = rx_batch(np.zeros(1000, np.complex128), dtype="float32",
                   init_offset=0.0, device="cpu")
    assert out["decoded"] == 0 and out["freq_offset"].dtype == np.float32
    with pytest.raises(ValueError, match="float16"):
        rx_batch(np.zeros(1000, np.complex128), dtype="float16", device="cpu")
