"""The port's timing tools on the CPU twins: gen_timing_template derives
rx/locked.py _PB_BIAS from the port's own dense correlator, and
timing_pin_probe pins the engine's grid between feeds without changing
what an unpinned run emits."""

import numpy as np
import pytest
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.locked import _PB_BIAS
from opv_tpu_torch.stream import LockedStreamDemodulator
from opv_tpu_torch.tools import capture, gen_timing_template, timing_pin_probe

SPF = CONFIG.samples_per_frame
CPU = torch.device("cpu")
NF, LEAD, BF, DB, PIN_AFTER = 24, 2000, 4, 8.0, 8


#: the port's float32 derivation against the JAX package's baked float32
#: value: the parabola's curvature is ~2e-3 of the fold, so float32
#: correlator rounding moves the result by a few 1e-5 between
#: implementations (XLA's sums 0.0409839, torch's CPU sums 0.0410069, both
#: 0.0410276 in float64); the bound chip_smoke holds the card's value to
F32_BIAS_TOL = 1e-4


def _jax_bias_float64(half=20, nf=9, delay=5000) -> float:
    """tools/gen_timing_template.py's derivation over the JAX package,
    with the capture as complex128 (float64 correlator)."""
    import jax.numpy as jnp
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.rx.fast import dense_soft, dense_sync
    from opv_tpu.tx import modulate_frames, tx_flush_zeros
    frames = build_bert_frame("W5NYV", frame_num=np.arange(nf))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=True)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    x = np.zeros(delay + len(s) + 2048, np.complex128)
    x[delay:delay + len(s)] = s
    raw, _ = dense_sync(dense_soft(jnp.asarray(x)[None],
                                   jnp.zeros(1, jnp.float64)))
    raw = np.asarray(raw, np.float64)[0]
    f = len(raw) // SPF
    fold = raw[: f * SPF].reshape(f, SPF).sum(0)
    seg = fold[np.arange(delay - half, delay - half + 2 * half + 3) % SPF]
    sm = seg[:-1] + seg[1:]
    pk = int(np.argmax(sm[: 2 * half + 1]))
    rm, r0, rp = sm[pk - 1], sm[pk], sm[pk + 1]
    d = np.clip(0.5 * (rm - rp) / (rm - 2 * r0 + rp), -0.5, 0.5)
    return float(pk + d + 0.5) - (half + 0.5)


def test_template_in_float64_is_the_jax_derivation():
    """With a float64 correlator the port's derivation is the JAX
    package's, whatever the sum order."""
    got = gen_timing_template.compute(dtype="float64")
    assert abs(got - _jax_bias_float64()) < 1e-9


def test_template_reproduces_the_baked_bias():
    assert abs(gen_timing_template.compute() - _PB_BIAS) < F32_BIAS_TOL


def test_template_bias_is_depth_stable():
    """The drift bound tests/test_locked.py holds JAX's derivation to."""
    assert abs(gen_timing_template.compute(nf=6) - _PB_BIAS) < 0.1


@pytest.fixture(scope="module")
def probe_capture():
    """A 24-frame head-to-head capture at 8 dB (seed 42) as (1, N)
    complex64, and the clean capture's grid anchor."""
    truth, s, sig_pow = capture.exact_signal(NF, CPU)
    wire = capture.headtohead_wire(s, sig_pow, 42, DB, LEAD)
    sw = capture.wire_to_complex(wire).astype(np.complex64)[None, :]
    clean = np.concatenate([np.zeros(LEAD, complex), s]).astype(np.complex64)
    return sw, timing_pin_probe.grid_anchor(clean, NF, CPU), truth


def test_free_mode_is_a_plain_engine_run(probe_capture):
    sw, anchor, truth = probe_capture
    got, pins = timing_pin_probe.pinned_run(sw, "free", anchor, BF,
                                            PIN_AFTER * SPF, CPU)
    sd = LockedStreamDemodulator(1, block_frames=BF, dtype="float32",
                                 device=CPU)
    step = BF * SPF
    want = []
    for off in range(0, sw.shape[1], step):
        want.extend(sd.feed(sw[:, off:off + step]))
    want.extend(sd.flush())
    assert pins == [] and got == want and len(got) >= NF - 2


def test_truth_mode_holds_the_grid_on_the_anchor(probe_capture):
    """Once pinning starts, each block runs at the anchor: every pin puts
    p0 + frac on it (mod one frame), and every frame emitted after the
    first pin sits on its integer grid."""
    sw, anchor, truth = probe_capture
    got, pins = timing_pin_probe.pinned_run(sw, "truth", anchor, BF,
                                            PIN_AFTER * SPF, CPU)
    assert len(pins) >= 3 and pins[0][0] == PIN_AFTER * SPF
    for _, grid in pins:
        err = (grid - anchor + SPF / 2) % SPF - SPF / 2
        assert abs(err) < 1e-4, (grid, anchor)
    after = [r[4] for r in got if r[4] >= pins[0][0]]
    assert after and all((p - int(np.floor(anchor))) % SPF == 0
                         for p in after)
    assert len(got) >= NF - 2


def test_probe_reports_each_mode(probe_capture):
    """The tool's JSON over one seed: a BER per mode, the anchor of the
    clean capture."""
    sw, anchor, truth = probe_capture
    out = timing_pin_probe.probe(DB, BF, NF, [42], LEAD, PIN_AFTER,
                                 ["truth_f0"], CPU)
    assert out["anchor_truth"] == anchor and out["device"] == "cpu"
    row = out["modes"]["truth_f0"]
    assert 0 <= row["ber"] < 0.05 and len(row["tail_per_seed"]) == 1
