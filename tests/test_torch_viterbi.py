"""Viterbi twins of the PyTorch port against the JAX package's oracle
(viterbi_decode_batch) and its Pallas kernel in interpret mode.  The CUDA
kernel is held against these twins on the card (test_torch_cuda.py)."""

import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import straddle_rows, wide_rows  # noqa: E402
from opv_tpu.config import CONFIG  # noqa: E402
from opv_tpu.core.convcode import conv_encode_bits_np  # noqa: E402
from opv_tpu.ops.pallas.viterbi import viterbi_pallas  # noqa: E402
from opv_tpu.rx.viterbi import viterbi_decode_batch as oracle_j  # noqa: E402
from opv_tpu_torch.ops import registry  # noqa: E402
from opv_tpu_torch.ops import viterbi as vit  # noqa: E402
from opv_tpu_torch.rx.viterbi import (_tables, viterbi_decode_batch,  # noqa: E402
                                      viterbi_decode_r4_batch)

EB = CONFIG.encoded_bits


def _matrix(kind: str, rng) -> np.ndarray:
    if kind == "random1":
        return rng.integers(0, 8, (1, EB))
    if kind == "random131":
        return rng.integers(0, 8, (131, EB))
    if kind == "clean":
        u = rng.integers(0, 2, (3, CONFIG.frame_bits)).astype(np.uint8)
        return np.where(conv_encode_bits_np(u) == 1, 7, 0)
    if kind == "tie_stress":
        return np.concatenate([rng.integers(0, 2, (4, EB)), np.zeros((2, EB)),
                               np.full((2, EB), 7), rng.integers(3, 5, (2, EB))])
    if kind == "wide":
        return wide_rows(rng)
    if kind == "straddle":
        return straddle_rows()
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random1", "random131", "clean", "tie_stress",
                                  "wide", "straddle"])
def test_twins_match_oracle_and_pallas(kind):
    """Both twins give the JAX oracle's bits and metrics; the Pallas
    kernel (interpret mode) of the same radix agrees too.  The wide and
    straddle rows cover the contract's values up to 2^15 - 1, where best
    metrics pass -2^25."""
    soft = _matrix(kind, np.random.default_rng(8)).astype(np.int32)
    b_o, m_o = (np.asarray(a) for a in oracle_j(jnp.asarray(soft)))
    for radix, twin in ((2, viterbi_decode_batch), (4, viterbi_decode_r4_batch)):
        bits, metrics = twin(torch.from_numpy(soft))
        assert bits.dtype == torch.uint8 and metrics.dtype == torch.int32
        np.testing.assert_array_equal(bits.numpy(), b_o)
        np.testing.assert_array_equal(metrics.numpy(), m_o)
    if kind in ("random1", "tie_stress"):      # keep the interpret runs small
        for radix in (2, 4):
            b_p, m_p = viterbi_pallas(jnp.asarray(soft), interpret=True, radix=radix)
            np.testing.assert_array_equal(np.asarray(b_p).astype(np.uint8), b_o)
            np.testing.assert_array_equal(np.asarray(m_p), m_o)


def _final_metrics(soft: np.ndarray) -> np.ndarray:
    """All 64 path metrics after the last trellis step (int64, no guard:
    state 0 starts at 0, the others far above any reachable metric)."""
    p0, p1, e1_0, e2_0, e1_1, e2_1 = _tables()
    sg = soft.astype(np.int64).reshape(len(soft), -1, 2)
    m = np.full((len(soft), 64), 2**40, np.int64)
    m[:, 0] = 0
    for t in range(sg.shape[1]):
        s1, s2 = sg[:, t, 0:1], sg[:, t, 1:2]
        bm0 = np.where(e1_0 == 1, 7 - s1, s1) + np.where(e2_0 == 1, 7 - s2, s2)
        bm1 = np.where(e1_1 == 1, 7 - s1, s1) + np.where(e2_1 == 1, 7 - s2, s2)
        m = np.minimum(m[:, p0] + bm0, m[:, p1] + bm1)
    return m


def test_wide_rows_pass_the_composite_key_range():
    """The rows that hold the kernel's end state to the contract do what
    they claim: the wide rows' best metrics lie below -2^25 (metric * 64
    wraps int32) and each straddle row's final metrics straddle -2^25."""
    lim = -2**25
    best = _final_metrics(wide_rows(np.random.default_rng(8))).min(1)
    assert (best < lim).all()
    fin = _final_metrics(straddle_rows())
    assert ((fin.min(1) < lim) & (fin.max(1) >= lim)).all()
    _, m_t = viterbi_decode_batch(torch.from_numpy(straddle_rows().astype(np.int32)))
    np.testing.assert_array_equal(m_t.numpy(), fin.min(1))


def test_clean_decode_metric_zero():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, (3, CONFIG.frame_bits)).astype(np.uint8)
    soft = torch.from_numpy(np.where(conv_encode_bits_np(u) == 1, 7, 0).astype(np.int32))
    for radix in (2, 4):
        bits, metrics = vit.viterbi_reference(soft, radix)
        np.testing.assert_array_equal(bits.numpy(), u)
        assert int(metrics.abs().sum()) == 0


def test_tables_match_jax():
    from opv_tpu.rx.viterbi import _tables as tables_j
    for a, b in zip(_tables(), tables_j()):
        np.testing.assert_array_equal(a, b)


def test_registry_cpu_dispatch_uses_twin_for_both_radices():
    soft = torch.from_numpy(np.random.default_rng(3).integers(0, 8, (2, EB))
                            .astype(np.int32))
    before = registry.launch_counts()
    try:
        outs = []
        for radix in (2, 4):
            registry.set_viterbi_radix(radix)
            outs.append(registry.viterbi_batch(soft))
    finally:
        registry.set_viterbi_radix(4)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert registry.launch_counts() == before     # no kernel launched on CPU
    with pytest.raises(ValueError):
        registry.set_viterbi_radix(3)



@pytest.mark.parametrize("kind", ["clean", "tie_stress"])
def test_single_frame_decode_matches_jax(kind):
    """rx.viterbi_decode (one frame, a batch of one through the registry)
    gives opv_tpu.rx.viterbi_decode's bits and metric, frame by frame."""
    from opv_tpu.rx.viterbi import viterbi_decode as decode_j
    from opv_tpu_torch.rx import viterbi_decode
    soft = _matrix(kind, np.random.default_rng(9)).astype(np.int32)
    for row in soft[:3]:
        bits, metric = viterbi_decode(torch.from_numpy(row))
        b_j, m_j = decode_j(jnp.asarray(row))
        assert bits.shape == (CONFIG.frame_bits,) and metric.shape == ()
        np.testing.assert_array_equal(bits.numpy(), np.asarray(b_j))
        assert int(metric) == int(m_j)
