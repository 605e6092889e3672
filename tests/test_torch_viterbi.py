"""Viterbi twins of the PyTorch port against the JAX package's oracle
(viterbi_decode_batch) and its Pallas kernel in interpret mode.  The CUDA
kernel is held against these twins on the card (test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.core.convcode import conv_encode_bits_np
from opv_tpu.ops.pallas.viterbi import viterbi_pallas
from opv_tpu.rx.viterbi import viterbi_decode_batch as oracle_j
from opv_tpu_torch.ops import registry
from opv_tpu_torch.ops import viterbi as vit
from opv_tpu_torch.rx.viterbi import (_tables, viterbi_decode_batch,
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
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random1", "random131", "clean", "tie_stress"])
def test_twins_match_oracle_and_pallas(kind):
    """Both twins give the JAX oracle's bits and metrics; the Pallas
    kernel (interpret mode) of the same radix agrees too."""
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

