"""The soft stage of the PyTorch port (_symbol_soft_batch and the twin of
the fused CUDA kernel) against the JAX package, whose correlation runs
through its Pallas kernel in interpret mode (OPV_CORR=pallas_interpret).

Tolerance: float32 soft values agree within 1e-5 of max|soft|: the
correlation sums 80 products in another order, and soft = |.|^2 - |.|^2
of values ~6e5 cancels.  The int8 path's s32 dot is held exactly.  The
CUDA kernel is held against the twin on the card (test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.ops import registry as registry_j
from opv_tpu.rx.locked import _symbol_soft_batch as soft_j
from opv_tpu.tx import modulate_frames, tx_flush_zeros
from opv_tpu_torch.ops import symbol_soft as ss
from opv_tpu_torch.rx.locked import (INT8_SCALE, _symbol_soft_batch,
                                     soft_stage_operands)

RTOL = 1e-5
C = 3


@pytest.fixture(scope="module")
def signal():
    """(3, N) complex64: a BERT burst at three delays, one channel noisy;
    N/40 - 1 = 2084 symbols, so the Pallas kernel's 2048-row tile and the
    ragged tail both run."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(1))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    n = 2085 * 40
    x = np.zeros((C, n), np.complex64)
    for c, d in enumerate((0, 13, 517)):
        x[c, d:d + min(len(s), n - d)] = s[: n - d]
    rng = np.random.default_rng(2)
    x[2] += (1500.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
    return x


def _params(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 40, C).astype(np.int32),
            rng.uniform(-400, 400, C).astype(np.float32),
            rng.uniform(0, 1, C).astype(np.float32),
            rng.uniform(110, 160, C).astype(np.float32))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("form", ["complex", "pairs", "rows"])
@pytest.mark.parametrize("use_frac", [False, True])
def test_float_forms_match_jax(signal, monkeypatch, form, use_frac):
    monkeypatch.setenv("OPV_CORR", "pallas_interpret")
    r, foff, frac, _ = _params()
    x = signal
    if form == "pairs":
        x = np.stack([x.real, x.imag], -1).astype(np.float32)
    elif form == "rows":
        x = np.stack([x.real, x.imag], -1).astype(np.float32).reshape(C, -1, 80)
    nsym = signal.shape[1] // 40 - 1
    fr = frac if use_frac else None
    want = soft_j(jnp.asarray(x), jnp.asarray(r), jnp.asarray(foff), nsym,
                  frac=None if fr is None else jnp.asarray(fr))
    got = _symbol_soft_batch(torch.from_numpy(x), torch.from_numpy(r),
                             torch.from_numpy(foff), nsym,
                             frac=None if fr is None else torch.from_numpy(fr))
    _close(got.numpy(), want)


@pytest.mark.parametrize("use_frac", [False, True])
def test_bf16_rows_match_jax(signal, monkeypatch, use_frac):
    """bf16 window rows: the JAX package narrows the kernel columns to
    bf16 and sums the (exact) products in float32; the port must too."""
    monkeypatch.delenv("OPV_CORR", raising=False)
    r, foff, frac, _ = _params(8)
    rows = torch.from_numpy(np.stack([signal.real, signal.imag], -1)
                            .reshape(C, -1, 80)).to(torch.bfloat16)
    nsym = rows.shape[1] - 1
    fr = frac if use_frac else None
    want = soft_j(jnp.asarray(rows.to(torch.float32).numpy()).astype(jnp.bfloat16),
                  jnp.asarray(r), jnp.asarray(foff), nsym,
                  frac=None if fr is None else jnp.asarray(fr))
    got = _symbol_soft_batch(rows, torch.from_numpy(r), torch.from_numpy(foff),
                             nsym, frac=None if fr is None else torch.from_numpy(fr))
    _close(got.numpy(), want)


def test_odd_n_complex_matches_jax(signal, monkeypatch):
    """(C, N) complex64 with N odd: the window-row view of channel c starts
    at byte 8*N*c, so the channels are not all 16-byte aligned; the twin
    still agrees with the JAX package."""
    monkeypatch.setenv("OPV_CORR", "pallas_interpret")
    r, foff, frac, _ = _params(9)
    x = np.ascontiguousarray(np.concatenate(
        [signal, signal[:, :1]], axis=1))                  # N = 2085*40 + 1
    assert x.shape[1] % 2 == 1
    nsym = x.shape[1] // 40 - 1
    want = soft_j(jnp.asarray(x), jnp.asarray(r), jnp.asarray(foff), nsym,
                  frac=jnp.asarray(frac))
    ops = soft_stage_operands(torch.from_numpy(x), torch.from_numpy(r),
                              torch.from_numpy(foff), nsym,
                              frac=torch.from_numpy(frac))
    assert ops[0].stride(0) == 2 * x.shape[1]               # a view, not a copy
    got = ss.symbol_soft_reference(*ops, nsym)
    _close(got.numpy(), want)


@pytest.mark.parametrize("per_channel_scale", [False, True])
def test_int8_rows_match_jax(signal, per_channel_scale):
    r, foff, frac, scale = _params(6)
    pairs = np.stack([signal.real, signal.imag], -1).reshape(C, -1, 80)
    step = scale[:, None, None] if per_channel_scale else INT8_SCALE
    rows = np.clip(np.round(pairs / step), -127, 127).astype(np.int8)
    nsym = rows.shape[1] - 1
    sc = scale if per_channel_scale else None
    want = soft_j(jnp.asarray(rows), jnp.asarray(r), jnp.asarray(foff), nsym,
                  scale=None if sc is None else jnp.asarray(sc),
                  frac=jnp.asarray(frac))
    got = _symbol_soft_batch(torch.from_numpy(rows), torch.from_numpy(r),
                             torch.from_numpy(foff), nsym,
                             scale=None if sc is None else torch.from_numpy(sc),
                             frac=torch.from_numpy(frac))
    _close(got.numpy(), want)


def test_int8_dot_exact(signal, monkeypatch):
    """The twin's int32 contraction equals the JAX package's s8 x s8 -> s32
    correlation on the same operands, through its XLA path and its Pallas
    kernel (interpret mode) alike."""
    r, foff, frac, scale = _params(7)
    rows = torch.from_numpy(np.clip(np.round(
        np.stack([signal.real, signal.imag], -1).reshape(C, -1, 80) / INT8_SCALE),
        -127, 127).astype(np.int8))
    nsym = rows.shape[1] - 1
    rows_q, kern_q, resc, phi = soft_stage_operands(
        rows, torch.from_numpy(r), torch.from_numpy(foff), nsym,
        frac=torch.from_numpy(frac))
    assert kern_q.dtype == torch.int8 and int(kern_q.abs().max()) <= 127
    got = ss.symbol_soft_reference(rows_q, kern_q, resc, phi, nsym, raw=True)
    assert got.dtype == torch.int32 and got.shape == (C, nsym + 1, 8)
    want = registry_j.symbol_corr(jnp.asarray(rows_q[:, : nsym + 1].numpy()),
                                  jnp.asarray(kern_q.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    monkeypatch.setenv("OPV_CORR", "pallas_interpret")
    want_p = registry_j.symbol_corr(jnp.asarray(rows_q[:, : nsym + 1].numpy()),
                                    jnp.asarray(kern_q.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p).astype(np.int32))


def test_int8_contraction_does_not_wrap():
    """Full-scale int8 rows against full-scale kernels: the s32 sums exceed
    int8 and int16 range and must not wrap."""
    rows = torch.full((1, 3, 80), 127, dtype=torch.int8)
    kern = torch.full((1, 80, 8), -127, dtype=torch.int8)
    ab = ss.correlate_reference(rows, kern, 2)
    assert ab.dtype == torch.int32 and int(ab[0, 0, 0]) == -127 * 127 * 80

