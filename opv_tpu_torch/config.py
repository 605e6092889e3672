"""OPV air-interface numerology and DSP loop configuration for the port.

The same dataclass as the JAX package's opv_tpu/config.py, field for field;
tests/test_torch_core.py::test_config_matches_jax_package pins the two
equal.  The port keeps its own copy so that it (and chip_smoke.py) runs on a
host where the JAX package is absent.  All values must stay bit-for-bit
identical to the reference air interface.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class OPVConfig:
    # ---- frame geometry (opv-mod.cpp:28-32) ----
    frame_bytes: int = 134
    sync_word: int = 0x02B8DB
    sync_bits: int = 24

    # ---- modulation (opv-mod.cpp:34-41) ----
    samples_per_symbol: int = 40
    sample_rate: float = 2_168_000.0
    symbol_rate: float = 54_200.0
    freq_dev: float = 13_550.0          # symbol_rate / 4
    iq_amplitude: float = 16383.0       # int16 full-scale factor (opv-mod.cpp:271)

    # ---- FEC (opv-mod.cpp:126-130, opv-demod.cpp:54-57) ----
    g1_mask: int = 0x4F                 # 171 octal, HDL bit-reversed
    g2_mask: int = 0x6D                 # 133 octal, HDL bit-reversed
    constraint: int = 7
    num_states: int = 64
    soft_max: int = 7                   # 3-bit soft quantization

    # ---- interleaver (opv-mod.cpp:142-153) ----
    interleave_rows: int = 67
    interleave_cols: int = 32

    # ---- randomizer (opv-mod.cpp:97-113) ----
    lfsr_seed: int = 0xFF

    # ---- payload layout (opv-mod.cpp:339-361, opv-demod.cpp:63-65) ----
    station_id_size: int = 6
    token_offset: int = 6
    reserved_offset: int = 9
    payload_offset: int = 12
    default_token: int = 0xBBAADD

    # ---- RX loop gains / thresholds (opv-demod.cpp:108-348, 587-787) ----
    afc_alpha: float = 0.001            # AFC loop gain (flag -a)
    afc_clamp_hz: float = 2000.0
    alpha_timing: float = 0.005         # TED proportional gain
    beta_timing: float = 0.00001        # TED integral gain
    timing_freq_clamp: float = 0.1      # max 10% symbol-rate error
    timing_adj_clamp: float = 2.0       # max 2 samples/symbol correction
    el_offset: float = 10.0             # early-late spacing = sps/4

    # coarse CFO grid search (opv-demod.cpp:131-202)
    cfo_coarse_span_hz: float = 1500.0
    cfo_coarse_step_hz: float = 25.0
    cfo_fine_span_hz: float = 30.0
    cfo_fine_step_hz: float = 5.0
    cfo_max_symbols: int = 1000

    # sync tracker thresholds (opv-demod.cpp:60, 783-786)
    sync_miss_limit: int = 5
    sync_hunt_norm_thresh: float = 0.85
    sync_locked_norm_thresh: float = 0.70
    sync_hunt_raw_thresh: float = 5000.0
    sync_min_energy: float = 100.0

    # ---- derived ----
    @property
    def frame_bits(self) -> int:
        return self.frame_bytes * 8               # 1072

    @property
    def encoded_bits(self) -> int:
        return self.frame_bits * 2                # 2144

    @property
    def frame_symbols(self) -> int:
        return self.sync_bits + self.encoded_bits  # 2168

    @property
    def samples_per_frame(self) -> int:
        return self.frame_symbols * self.samples_per_symbol  # 86720

    @property
    def chunk_samples(self) -> int:
        """Streaming chunk = one frame of samples (opv-demod.cpp:1012)."""
        return self.samples_per_frame

    @property
    def f1_freq(self) -> float:
        """Lower tone NCO frequency (transmitted for encoded bit '0')."""
        return -self.freq_dev

    @property
    def f2_freq(self) -> float:
        return +self.freq_dev

    @property
    def phase_inc_f1(self) -> float:
        return 2.0 * math.pi * self.f1_freq / self.sample_rate

    @property
    def phase_inc_f2(self) -> float:
        return 2.0 * math.pi * self.f2_freq / self.sample_rate

    def sync_pattern_bits(self) -> list[int]:
        """Sync word as a list of bits, MSB first (opv-mod.cpp:315-321)."""
        return [(self.sync_word >> (self.sync_bits - 1 - i)) & 1
                for i in range(self.sync_bits)]


CONFIG = OPVConfig()
