"""The port's measurement tools, named after the JAX repo's tools/:

    python -m opv_tpu_torch.tools.ber_headtohead      waterfall BER rows,
                                                      held to BER_r05.json
    python -m opv_tpu_torch.tools.ber_curve           BER / FER sweep
    python -m opv_tpu_torch.tools.timing_pin_probe    grid-pinning probe
    python -m opv_tpu_torch.tools.gen_timing_template _PB_BIAS derivation
    python -m opv_tpu_torch.tools.stage_bench         the steady body's
                                                      stages on the card
    python -m opv_tpu_torch.tools.tx_bench            modulate, tx_chain,
                                                      the exact TX
    python -m opv_tpu_torch.tools.wideband_bench      WidebandReceiver
                                                      throughput, K sweep
    python -m opv_tpu_torch.tools.modem_bench         opv_modem -l cold
                                                      start, cadence, burst
    python -m opv_tpu_torch.tools.scaling_bench       time-sharded scaling,
                                                      halo sweep, shard cost

capture.py holds the seeded captures and signals they share, timing.py the
timing, rooflines and record header of the bench tools.  Each runs on the
card (--device cuda, the default) unless --device cpu is given (where the
bench tools time nothing), and has a main(argv) that can be called
in-process."""
