"""The port's receiver-quality tools, named after the JAX repo's tools/:

    python -m opv_tpu_torch.tools.ber_headtohead      waterfall BER rows,
                                                      held to BER_r05.json
    python -m opv_tpu_torch.tools.ber_curve           BER / FER sweep
    python -m opv_tpu_torch.tools.timing_pin_probe    grid-pinning probe
    python -m opv_tpu_torch.tools.gen_timing_template _PB_BIAS derivation

capture.py holds the seeded captures they share.  Each runs on the card
(--device cuda, the default) unless --device cpu is given, and has a
main(argv) that can be called in-process."""
