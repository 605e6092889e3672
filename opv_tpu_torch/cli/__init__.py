"""The port's command-line tools, flag-compatible with the JAX package's
(opv_tpu/cli/) on every path the port has:

    python -m opv_tpu_torch.cli.opv_mod     modulator (exact or --fast)
    python -m opv_tpu_torch.cli.opv_demod   demodulator (-s --fast)
    python -m opv_tpu_torch.cli.opv_modem   UDP modem server

Each runs on the card (--device cuda, the default) unless --device cpu is
given; main(argv) reads sys.stdin.buffer and writes sys.stdout.buffer, so
it can be called in-process."""
