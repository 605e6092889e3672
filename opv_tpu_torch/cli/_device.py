"""--device for the port's CLIs: "cuda" (the default), "cuda:N" or "cpu".
A CUDA device that is not there is an error naming --device cpu, never a
silent run on the host."""

from __future__ import annotations

import torch


class DeviceError(RuntimeError):
    pass


def resolve_device(name: str) -> torch.device:
    """The torch.device of a --device value; raises DeviceError when it
    names a CUDA device this host does not have."""
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise DeviceError(f"--device {name}: {e}") from None
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0 or (dev.index or 0) >= count:
            raise DeviceError(
                f"--device {name}: no such CUDA device ({count} visible); "
                f"pass --device cpu to run on the host")
    elif dev.type != "cpu":
        raise DeviceError(f"--device {name}: only cuda[:N] and cpu are "
                          f"supported")
    return dev
