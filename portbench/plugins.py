"""The harness's parts found by name: portbench/<kind>/<name>.py as a
module (a metric's reader, a mix's generator, a cell's check)."""

from __future__ import annotations

import importlib.util
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


def load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} module {name!r}: {path} is missing")
    safe = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
