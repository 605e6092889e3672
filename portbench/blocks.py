"""The locked engine's block records (its block_trace, kept with
timing=True: one record a resolved block of how its program was launched,
the device programs launched for it, the host ms of its spans by path and
the device ms of its programs' CUDA event pairs), over the window's blocks
after the traced seconds, for the per-layer metrics that read them.  An
engine that keeps no such records reads as None, and so does a window
whose blocks hold nothing a metric reads."""

from __future__ import annotations


def records(ctx):
    """The block records after the traced seconds, or None."""
    rows = getattr(ctx.engine, "block_trace", None)
    if not rows:
        return None
    return rows[ctx.window.traced_blocks:] or None


def mean(ctx, value):
    """The mean of value(record) over the records, or None."""
    rows = records(ctx)
    if rows is None:
        return None
    return sum(value(r) for r in rows) / len(rows)


def host_ms(record: dict, name: str, under: str | None = None) -> float:
    """A record's host ms in the spans named `name`, wherever they were
    open (or only inside the top-level span `under`)."""
    return sum(v for path, v in record["host_ms"].items()
               if path.rsplit("/", 1)[-1] == name
               and (under is None or path.startswith(under + "/")))


def device_ms(ctx, name: str):
    """The mean device ms of the device span `name` a run, over every run
    the records hold, or None where they hold none."""
    rows = records(ctx)
    runs = [ms for r in rows or () for ms in r["device_ms"].get(name, ())]
    return sum(runs) / len(runs) if runs else None
