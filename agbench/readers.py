"""What the metric readers share.  Each metrics/<name>.py has one
read(run) that returns the metric's value, or None where the run has
nothing to read for it (the harness then leaves the metric out)."""

from __future__ import annotations

from agbench import harness, roofline


def per_step(run, units: str):
    """Seconds of the window's steps per unit of work (None without
    such units)."""
    n = run.units(units)
    return run.step_seconds() / n if n else None


def rate(run, units: str):
    """Units of work of the window's steps per second of them."""
    n, s = run.units(units), run.step_seconds()
    return n / s if n and s > 0 else None


def peak_gib(run):
    """The window's peak of allocated device bytes, in GiB."""
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None


def stat_mean(run, *path):
    """The mean over the measured steps of a number in each step's stats,
    found by the keys in path (None where no step has it)."""
    vals = []
    for s in run.measured_steps():
        v = s["stats"]
        for key in path:
            v = v.get(key) if isinstance(v, dict) else None
        if v is not None:
            vals.append(float(v))
    return sum(vals) / len(vals) if vals else None


def idle(run):
    """The device's idle share over the traced steps."""
    return run.trace.get("idle") if run.trace.get("busy_s") else None


def sw_roofline(run):
    """The banded SW's share of its roofline, in %: the least time the
    card needs for the work its inputs hold (roofline.SwWork) over the
    device time of the operations launched under the SW span."""
    ops, nbytes = run.sw.totals()
    dev_s = run.trace.get("span_device_s", {}).get(harness.SW_SPAN, 0.0)
    if not ops or dev_s <= 0 or not run.card:
        return None
    return 100.0 * roofline.bound(run.card, ops, nbytes)["bound_s"] / dev_s
