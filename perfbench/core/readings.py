"""The arithmetic of the per-layer metrics, shared by their readers
(``metrics/<name>.py``). Each takes the run: its unprofiled window
(``window``: steps and seconds), its traced stretch (``trace``), the launch
counters' growth over that stretch (``launches``) and the driver."""

from __future__ import annotations

from perfbench.counts import kernels

F32_OPS_PER_S = 67e12


def per_unit_ms(run, family: str, per_batch: bool = False) -> float | None:
    """Device ms a step (or a batch) in one kernel family."""
    units = run.trace.steps
    if per_batch:
        units *= run.driver.batches_per_step()
    seconds = run.trace.family_s().get(family)
    return None if seconds is None else seconds / units * 1e3


def idle_share(run) -> float:
    """Percent of the traced stretch in which no device operation ran."""
    return (1.0 - run.trace.busy_s() / run.trace.wall_s) * 100.0


def mfu(run) -> float:
    """Model FLOPs over the unprofiled window, as a percent of the card's
    float32 peak outside the tensor cores."""
    flops = run.driver.flops_per_step() * run.window["steps"]
    return flops / (run.window["seconds"] * F32_OPS_PER_S) * 100.0


def roofline(run) -> float | None:
    """Sum of the least times of the step's hand-written kernel calls over
    the sum of their traced times, in percent; None unless each kernel
    launched as often as the configuration's call shapes say."""
    calls = run.driver.calls()
    steps = run.trace.steps * run.driver.batches_per_step()
    expected = kernels.launches(calls)
    for k, n in expected.items():
        if run.launches.get(k) != n * steps:
            return None
    traced = sum(run.trace.matching_s(kernels.KERNELS[k])
                 for k in calls)
    if traced <= 0:
        return None
    return kernels.least_total_s(calls) * steps / traced * 100.0
