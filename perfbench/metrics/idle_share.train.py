"""Percent of the traced stretch in which the card ran nothing (one minus
the union of its operations' intervals over the stretch's wall time)."""

from perfbench.core.readings import idle_share


def read(run):
    return idle_share(run)
