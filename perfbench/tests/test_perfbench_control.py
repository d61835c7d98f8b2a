"""The control on the card: the plain reference computed in TF32, put in
the program's place, comes out not correct; the sound program at the same
tiny size comes out correct. (At the cells' own sizes the control's
readings come from ``perfbench/calibrate.py``.)"""

import time

import pytest

from perfbench.core import cell
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_faults import NAMES


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["serve", "extract", "train"])
@pytest.mark.parametrize("fault", [None, "control"])
def test_control_fails_on_the_card(cuda, kind, fault):
    cfg, traffic = tiny.cell(kind)
    drv = cell.driver(traffic["kind"])(cfg, traffic, 2 ** 31 + 5, "cuda",
                                       fault=fault)
    drv.setup()
    for _ in range(drv.check_steps()):
        drv.step()
    drv.close()
    checks = drv.check()
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    assert ok is (fault is None), checks
