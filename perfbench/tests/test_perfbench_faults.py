"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath (half of each batch left out, an answer altered where it is
produced, a step that returns its state unchanged, and for serving a match
over only half of the gallery), not."""

import time

import pytest

from perfbench.core import cell
from perfbench.tests import tiny

NAMES = {"serve": "serve-efm342-s64", "extract": "extract-lightcnn29-b128",
         "train": "train-lightcnn29-p64"}
CASES = [(k, f) for k in NAMES for f in (None, "half", "alter", "stale")
         if not (k == "extract" and f == "stale")] + [("serve", "half_gallery")]


@pytest.mark.parametrize("kind,fault", CASES)
def test_run_is_correct_only_when_sound(kind, fault):
    cfg, traffic = tiny.cell(kind)
    bench = cell.manifest()
    out = cell.run_cell(NAMES[kind], traffic, cfg, seed=2 ** 31 + 11,
                        seconds=0.2, trace=False, device="cpu",
                        t_start=time.perf_counter(), bench=bench, fault=fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
