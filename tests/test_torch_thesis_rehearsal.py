"""``tools/thesis_rehearsal_torch.py --cpu``: the port's whole thesis chain
at a tiny size, every stage a CLI subprocess on the CPU — pack, backbone
training preempted by a real SIGTERM after its first epoch and resumed
with ``--resume``, extraction from the trained export, slicing, the
triplet head, ``eval_cos`` and, where matplotlib is installed,
``draw_cos``. LightCNN9 at 32 px, two backbone epochs; the subprocesses
get two threads each so the test stays cheap under the suite's workers.
"""

import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import thesis_rehearsal_torch as rehearsal  # noqa: E402


def test_cpu_chain_with_preemption_and_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    art = os.path.relpath(str(tmp_path / "art"), REPO)
    summary = rehearsal.main([
        "--cpu", "--rows", "256", "--ids", "16", "--size", "32", "--model",
        "lightcnn9", "--backbone-batch", "16", "--backbone-epochs", "2",
        "--scan-chunk", "2", "--head-batch", "128", "--head-epochs", "2",
        "--extract-batch", "64", "--out", str(tmp_path / "work"),
        "--artifacts", art])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    stages = [ln["stage"] for ln in lines]
    plots = importlib.util.find_spec("matplotlib") is not None
    assert stages == ["pack", "backbone_resumed", "backbone", "extract",
                      "slice", "head", "eval_cos", "draw_cos", "summary"]
    assert ("skipped" in lines[7]) != plots
    assert summary == lines[-1] and summary["platform"] == "cpu"
    assert summary["resume"]["resumed_at_epoch"] == 1
    assert summary["resume"]["epoch_lines"] == 2      # one run each side
    assert set(summary["timings_s"]) == {
        "pack", "backbone_preempted", "backbone_resumed", "extract", "slice",
        "head", "eval_cos"} | ({"draw_cos"} if plots else set())
    curve = summary["separation_curve"]
    assert [c["epoch"] for c in curve] == [0, 1]
    assert all(0.0 <= c["auc"] <= 1.0 for c in curve)
    with open(os.path.join(REPO, art, "thesis_rehearsal.json")) as f:
        assert json.load(f) == summary
    work = tmp_path / "work"
    for log in ("backbone_preempted.log", "backbone_resumed.log",
                "extract.log", "head.log"):
        assert (work / log).is_file()
    assert "preemption requested" in (work / "backbone_preempted.log").read_text()
    assert os.path.isfile(work / "sliced" / "test.npz")
