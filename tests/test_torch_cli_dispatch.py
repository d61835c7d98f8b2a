"""The port's CLI dispatcher (``python -m <port>.cli <command>``) against
the JAX package's: the same 17 commands and usage text, the same exit
codes (0 for ``-h`` / ``--help``, 2 for no command or an unknown one),
and every command resolving to the port's own module (``export_aot`` and
``train_began``, the last two ported, included)."""

import importlib
import subprocess
import sys

import pytest

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    __main__ as jmain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    __main__ as tmain,
)

PORT = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"


def test_same_commands():
    assert tmain.COMMANDS == jmain.COMMANDS and len(tmain.COMMANDS) == 17
    assert not hasattr(tmain, "UNPORTED")   # every command is ported


@pytest.mark.parametrize("argv", [["-h"], ["--help"], [], ["nope"],
                                  ["--nope"]])
def test_usage_and_exit_codes_equal_jax(argv, capsys):
    want = jmain.main(list(argv))
    want_out = capsys.readouterr().out
    got = tmain.main(list(argv))
    assert got == want == (0 if argv and argv[0] in ("-h", "--help") else 2)
    assert capsys.readouterr().out == want_out


@pytest.mark.parametrize("command", tmain.COMMANDS)
def test_ported_command_resolves_to_the_port(command, monkeypatch):
    """The dispatcher imports the port's module and hands it the rest of
    the arguments."""
    mod = importlib.import_module(f"{PORT}.cli.{command}")
    seen = []
    monkeypatch.setattr(mod, "main", lambda argv: seen.append(argv) or 7)
    assert tmain.main([command, "--x", "1"]) == 7
    assert seen == [["--x", "1"]]


@pytest.mark.parametrize("command,item", [("export_aot", "item 5"),
                                          ("train_began", "item 12")])
def test_unported_command_exits_naming_its_item(command, item, capsys):
    """The two commands that once exited naming their ROADMAP item (5 and
    12) now dispatch: their ``--help`` exits 0 with the port's usage."""
    with pytest.raises(SystemExit) as exc:
        tmain.main([command, "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage:") and item not in out


def test_module_entry_exit_codes():
    """``python -m <port>.cli``: ``-h`` of the dispatcher and of a command
    exit 0 (``export_aot`` and ``train_began`` included), a bare call 2;
    only an int a main returns becomes the exit code."""
    def run(*args):
        return subprocess.run([sys.executable, "-m", f"{PORT}.cli", *args],
                              capture_output=True, text=True, timeout=120)

    assert run("-h").returncode == 0
    assert run().returncode == 2
    r = run("landmarks68", "-h")
    assert r.returncode == 0 and "import-dat" in r.stdout
    for command in ("export_aot", "train_began"):
        r = run(command, "-h")
        assert r.returncode == 0 and "--out" in r.stdout
