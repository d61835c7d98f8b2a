"""CLI dispatcher: ``python -m <package>.cli <command> [args...]``.

Port of the JAX package's ``cli/__main__.py``: the same 17 commands, usage
text and exit codes (0 for ``-h`` / ``--help``, 2 for no command or an
unknown one); every command has its port module.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = [
    "train_backbone", "train_head", "train_final", "train_began",
    "extract_features", "eval_cos", "draw_cos", "slice_dataset",
    "lfw_eval", "lfw_run", "align", "pack_dataset", "serve_demo",
    "identify", "landmarks68", "import_params", "export_aot",
]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: ... cli <command> [args...]\ncommands: "
              + ", ".join(COMMANDS))
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    mod = importlib.import_module(f"{__package__}.{argv[0]}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    _rc = main()
    # CLI mains return rich objects (states, results) for tests: only an
    # int is a meaningful process exit code
    sys.exit(_rc if isinstance(_rc, int) else 0)
