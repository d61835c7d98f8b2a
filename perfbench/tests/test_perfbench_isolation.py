"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench.core import cell

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"

_SETUP = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.core import cell
from perfbench.tests import tiny
cfg, traffic = tiny.cell({kind!r})
drv = cell.driver(traffic["kind"])(cfg, traffic, 3, "cpu")
drv.setup()
drv.step()
print(json.dumps(cell.loaded_forbidden(sys.modules)))
"""


@pytest.mark.parametrize("kind", ["serve", "extract", "train"])
def test_driver_loads_no_jax(kind):
    res = subprocess.run(
        [sys.executable, "-c", _SETUP.format(root=cell.ROOT, kind=kind)],
        capture_output=True, text=True, timeout=600, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref, name)):
                top = mod.split(".")[0]
                assert top not in (PORT, "jax", "jaxlib", "flax", "optax",
                                   PORT[:-len("_torch")]), (name, mod)
    code = (f"import sys; sys.path.insert(0, {cell.ROOT!r}); "
            "import perfbench.reference.mtcnn, perfbench.reference.train; "
            f"print(any(m.split('.')[0] == {PORT!r} for m in sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert res.stdout.strip() == "False"
