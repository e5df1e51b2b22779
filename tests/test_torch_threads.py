"""The torch thread pin: every port test file that runs torch on the CPU
imports ``one_torch_thread`` from ``tests/torch_threads.py`` and defines
no copy of it (``test_torch_gpu.py`` runs on the card only)."""

import ast
import glob
import os

from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))


def test_every_port_test_file_imports_the_pin():
    missing, copies = [], []
    for path in sorted(glob.glob(os.path.join(HERE, "test_torch_*.py"))):
        name = os.path.basename(path)
        if name == "test_torch_gpu.py":
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), name)
        if not any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_threads"
                   and "one_torch_thread" in [a.name for a in node.names]
                   for node in tree.body):
            missing.append(name)
        copies += [name for node in ast.walk(tree)
                   if isinstance(node, ast.FunctionDef)
                   and node.name == "one_torch_thread"]
    assert not missing and not copies, (missing, copies)
