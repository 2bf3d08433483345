"""No module of the benchmark imports JAX or the JAX package, the plain
reference imports nothing of the program, and nothing in portbench/
reads the JAX package's benchmark folder.

Names are compared as whole top-level names (the part before the first
dot): racon_tpu_torch begins with racon_tpu and is not it."""

import ast
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "racon_tpu"}


def _modules(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere_in_portbench():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN)
             for p in _modules(BENCH)}
    assert not {p: v for p, v in found.items() if v}
    assert len(found) > 20  # the scan saw the harness, readers, tests


def test_whole_name_comparison():
    # the program's name begins with the JAX package's and is allowed
    assert "racon_tpu_torch" not in FORBIDDEN
    assert "racon_tpu_torch".split(".")[0] != "racon_tpu"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for p in list(_modules(ref)) + [os.path.join(BENCH, "check.py")]:
        names = set(_imports(p))
        assert "racon_tpu_torch" not in names, p
        assert not names & FORBIDDEN, p


def test_nothing_reads_the_jax_benchmark_folder():
    for p in _modules(BENCH):
        if os.path.abspath(p) == os.path.abspath(__file__):
            continue
        src = open(p).read()
        assert not re.search(r"""(?<![\w./])benchmarks\b|(?<![\w/])bench\.py""",
                             src), p
