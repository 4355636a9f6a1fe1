"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (``repro_torch`` begins with ``repro``), and
the reference imports nothing of the program."""
import ast

import pytest

from portbench.harness import loader

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(loader.BENCH_DIR.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(loader.BENCH_DIR)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((loader.BENCH_DIR / "reference").glob("*.py")):
        assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_the_prefix_rule_is_by_whole_name():
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch".split(".")[0] != "repro"
