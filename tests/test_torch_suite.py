"""The suite's own shape: no test leaves the default run.

Tier-1 runs `pytest -m 'not slow'`, so a `slow` mark takes a test out of it
for good: nothing runs `-m slow`. No test here carries one.

Checked in the source of every module under tests/ (conftest.py and the
helpers included), with `ast`: any `pytest.mark.slow` or `<x>.mark.slow`
attribute wherever it stands (a decorator, `pytestmark`, `pytest.param(...,
marks=...)`, an alias), `getattr(<x>.mark, "slow")`, and a marker given by
name, as in `item.add_marker("slow")` or `request.applymarker("slow")`. A
hook that deselects tests by other means is not checked."""
import ast
import pathlib

BY_NAME = {"add_marker", "applymarker", "getattr", "Mark", "MarkDecorator"}


def _slow_marks(tree):
    """Line numbers of the `slow` marks in a module's syntax tree."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr == "slow"
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "mark"):
            yield node.lineno
        if isinstance(node, ast.Call):
            func = node.func
            name = getattr(func, "attr", getattr(func, "id", None))
            if name in BY_NAME and any(
                    isinstance(a, ast.Constant) and a.value == "slow"
                    for a in node.args):
                yield node.lineno


def test_no_test_is_marked_slow():
    marked = [f"{path.name}:{line}"
              for path in sorted(pathlib.Path(__file__).parent.glob("*.py"))
              for line in _slow_marks(ast.parse(path.read_text(), str(path)))]
    assert not marked, marked
