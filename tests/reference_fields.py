"""The field names a reference script under `scripts/` (or `bench.py`)
prints, read from its source, for the port's twins to be held to."""

import ast
from pathlib import Path


def ref_keys(path: Path, func: str | None = None) -> set:
    """Every string key of a dict literal, `x["key"] = ...` target and
    `x.update(key=...)` keyword in the reference script at `path`, or only
    in its function `func`."""
    tree = ast.parse(Path(path).read_text())
    if func is not None:
        tree = next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant):
                    keys.add(t.slice.value)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"):
            keys |= {k.arg for k in node.keywords if k.arg}
    return keys
