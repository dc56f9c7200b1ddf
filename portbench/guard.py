"""The benchmark's import guard: an AST scan of ``portbench/**/*.py``.

No file imports JAX or the JAX package: an import's top-level name (the
part before the first dot) is compared whole against :data:`FORBIDDEN`, so
the port, whose name begins with the JAX package's, is not mistaken for
it.  Only the entries (``entries/``), which drive the program, and the
tests import the port: the reference, the input generator, the comparison,
the counts and the harness do not, so that the yardstick takes nothing of
what it measures.  ``python3 portbench/guard.py`` prints each offence and
exits 1 on any.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterator, List, Tuple

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudsc2_tpu")
PORT = "cloudsc2_tpu_torch"
#: the folders under ``portbench/`` whose files may import the port
MAY_IMPORT_PORT = ("entries", "tests")


def imports(tree: ast.AST) -> Iterator[Tuple[int, str]]:
    """``(line, top-level name)`` of each absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def offences(path: Path, root: Path = ROOT) -> List[str]:
    """What ``path`` (a file under ``root``) imports that it may not."""
    rel = path.relative_to(root)
    refused = FORBIDDEN if rel.parts[0] in MAY_IMPORT_PORT else FORBIDDEN + (PORT,)
    tree = ast.parse(path.read_text(), filename=str(path))
    return [f"{rel}:{line}: imports {name}" for line, name in imports(tree) if name in refused]


def scan(root: Path = ROOT) -> List[str]:
    """Every offence under ``root``."""
    return [o for path in sorted(root.rglob("*.py")) for o in offences(path, root)]


if __name__ == "__main__":
    found = scan()
    print("\n".join(found) or f"no offence in {ROOT}")
    sys.exit(1 if found else 0)
