"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository.  They import the harness the way ``run.py`` does
(``portbench/`` and ``src/`` on the path)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
