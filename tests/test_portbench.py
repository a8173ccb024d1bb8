"""``portbench/``'s CPU tests in tier-1: every test of
``portbench/test_portbench_*.py``, collected here under its own name (the
card's tests skip here). ``python -m pytest portbench`` runs the same
tests; ``python -m pytest portbench -m cuda``, on the card, its card
tests."""

import importlib
from pathlib import Path

for _path in sorted((Path(__file__).resolve().parent.parent / "portbench")
                    .glob("test_portbench_*.py")):
    for _name, _obj in vars(importlib.import_module(f"portbench.{_path.stem}")).items():
        if _name.startswith("test_") and callable(_obj):
            assert _name not in globals(), f"two tests named {_name} in portbench/"
            globals()[_name] = _obj
