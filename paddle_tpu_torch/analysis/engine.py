"""The file walk and error test shared by the analysis tiers
(counterpart of ``paddle_tpu/analysis/engine.py:106-130``)."""

from __future__ import annotations

import os

from .diagnostics import ERROR

__all__ = ["_iter_py_files", "has_errors"]


def _iter_py_files(paths):
    """Every ``.py`` file under the given files and directories, in sorted
    order, skipping ``__pycache__`` and hidden directories."""
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d != "__pycache__" and
                               not d.startswith(".")]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)
        else:
            yield p


def has_errors(findings) -> bool:
    return any(f.severity == ERROR for f in findings)
