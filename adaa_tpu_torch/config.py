"""Experiment-config helpers (port of the parts of ``adaa_tpu/config.py``
that the port's entry points need)."""
from __future__ import annotations

from typing import Any, Dict, Optional


def resolve_checkpoint_path(ckpt: Dict[str, Any]) -> Optional[str]:
    """Accept both ``checkpoint.path`` and legacy ``checkpoint.paths[0]``."""
    path = ckpt.get("path")
    if path:
        return str(path)
    paths = ckpt.get("paths")
    if paths:
        return str(paths[0])
    return None
