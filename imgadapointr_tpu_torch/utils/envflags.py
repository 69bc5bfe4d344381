"""Boolean environment flags (the JAX package's ``utils/envflags.py`` rule)."""

from __future__ import annotations

import os


def env_flag(name: str) -> bool:
    """A boolean environment flag: set and not one of '', '0', 'false',
    'no', 'off' (any case)."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")
