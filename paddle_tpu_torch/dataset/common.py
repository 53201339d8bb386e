"""Shared dataset plumbing (counterpart of ``paddle_tpu/dataset/common.py``;
reference: python/paddle/dataset/common.py). Both packages read the same
cache directory, ``$PADDLE_TPU_DATA_HOME``.

``download`` is gated: with no network egress it raises unless the file is
already cached, and every loader catches that and synthesizes data instead.
"""
from __future__ import annotations

import os
import sys

__all__ = ["DATA_HOME", "cached_path", "synthetic_notice"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def cached_path(module: str, filename: str):
    """Path of a real data file if the user has placed it in the cache
    (reference download() target layout); None otherwise."""
    p = os.path.join(DATA_HOME, module, filename)
    return p if os.path.exists(p) else None


_warned = set()


def synthetic_notice(name: str):
    if name not in _warned:
        _warned.add(name)
        print(f"[paddle_tpu_torch.dataset] '{name}' not found under {DATA_HOME}; "
              f"using deterministic synthetic data (no network egress)",
              file=sys.stderr)
