"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    global generator
    old = generator
    generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        generator = old


def switch(new_generator=None):
    """Install ``new_generator`` (a fresh one by default); returns the
    previous generator."""
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old
