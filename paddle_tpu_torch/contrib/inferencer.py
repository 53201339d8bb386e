"""reference python/paddle/contrib/inferencer.py — re-export; the class
lives beside Trainer in trainer.py (as in the JAX package)."""
from .trainer import Inferencer  # noqa: F401
