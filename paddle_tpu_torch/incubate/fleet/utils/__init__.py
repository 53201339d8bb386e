from . import fs  # noqa: F401
