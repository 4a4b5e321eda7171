"""The port's tasks (importing registers them)."""

from . import tasks  # noqa: F401
