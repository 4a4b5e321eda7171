"""The port's model architectures (importing registers them)."""

from . import mmf_m4c  # noqa: F401
