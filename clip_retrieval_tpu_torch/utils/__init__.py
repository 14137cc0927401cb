"""Small helpers shared by the port's entry points."""

from .braces import braceexpand  # noqa: F401
