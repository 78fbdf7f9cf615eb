"""Copied from hypo_tpu/parallel/__init__.py (``make_mesh`` is
``local_devices`` here)."""
from .mesh import local_devices  # noqa: F401
