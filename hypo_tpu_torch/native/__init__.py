"""Copied from hypo_tpu/native/__init__.py."""
from .api import (available, NativeGraph,  # noqa: F401
                  native_window_consensus)
