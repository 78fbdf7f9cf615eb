"""Copied from hypo_tpu/utils/__init__.py."""
