"""Copied from hypo_tpu/kmers/__init__.py."""
from .counting import KmerCounter, count_files  # noqa: F401
from .cutoffs import CutOffs, find_cutoffs  # noqa: F401
from .solid import Bitset, SolidKmers  # noqa: F401
