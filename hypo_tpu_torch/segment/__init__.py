"""Copied from hypo_tpu/segment/__init__.py."""
from .regions import RegionType  # noqa: F401
from .solid_pos import find_solid_pos  # noqa: F401
from .sr import scan_strong_regions, sr_tiers  # noqa: F401
from .minimizers import MWMinimizerInfo, build_mw_minimizer_info  # noqa: F401
