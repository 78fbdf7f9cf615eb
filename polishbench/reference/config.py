"""Configuration: flags and algorithm settings.

Mirrors the reference's flag/settings surface:
- ``InputFlags`` / ``ScoreParams``: reference include/globalDefs.hpp:58-87
- settings constants: reference src/main.cpp:85-88
- ``get_kmer_len``: reference src/main.cpp:490-528
- ``get_expected_file_sz``: reference src/main.cpp:530-570
- ``set_kind``: reference src/main.cpp:572-585.  NOTE: in the reference
  the call to ``set_kind`` is dead code (main.cpp:312 only re-declares the
  function), so ``-k ccs`` never actually switches window sizes there.  We
  implement the documented behavior and expose
  ``InputFlags.legacy_dead_set_kind`` (default False) to reproduce the
  reference quirk when byte-parity against the shipped binary is wanted.

Frozen copy of hypo_tpu_torch/config.py (the port's copy of
hypo_tpu/config.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional


@dataclasses.dataclass
class ScoreParams:
    # reference defaults: src/main.cpp:101-106
    sr_match: int = 5
    sr_mismatch: int = -4
    sr_gap: int = -8
    lr_match: int = 3
    lr_mismatch: int = -5
    lr_gap: int = -4


@dataclasses.dataclass(frozen=True)
class SRSettings:
    # reference src/main.cpp:85
    cov_th: int = 5
    supp_frac: float = 0.4


@dataclasses.dataclass(frozen=True)
class MinimizerSettings:
    # reference src/main.cpp:86
    k: int = 10
    w: int = 10
    cov_th: int = 5
    supp_frac: float = 0.8
    # poly-base 10-mers (2-bit packed); reference globalDefs.hpp:126-135
    poly_a: int = 0x000000
    poly_c: int = 0x055555
    poly_g: int = 0x0AAAAA
    poly_t: int = 0x0FFFFF


@dataclasses.dataclass
class WindowSettings:
    # reference src/main.cpp:87 (mutable; set_kind may change it)
    ideal_swind_size: int = 100
    ideal_lwind_size: int = 500
    wind_size_search_th: int = 80


@dataclasses.dataclass(frozen=True)
class ArmsSettings:
    # reference src/main.cpp:88 {3u,20u,5u,10u,10u,0.4,10u}
    min_short_num: int = 3
    min_internal_num1: int = 20
    min_internal_num2: int = 5
    min_internal_num3: int = 10
    min_contrib: int = 10
    min_internal_contrib: float = 0.4
    short_arm_coef: int = 10


SR_SETTINGS = SRSettings()
MINIMIZER_SETTINGS = MinimizerSettings()
ARMS_SETTINGS = ArmsSettings()


@dataclasses.dataclass
class InputFlags:
    """Mirror of reference InputFlags (globalDefs.hpp:68-87)."""

    sr_filenames: List[str] = dataclasses.field(default_factory=list)
    sr_bam_filename: str = ""
    lr_bam_filename: str = ""
    draft_filename: str = ""
    output_filename: str = ""
    score_params: ScoreParams = dataclasses.field(default_factory=ScoreParams)
    map_qual_th: int = 2  # -q
    norm_edit_th: int = 20  # -n (percent)
    threads: int = 1  # -t
    processing_batch_size: int = 0  # -p (0 = all contigs)
    k: int = 13  # derived from -s
    cov: int = 0  # -c
    sz_in_gb: int = 12
    done_stage: int = 0
    intermed: bool = False  # -i
    kind: str = "sr"  # -k {sr, ccs}
    legacy_dead_set_kind: bool = False  # reproduce main.cpp:312 dead call
    aux_dir: str = "aux"
    inspect: bool = False  # write aux/regions.bed + aux/inspect.txt
    window_settings: WindowSettings = dataclasses.field(
        default_factory=WindowSettings)
    # device/bench knobs (no reference equivalent).
    # use_device_poa: None = auto, which keeps the host engine
    # (pipeline.polish.Polisher._resolve_device_poa); True/False = force.
    use_device_poa: Optional[bool] = None
    # "full": entire POA on device, one dispatch per bucket (column-POA
    #         tie-breaking, hypo_tpu.poa.device_full)
    # "exact": per-arm-round device DP with host merges; bit-identical
    #          to the host oracle engine
    device_poa_mode: str = "full"
    seed: int = 0
    # multi-host sharding (no reference equivalent — it is single-node):
    # contigs split into contiguous ranges; each process streams its own
    # BAM slice and writes output.shard{pid}; rank 0 gathers.
    num_processes: int = 1
    process_id: int = 0
    coordinator: str = ""  # torch.distributed coordinator (host:port)

    def __post_init__(self):
        if not self.legacy_dead_set_kind:
            set_kind(self.kind, self.window_settings)


# Stage constants (reference globalDefs.hpp:90-92)
STAGE_BEG = 0
STAGE_SK = 1
STAGE_SP = 2


_UNIT_POWER = {"K": 10, "M": 20, "G": 30, "T": 40}


def parse_size(given: str):
    """Split '4.6m' -> (4.6, 'M'); plain numbers -> (n, None)."""
    m = re.match(r"^([0-9]*\.?[0-9]+)\s*([kmgtKMGT]?)$", given.strip())
    if not m:
        raise ValueError(f"Bad genome-size string: {given!r}")
    val = float(m.group(1))
    unit = m.group(2).upper() or None
    return val, unit


def get_kmer_len(given_size: str) -> int:
    """Minimal odd k with 4^k >= genome size (reference main.cpp:490-528).

    Reproduces the reference arithmetic: k = ceil((power + ceil(log2 v))/2),
    bumped to odd, floored at 2 by the caller (main.cpp:172).
    """
    val, unit = parse_size(given_size)
    if unit is None:
        if val != math.floor(val):
            raise ValueError(
                "Genome-size with no units should be an absolute number")
        power = 0
    else:
        power = _UNIT_POWER[unit]
    kmer_len = power + math.ceil(math.log2(val))
    # NOTE: the reference computes ceil(kmer_len/2) on an unsigned int, so
    # the division truncates *before* ceil (main.cpp:524) — e.g. 23 -> 11.
    kmer_len = int(kmer_len) // 2
    if kmer_len % 2 == 0:
        kmer_len += 1
    return max(2, int(kmer_len))


def get_expected_file_sz(given_size: str, cov: int) -> int:
    """Expected short-read file size in GB, clamped [12, 1024].

    Reference main.cpp:530-570 (used as the KMC memory budget; we keep it
    for CLI parity / memory planning).
    """
    val, unit = parse_size(given_size)
    val = 2 * cov * val
    if unit is None:
        sz = val / 1e9
    elif unit == "K":
        sz = val / 1e6
    elif unit == "M":
        sz = val / 1e3
    elif unit == "G":
        sz = val
    else:  # T
        sz = 1024
    sz = int(sz)
    return min(max(sz, 12), 1024)


def set_kind(kind: str, ws: WindowSettings) -> None:
    """Window sizing per short-read kind (reference main.cpp:572-585)."""
    if kind == "sr":
        ws.ideal_swind_size = 100
        ws.wind_size_search_th = 80
    elif kind == "ccs":
        ws.ideal_swind_size = 500
        ws.wind_size_search_th = 400
    else:
        raise ValueError("kind-sr must be 'sr' or 'ccs'")
