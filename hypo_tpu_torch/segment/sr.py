"""Strong-region (SR) construction from supported solid k-mers.

Port of the two-tier 80%/40% support scan in reference
Contig::prepare_for_division (src/Contig.cpp:75-139).  A k-mer is valid
if coverage >= cov_th and either support >= 2*floor(0.4*cov) ("80% tier",
re-arms the 40% tier) or support >= floor(0.4*cov) while the previous
tier-touching k-mer was 80% ("40% tier", accepted once then disarms).
Runs of valid k-mers (closed when the scan passes the last covered base)
become SRs; the first/last k-mer ids of each SR are its anchors.  The
tiers are one array pass (``sr_tiers``); the scan that arms and disarms
the 40% tier is ``scan_strong_regions``, whose native twin is
native.host_api.strong_regions.

Copied from hypo_tpu/segment/sr.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SR_SETTINGS


@dataclasses.dataclass
class StrongRegions:
    sr_pos: np.ndarray       # int64, start position of each SR
    sr_len: np.ndarray       # int64
    anchor_kmers: np.ndarray  # int64, [dummy, first_0, last_0, first_1, ...]

    @property
    def num_sr(self) -> int:
        return len(self.sr_pos)

    @property
    def len_sr(self) -> int:
        return int(self.sr_len.sum())


def sr_tiers(coverage: np.ndarray, support: np.ndarray) -> np.ndarray:
    """Each solid k-mer's tier, uint8: 2 for the 80% tier, 1 for the 40%
    tier, 0 for neither (below ``cov_th`` or too little support)."""
    covered = coverage >= SR_SETTINGS.cov_th
    # floor, matches the reference's UINT cast
    supp_th = (SR_SETTINGS.supp_frac * coverage).astype(np.int64)
    tier80 = covered & (support >= 2 * supp_th)
    tier40 = covered & ~tier80 & (support >= supp_th)
    return (2 * tier80 + tier40).astype(np.uint8)


def scan_strong_regions(positions: np.ndarray, kids: np.ndarray,
                        tier: np.ndarray, k: int):
    """The sequential part of the scan (the 40% tier's arming): SRs of
    the solid positions given their tiers, as (sr_pos, sr_len,
    anchor_kmers).  native.host_api.strong_regions is its twin."""
    sr_pos = []
    sr_len = []
    anchors = [0]
    in_sr = False
    pvs_80 = True
    first_kind = last_kind = 0
    first_sr_pos = last_sr_pos = 0

    def close():
        nonlocal in_sr, pvs_80
        sr_pos.append(first_sr_pos)
        sr_len.append(last_sr_pos - first_sr_pos)
        anchors.append(int(kids[first_kind]))
        anchors.append(int(kids[last_kind]))
        in_sr = False
        pvs_80 = True

    tiers = np.asarray(tier).tolist()
    for i, p in enumerate(np.asarray(positions).tolist()):
        if in_sr and p > last_sr_pos:
            close()
        t = tiers[i]
        if t == 2:
            valid = True
            pvs_80 = True
        elif t == 1:
            valid = pvs_80
            pvs_80 = False
        else:
            valid = False
        if valid:
            if not in_sr:
                first_kind = i
                first_sr_pos = p
                in_sr = True
            last_kind = i
            last_sr_pos = p + k
        if in_sr and p == last_sr_pos:
            close()
    if in_sr:
        close()
    return (np.array(sr_pos, dtype=np.int64),
            np.array(sr_len, dtype=np.int64),
            np.array(anchors, dtype=np.int64))

