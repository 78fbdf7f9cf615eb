"""Coverage-histogram cutoff finder.

Faithful port of the reference peak/valley scan with delta-average plan B
(reference external/suk/src/SolidKmers.cpp:258-363).  Given hist[c] =
number of distinct kmers with count c (c in [0, 4*coverage]), finds:

- err:   end of the initial error peak
- mean:  count at the global maximum right of err
- lower: left valley (first count left of mean where most of the next 5
         lower counts have >= frequency)
- upper: right valley (symmetric scan; plan B = first minimum of a moving
         average of percentage deltas)

Divergence note: the reference divides by ``count_lower*hist[ind]`` in
plan B without a zero guard (SolidKmers.cpp:339, UB when no lower
neighbor exists); we treat that case as delta 0.

Frozen copy of hypo_tpu_torch/kmers/cutoffs.py (the port's copy of
hypo_tpu/kmers/cutoffs.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CutOffs:
    err: int = 0
    lower: int = 0
    upper: int = 0
    mean: int = 0


def find_cutoffs(hist) -> CutOffs:
    hist = np.asarray(hist, dtype=np.int64)
    coffs = CutOffs()
    length = len(hist) - 1  # last bin ignored (clubs higher freqs)

    # initial error peak
    ind = 2
    while ind < length and hist[ind] > hist[ind + 1]:
        ind += 1
    err_th = 2 if ind > 100 else ind
    coffs.err = err_th

    # mean = global maximum right of the error peak
    gmax = 0
    coffs.mean = err_th + 1  # defensive default (ref leaves it unset)
    for ind in range(err_th + 1, length):
        if hist[ind] > gmax:
            gmax = int(hist[ind])
            coffs.mean = ind

    lookup = 5
    # lower cutoff: scan left from mean-1 down to err
    bind = coffs.mean - 1
    eind = err_th
    coffs.lower = eind
    for ind in range(bind, eind - 1, -1):
        count_ge = 0
        count_lower = 0
        for ind2 in range(ind - 1, max(ind - lookup, eind) - 1, -1):
            if hist[ind2] < hist[ind]:
                count_lower += 1
            else:
                count_ge += 1
        if count_ge >= count_lower:
            coffs.lower = ind
            break

    # upper cutoff: scan right from mean+1
    bind = coffs.mean + 1
    eind = min(bind + 2 * (coffs.mean - coffs.lower), length)
    coffs.upper = eind
    plan_a = False
    for ind in range(bind, eind):
        count_lower = 0
        count_ge = 0
        for ind2 in range(ind + 1, min(ind + lookup, length - 1) + 1):
            if hist[ind2] < hist[ind]:
                count_lower += 1
            else:
                count_ge += 1
        if count_ge >= count_lower:
            coffs.upper = ind
            plan_a = True
            break

    if not plan_a and eind > bind:
        delta_avg = np.zeros(eind, dtype=np.int64)
        for ind in range(bind, eind):
            delta_sum = 0
            count_lower = 0
            for ind2 in range(ind + 1, min(ind + lookup, length - 1) + 1):
                if hist[ind2] < hist[ind]:
                    count_lower += 1
                    delta_sum += int(hist[ind] - hist[ind2])
            denom = count_lower * int(hist[ind])
            delta_avg[ind] = (delta_sum * 100) // denom if denom else 0
        min_avg = float(delta_avg[bind])
        for ind in range(bind, eind):
            wl = min(lookup, eind - ind)
            avg = float(delta_avg[ind:ind + wl].sum()) / wl
            if avg < min_avg:
                min_avg = avg
                coffs.upper = ind

    return coffs
