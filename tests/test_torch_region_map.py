"""A contig's region map as flat arrays (``pipeline.contig``), on the CPU:
each stage's native call against its Python walk, and the array prune
and output against the per-window loops they replaced.

- The strong-region scan: ``host_api.strong_regions`` and
  ``segment.sr.scan_strong_regions`` give the same ``sr_pos``,
  ``sr_len`` and ``anchor_kmers`` on random solid positions: a contig
  that starts with an SR, one with no SR, none at all, dense runs.
  ``prepare_for_division``'s boundaries and MegaWindows equal the list
  walk it replaced.
- The division: ``divide_into_regions`` with the host library and with
  ``HYPO_TPU_NO_NATIVE`` gives the same ``reg_starts``, ``reg_type``,
  ``reg_info`` and windows, on crafted contigs (first region an SR,
  MegaWindows no longer than the ideal window, empty minimizer tables,
  homopolymer runs at and near the force cut's search threshold, the
  ``(n,m)`` -> OTHER quirk, no SR) and on a simulated one.
- The fill and prune: on random arm tables, the native table's
  counters (``fill_short_windows_from_table``), the windows' own
  (``add_arm_table`` + ``fill_short_windows``) and the per-alignment
  arms (``fill_short_windows``) leave the windows the per-window loop
  leaves: the same survivors, counters and cleared prefix and suffix.
- The output: ``polished_seq`` equals the per-region loop, with and
  without long reads, with LONG and dropped windows.
- A whole polish of a small simulated contig writes the same FASTA and
  the same ``--inspect`` files with the host library and with
  ``HYPO_TPU_NO_NATIVE=1``.
"""
import math

import numpy as np
import pytest

from hypo_tpu_torch import cli
from hypo_tpu_torch.config import ARMS_SETTINGS, WindowSettings
from hypo_tpu_torch.dna import decode
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.alignment import Alignment, Arm
from hypo_tpu_torch.pipeline.contig import Contig
from hypo_tpu_torch.pipeline.window import LONG, Window
from hypo_tpu_torch.segment.regions import RegionType as R
from hypo_tpu_torch.segment.sr import scan_strong_regions, sr_tiers
from hypo_tpu_torch.sim import SimConfig, simulate
from hypo_tpu_torch.utils import trace

pytestmark = pytest.mark.skipif(not host_api.available(),
                                reason="the native host library did not build")

WS = WindowSettings()
MK = 10


# -- the strong-region scan ----------------------------------------------

def _solid(rng, n, shape):
    """Random solid positions (sorted, unique), k-mer ids and tiers."""
    if shape == "dense":
        gaps = rng.choice([1, 1, 1, 2, 12], n)
    else:
        gaps = rng.choice([1, 1, 2, 5, 11, 12, 13, 40], n)
    pos = np.cumsum(gaps) - gaps[0] + (0 if shape == "sr_first" else 7)
    kids = rng.integers(0, 4 ** 11, n)
    p = {"no_sr": [1.0, 0, 0], "sr_first": [0.2, 0.3, 0.5],
         "dense": [0.1, 0.3, 0.6], "mixed": [0.4, 0.3, 0.3]}[shape]
    tier = rng.choice(3, n, p=p).astype(np.uint8)
    if shape == "sr_first":
        tier[0] = 2
    return pos.astype(np.int64), kids.astype(np.int64), tier


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", ["mixed", "dense", "sr_first", "no_sr"])
def test_strong_region_scan_native_equals_python(seed, shape):
    rng = np.random.default_rng(seed)
    pos, kids, tier = _solid(rng, int(rng.integers(1, 3000)), shape)
    for k in (11, 5):
        got = host_api.strong_regions(pos, kids, tier, k)
        want = scan_strong_regions(pos, kids, tier, k)
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and np.array_equal(g, w)
    if shape == "no_sr":
        assert len(got[0]) == 0 and list(got[2]) == [0]
    elif shape == "sr_first":
        assert got[0][0] == 0


def test_strong_region_scan_of_nothing():
    z = np.zeros(0, np.int64)
    got = host_api.strong_regions(z, z, np.zeros(0, np.uint8), 11)
    assert [a.tolist() for a in got] == [[], [], [0]]


def test_tiers_follow_the_two_thresholds():
    cov = np.array([4, 5, 5, 5, 10, 10, 10, 10])
    sup = np.array([4, 4, 1, 2, 8, 4, 3, 0])
    # floor(0.4 * 5) = 2, floor(0.4 * 10) = 4; below cov_th 5: no tier
    assert sr_tiers(cov, sup).tolist() == [0, 2, 0, 1, 2, 1, 0, 0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", ["mixed", "sr_first", "no_sr"])
def test_boundaries_equal_the_list_walk(monkeypatch, seed, shape):
    """stage1_starts, is_win_even and the MegaWindows handed to the
    minimizer build equal the list appends they replaced."""
    rng = np.random.default_rng(seed)
    pos, kids, tier = _solid(rng, 800, shape)
    clen = int(pos[-1]) + 11 + int(rng.integers(0, 2)) * 30
    ctg = Contig(0, "c", rng.integers(0, 4, clen).astype(np.uint8))
    ctg.solid_pos, ctg.kids = pos, kids
    ctg.kmer_coverage = np.full(len(pos), 10, np.int64)
    ctg.kmer_support = np.array([0, 4, 8], np.int64)[tier]
    seen = {}
    monkeypatch.setattr(Contig, "_build_mw_minimizers",
                        lambda self, b, e, ws: seen.update(b=b, e=e))
    sr_pos, sr_len, _a = scan_strong_regions(pos, kids, tier, 11)
    ctg.prepare_for_division(11, WS)

    n = len(sr_pos)
    even = not (n > 0 and int(sr_pos[0]) == 0)
    starts = [0]
    begs = [0] if even else []
    ends = [int(sr_pos[0]) if n else clen] if even else []
    for i in range(n):
        s = int(sr_pos[i])
        e = s + int(sr_len[i])
        starts += [s, e]
        begs.append(e)
        ends.append(int(sr_pos[i + 1]) if i + 1 < n else clen)
    starts.append(clen)
    assert ctg.is_win_even == even
    assert ctg.stage1_starts.tolist() == sorted(set(starts))
    assert seen["b"].tolist() == begs and seen["e"].tolist() == ends
    assert seen["b"].dtype == seen["e"].dtype == np.int64


# -- the division -----------------------------------------------------------

def _hp_codes(rng, n, mean_run):
    """Codes made of homopolymer runs of mean length ``mean_run``."""
    runs = rng.geometric(1.0 / mean_run, n)
    bases = rng.integers(0, 4, n)
    codes = np.repeat(bases, runs)[:n]
    return codes.astype(np.uint8)


def _divided_inputs(seed, case):
    """A Contig as prepare_for_division and the minimizer support leave
    it, crafted: (contig, expected first-region type or None)."""
    rng = np.random.default_rng(seed)
    clen = int(rng.integers(3000, 12000))
    codes = _hp_codes(rng, clen, {"homopolymers": 2.2}.get(case, 1.3))
    # SRs: (start, end) with gaps
    srs = []
    p = (0 if case == "sr_first"
         else int(rng.integers(1, WS.ideal_swind_size + 1))
         if case == "short_mws" else int(rng.integers(1, 400)))
    while case not in ("no_sr", "quirk") and p < clen - 50:
        e = min(clen, p + int(rng.integers(11, 300)))
        srs.append((p, e))
        gap = (int(rng.integers(1, WS.ideal_swind_size + 1))
               if case == "short_mws" else int(rng.integers(1, 1500)))
        p = e + gap
    if case == "short_mws":      # the last SR ends the contig
        srs[-1] = (srs[-1][0], clen)
    first = None
    if case == "quirk":
        # one MegaWindow (no SR) whose first supported minimizer sits
        # past a homopolymer that covers the force cut's whole search
        codes[79] = 1
        codes[80:400] = 0
        first = R.OTHER
    even = not (srs and srs[0][0] == 0)
    edges = [0] + [x for se in srs for x in se] + [clen]
    s1 = np.unique(np.array(edges, np.int64))
    mws = ([(0, srs[0][0] if srs else clen)] if even else [])
    mws += [(e, srs[i + 1][0] if i + 1 < len(srs) else clen)
            for i, (_s, e) in enumerate(srs)]
    off, vals, mpos = [0], [], []
    for b, e in mws:
        if e - b > WS.ideal_swind_size:
            # dense, sparse or rare minimizers: the sparse ones leave
            # stretches for the force cut
            every = int(rng.choice([12, 60, 500]))
            m = np.sort(rng.choice(np.arange(b, max(b + 1, e - 5)),
                                   size=max(0, (e - b) // every),
                                   replace=False))
            if case == "quirk" and b == 0:
                m = np.concatenate(([400], m[m > 400 + MK]))
            vals.extend(rng.integers(0, 4 ** MK, len(m)).tolist())
            mpos.extend(m.tolist())
        off.append(len(mpos))
    ctg = Contig(0, "c", codes)
    ctg.is_win_even = even
    ctg.stage1_starts = s1
    ctg.mw_off = np.array(off, np.int64)
    ctg.mw_vals = np.array(vals, np.int64)
    ctg.mw_pos = np.array(mpos, np.int64)
    nm = len(mpos)
    if case == "empty_minimizers":
        ctg.mw_cov = np.zeros(nm, np.int32)
        ctg.mw_sup = np.zeros(nm, np.int32)
    else:
        ctg.mw_cov = rng.integers(0, 30, nm).astype(np.int32)
        ctg.mw_sup = (ctg.mw_cov * rng.choice([0.5, 0.8, 0.9, 1.0], nm)
                      ).astype(np.int32)
        if case == "quirk":
            ctg.mw_cov[0], ctg.mw_sup[0] = 20, 20
    return ctg, first


def _clone(ctg):
    c = Contig(ctg.id, ctg.name, ctg.codes)
    for a in ("is_win_even", "stage1_starts", "mw_off", "mw_vals", "mw_pos",
              "mw_cov", "mw_sup"):
        setattr(c, a, getattr(ctg, a))
    return c


def _divide_both(monkeypatch, ctg):
    out = []
    for native in (True, False):
        c = _clone(ctg)
        if native:
            monkeypatch.delenv("HYPO_TPU_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
        c.divide_into_regions(WS)
        out.append(c)
    monkeypatch.delenv("HYPO_TPU_NO_NATIVE", raising=False)
    return out


def _assert_same_map(a, b):
    assert a.reg_starts.dtype == b.reg_starts.dtype == np.int64
    assert a.reg_type.dtype == b.reg_type.dtype == np.uint8
    assert a.reg_info.dtype == b.reg_info.dtype == np.int64
    assert np.array_equal(a.reg_starts, b.reg_starts)
    assert np.array_equal(a.reg_type, b.reg_type)
    assert np.array_equal(a.reg_info, b.reg_info)
    assert len(a.windows) == len(b.windows) == len(a.reg_type)
    for wa, wb in zip(a.windows, b.windows):
        assert (wa is None) == (wb is None)
        if wa is not None:
            assert np.array_equal(wa.draft, wb.draft)


CASES = ["mixed", "sr_first", "short_mws", "empty_minimizers",
         "homopolymers", "quirk", "no_sr"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_division_native_equals_python(monkeypatch, seed, case):
    ctg, first = _divided_inputs(seed, case)
    nat, py = _divide_both(monkeypatch, ctg)
    _assert_same_map(nat, py)
    t = nat.reg_type
    assert nat.reg_starts[0] == 0 and nat.reg_starts[-1] == ctg.length
    assert np.all(np.diff(nat.reg_starts) > 0)
    assert t[-1] == R.SR
    if first is not None:
        assert t[0] == first
    if case == "sr_first":
        assert t[0] == R.SR and not ctg.is_win_even
    if case == "short_mws":
        assert not np.isin(t, (R.MSR, R.MWM)).any()
    if case == "empty_minimizers":
        assert not (t == R.MSR).any()
    if case == "no_sr":
        assert not (t[:-1] == R.SR).any()
    if case in ("mixed", "homopolymers"):
        assert (t == R.MSR).any() and (t == R.OTHER).any()
    # windows exactly for the weak regions, each its draft's slice
    weak = (t[:-1] != R.SR) & (t[:-1] != R.MSR)
    assert [w is not None for w in nat.windows[:-1]] == weak.tolist()


@pytest.mark.parametrize("off", [[0, 0], [0, 0, 3]])
def test_division_refuses_tables_that_do_not_match(off):
    """Two MegaWindows ([0, 200) and [300, 500)) need three offsets:
    [0, 0] has two, and [0, 0, 3] points past an empty table."""
    z = np.zeros(0, np.int64)
    with pytest.raises(ValueError, match="do not match"):
        host_api.divide_regions(
            np.zeros(500, np.uint8), np.array([0, 200, 300, 500]), True,
            np.array(off), z, z, np.zeros(0, np.uint8), MK, 100, 80)
    with pytest.raises(ValueError, match="k-mer ids"):
        host_api.strong_regions(np.arange(3), np.arange(2),
                                np.zeros(3, np.uint8), 11)


@pytest.mark.parametrize("seed", [5, 6])
def test_division_of_a_simulated_contig(tmp_path, monkeypatch, seed):
    """Real stages up to the division on a 20 kbp simulation with a
    stretch that no short read covers (force cuts there)."""
    from hypo_tpu_torch.config import MINIMIZER_SETTINGS as MS
    from hypo_tpu_torch.config import get_kmer_len
    from hypo_tpu_torch.io.fasta import read_fastx
    from hypo_tpu_torch.kmers.solid import SolidKmers
    from hypo_tpu_torch.native import bam_api
    paths = simulate(SimConfig(genome_size=20000, seed=seed,
                               dropout=(0.4, 0.5)), str(tmp_path / "sim"))
    (name, seq), = list(read_fastx(paths["draft"]))
    k = get_kmer_len("20000")
    sk = SolidKmers(k).initialise([paths["reads"]], 30)
    stream = bam_api.NativeBamStream(paths["sr_bam"], {name: 0})
    store, _n, _ni = stream.load_store(1, 2, None)
    ctg = Contig(0, name, seq)
    ctg.find_solid_pos(sk)
    host_api.skmer_support(ctg, store[0], k)
    ctg.prepare_for_division(k, WS)
    host_api.minimizer_support(ctg, store[0], MS.k, MS.w)
    nat, py = _divide_both(monkeypatch, ctg)
    _assert_same_map(nat, py)
    assert (nat.reg_type == R.OTHER).sum() > 10
    assert (nat.reg_type == R.SR).sum() > 100


@pytest.mark.parametrize("native", [True, False])
def test_division_counts_its_regions(monkeypatch, native):
    ctg, _f = _divided_inputs(0, "mixed")
    if not native:
        monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    trace.RECORDER.reset()
    trace.enable()
    try:
        ctg.divide_into_regions(WS)
    finally:
        trace.disable()
    counts = {}
    for name, n, *_ in trace.RECORDER.counts:
        counts[name] = counts.get(name, 0) + n
    trace.RECORDER.reset()
    name = "pipeline.regions_native" if native else "pipeline.regions_python"
    assert counts == {name: ctg.num_regions()}


# -- the fill and prune ---------------------------------------------------

def _prune_loop(ctg):
    """The per-window prune that the array rule replaced
    (Contig.cpp:249-289)."""
    A = ARMS_SETTINGS
    for i in range(ctg.num_regions()):
        t = ctg.reg_type[i]
        if t in (R.SR, R.MSR):
            continue
        w = ctg.windows[i]
        if w is None:
            continue
        discarded = False
        internal_contrib = w.get_num_internal()
        if internal_contrib < A.min_short_num:
            win_len = int(ctg.reg_starts[i + 1] - ctg.reg_starts[i])
            covered = w.longest_pre_len + w.longest_suf_len >= win_len
            sufficient = (w.num_pre >= A.min_short_num
                          and w.num_suf >= A.min_short_num)
            if not (covered and sufficient):
                ctg.windows[i] = None
                discarded = True
        if not discarded:
            contrib = w.get_num_total()
            cond0 = internal_contrib > A.min_internal_num1
            cond1 = (contrib >= A.min_contrib and internal_contrib
                     >= math.floor(A.min_internal_contrib * contrib))
            cond2 = (t in (R.SWS, R.SW, R.WS, R.MWS, R.SWM)
                     and internal_contrib >= A.min_internal_num2)
            if cond0 or cond1 or cond2:
                w.clear_pre_suf()


class _Reads:
    """Alignments as add_arm_table reads them: codes(aln, qb, qe)."""

    def __init__(self, rng, n):
        self.seqs = [rng.integers(0, 4, 400).astype(np.uint8)
                     for _ in range(n)]

    def codes(self, a, b, e):
        return self.seqs[a][b:e]


def _arm_table(rng, ctg, n_aln):
    """Random arms for every region (SRs too, which no window takes):
    counts skewed so that every branch of the prune is taken; and four
    windows at the rule's edges: 20 internal arms (19 and an empty one)
    against 40 prefix and suffix arms in a window of no SR's side (kept
    whole), 21 of them (cleared), and 3 prefix and 3 suffix arms whose
    longest reach the window's length exactly (kept) and one short of it
    (dropped)."""
    rows = []
    rs = ctg.reg_starts
    t = ctg.reg_type
    wl_all = np.diff(rs)
    far = np.nonzero(np.isin(t[:-1], (R.MWM, R.MW, R.WM, R.OTHER)))[0]
    near = np.nonzero(np.isin(t[:-1], (R.SWS, R.SW, R.WS, R.MWS, R.SWM,
                                       R.MWM, R.MW, R.WM, R.OTHER))
                      & (wl_all[:len(t) - 1] >= 4)
                      & (wl_all[:len(t) - 1] <= 300))[0]
    near = near[~np.isin(near, far[:2])]
    edge = {int(far[0]): 20, int(far[1]): 21, int(near[0]): 0,
            int(near[1]): -1}

    def row(wi, kind, ln):
        qb = int(rng.integers(0, 400 - ln))
        rows.append((int(rng.integers(0, n_aln)), wi, qb, qb + ln, kind))

    for wi, n_int in edge.items():
        wl = int(wl_all[wi])
        if n_int > 0:
            for _ in range(n_int - 1):
                row(wi, 0, 30)
            row(wi, 3, 0)
            for _ in range(20):
                row(wi, 1, 20)
                row(wi, 2, 20)
        else:   # longest prefix + longest suffix = wl + n_int
            for ln in (1, 1, wl // 2):
                row(wi, 1, ln)
            for ln in (wl - wl // 2 + n_int, 1, 1):
                row(wi, 2, ln)
    for wi in range(ctg.num_regions()):
        if wi in edge:
            continue
        wl = int(rs[wi + 1] - rs[wi])
        n = {0: 0, 1: 1, 2: 2, 3: 4, 4: 8, 5: 25}[int(rng.integers(0, 6))]
        for _ in range(n):
            t = int(rng.choice(4, p=[0.4, 0.25, 0.25, 0.1]))
            ln = int(rng.integers(1, max(2, min(399, wl + 20))))
            qb = int(rng.integers(0, 400 - ln))
            rows.append((int(rng.integers(0, n_aln)), wi, qb, qb + ln, t))
    rng.shuffle(rows)
    a = np.array(rows, np.int64).T
    return (a[0].astype(np.int32), a[1].astype(np.int32),
            a[2].astype(np.int32), a[3].astype(np.int32),
            a[4].astype(np.uint8))


def _per_alignment(table, reads):
    """The table's arms as Alignment objects' arm lists."""
    aln_idx, windex, qb, qe, at = table
    alns = [Alignment() for _ in reads.seqs]
    for a, wi, b, e, t in zip(*(x.tolist() for x in table)):
        alns[a].arms.append(
            Arm(wi, None if t == 3 else reads.codes(a, b, e),
                {0: 0, 1: 1, 2: 2, 3: 3}[t]))
    return alns


def _counters(ctg):
    return [None if w is None else
            (w.num_internal, w.num_pre, w.num_suf, w.num_empty,
             w.longest_pre_len, w.longest_suf_len, len(w.pre_arms),
             len(w.suf_arms))
            for w in ctg.windows]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fill_and_prune_equal_the_window_loop(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    base, _f = _divided_inputs(seed, "mixed")
    reads = _Reads(rng, 50)
    ctg0 = _divide_both(monkeypatch, base)[0]
    table = _arm_table(rng, ctg0, 50)

    want = _divide_both(monkeypatch, base)[0]
    want.add_arm_table(reads, table)
    _prune_loop(want)

    from_table = _divide_both(monkeypatch, base)[0]
    from_table.fill_short_windows_from_table(table)
    from_objects = _divide_both(monkeypatch, base)[0]
    from_objects.add_arm_table(reads, table)
    from_objects.fill_short_windows([])
    per_alignment = _divide_both(monkeypatch, base)[0]
    per_alignment.fill_short_windows(_per_alignment(table, reads))

    expect = _counters(want)
    kept_edges = [i for i in range(len(expect)) if expect[i] is not None
                  and expect[i][:4] in ((19, 20, 20, 1), (0, 3, 3, 0))]
    cleared_edges = [i for i in range(len(expect))
                     if expect[i] is not None
                     and expect[i][:4] == (20, 0, 0, 1)]
    assert len(kept_edges) >= 2 and cleared_edges
    n_live = sum(c is not None for c in expect)
    assert 0 < n_live < sum(w is not None for w in ctg0.windows)
    assert any(c is not None and c[1] == c[2] == 0 and c[0] > 3
               for c in expect)              # some cleared
    assert any(c is not None and c[1] > 0 for c in expect)  # some kept
    # the table path holds no arm arrays: compare its counters only
    assert [c and c[:6] for c in _counters(from_table)] == \
        [c and c[:6] for c in expect]
    assert _counters(from_objects) == expect
    assert _counters(per_alignment) == expect


# -- the output -------------------------------------------------------------

def _polished_loop(ctg, no_long_reads):
    """The per-region output loop that the array assembly replaced
    (Contig.cpp:345-366)."""
    parts = []
    cur = int(ctg.reg_starts[0])
    for i in range(ctg.num_regions()):
        nxt = int(ctg.reg_starts[i + 1])
        t = ctg.reg_type[i]
        if t in (R.SR, R.MSR):
            parts.append(decode(ctg.codes[cur:nxt]))
        elif ctg.windows[i] is not None:
            parts.append(ctg.windows[i].consensus or "")
        elif no_long_reads:
            parts.append(decode(ctg.codes[cur:nxt]))
        cur = nxt
    return "".join(parts)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("no_long_reads", [True, False])
def test_polished_seq_equals_the_region_loop(monkeypatch, seed,
                                             no_long_reads):
    rng = np.random.default_rng(seed)
    base, _f = _divided_inputs(seed, ["mixed", "sr_first", "no_sr"][seed])
    ctg = _divide_both(monkeypatch, base)[0]
    ctg.codes = ctg.codes.copy()
    ctg.codes[rng.integers(0, ctg.length, 20)] = 4      # a few N
    strong = np.nonzero(np.isin(ctg.reg_type[:-1], (R.SR, R.MSR)))[0]
    ctg.codes[ctg.reg_starts[strong[::7]]] = 4
    alphabet = np.array(list("ACGT"))
    for i, w in enumerate(ctg.windows):
        if w is None:
            continue
        r = rng.random()
        if r < 0.2:
            ctg.windows[i] = None                        # dropped
        elif r < 0.3:
            ctg.reg_type[i] = R.LONG
            ctg.windows[i] = Window(w.draft, LONG)
            ctg.windows[i].consensus = "".join(
                rng.choice(alphabet, int(rng.integers(0, 300))))
        elif r < 0.35:
            w.consensus = None                           # no consensus
        else:
            w.consensus = "".join(
                rng.choice(alphabet, int(rng.integers(0, 150))))
    got = ctg.polished_seq(no_long_reads)
    assert got == _polished_loop(ctg, no_long_reads)
    assert "N" in got


# -- a whole polish -----------------------------------------------------------

@pytest.fixture(scope="module")
def small_sim(tmp_path_factory):
    return simulate(SimConfig(genome_size=9000, seed=41,
                              draft_error_rate=0.012, dropout=(0.4, 0.55)),
                    str(tmp_path_factory.mktemp("region_map") / "sim"))


def test_polish_with_and_without_the_host_library(small_sim, tmp_path,
                                                  monkeypatch):
    """The host engine's FASTA and the --inspect files (the region map
    as BED, each window's counters, draft and consensus) are the same
    bytes through the native region map and through the Python walk."""
    out = {}
    for native in (True, False):
        if native:
            monkeypatch.delenv("HYPO_TPU_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
        d = tmp_path / ("native" if native else "python")
        cli.main(["-r", small_sim["reads"], "-d", small_sim["draft"],
                  "-b", small_sim["sr_bam"], "-c", "30", "-s", "9k",
                  "-t", "2", "--no-device-poa", "--inspect",
                  "-o", str(d / "out.fa"), "--aux-dir", str(d / "aux")])
        out[native] = [(d / p).read_bytes() for p in
                       ("out.fa", "aux/regions.bed", "aux/inspect.txt")]
    assert out[True] == out[False]
    fasta, bed, dump = out[True]
    assert len(fasta) > 8000
    assert b"\tOTH\n" in bed and b"\tSR\n" in bed
    assert b"cons\t" in dump
