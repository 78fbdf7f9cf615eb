"""Entry points of the port.

``entry()`` returns one call of the DP kernel (poa.cuda_poa.poa_dp_batch)
on the card, with its example tensors.

``dryrun_multichip(n)`` is a multi-device dry run of ``polish()``: real
windows, laid out as the pipeline leaves them (``make_contig``: a contig
whose short windows' arms sit in a flat arm table), go through the tile
runner's ``run_polish_batch`` (poa.full_runner.FullDeviceRunner) over n
devices, whose tiles split into one block of rows per device, and every
device window is checked against the column-POA spec
(poa.colpoa_ref.ColPoa); the k-mer count all-reduce is checked on one
process; then ``polish()`` of a multi-contig simulation over n devices
must write the same FASTA as over one device, with the rows per device
balanced.

Copied from the repository's __graft_entry__.py (the JAX package's
entry points): a JAX device mesh becomes a list of devices.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

SCORES = dict(m=5, n=-4, g=-8)


def entry(device=None):
    """(fn, example_args): fn(*example_args) is one call of the DP
    kernel (B=8, N=L=128, P=8, short-read scores) on ``device``, by
    default the current CUDA device; returns (bp, max_row)."""
    from .parallel.mesh import make_example_inputs
    from .pipeline.polish import cuda_device
    from .poa.cuda_poa import poa_dp_batch

    N, L, P = 128, 128, 8
    dev = cuda_device() if device is None else torch.device(device)
    (node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len, mode,
     _reads) = make_example_inputs(B=8, N=N, L=L, Pcap=P, R=64)

    def fn(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len,
           mode):
        return poa_dp_batch(node_code, pred_rows, pred_cnt, is_end,
                            n_nodes, arm, arm_len, mode, N=N, L=L, P=P,
                            **SCORES)

    example_args = tuple(
        torch.as_tensor(x, device=dev)
        for x in (node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                  arm_len, mode))
    return fn, example_args


class Contig:
    """The fields of a contig that run_polish_batch reads."""

    def __init__(self, codes, reg_starts, windows, arm_data):
        self.codes = codes
        self.reg_starts = reg_starts
        self.windows = windows
        self._device_arm_data = arm_data


def make_contig(specs, window_cls=None) -> Contig:
    """A contig of ``specs``' windows, one region each, as the pipeline
    leaves them: a SHORT window's arms in a flat arm table (one
    alignment an arm) and unmaterialized, a LONG window's arms on the
    window.  A spec is (kind, wtype, draft, [(arm type, arm)]), draft
    and arms strings, arm type 0 internal, 1 prefix, 2 suffix, as the
    arm table has them.  ``window_cls`` is the Window class to build
    (pipeline.window.Window by default)."""
    from .dna import encode, pack2
    from .pipeline.window import SHORT, Window

    window_cls = window_cls or Window
    drafts = [encode(d) for _k, _t, d, _a in specs]
    reg_starts = np.concatenate(([0], np.cumsum([len(d) for d in drafts])))
    codes = np.concatenate(drafts).astype(np.uint8)
    windows, rows, arm_codes = [], [], []
    for wi, (_kind, wt, _d, arms) in enumerate(specs):
        w = window_cls(codes[reg_starts[wi]:reg_starts[wi + 1]], wt)
        for at, arm in arms:
            if wt != SHORT:
                (w.add_internal, w.add_prefix, w.add_suffix)[at](encode(arm))
                continue
            rows.append((len(arm_codes), wi, 0, len(arm), at))
            arm_codes.append(encode(arm))
            if at == 0:
                w.num_internal += 1
            elif at == 1:
                w.num_pre += 1
            else:
                w.num_suf += 1
        windows.append(w)
    lens = np.array([len(a) for a in arm_codes], np.int64)
    aoff = np.concatenate(([0], np.cumsum(lens)[:-1]))
    abuf = pack2(np.concatenate(arm_codes).astype(np.uint8))
    table = tuple(np.array(c, np.int32) for c in zip(*rows))
    table = table[:4] + (table[4].astype(np.uint8),)
    return Contig(codes, reg_starts, windows, (table, abuf, aoff))


def dryrun_specs(n_devices: int, seed: int = 0):
    """The dry run's windows, made from ``seed``, as make_contig's
    specs: 20 per device of kind ``tile``, enough for several tiles on
    the CPU (64 rows), a spread of 2-6 distinct internal arms, two
    copies each, one in 16 with a 200 bp draft (shape class 1); two of
    kind ``classless``, with 20 distinct arms, over the K cap (host
    fallback); four LONG windows with internal, prefix and suffix arms
    (host engine)."""
    from .dna import decode
    from .pipeline.window import LONG, SHORT

    rng = np.random.default_rng(seed)

    def mutate(codes):
        out = codes.copy()
        for _ in range(int(rng.integers(1, 3))):
            out[int(rng.integers(len(out)))] = int(rng.integers(4))
        return out

    specs = []
    for i in range(20 * n_devices):
        dlen = 200 if i % 16 == 0 else 24
        draft = rng.integers(0, 4, dlen).astype(np.uint8)
        arms = []
        for v in range(2 + int(rng.integers(0, 5))):
            arm = decode(mutate(draft) if v else draft)
            arms += [(0, arm), (0, arm)]
        specs.append(("tile", SHORT, decode(draft), arms))
    for _i in range(2):
        draft = rng.integers(0, 4, 24).astype(np.uint8)
        specs.append(("classless", SHORT, decode(draft),
                      [(0, decode(mutate(draft))) for _v in range(20)]))
    for _i in range(4):
        draft = rng.integers(0, 4, 120).astype(np.uint8)
        arms = [(0, decode(mutate(draft))) for _v in range(3)]
        for _v in range(2):
            cut = int(rng.integers(40, 80))
            arms += [(1, decode(mutate(draft[:cut]))),
                     (2, decode(mutate(draft[cut:])))]
        specs.append(("long", LONG, decode(draft), arms))
    return specs


def check_against_spec(ctg: Contig, specs) -> None:
    """Every ``tile`` window's consensus (internal arms only) equals the
    column-POA spec's over its arms, in order, between the J/O
    markers."""
    from .poa import GLOBAL_CODE, NW
    from .poa.colpoa_ref import ColPoa
    from .poa.engine import HEAD, TAIL

    for w, (kind, _wt, _d, arms) in zip(ctg.windows, specs):
        if kind != "tile":
            continue
        cp = ColPoa(SCORES["m"], SCORES["n"], SCORES["g"])
        for _at, arm in arms:
            cp.add([GLOBAL_CODE[c] for c in HEAD + arm + TAIL], NW)
        codes, _sup = cp.consensus()
        expect = "".join("ACGTJO"[c] for c in codes)[1:-1]
        if w.consensus != expect:
            raise AssertionError(f"device window {w.consensus!r} != spec "
                                 f"{expect!r}")


@contextlib.contextmanager
def _poa_ndev(n: int):
    """HYPO_POA_NDEV set to n inside, so that a runner keeps all n of
    the devices it is given whatever the caller's environment holds."""
    old = os.environ.get("HYPO_POA_NDEV")
    os.environ["HYPO_POA_NDEV"] = str(n)
    try:
        yield
    finally:
        if old is None:
            del os.environ["HYPO_POA_NDEV"]
        else:
            os.environ["HYPO_POA_NDEV"] = old


def _polish_md5(sim: dict, devices: Sequence[torch.device], out: str,
                aux: str):
    """polish() of ``sim`` with the tiles over ``devices``: (Polisher,
    md5 of the FASTA)."""
    from .cli import build_parser, flags_from_args
    from .pipeline.polish import Polisher

    flags = flags_from_args(build_parser().parse_args([
        "-r", sim["reads"], "-d", sim["draft"], "-b", sim["sr_bam"],
        "-c", "30", "-s", str(sim["genome_size"]), "-t", "2",
        "-o", out, "--aux-dir", aux, "--device-poa"]))
    with _poa_ndev(len(devices)):
        p = Polisher(flags, device=list(devices))
        p.polish()
    with open(out, "rb") as fh:
        return p, hashlib.md5(fh.read()).hexdigest()


def dryrun_multichip(n_devices: int,
                     devices: Optional[List[torch.device]] = None,
                     genome_size: int = 500_000) -> dict:
    """The multi-device dry run over ``devices`` (by default the first
    ``n_devices`` CUDA devices; a caller may pass a list of n_devices,
    the same device more than once included): runner-level checks,
    then polish() of a 4-contig simulation of ``genome_size`` (seed 11)
    over the devices and over the first alone.  Raises on any
    disagreement; returns the multi-device run's stats and md5."""
    from .config import ScoreParams
    from .parallel.distributed import merge_dense_counts_psum
    from .parallel.mesh import local_devices
    from .poa.full_runner import FullDeviceRunner
    from .sim import SimConfig, simulate

    devices = (local_devices(n_devices) if devices is None
               else [torch.device(d) for d in devices])
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): given "
                         f"{len(devices)} devices")
    specs = dryrun_specs(n_devices)
    ctg = make_contig(specs)
    with _poa_ndev(n_devices):
        runner = FullDeviceRunner(ScoreParams(), devices)
    n = runner.run_polish_batch([ctg])
    st = runner.stats
    if not (n == len(specs) and st["full_dispatches"] > 1
            and st["host_fallbacks"] >= 2 and st["host_long_windows"] >= 2
            and all(w.consensus is not None for w in ctg.windows)):
        raise AssertionError(f"dryrun runner: {n} of {len(specs)} "
                             f"windows, stats {st}")
    check_against_spec(ctg, specs)

    rng = np.random.default_rng(0)
    table = rng.integers(0, 100, 4 ** 6).astype(np.int32)
    if not np.array_equal(merge_dense_counts_psum(table), table):
        raise AssertionError("single-process count all-reduce is not the "
                             "identity")

    with tempfile.TemporaryDirectory(prefix="hypo_dryrun_") as tmp:
        sim = simulate(SimConfig(genome_size=genome_size, num_contigs=4,
                                 short_cov=30, seed=11),
                       os.path.join(tmp, "sim"))
        p_multi, h_multi = _polish_md5(sim, devices,
                                       os.path.join(tmp, "multi.fa"),
                                       os.path.join(tmp, "aux_multi"))
        _p, h_single = _polish_md5(sim, devices[:1],
                                   os.path.join(tmp, "single.fa"),
                                   os.path.join(tmp, "aux_single"))
    stats = p_multi.device_runner.stats
    nwin = stats["full_windows"] + stats["trivial_windows"]
    rows = stats["rows_per_device"]
    balance = max(rows) / max(min(rows), 1)
    if sum(rows) != stats["full_windows"] or balance > 1.5:
        raise AssertionError(f"dryrun polish: rows per device {rows}, "
                             f"{stats['full_windows']} device windows")
    if h_multi != h_single:
        raise AssertionError(f"dryrun polish: {n_devices} devices md5 "
                             f"{h_multi}, one device {h_single}")
    print(f"dryrun_multichip({n_devices}): ok, polish() over "
          f"{[str(d) for d in devices]}: {nwin} windows, "
          f"{stats['full_dispatches']} tiles, rows per device {rows} "
          f"(balance {balance:.2f}), output equal to one device's (md5 "
          f"{h_multi}); runner level: {st['full_dispatches']} tiles, "
          f"{len(specs)} windows, every device window equal to the "
          f"column-POA spec", flush=True)
    return dict(stats=stats, md5=h_multi, windows=nwin, balance=balance)
