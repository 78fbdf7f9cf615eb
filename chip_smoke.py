#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hypo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and never
prints its last line):
  1. environment: torch / CUDA / nvcc versions, the card's name and
     power limit; fails without CUDA;
  2. build both CUDA kernels with nvcc (timed);
  3. DP kernel vs its plain PyTorch version on the card, at the class-0
     (B=2048, N=256, L=126, P=8; a chain and a multi-predecessor bucket)
     and class-1 (B=256, N=1024, L=510, P=8) tile shapes, mixed
     NW/LOV/ROV modes and ragged n_nodes: exact equality, median times;
  4. consensus kernel vs its plain version on the rank arrays of a real
     tile of each shape class (class 0: B=2048, N=256, L=126; class 1:
     B=256, N=1024, L=510; random windows merged by the port's arm
     steps): exact equality, median times;
  5. each tile through the tile program vs the NumPy spec
     hypo_tpu.poa.colpoa_ref.ColPoa on every window without overflow
     (at least 256 / 128 of them); both kernels' launch counters > 0;
     then where the class-0 tile's time goes: per-step times with a
     sync around each call, and the device's busy share in one
     torch.profiler trace of the same tile;
  6. end to end at E. coli scale: a 4 Mbp / 30x simulation polished by
     ``hypo_tpu_torch.cli --device-poa`` (in this process, kernel launch
     counters reset just before) and by the host engine
     (``hypo_tpu.cli --no-device-poa``, a subprocess): identical FASTA
     md5, stage times, QV before/after.
Tolerance everywhere: 0 (every compared value is an integer).

The last lines are the card (nvidia-smi name, power limit), one JSON
object describing each kernel, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import hashlib
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hypo_tpu_torch import _build
from hypo_tpu_torch.poa import NW, LOV, ROV
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa.cuda_consensus import heaviest_bundle
from hypo_tpu_torch.poa.cuda_poa import poa_dp_batch
from hypo_tpu_torch.poa.dp import poa_dp_batch_ref

HERE = os.path.dirname(os.path.abspath(__file__))
SCORES = dict(m=5, n=-4, g=-8)
REPS = 5
KERNEL_INNER = 10
POA_RE = re.compile(r"POA over (\d+) windows\. \[([0-9.]+) sec")
TOTAL_RE = re.compile(r"Overall\. \[([0-9.]+) sec total")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, inner: int = 1, reps: int = REPS) -> float:
    """Median over reps samples of the milliseconds per call of fn(),
    after one warm-up; a sample is ``inner`` back-to-back calls between
    two CUDA events, so a kernel's launch overhead overlaps the previous
    launch instead of being counted as device time."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / inner)
    return float(np.median(ts))


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# -- 1. environment -----------------------------------------------------------

def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    r = subprocess.run([_build.nvcc_path(), "--version"],
                       capture_output=True, text=True, check=True)
    log("nvcc: " + r.stdout.strip().splitlines()[-1])
    card = smi_line()
    log(f"card: {card} (devices: {torch.cuda.device_count()})")
    return card


# -- 2. build -----------------------------------------------------------------

def phase_build() -> None:
    for name in ("poa_dp", "consensus"):
        t0 = time.time()
        _build.load(name)
        secs, out = _build.build_log.get(name, (0.0, "(already built)"))
        log(f"build {name}: {time.time() - t0:.2f} s (nvcc {secs:.2f} s)")
        for line in out.splitlines():
            if re.search(r"registers|spill|smem|error|warning", line):
                log("  " + line.strip())


# -- 3. DP kernel vs plain ----------------------------------------------------

def dp_bucket(rng, B, N, L, P, multi: bool, dev):
    """bench.py's chain / multi-predecessor recipe with mixed modes,
    ragged graph sizes (a few inactive windows) and ragged arms."""
    nc = rng.integers(0, 4, (B, N))
    pr = np.tile(np.arange(N)[None, :, None], (B, 1, P))
    pc = np.ones((B, N), np.int64)
    if multi:
        # ~30% of rows get 2-3 predecessors reaching 1-8 ranks back
        pc = np.where(rng.random((B, N)) < 0.3,
                      rng.integers(2, 4, (B, N)), 1)
        for p in range(1, 3):
            pr[:, :, p] = np.maximum(pr[:, :, 0] - rng.integers(1, 8, (B, N)),
                                     0)
    nn = rng.integers(N // 4, N + 1, B)
    nn[rng.random(B) < 0.02] = 0
    ie = rng.random((B, N)) < 0.05
    ie[np.arange(B), np.maximum(nn - 1, 0)] = True
    arm = rng.integers(0, 4, (B, L))
    al = rng.integers(L // 2, L + 1, B)
    md = rng.choice([NW, LOV, ROV], B)
    i32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32)  # noqa
    return (i32(nc), i32(pr), i32(pc), torch.as_tensor(ie, device=dev),
            i32(nn), i32(arm), i32(al), i32(md))


def phase_dp(rng, dev) -> dict:
    P = 8
    res = {}
    for name, (B, N, L), multi in (("class0_chain", (2048, 256, 126), False),
                                   ("class0_multi", (2048, 256, 126), True),
                                   ("class1_multi", (256, 1024, 510), True)):
        args = dp_bucket(rng, B, N, L, P, multi, dev)
        kw = dict(N=N, L=L, P=P, **SCORES)
        bp_k, mr_k = poa_dp_batch(*args, **kw)
        bp_p, mr_p = poa_dp_batch_ref(*args, **kw)
        torch.cuda.synchronize()
        nn = args[4]
        rows = (torch.arange(N + 1, device=dev)[None, :]
                <= nn[:, None])[:, :, None]
        bp_diff = ((bp_k.int() - bp_p.int()).abs() * rows).amax().item()
        mr_diff = (mr_k - mr_p).abs().amax().item()
        if bp_diff or mr_diff:
            raise RuntimeError(f"DP kernel != plain on {name}: max |bp| "
                               f"diff {bp_diff}, max |max_row| diff "
                               f"{mr_diff}")
        ms = cuda_ms(lambda: poa_dp_batch(*args, **kw), inner=KERNEL_INNER)
        plain_ms = cuda_ms(lambda: poa_dp_batch_ref(*args, **kw))
        cells = int(nn.sum().item()) * (L + 1)
        log(f"DP {name} B={B} N={N} L={L} P={P}: equal (bp rows <= n_nodes,"
            f" max_row); kernel {ms:.3f} ms ({cells / ms / 1e6:.2f} "
            f"Gcells/s), plain {plain_ms:.3f} ms")
        res[name] = dict(ms=ms, plain_ms=plain_ms,
                         max_abs_err=max(bp_diff, mr_diff))
    return res


# -- 4./5. a real class-0 tile: consensus kernel, tile vs spec ---------------

def random_tile(rng, B, K, L, tlen, err):
    """Windows of 3..K-1 noisy copies of a random truth (NW arms framed
    by the J/O markers 4/5, LOV heads, ROV tails), one pool row per
    arm, weights 1-3.  Returns the tile inputs and each window's arms."""
    pool, plen, specs = [], [], []
    idx = np.full((B, K), -1, np.int32)
    amode = np.zeros((B, K), np.int8)
    aw = np.zeros((B, K), np.int32)
    narms = np.zeros(B, np.int32)
    for b in range(B):
        truth = rng.integers(0, 4, tlen)
        arms = []
        for k in range(int(rng.integers(3, K))):
            r = rng.random(tlen)
            sub = rng.integers(0, 4, tlen)
            s = np.where(r < err * 2 / 3, sub, truth)
            ins = (r >= err * 2 / 3) & (r < err)
            s = np.insert(s, np.nonzero(ins)[0], sub[ins])
            s = s[rng.random(len(s)) >= err / 3].tolist()  # deletions
            md = int(rng.choice([NW, NW, NW, LOV, ROV]))
            if md == NW:
                s = [4] + s + [5]
            elif md == LOV:
                s = [4] + s[:max(1, len(s) // 2)]
            else:
                s = s[len(s) // 2:] + [5]
            s = s[:L]
            w = int(rng.integers(1, 4))
            idx[b, k] = len(pool)
            amode[b, k] = md
            aw[b, k] = w
            row = np.zeros(L, np.int8)
            row[:len(s)] = s
            pool.append(row)
            plen.append(len(s))
            arms.append((s, md, w))
        narms[b] = len(arms)
        specs.append(arms)
    return (np.stack(pool), np.array(plen, np.int32), idx, amode, aw, narms,
            specs)


def spec_consensus(arms):
    """(codes, supports) of the NumPy spec for one window's arms."""
    from hypo_tpu.poa.colpoa_ref import ColPoa
    cp = ColPoa(SCORES["m"], SCORES["n"], SCORES["g"])
    for s, md, w in arms:
        cp.add(s, md, w=w)
    return cp.consensus()


# shape classes of the tile phases (poa.full_runner.CLASSES at full B):
# name, B, L, N, truth length of the random windows, minimum windows
# without overflow held against the spec
TILES = (("class0", 2048, 126, 256, 100, 256),
         ("class1", 256, 510, 1024, 400, 128))


def phase_tile(rng, dev, name, B, L, N, tlen, min_spec) -> dict:
    K, P = 16, 8
    t0 = time.time()
    pool, plen, idx, amode, aw, narms, specs = random_tile(
        rng, B, K, L, tlen=tlen, err=0.04)
    log(f"{name} tile: {B} windows, {len(pool)} arms, L={L} N={N} (made in "
        f"{time.time() - t0:.1f} s)")
    steps = dict(N=N, L=L, P=P, device=dev, **SCORES)
    t0 = time.time()
    st = TF.run_arm_steps(pool, plen, idx, amode, aw, narms, **steps)
    torch.cuda.synchronize()
    log(f"{name} tile arm steps ({int(narms.max())}): "
        f"{time.time() - t0:.2f} s; nodes max {int(st.n_nodes.max())}")

    # 4. consensus kernel vs plain on the final graphs' rank arrays
    ra = TF._rank_arrays_batch(st, N)
    cargs = (ra.pred_ranks, ra.pred_w_r, ra.pred_cnt_r, ra.is_end_r,
             ra.node_code_r, ra.node_sup_r, st.n_nodes,
             ra.rank_of[:, 0].contiguous())
    out_k = heaviest_bundle(*cargs, N=N, P=P)
    out_p = TF._consensus_wavefront(*cargs, N=N, P=P)
    torch.cuda.synchronize()
    err = max((a - b).abs().amax().item() for a, b in zip(out_k, out_p))
    if err:
        raise RuntimeError(f"consensus kernel != plain on {name}: max diff "
                           f"{err}")
    ms = cuda_ms(lambda: heaviest_bundle(*cargs, N=N, P=P),
                 inner=KERNEL_INNER)
    plain_ms = cuda_ms(lambda: TF._consensus_wavefront(*cargs, N=N, P=P))
    log(f"consensus {name} B={B} N={N} P={P}: equal (codes, supports, "
        f"lengths); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # 5. the tile program vs the NumPy spec
    tile = TF.build_tile_program(N=N, L=L, K=K, P=P, B=B, A=len(pool),
                                 device=dev, **SCORES)
    targs = (pool, plen, idx, amode, aw, narms, np.zeros(B, np.int32))
    packed = tile(*targs).cpu().numpy()
    cc, cs, cl = (x.cpu().numpy() for x in TF._consensus_batch(st, N=N, P=P))
    nib = packed[:, :N // 2].view(np.uint8)
    codes = np.stack([nib & 0xF, nib >> 4], axis=2).reshape(B, N)
    clen = (packed[:, N // 2].view(np.uint8).astype(np.int64)
            | (packed[:, N // 2 + 1].view(np.uint8).astype(np.int64) << 8))
    ovf = packed[:, N // 2 + 2] != 0
    ok = np.nonzero(~ovf)[0]
    if len(ok) < min_spec:
        raise RuntimeError(f"{name}: only {len(ok)} windows without "
                           f"overflow")
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 1) as workers:
        wants = workers.map(spec_consensus, [specs[b] for b in ok],
                            chunksize=4)
    for b, (want, want_sup) in zip(ok, wants):
        if (codes[b, :clen[b]].tolist() != want
                or cc[b, :cl[b]].tolist() != want
                or cs[b, :cl[b]].tolist() != want_sup):
            raise RuntimeError(f"{name} tile window {b} != ColPoa spec")
    log(f"{name} tile vs ColPoa: all {len(ok)} windows without overflow "
        f"equal ({int(ovf.sum())} of {B} overflowed; spec "
        f"{time.time() - t0:.1f} s)")
    launches = (poa_dp_batch.launches, heaviest_bundle.launches)
    log(f"launch counters so far: DP {launches[0]}, consensus "
        f"{launches[1]}")
    if min(launches) <= 0:
        raise RuntimeError("a kernel was never launched")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, tile=tile,
                targs=targs)


def phase_profile(tile, targs) -> None:
    """Where one tile's time goes, all in this one run: (a) the tile
    program with a synchronize around every call of its steps; (b) the
    tile unprofiled; (c) the tile under torch.profiler (CUDA activity
    only): device kernels launched, their summed time, and the device's
    busy share (union of kernel intervals over the traced wall)."""
    names = ("_rank_arrays_batch", "poa_dp_batch", "_traceback_matched_batch",
             "_merge", "heaviest_bundle")
    orig = {n: getattr(TF, n) for n in names}
    spent = {n: [0.0, 0] for n in names}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t0
            spent[name][1] += 1
            return out
        return call

    def wall() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tile(*targs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for n in names:
        setattr(TF, n, timed(n, orig[n]))
    try:
        inst = wall()
    finally:
        for n, fn in orig.items():
            setattr(TF, n, fn)
    rest = inst - sum(s for s, _ in spent.values())
    log(f"profile: tile with a sync around each step {inst:.3f} s = "
        + ", ".join(f"{n.strip('_')} {s:.3f} s ({c} calls)"
                    for n, (s, c) in spent.items())
        + f", other {rest:.3f} s (curation, packing, state select)")
    plain_wall = wall()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = wall()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("profile: the profiler saw no device time (busy share not "
            "measured)")
        return
    busy, hi = 0, float("-inf")
    for a, b in spans:
        busy += max(0, b - max(a, hi))
        hi = max(hi, b)
    total = sum(b - a for a, b in spans) / 1e6
    log(f"profile: tile unprofiled {plain_wall:.3f} s; traced {traced:.3f} "
        f"s with {len(spans)} device kernels / copies, {total:.4f} s of "
        f"device time, busy {busy / 1e6:.4f} s = {busy / 1e6 / traced:.3f}"
        f" of the traced wall ({total / plain_wall:.3f} of the unprofiled "
        f"wall)")


# -- 6. end to end ------------------------------------------------------------

class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _md5(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def phase_e2e(tmp: str, genome_size: int = 4_000_000) -> dict:
    from hypo_tpu.eval_qv import compare
    from hypo_tpu.native import host_api
    from hypo_tpu_torch import cli

    if not host_api.available():
        raise RuntimeError("the native host library did not build/load")
    env = dict(os.environ, PYTHONPATH=HERE)
    sim = os.path.join(tmp, "sim")
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "hypo_tpu.sim", "--out", sim,
                    "--genome-size", str(genome_size), "--short-cov", "30",
                    "--seed", "1"], cwd=HERE, env=env, check=True,
                   capture_output=True)
    log(f"sim {genome_size / 1e6:g} Mbp / 30x: {time.time() - t0:.1f} s")
    threads = str(os.cpu_count() or 1)
    common = ["-r", f"{sim}/reads.fq.gz", "-d", f"{sim}/draft.fa",
              "-b", f"{sim}/sr.bam", "-c", "30", "-s", str(genome_size),
              "-t", threads]

    dev_out = os.path.join(tmp, "torch.fa")
    poa_dp_batch.launches = 0
    heaviest_bundle.launches = 0
    buf = io.StringIO()
    old = sys.stderr
    sys.stderr = _Tee(old, buf)
    t0 = time.time()
    try:
        polisher = cli.run(common + ["-o", dev_out, "--device-poa"])
        torch.cuda.synchronize()
    finally:
        sys.stderr = old
    wall = time.time() - t0
    launches = {"poa_dp": poa_dp_batch.launches,
                "consensus": heaviest_bundle.launches}
    text = buf.getvalue()
    mp, mt = POA_RE.search(text), TOTAL_RE.search(text)
    stats = polisher.device_runner.stats

    host_out = os.path.join(tmp, "host.fa")
    r = subprocess.run([sys.executable, "-m", "hypo_tpu.cli", *common,
                        "-o", host_out, "--no-device-poa"], cwd=HERE,
                       env=env, capture_output=True, text=True, check=True)
    hp, ht = POA_RE.search(r.stderr), TOTAL_RE.search(r.stderr)
    md5_dev, md5_host = _md5(dev_out), _md5(host_out)
    q0 = compare(f"{sim}/truth.fa", f"{sim}/draft.fa")
    q1 = compare(f"{sim}/truth.fa", dev_out)
    nwin, poa_s, total_s = int(mp.group(1)), float(mp.group(2)), \
        float(mt.group(1))
    log(f"e2e port (--device-poa, -t {threads}): {nwin} windows, POA stage "
        f"{poa_s:.2f} s ({nwin / poa_s:.0f} windows/s), total {total_s:.2f}"
        f" s (wall {wall:.2f} s)")
    log(f"e2e port device stats: device windows {stats['full_windows']}, "
        f"tiles {stats['full_dispatches']}, overflows "
        f"{stats['full_overflows']}, host-routed windows "
        f"{stats['host_long_windows'] + stats['host_fallbacks']} (long "
        f"{stats['host_long_windows']}, fallbacks {stats['host_fallbacks']})"
        f", trivial {stats['trivial_windows']}; per class: tiles "
        f"{stats['class_tiles']}, windows {stats['class_windows']}")
    log(f"e2e host engine (--no-device-poa): {int(hp.group(1))} windows, "
        f"POA stage {float(hp.group(2)):.2f} s, total "
        f"{float(ht.group(1)):.2f} s")
    log(f"e2e QV: draft {q0['qv']:.2f} (edit distance "
        f"{q0['edit_distance']}) -> polished {q1['qv']:.2f} "
        f"({q1['edit_distance']})")
    log(f"e2e md5: port {md5_dev} host {md5_host}")
    log(f"e2e kernel launches on the main path: {launches}")
    if md5_dev != md5_host:
        raise RuntimeError("port and host engine FASTA differ")
    if stats["full_windows"] <= 0:
        raise RuntimeError("no window went through the device")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise RuntimeError(f"kernel {name} never launched on the path")
    if not q1["edit_distance"] < q0["edit_distance"]:
        raise RuntimeError("polishing did not reduce the edit distance")
    return launches


def main() -> None:
    card = phase_env()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20261016)
    phase_build()
    dp = phase_dp(rng, dev)
    cons = {t[0]: phase_tile(rng, dev, *t) for t in TILES}
    phase_profile(cons["class0"]["tile"], cons["class0"]["targs"])
    with tempfile.TemporaryDirectory(prefix="hypo_chip_smoke_") as tmp:
        launches = phase_e2e(tmp)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    cons = {k: {f: v[f] for f in ("ms", "plain_ms", "max_abs_err")}
            for k, v in cons.items()}

    def entry(name, source, replaces, launches, shape, by_shape):
        # ms / plain_ms at the class-0 shape; every shape under "shapes"
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=max(v["max_abs_err"]
                                    for v in by_shape.values()),
                    ms=by_shape[shape]["ms"],
                    plain_ms=by_shape[shape]["plain_ms"], shape=shape,
                    shapes=by_shape)

    kernels = [
        entry("poa_dp", "hypo_tpu_torch/csrc/poa_dp.cu",
              "hypo_tpu/poa/pallas_poa.py:259", launches["poa_dp"],
              "class0_multi", dp),
        entry("heaviest_bundle", "hypo_tpu_torch/csrc/consensus.cu",
              "hypo_tpu/poa/pallas_consensus.py:191", launches["consensus"],
              "class0", cons),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
