"""Pipeline throughput of the port's device path, held against its host
engine in the same run: the counterpart of the repo root's ``bench.py``.

    python -m hypo_tpu_torch.bench [--mbp 4] [--sim DIR] [--device cuda|cpu]
                                   [--kernel] [--threads N]
                                   [--in-turns-with OTHER_CHECKOUT]

1. Simulates ``--mbp`` Mbp at 30x short reads, seed 1, with
   ``python -m hypo_tpu_torch.sim`` (into a temporary directory that is
   removed at the end), unless ``--sim`` names a directory that holds
   one.
2. Polishes it with the port's host engine
   (``python -m hypo_tpu_torch.cli ... --no-device-poa``, a subprocess),
   and reads its POA stage and total seconds from the Monitor lines.
3. Starts one device child process (``--child``) that polishes the same
   input twice through ``pipeline.polish.polish``: **cold** (its first
   run, which pays the CUDA context, the kernels' build or load and the
   warm-up) and then **warm**.  For each it prints one JSON line:
   windows, POA-stage seconds (unrounded: the ``pipeline.poa`` span),
   total seconds, the md5, the runner's stats, the kernels' launches
   and the pipeline table.  The table sums the program's own spans
   (``utils.trace``, turned on in the child; host clock only, no sync)
   of the polish's main thread, with their counts:

   - ``jobs``: the native job build (``runner.jobs``);
   - ``pack``: ``host_api.tile_pack`` (``tiles.pack``);
   - ``issue``: the tile program's calls, which queue each tile's work
     on the device (``tiles.issue`` less ``tiles.warm_wait``);
   - ``warm_wait``: the first dispatch waiting for the warm-up thread;
   - ``drain``: the runner's synchronize before its first readback
     (``tiles.drain``);
   - ``readback``: each tile's output to the host (``tiles.readback``);
   - ``finalize``: ``host_api.tile_finalize`` and the consensus
     strings' assignment (``tiles.finalize``);
   - ``leftovers``: the host engine's windows (LONG, classless and
     overflowed: ``runner.leftovers``);
   - ``rest``: the POA stage less all of the above (the arms' release,
     Python glue).

   With ``--kernel`` the child then times kernel 1 (the DP) at the
   class-0 tile shape (B=2048, N=256, L=126, P=8; a chain and a
   multi-predecessor graph, ``bench.py``'s recipe): device ms per call
   from torch.profiler, and ms per call between CUDA events.
4. Prints both tables, the host engine and the md5 check (the device
   runs against the host engine, and against the pinned md5 when the
   bench simulated the pinned 4 Mbp input itself) to stderr, and the
   ``secondary`` line on stderr: each run's windows, seconds, windows
   per second of POA stage, md5, pipeline table and launches, and the
   host engine's.  The end-to-end benchmark is ``polishbench/``.

A failed child, or a device md5 that differs, exits non-zero.  ``--device cuda`` (the default) needs a CUDA card and never
falls back to the CPU; ``--device cpu`` runs the tile program's plain
versions on CPU tensors (for tests, at small sizes).

``--in-turns-with DIR [DIR ...]`` also times, after the above, the
device CLI (``python -m hypo_tpu_torch.cli --device-poa``, one process
a run) of each other checkout of the port and of this one in turns
(other, this, this, other), every checkout built first, and prints each
run's POA stage, total and md5: how a change moves the POA stage,
measured in one call on one card.  The host engine's run also follows a
build of the host libraries, so no timed run pays g++; the device child
builds its kernels in its warm-up, as a user's first run does.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POA_RE = re.compile(r"POA over (\d+) windows\. \[([0-9.]+) sec")
TOTAL_RE = re.compile(r"Overall\. \[([0-9.]+) sec total")
# md5 of hypo_tpu's host-engine FASTA of the simulation the bench makes
# itself, by (genome size, seed): the 4 Mbp / 30x run
PINNED_MD5 = {(4_000_000, 1): "db85bbe32c2b4637f6e6a5e933e5c498"}
BUCKETS = ("jobs", "pack", "issue", "warm_wait", "drain", "readback",
           "finalize", "leftovers", "rest")
# the span each bucket sums (``issue`` less ``warm_wait``)
BUCKET_SPANS = {"jobs": "runner.jobs", "pack": "tiles.pack",
                "issue": "tiles.issue", "warm_wait": "tiles.warm_wait",
                "drain": "tiles.drain", "readback": "tiles.readback",
                "finalize": "tiles.finalize", "leftovers": "runner.leftovers"}
KERNELS = ("poa_dp", "poa_tb", "consensus", "poa_rank", "poa_merge")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def md5(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def stage_times(text: str):
    """(windows, POA-stage seconds, total seconds) from the Monitor
    lines; a run in several batches sums its POA stages."""
    poa = POA_RE.findall(text)
    tot = TOTAL_RE.search(text)
    if not poa or not tot:
        raise RuntimeError("no POA stage / total in the polisher's log:\n"
                           + text[-2000:])
    return (sum(int(n) for n, _s in poa), sum(float(s) for _n, s in poa),
            float(tot.group(1)))


def cli_args(sim: str, size: int, threads: int) -> List[str]:
    return ["-r", f"{sim}/reads.fq.gz", "-d", f"{sim}/draft.fa",
            "-b", f"{sim}/sr.bam", "-c", "30", "-s", str(size),
            "-t", str(threads)]


def run_cli(root: str, argv: List[str]) -> str:
    """``python -m hypo_tpu_torch.cli argv`` from checkout ``root``;
    returns its log (stdout and stderr)."""
    r = subprocess.run([sys.executable, "-m", "hypo_tpu_torch.cli", *argv],
                       cwd=root, env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"hypo_tpu_torch.cli exited with {r.returncode} "
                           f"in {root}:\n{r.stderr[-3000:]}")
    return r.stdout + r.stderr


def simulate(out: str, size: int, seed: int) -> None:
    log(f"simulating {size / 1e6:g} Mbp / 30x, seed {seed}, into {out}")
    subprocess.run([sys.executable, "-m", "hypo_tpu_torch.sim", "--out", out,
                    "--genome-size", str(size), "--short-cov", "30",
                    "--seed", str(seed)], cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT), check=True,
                   capture_output=True)


def genome_size(sim: str) -> int:
    """The ``-s`` of a simulation: its truth's length (the simulated
    genome size), else its draft's."""
    from .io.fasta import read_fastx
    path = f"{sim}/truth.fa"
    if not os.path.exists(path):
        path = f"{sim}/draft.fa"
    return sum(len(s) for _n, s in read_fastx(path))


# -- the device child ----------------------------------------------------------

def pipeline_table(spans, thread: str):
    """(seconds by bucket, spans by bucket, POA-stage seconds) of one
    polish's spans on ``thread``."""
    from .utils import trace
    mine = [s for s in spans if s.thread == thread]
    secs = {b: trace.seconds(mine, name) for b, name in BUCKET_SPANS.items()}
    calls = {b: sum(s.name == name for s in mine)
             for b, name in BUCKET_SPANS.items()}
    secs["issue"] -= secs["warm_wait"]
    poa_s = trace.seconds(mine, "pipeline.poa")
    secs["rest"] = poa_s - sum(secs.values())
    return secs, calls, poa_s


def _kernel_rows(dev) -> List[dict]:
    """Kernel 1 at the class-0 tile shape, bench.py's chain and
    multi-predecessor recipe (pred_rows[b, r, p] = r for a chain, ~30%
    of rows with 2-3 predecessors 1-8 rows back; every window full, arms
    full-length)."""
    import numpy as np
    import torch

    from .poa.cuda_poa import poa_dp_batch
    from .tools.timing import event_ms, profiled_ms
    N, L, P, B = 256, 126, 8, 2048
    rng = np.random.default_rng(0)
    rows = []
    for name, multi in (("chain", False), ("multi-pred", True)):
        nc = rng.integers(0, 4, (B, N))
        pr = np.tile(np.arange(N)[None, :, None], (B, 1, P))
        pc = np.ones((B, N), np.int64)
        if multi:
            pc = np.where(rng.random((B, N)) < 0.3,
                          rng.integers(2, 4, (B, N)), 1)
            for p in range(1, 3):
                pr[:, :, p] = np.maximum(
                    pr[:, :, 0] - rng.integers(1, 8, (B, N)), 0)
        ie = np.zeros((B, N), bool)
        ie[:, N - 1] = True
        t = lambda x, dt=torch.int32: torch.as_tensor(  # noqa: E731
            x, device=dev).to(dt).contiguous()
        args = (t(nc), t(pr), t(pc), t(ie, torch.bool),
                t(np.full(B, N)), t(rng.integers(0, 4, (B, L))),
                t(np.full(B, L)), t(np.zeros(B)))

        def call():
            return poa_dp_batch(*args, N=N, L=L, P=P, m=5, n=-4, g=-8)

        dev_ms, per = profiled_ms(call, dev)
        ev = event_ms(call, dev)
        rows.append({"kernel": "poa_dp", "graph": name, "B": B, "N": N,
                     "L": L, "P": P, "device_ms": dev_ms, "event_ms": ev,
                     "device_activities_per_call": per,
                     "gcells_per_s": B * N * L / (dev_ms * 1e-3) / 1e9})
    return rows


def child(opts) -> None:
    """Polish ``opts.sim`` twice (cold, warm) with the device path in
    this process; one JSON line per run on stdout."""
    import torch

    from .cli import build_parser, flags_from_args
    from .pipeline.polish import polish
    from .poa import cuda_consensus, cuda_merge, cuda_poa, cuda_rank, cuda_tb
    from .tools.timing import card, device_for
    from .utils import trace
    dev = device_for(opts.device)
    # each kernel's wrappers (kernel 4 has the finish's rank and the
    # step head)
    counters = ((cuda_poa.poa_dp_batch,), (cuda_tb.poa_tb_matched,),
                (cuda_consensus.heaviest_bundle,),
                (cuda_rank.rank_arrays, cuda_rank.step_head),
                (cuda_merge.merge_arm,))
    trace.enable()
    size = genome_size(opts.sim)
    name = card(dev)
    for run in ("cold", "warm"):
        out = os.path.join(opts.out_dir, f"device_{run}.fa")
        argv = cli_args(opts.sim, size, opts.threads) + [
            "-o", out, "--device-poa", "--aux-dir",
            os.path.join(opts.out_dir, f"aux_{run}")]
        flags = flags_from_args(build_parser().parse_args(argv))
        trace.RECORDER.reset()
        for ws in counters:
            for c in ws:
                c.launches = 0
        log_path = os.path.join(opts.out_dir, f"device_{run}.log")
        t0 = time.time()
        with open(log_path, "w") as fh:
            old = sys.stderr
            sys.stderr = fh
            try:
                p = polish(flags, dev if dev.type == "cpu" else None)
            finally:
                sys.stderr = old
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        with open(log_path) as fh:
            nwin, _poa_s, total_s = stage_times(fh.read())
        table, calls, poa_s = pipeline_table(
            trace.RECORDER.spans, threading.current_thread().name)
        print(json.dumps({
            "run": run, "device": name, "windows": nwin,
            "poa_s": poa_s, "total_s": total_s, "wall_s": wall,
            "md5": md5(out), "windows_per_s": nwin / poa_s,
            "launches": dict(zip(KERNELS, (sum(c.launches for c in ws)
                                           for ws in counters))),
            "stats": p.device_runner.stats,
            "pipeline": table, "calls": calls}),
            flush=True)
    if opts.kernel:
        if dev.type != "cuda":
            raise SystemExit("--kernel times a CUDA kernel: needs --device "
                             "cuda")
        for row in _kernel_rows(dev):
            print(json.dumps(dict(row, device=name)), flush=True)


# -- the parent ----------------------------------------------------------------

def run_child(opts, sim: str, work: str) -> List[dict]:
    cmd = [sys.executable, "-m", "hypo_tpu_torch.bench", "--child",
           "--sim", sim, "--out-dir", work, "--device", opts.device,
           "--threads", str(opts.threads)]
    if opts.kernel:
        cmd.append("--kernel")
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"[bench] the device child exited with "
                         f"{r.returncode}:\n{r.stderr[-4000:]}")
    return [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]


def print_table(runs: Dict[str, dict], host) -> None:
    cols = list(runs)
    log("pipeline table, seconds (calls), device " + runs[cols[0]]["device"])
    log(f"{'bucket':10s}" + "".join(f"{c:>22s}" for c in cols))
    for b in BUCKETS:
        cells = []
        for c in cols:
            n = runs[c]["calls"].get(b)
            cells.append(f"{runs[c]['pipeline'][b]:.4f}"
                         + (f" ({n})" if n is not None else ""))
        log(f"{b:10s}" + "".join(f"{x:>22s}" for x in cells))
    for key in ("poa_s", "total_s", "wall_s", "windows_per_s"):
        log(f"{key:10s}" + "".join(f"{runs[c][key]:>22.4f}" for c in cols))
    log(f"{'launches':10s}" + "".join(
        f"{json.dumps(list(runs[c]['launches'].values())):>22s}"
        for c in cols))
    hw, hp, ht = host
    log(f"host engine (--no-device-poa): {hw} windows, POA stage {hp:.4f} s "
        f"({hw / hp:.1f} windows/s), total {ht:.4f} s")
    log("cold - warm: POA stage "
        f"{runs['cold']['poa_s'] - runs['warm']['poa_s']:.4f} s, total "
        f"{runs['cold']['total_s'] - runs['warm']['total_s']:.4f} s, "
        f"wall {runs['cold']['wall_s'] - runs['warm']['wall_s']:.4f} s")


def build(root: str, kernels: bool) -> None:
    """Build checkout ``root``'s native host libraries (and, with
    ``kernels``, its CUDA kernels) in a subprocess, so that no timed run
    pays a compiler."""
    code = ("from hypo_tpu_torch.native import api, bam_api, host_api; "
            "assert host_api.available() and api.available() "
            "and bam_api.available()")
    if kernels:
        code += ("; from hypo_tpu_torch import _build; "
                 "[_build.load(k) for k in ('poa_dp', 'poa_tb', "
                 "'consensus')]")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"[bench] building {root} failed:\n"
                         f"{r.stderr[-3000:]}")


def in_turns(others: List[str], sim: str, size: int, threads: int,
             work: str) -> List[dict]:
    """For each checkout in ``others``, its device CLI and this one's in
    turns (other, this, this, other), after building every one."""
    for root in (*others, ROOT):
        build(root, kernels=True)
    rows = []
    order = [(name, root) for other in others
             for name, root in ((other, other), ("this", ROOT),
                                ("this", ROOT), (other, other))]
    for k, (name, root) in enumerate(order):
        out = os.path.join(work, f"turn{k}.fa")
        argv = cli_args(sim, size, threads) + [
            "-o", out, "--device-poa", "--aux-dir",
            os.path.join(work, f"aux_turn{k}")]
        nwin, poa_s, total_s = stage_times(run_cli(root, argv))
        rows.append({"turn": k, "root": root, "windows": nwin,
                     "poa_s": poa_s, "total_s": total_s, "md5": md5(out)})
        log(f"in turns {k} ({root}): POA stage {poa_s:.4f} s, "
            f"total {total_s:.4f} s, md5 {rows[-1]['md5']}")
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=float, default=4.0,
                    help="genome size of the simulation the bench makes")
    ap.add_argument("--sim", help="directory of an existing simulation "
                                  "(hypo_tpu_torch.sim's files)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kernel", action="store_true",
                    help="also time kernel 1 at the class-0 tile shape")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--in-turns-with", metavar="DIR", nargs="+",
                    default=[], help="other checkouts whose device CLI "
                                     "to time in turns with this one's")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.child:
        child(opts)
        return
    if opts.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("[bench] no CUDA device (torch.cuda."
                             "is_available() is false); pass --device cpu "
                             "for a CPU run")
    work = tempfile.mkdtemp(prefix="hypo_bench_")
    try:
        pin = None
        if opts.sim:
            sim = opts.sim
        else:
            size = int(round(opts.mbp * 1e6))
            sim = os.path.join(work, "sim")
            simulate(sim, size, seed=1)
            pin = PINNED_MD5.get((size, 1))
        size = genome_size(sim)
        build(ROOT, kernels=False)   # the device child builds its kernels
        host_out = os.path.join(work, "host.fa")
        host = stage_times(run_cli(ROOT, cli_args(sim, size, opts.threads)
                                   + ["-o", host_out, "--no-device-poa",
                                      "--aux-dir",
                                      os.path.join(work, "aux_host")]))
        host_md5 = md5(host_out)
        lines = run_child(opts, sim, work)
        runs = {r["run"]: r for r in lines if "run" in r}
        if set(runs) != {"cold", "warm"}:
            raise SystemExit(f"[bench] the device child printed runs "
                             f"{sorted(runs)}, expected cold and warm")
        print_table(runs, host)
        for r in lines:
            if "kernel" in r:
                log(f"kernel {r['kernel']} ({r['graph']}, B={r['B']} "
                    f"N={r['N']} L={r['L']} P={r['P']}): device "
                    f"{r['device_ms']:.4f} ms a call (torch.profiler), "
                    f"{r['event_ms']:.4f} ms a call (CUDA events), "
                    f"{r['gcells_per_s']:.1f} Gcells/s")
        ok = all(runs[k]["md5"] == host_md5 for k in runs)
        if pin is not None:
            ok = ok and host_md5 == pin
        log(f"md5 host {host_md5}, device cold {runs['cold']['md5']}, warm "
            f"{runs['warm']['md5']}, pinned {pin or 'none for this input'}: "
            + ("MATCH" if ok else "DIFFER"))
        turns = (in_turns(opts.in_turns_with, sim, size, opts.threads, work)
                 if opts.in_turns_with else [])
        warm = runs["warm"]
        log("secondary " + json.dumps({
            "genome_bp": size, "device": warm["device"],
            "host_windows": host[0], "host_poa_s": host[1],
            "host_wps": host[0] / host[1], "host_total_s": host[2],
            "host_md5": host_md5, "pinned_md5": pin,
            **{f"{k}_{f}": runs[k][f] for k in ("cold", "warm")
               for f in ("windows", "poa_s", "total_s", "wall_s",
                         "windows_per_s", "md5", "pipeline", "launches")},
            "in_turns": turns}))
        if not ok:
            raise SystemExit("[bench] a device FASTA differs from the host "
                             "engine's (or the pin)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
