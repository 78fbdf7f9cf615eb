"""Where the class-0 arm step's time goes on the card: the counterpart of
``tools/profile_device.py``.

    python -m hypo_tpu_torch.tools.profile_device [B=2048] [reps=4]
                                                  [--device cuda|cpu]

Builds a mid-POA class-0 state (L=126, N=256, P=8): 64 windows, each
with 5 mutated copies of a random 120-base sequence (3% substitutions,
every third arm one base shorter) merged by the port's ``run_arm_steps``
on the chosen device, plus one more such arm per window; then tiles it
to B windows; then merges that arm (one arm step), so that an arm
step on the state re-merges an arm every graph already holds.
The merge works in place, and such a step does the same work at every
call (only supports and edge weights grow).  Each part of an arm step is
timed per call on that state:

  rank   cuda_rank.rank_arrays            (kernel 4: the arm step's
                                           rank arrays)
  dp     cuda_poa.poa_dp_batch            (kernel 1, the DP)
  tb     device_full._traceback_matched_batch (kernel 3's tile emitter)
  merge  cuda_merge.merge_arm             (kernel 5: the aligned arm into
                                           the graph, in place)
  cons   device_full._consensus_batch     (kernel 4, kernel 2, reversal)
  step   device_full._arm_step_batch      (rank + dp + tb + merge)

then two more rows.  ``step (graph)`` (CUDA only): the tile program's
own ``step`` graph (poa.device_full.build_tile_program at B, the graph
the runner replays), its state set to the eager step's input and its
counter to 0 before the first replay; its output is compared leaf by
leaf with the eager step's, and the tool fails if they differ; its
device kernels and copies per call are the step graph's kernel count,
and its ``split`` the device ms a call of each kernel name in it (the
first 60 characters; one more trace).
``tile``: one tile of
the 64 windows' 6 arms tiled to B, eager (device_full.run_tile_eager)
against the tile program (graph replays on CUDA, its parts called
directly on the CPU); the tool fails unless both give the same bytes.
Its row gives ms, device ms, device kernels and copies, and the host's
launch calls (kernels, graphs, copies and fills, by name, as the
profiler records them) for each.

Each row gives the ms per call between CUDA events (``reps`` samples of
10 back-to-back calls after a warm-up, median; it holds the host's
issue work where that is longer than the device's), the device ms per
call from torch.profiler (the summed durations of the device kernels
and copies), and the device kernels and copies per call.  The last line
of stdout is one JSON object with every row.  ``--device cpu`` (tests)
times on the host clock and reports no device time, no host launches
and no ``step (graph)`` row.
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..poa import device_full as TF
from ..poa.cuda_merge import merge_arm
from ..poa.cuda_poa import poa_dp_batch
from ..poa.cuda_rank import STEP_LEAVES, rank_arrays
from .timing import card, device_for, event_ms, fmt, profiled_ms, sync

L, N, K, P = 126, 256, 16, 8
SCORES = dict(m=5, n=-4, g=-8)
NWIN, N_ARMS = 64, 5
PARTS = ("rank", "dp", "tb", "merge", "cons", "step")
# the host's runtime and driver calls that launch device work
LAUNCH_RE = re.compile(r"cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")


def make_arms(nwin: int, n_arms: int, seed: int = 0):
    """(arms [n_arms + 1, nwin, L] i32, lengths [n_arms + 1, nwin]) by
    tools/profile_device.py's recipe, from the same numpy seed."""
    rng = np.random.default_rng(seed)
    base_len = L - 6
    arms = np.zeros((n_arms + 1, nwin, L), np.int32)
    alens = np.zeros((n_arms + 1, nwin), np.int32)
    for w in range(nwin):
        base = rng.integers(0, 4, base_len)
        for a in range(n_arms + 1):
            s = base.copy()
            nmut = max(1, int(0.03 * base_len))
            pos = rng.choice(base_len, nmut, replace=False)
            s[pos] = (s[pos] + rng.integers(1, 4, nmut)) % 4
            if a % 3 == 1:
                s = np.delete(s, rng.integers(1, base_len - 1))
            arms[a, w, :len(s)] = s
            alens[a, w] = len(s)
    return arms, alens


def build_state(device, nwin: int = NWIN, n_arms: int = N_ARMS,
                seed: int = 0):
    """The graphs of ``nwin`` windows after ``n_arms`` arms each, merged
    by run_arm_steps on ``device`` (arm a of window w in pool row
    a * nwin + w, weight 1, mode NW); returns (PoaState, the next arm
    [nwin, L], its lengths [nwin]) on ``device``."""
    arms, alens = make_arms(nwin, n_arms, seed)
    idx = np.full((nwin, K), -1, np.int32)
    idx[:, :n_arms] = (np.arange(n_arms)[None, :] * nwin
                       + np.arange(nwin)[:, None])
    st = TF.run_arm_steps(
        arms[:n_arms].reshape(n_arms * nwin, L).astype(np.int8),
        alens[:n_arms].reshape(-1), idx, np.zeros((nwin, K), np.int8),
        np.ones((nwin, K), np.int32), np.full(nwin, n_arms, np.int32),
        N=N, L=L, P=P, **SCORES, device=device)
    return (st, TF.upload(arms[n_arms], device),
            TF.upload(alens[n_arms], device))


def tile_to(x: torch.Tensor, B: int) -> torch.Tensor:
    """x repeated along its first dimension to B rows."""
    reps = -(-B // x.shape[0])
    return x.repeat((reps,) + (1,) * (x.dim() - 1))[:B].contiguous()


def step_inputs(B: int, device):
    """(state, arm, arm_len, mode, active, w) of the class-0 step at B
    windows on ``device``."""
    st, arm, alen = build_state(device)
    st = TF.PoaState(*(tile_to(x, B) for x in st))
    arm, alen = tile_to(arm, B), tile_to(alen, B)
    mode = torch.zeros(B, dtype=torch.int32, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    w = torch.ones(B, dtype=torch.int32, device=device)
    return st, arm, alen, mode, active, w


def parts(st, arm, alen, mode, active, w):
    """(each part of the arm step as a call, the state they work on): the
    state is a copy of ``st`` with the arm merged once, and the inputs of
    dp, tb and merge are computed once on it as the step computes them.
    merge and step each update a copy of their own in place."""
    kw = dict(N=N, L=L, P=P)
    work = TF._arm_step_batch(TF.clone_state(st), arm, alen, mode, active,
                              w, **kw, **SCORES)
    ra = rank_arrays(work, N, STEP_LEAVES)
    act = active & (alen > 0) & (work.n_nodes > 0)
    dp_args = (ra.node_code_r, ra.pred_rows, ra.pred_cnt_r, ra.is_end_r,
               torch.where(act, work.n_nodes, 0), arm, alen, mode)
    bp, max_row = poa_dp_batch(*dp_args, **kw, **SCORES)
    matched = TF._traceback_matched_batch(bp, ra.pred_rows, alen, mode,
                                          max_row, active=act, **kw)
    merged, stepped = TF.clone_state(work), TF.clone_state(work)
    return {
        "rank": lambda: rank_arrays(work, N, STEP_LEAVES),
        "dp": lambda: poa_dp_batch(*dp_args, **kw, **SCORES),
        "tb": lambda: TF._traceback_matched_batch(
            bp, ra.pred_rows, alen, mode, max_row, active=act, **kw),
        "merge": lambda: merge_arm(merged, ra.node_col_r, matched, arm,
                                   alen, w, active, **kw),
        "cons": lambda: TF._consensus_batch(work, N=N, P=P),
        "step": lambda: TF._arm_step_batch(stepped, arm, alen, mode, active,
                                           w, **kw, **SCORES),
    }, work


def tile_arrays(B: int):
    """A tile of B windows: window b holds the NWIN windows' N_ARMS + 1
    arms of window b % NWIN (make_arms), weight 1, mode NW."""
    arms, alens = make_arms(NWIN, N_ARMS)
    na = N_ARMS + 1
    idx = np.full((B, K), -1, np.int32)
    idx[:, :na] = (np.arange(na)[None, :] * NWIN
                   + (np.arange(B) % NWIN)[:, None])
    return (arms.reshape(na * NWIN, L).astype(np.int8), alens.reshape(-1),
            idx, np.zeros((B, K), np.int8), np.ones((B, K), np.int32),
            np.full(B, na, np.int32), np.zeros(B, np.int32))


def program(B: int, A: int, dev):
    return TF.build_tile_program(N=N, L=L, K=K, P=P, B=B, A=A, devices=dev,
                                 **SCORES)


def graph_step(st, arm, alen, dev):
    """The tile program's step graph set to replay the class-0 step on
    state ``st``: arm b of ``arm`` into window b, weight 1, mode NW.
    Returns (the program's block, whose state the replays update in
    place, starting from a copy of ``st``, and a call that sets its arm
    counter to 0 and replays the step graph)."""
    B = arm.shape[0]
    prog = program(B, B, dev)
    # every arm slot of window b reads pool row b
    idx = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, K))
    prog(arm.to(torch.int8), alen, idx, np.zeros((B, K), np.int8),
         np.ones((B, K), np.int32), np.full(B, K, np.int32),
         np.zeros(B, np.int32))          # loads the inputs, captures
    block = prog.blocks[0]
    for leaf, v in zip(block.st, st):
        leaf.copy_(v)
    step = block.parts()[1]

    def replay():
        block.k.zero_()
        step()
    return block, replay


def host_launches(fn, dev) -> Optional[Dict[str, int]]:
    """The host's launch calls in one call of fn(), by name, from a
    torch.profiler trace (CPU and CUDA activity); None off the card."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    out: Dict[str, int] = {}
    for e in prof.events():
        if LAUNCH_RE.match(e.name):
            name = re.sub(r"_v\d+$", "", e.name)   # CUPTI's API version
            out[name] = out.get(name, 0) + 1
    return out


def tile_row(B: int, reps: int, dev, inner: int) -> dict:
    """The ``tile`` row: an eager tile against the tile program's, which
    must give the same bytes."""
    arrays = tile_arrays(B)
    prog = program(B, len(arrays[0]), dev)
    calls = {"eager": lambda: TF.run_tile_eager(*arrays, N=N, L=L, P=P,
                                                device=dev, **SCORES),
             "program": lambda: prog(*arrays)}
    outs = {k: fn() for k, fn in calls.items()}
    sync(dev)
    if not torch.equal(outs["eager"].cpu(), outs["program"].cpu()):
        raise RuntimeError("the tile program's tile differs from the eager "
                           "tile")
    r = {"part": "tile", "steps": N_ARMS + 1, "equal_to_eager": True}
    for name, fn in calls.items():
        dev_ms, per = profiled_ms(fn, dev)
        r[name] = {"ms": event_ms(fn, dev, reps=reps, inner=inner),
                   "device_ms": dev_ms, "device_activities_per_call": per,
                   "host_launches": host_launches(fn, dev)}
    return r


def kernel_split(fn, dev, calls: int = 10) -> Optional[Dict[str, float]]:
    """Device ms a call of fn() by device kernel or copy name (its first
    60 characters), from one torch.profiler trace (CUDA activity only)
    after a warm-up call; None off the card or when the trace holds no
    device activity."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync(dev)
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:60]
            out[name] = (out.get(name, 0.0) + (e.time_range.end
                                               - e.time_range.start)
                         / 1e3 / calls)
    return out or None


def row(name: str, fn, dev, reps: int, inner: int = 10) -> dict:
    ms = event_ms(fn, dev, reps=reps, inner=inner)
    dev_ms, per = profiled_ms(fn, dev)
    return {"part": name, "ms": ms, "device_ms": dev_ms,
            "device_activities_per_call": per}


def log_row(r: dict) -> None:
    print(f"[prof] {r['part']:12s}: {r['ms']:9.4f} ms/call (CUDA events"
          f" or host clock), device {fmt(r['device_ms'])} ms/call, "
          f"{fmt(r['device_activities_per_call'], 1)} device kernels and "
          f"copies/call", flush=True)


def profile(B: int, reps: int, dev, inner: int = 10) -> List[dict]:
    """The table's rows (printed as they are measured); a row's ms is
    the median of ``reps`` samples of ``inner`` calls."""
    inputs = step_inputs(B, dev)
    calls, st = parts(*inputs)
    rows = []
    for name in PARTS:
        rows.append(row(name, calls[name], dev, reps, inner))
        log_row(rows[-1])
    if dev.type == "cuda":
        eager = TF._arm_step_batch(TF.clone_state(st), *inputs[1:], N=N,
                                   L=L, P=P, **SCORES)
        block, replay = graph_step(st, inputs[1], inputs[2], dev)
        replay()
        sync(dev)
        diff = [f for f, a, b in zip(TF.PoaState._fields, eager, block.st)
                if not torch.equal(a, b)]
        print(f"[prof] step (graph) replay vs eager step: "
              + (f"leaves differ: {diff}" if diff else
                 f"all {len(eager)} leaves equal"), flush=True)
        if diff:
            raise RuntimeError(f"the tile program's step graph differs from "
                               f"the eager step in {diff}")
        try:
            r = row("step (graph)", replay, dev, reps, inner)
        except RuntimeError:   # the profiler saw no replayed kernel
            r = {"part": "step (graph)",
                 "ms": event_ms(replay, dev, reps=reps, inner=inner),
                 "device_ms": None, "device_activities_per_call": None}
        r["equal_to_eager"] = True
        r["split"] = kernel_split(replay, dev)
        rows.append(r)
        log_row(r)
        print(f"[prof] step (graph) split (device ms a call by kernel): "
              + ("not measured" if r["split"] is None else json.dumps(
                  {k: round(v, 5) for k, v in sorted(
                      r["split"].items(), key=lambda kv: -kv[1])})),
              flush=True)
    r = tile_row(B, reps, dev, inner)
    rows.append(r)
    for name in ("eager", "program"):
        t = r[name]
        hl = t["host_launches"]
        print(f"[prof] tile {name:7s}: {t['ms']:9.4f} ms/call, device "
              f"{fmt(t['device_ms'])} ms/call, "
              f"{fmt(t['device_activities_per_call'], 1)} device kernels "
              f"and copies/call, host launch calls "
              f"{'not measured' if hl is None else json.dumps(hl)} "
              f"({r['steps']} arm steps; bytes equal)", flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=2048)
    ap.add_argument("reps", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    opts = ap.parse_args(argv)
    dev = device_for(opts.device)
    where = card(dev)
    print(f"[prof] device {where}, B={opts.B}, class 0 (L={L}, N={N}, "
          f"P={P}), state of {NWIN} windows x {N_ARMS} arms tiled to B",
          flush=True)
    rows = profile(opts.B, opts.reps, dev)
    print(json.dumps({"device": where, "B": opts.B, "rows": rows}),
          flush=True)


if __name__ == "__main__":
    main()
