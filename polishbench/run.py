"""One run of one cell of the benchmark of hypo_tpu_torch on the card.

    python3 polishbench/run.py --workload bact4m_sr.cov30 --seed 7 \\
        --seconds 20 --trace 0

1. Set-up (``setup_s``): the cell's inputs from the seed (``gen``), the
   port imported, the card checked, and one untimed warm-up polish,
   which builds or loads the kernels and host libraries in the port's
   ``hypo_tpu_torch/_build/`` (inside the checkout; only a checkout's
   first run builds them).
2. The window: whole polishes of the draft, one after another, as
   ``python -m hypo_tpu_torch.cli ... --device-poa --device-poa-mode
   full`` does them (``cli.build_parser`` / ``flags_from_args``, then
   ``pipeline.polish.polish``), until ``--seconds`` have passed; the
   polish in flight then runs to its end.  ``polish_kbp_per_s`` is the
   draft's kbp times the polishes, over the window's wall seconds.
3. ``--trace 1`` instead reads the cell's per-layer metrics, from the
   spans, counters and ``torch.profiler`` trace of ``trace``.
4. The check (``check``): every polished FASTA of the window against
   the plain reference, once the window has closed and the program's
   state is freed.
5. The last line of stdout: one JSON object (``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
   ``breakdown``, and last ``checks``: each number compared with its
   limit, which also end stderr).

No card, or fewer than the cell asks for, and the run exits non-zero
with no result line; so does a run that finds ``jax``, ``jaxlib``,
``flax`` or ``hypo_tpu`` in ``sys.modules``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "hypo_tpu")


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``hypo_tpu_torch/_build/``)."""
    cache = os.path.join(root, ".polishbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not
    load, compared whole (``hypo_tpu_torch`` is not ``hypo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cli_argv(cfg: dict, mx: dict, inputs: dict, out: str,
             aux: str) -> list:
    """The polisher's command line for the cell's inputs."""
    pol = cfg["polisher"]
    argv = ["-r", inputs["reads"], "-d", inputs["draft"],
            "-b", inputs["sr_bam"], "-c", str(mx["reads"]["short_cov"]),
            "-s", str(pol["size_ref"]), "-k", pol["kind_sr"],
            "-t", str(pol["threads"]), "-o", out, "--aux-dir", aux,
            "--device-poa", "--device-poa-mode", pol["device_poa_mode"]]
    if inputs.get("lr_bam"):
        argv += ["-B", inputs["lr_bam"]]
    return argv


def power_limit() -> str:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def log(msg: str) -> None:
    print(f"[polishbench] {msg}", file=sys.stderr, flush=True)


def run(opts, device=None, work_dir: str = None) -> dict:
    """One run; returns the result object.  ``device`` is for the tests:
    a CPU device skips the look for a card and runs the port's plain
    kernels there."""
    import shutil
    import tempfile

    from polishbench import check, gen, registry
    from polishbench.trace import (Trace, Tracer, anchor_mark,
                                   device_activity, idle_gaps,
                                   launch_counters, top_ops)

    cell = registry.Cell(opts.workload, registry.benchmark())
    readers = cell.readers() if opts.trace else {}
    import torch

    from hypo_tpu_torch.cli import build_parser, flags_from_args
    from hypo_tpu_torch.pipeline.polish import polish
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("polishbench: no CUDA card "
                             "(torch.cuda.is_available() is false)")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"polishbench: {opts.workload} needs "
                             f"{cell.chips} card(s), "
                             f"{torch.cuda.device_count()} visible")
    cfg, mx = cell.config, cell.mix
    work = tempfile.mkdtemp(prefix="polishbench-", dir=work_dir)
    try:
        t0 = time.perf_counter()
        inputs = gen.simulate_cell(os.path.join(work, "in"), opts.seed, cfg,
                                   mx)
        log(f"inputs made in {time.perf_counter() - t0:.2f} s; "
            f"{cfg['polisher']['threads']} threads on {os.cpu_count()} cores")
        records = check.read_fasta(inputs["draft"])
        draft_name, draft_seq = records[0]
        draft_kbp = sum(len(seq) for _n, seq in records) / 1e3

        def one(i: int):
            argv = cli_argv(cfg, mx, inputs,
                            os.path.join(work, f"polished_{i}.fa"),
                            os.path.join(work, "aux"))
            flags = flags_from_args(build_parser().parse_args(argv))
            old = sys.stdout, sys.stderr
            with open(os.path.join(work, "polish.log"), "a") as fh:
                sys.stdout = sys.stderr = fh
                try:
                    return polish(flags, device)
                finally:
                    sys.stdout, sys.stderr = old

        t0 = time.perf_counter()
        one(-1)
        log(f"warm-up polish {time.perf_counter() - t0:.2f} s")
        setup_s = time.perf_counter() - T_START

        tracer = traced = None
        if opts.trace:
            tracer = Tracer()
            tracer.install()
            counters = launch_counters()
        for attempt in range(3 if opts.trace else 1):
            if tracer is None:
                n, w0, w1, _stats = window(one, opts.seconds, device)
                break
            tracer.reset()
            for c in counters:
                c.launches = 0
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                anchor = anchor_mark()
                tracer.recording = True
                n, w0, w1, stats = window(one, opts.seconds, device)
                tracer.recording = False
            acts = device_activity(prof, anchor) if device is None else None
            traced = Trace(n, (w0, w1), tracer.stages, tracer.totals,
                           dict(tracer.spans.secs), stats,
                           sum(c.launches for c in counters), acts)
            if acts is None or acts:
                break
            log(f"trace {attempt + 1} saw no device activity; again")
        if tracer is not None:
            tracer.uninstall()
        window_s = w1 - w0
        polishes = n
        dev = {"platform": "gpu" if device is None else str(device),
               "kind": (torch.cuda.get_device_name(0) if device is None
                        else "cpu"),
               "count": cell.chips,
               "memory_peak_bytes": (max(torch.cuda.max_memory_allocated(d)
                                         for d in range(cell.chips))
                                     if device is None else 0),
               "power_limit": power_limit() if device is None else "none"}
        import gc
        gc.collect()
        if device is None:
            torch.cuda.empty_cache()

        # -- the check -----------------------------------------------------
        t0 = time.perf_counter()
        stretches = check.plan(opts.seed, len(draft_seq), mx)
        ref = check.Reference(inputs, flags_k(cfg), mx["reads"]["short_cov"],
                              mx["check"], stretches)
        texts = ref.run()
        checks, correct = check.verdict(
            [os.path.join(work, f"polished_{i}.fa") for i in range(polishes)],
            draft_name, texts, ref.stats)
        log(f"reference {time.perf_counter() - t0:.2f} s: "
            + json.dumps(ref.stats))

        if opts.trace:
            metrics = {}
            units = {m["name"]: m["unit"] for m in cell.per_layer}
            for name, read in readers.items():
                v = read(traced)
                if v is not None:
                    metrics[name] = {"value": v, "unit": units[name]}
            if traced.device is not None:
                dev["busy_s"] = traced.busy(w0, w1)
                dev["window_s"] = window_s
        else:
            metrics = {
                "polish_kbp_per_s": {"value": draft_kbp * polishes / window_s,
                                     "unit": "kbp/s"},
                "setup_s": {"value": setup_s, "unit": "s"},
            }
        result = {"correct": bool(correct), "attempted": polishes,
                  "failed": checks["polishes_wrong"]["value"],
                  "metrics": metrics, "device": dev}
        if opts.trace and traced.device is not None:
            result["breakdown"] = {
                "device_ops": top_ops(traced.device),
                "idle_gaps": idle_gaps(traced.device, traced.stages, w0, w1)}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def window(one, seconds: float, device):
    """Whole polishes, ``one(i)`` after ``one(i - 1)``, until ``seconds``
    have passed; the polish in flight runs to its end.  Returns
    (polishes, start, end, the runners' stats summed)."""
    import torch
    stats = {"class_tiles": [0, 0], "class_windows": [0, 0],
             "trivial_windows": 0, "host_long_windows": 0,
             "host_fallbacks": 0, "full_overflows": 0}
    each = []
    w0 = time.perf_counter()
    while True:
        runner_stats = one(len(each)).device_runner.stats
        each.append(time.perf_counter() - w0 - sum(each))
        for k in stats:
            v = runner_stats[k]
            stats[k] = ([a + b for a, b in zip(stats[k], v)]
                        if isinstance(v, list) else stats[k] + v)
        if time.perf_counter() - w0 >= seconds:
            break
    if device is None:
        torch.cuda.synchronize()
    w1 = time.perf_counter()
    log("window: " + " ".join(f"{t:.3f}" for t in each) + " s a polish")
    return len(each), w0, w1, stats


def flags_k(cfg: dict) -> int:
    """The k-mer length the polisher derives from ``-s`` (the port's
    ``config.get_kmer_len``, as the reference's copy has it)."""
    from polishbench.reference.config import get_kmer_len
    return max(2, get_kmer_len(str(cfg["polisher"]["size_ref"])))


def main(argv=None) -> None:
    opts = parse(argv)
    set_cache_dirs(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    result = run(opts)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"polishbench: the run loaded {', '.join(found)}")
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
