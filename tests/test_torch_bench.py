"""The port's measurement layer against the JAX package, on the CPU (the
kernels' plain versions), plus card-only cases under the ``cuda``
marker:

- the tile runner's dispatch order: ``_run_tiles`` calls the tile
  program for every tile before its first readback, in the order in
  which hypo_tpu's ``run_polish_batch`` calls its own on the same 20 kbp
  input (CPU tile of B = 64, one device), and both write one FASTA;
- the ``HYPO_POA_DEBUG`` stage lines: ``run_polish_batch`` prints
  hypo_tpu's labels, in hypo_tpu's order, with the same counts (times,
  stats and the port's extra ``device drain`` line aside), and nothing
  without the variable;
- the warm-up: it names all three kernels, runs each class's tile
  program once on a zero tile in its thread, and an error it meets
  reaches the first dispatch, from the runner and from polish();
- ``python -m hypo_tpu_torch.bench --device cpu`` at 20 kbp: a pipeline
  table within the POA stage, device md5s equal to the host engine's;
  without a card, ``--device cuda`` exits non-zero with no output;
- ``python -m hypo_tpu_torch.tools.profile_device`` at B = 64: six
  eager rows and the tile row (eager and tile program, equal bytes);
  its state and step equal the JAX tool's state and JAX's
  ``_arm_step_batch``;
- ``python -m hypo_tpu_torch.tools.long_window_stats`` prints the JAX
  tool's statistics on a 60 kbp hybrid simulation.

Every compared value is bytes or an integer: tolerance 0."""
import contextlib
import functools
import hashlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from hypo_tpu.config import InputFlags as JInputFlags
from hypo_tpu.config import ScoreParams, get_kmer_len
from hypo_tpu.native import host_api as jhost_api
from hypo_tpu.pipeline.polish import Polisher as JPolisher
from hypo_tpu.poa import device_full as JDF
from hypo_tpu.poa import full_runner as jfull
from hypo_tpu.sim import SimConfig, simulate
from hypo_tpu_torch.config import InputFlags
from hypo_tpu_torch.entry import dryrun_specs, make_contig
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.polish import Polisher
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa import full_runner as tfull
from hypo_tpu_torch.tools import long_window_stats, profile_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIME_RE = re.compile(r"\d+\.\d\ds")


def _md5(path):
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def _tool(name):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _labels(text, drop_drain=False):
    """The ``[poa]`` lines with times and stats taken out."""
    out = []
    for line in text.splitlines():
        if not line.startswith("[poa] "):
            continue
        line = TIME_RE.sub("T", line.split("stats=")[0]).rstrip()
        if drop_drain and line.startswith("[poa] device drain"):
            continue
        out.append(line)
    return out


def _main_thread():
    return threading.current_thread() is threading.main_thread()


def _spy_program(mp, cls, events):
    """Record each tile-program call made from the main thread as
    ("tile", windows with arms, arm slots)."""
    program = cls._program

    def spied(self, ci, scores):
        fn = program(self, ci, scores)
        if not _main_thread():
            return fn

        def tile(*a, **k):
            narms = np.asarray(a[5])
            events.append(("tile", int((narms > 0).sum()),
                           int(narms.sum())))
            return fn(*a, **k)
        return tile

    mp.setattr(cls, "_program", spied)


def _spy_finalize(mp, mod, events):
    fin = mod.tile_finalize

    def spied(packed, row_of, cnt, *a):
        events.append(("finalize", int(cnt)))
        return fin(packed, row_of, cnt, *a)

    mp.setattr(mod, "tile_finalize", spied)


@pytest.fixture(scope="module")
def polished_20k(tmp_path_factory):
    """A 20 kbp short-read simulation polished with the device path by
    the port (CPU tile) and by hypo_tpu (one device), both under
    HYPO_POA_DEBUG=1 with their tile programs, readbacks (port) and
    tile_finalize spied on.  Returns {name: (events, stdout, md5)}."""
    if not host_api.available():
        pytest.skip("the native host library did not build")
    tmp = tmp_path_factory.mktemp("sim20k")
    paths = simulate(SimConfig(genome_size=20000, seed=1), str(tmp / "sim"))
    common = dict(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        draft_filename=paths["draft"],
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"], use_device_poa=True,
        device_poa_mode="full")
    out = {}
    for name in ("port", "jax"):
        events = []
        buf = io.StringIO()
        fa = str(tmp / f"{name}.fa")
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(buf):
            mp.setenv("HYPO_POA_DEBUG", "1")
            mp.setenv("HYPO_POA_NDEV", "1")
            if name == "port":
                _spy_program(mp, tfull.FullDeviceRunner, events)
                _spy_finalize(mp, host_api, events)
                readback = tfull.FullDeviceRunner._readback

                def spied(self, handle):
                    events.append(("readback",))
                    return readback(self, handle)

                mp.setattr(tfull.FullDeviceRunner, "_readback", spied)
                flags = InputFlags(output_filename=fa,
                                   aux_dir=str(tmp / "aux_port"), **common)
                Polisher(flags, device=CPU).polish()
            else:
                _spy_program(mp, jfull.FullDeviceRunner, events)
                _spy_finalize(mp, jhost_api, events)
                flags = JInputFlags(output_filename=fa,
                                    aux_dir=str(tmp / "aux_jax"), **common)
                jp = JPolisher(flags)
                jp.polish()
                assert jp.device_runner.ndev == 1
        out[name] = (events, buf.getvalue(), _md5(fa))
    return out


def test_run_tiles_dispatches_every_tile_before_the_first_readback(
        polished_20k):
    events, _text, md5 = polished_20k["port"]
    jevents, _jtext, jmd5 = polished_20k["jax"]
    kinds = [e[0] for e in events]
    ntiles = kinds.count("tile")
    assert ntiles >= 3
    assert kinds == ["tile"] * ntiles + ["readback", "finalize"] * ntiles
    # the JAX runner's order of tile-program calls and finalizes, tile
    # by tile with the same windows and arms
    assert [e for e in events if e[0] != "readback"] == jevents
    assert md5 == jmd5


def test_run_polish_batch_prints_the_jax_stage_lines(polished_20k):
    _e, text, _m = polished_20k["port"]
    _je, jtext, _jm = polished_20k["jax"]
    assert "[poa] device drain" in text
    port = _labels(text, drop_drain=True)
    assert [line.split(":")[0] for line in port] == [
        "[poa] native jobs", "[poa] pack+dispatch", "[poa] readback+finalize",
        "[poa] host leftovers"]
    assert port == _labels(jtext)


def test_nothing_prints_without_the_variable(monkeypatch, capsys):
    monkeypatch.delenv("HYPO_POA_DEBUG", raising=False)
    monkeypatch.setenv("HYPO_POA_NDEV", "1")
    ctg = make_contig(dryrun_specs(1))
    tfull.FullDeviceRunner(ScoreParams(), "cpu").run_polish_batch([ctg])
    assert all(w.consensus is not None for w in ctg.windows)
    assert "[poa]" not in capsys.readouterr().out


def test_warm_names_all_three_kernels():
    assert tfull.FullDeviceRunner.KERNELS == ("poa_dp", "poa_tb",
                                             "consensus")


@pytest.mark.parametrize("classes", [(0,), (0, 1)])
def test_warm_runs_each_class_on_a_zero_tile_in_a_thread(monkeypatch,
                                                        classes):
    runner = tfull.FullDeviceRunner(ScoreParams(), CPU)
    calls = []
    program = runner._program

    def spied(ci, scores):
        fn = program(ci, scores)

        def tile(*a, **k):
            out = fn(*a, **k)
            calls.append((ci, threading.current_thread().name,
                          np.asarray(a[5]).tolist().count(0), out))
            return out
        return tile

    monkeypatch.setattr(runner, "_program", spied)
    thread = runner.warm(classes)
    assert thread.name == "hypo-tile-warm"
    runner._join_warm()
    assert not thread.is_alive()
    assert [c[0] for c in calls] == list(classes)
    for ci, name, empty, out in calls:
        L, N, K, B, A = runner._class_shape(ci)
        assert name == "hypo-tile-warm" and empty == B - 1
        assert out.shape == (B, N // 2 + 4)
        assert not out[:, N // 2:].any()        # every consensus empty


@pytest.mark.parametrize("path", ["dry_run_contig", "run_polish_batch"])
def test_a_warm_up_error_reaches_the_first_dispatch(monkeypatch, tmp_path,
                                                    path):
    """The warm-up thread's tile program raises; the first dispatch
    raises it (as the cause), and the thread is joined: the runner's
    own run_polish_batch on the dry run's contig, or polish()."""
    def boom(self, ci, scores):
        if _main_thread():
            return build(self, ci, scores)

        def tile(*a, **k):
            raise ValueError("boom in the warm-up")
        return tile

    if not host_api.available():
        pytest.skip("the native host library did not build")
    build = tfull.FullDeviceRunner._program
    monkeypatch.setattr(tfull.FullDeviceRunner, "_program", boom)
    monkeypatch.setenv("HYPO_POA_NDEV", "1")
    if path == "dry_run_contig":
        runner = tfull.FullDeviceRunner(ScoreParams(), CPU)
        runner.warm()
        with pytest.raises(RuntimeError, match="warm-up failed") as err:
            runner.run_polish_batch([make_contig(dryrun_specs(1))])
    else:
        paths = simulate(SimConfig(genome_size=8000, seed=7,
                                   draft_error_rate=0.012),
                         str(tmp_path / "sim"))
        flags = InputFlags(
            sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
            draft_filename=paths["draft"],
            output_filename=str(tmp_path / "out.fa"),
            aux_dir=str(tmp_path / "aux"),
            k=max(2, get_kmer_len(str(paths["genome_size"]))), cov=30,
            use_device_poa=True, device_poa_mode="full")
        polisher = Polisher(flags, device=CPU)
        with pytest.raises(RuntimeError, match="warm-up failed") as err:
            polisher.polish()
        runner = polisher.device_runner
    assert runner.stats["full_dispatches"] == 0
    assert isinstance(err.value.__cause__, ValueError)
    assert runner._warm_thread is None and runner._warm_error is None


def _bench(*args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "hypo_tpu_torch.bench", *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=timeout)


def test_bench_on_the_cpu_at_20kbp():
    r = _bench("--mbp", "0.02", "--device", "cpu", "--threads", "2")
    assert r.returncode == 0, r.stderr[-3000:]
    sec = json.loads(re.search(r"\[bench\] secondary (\{.*\})",
                               r.stderr).group(1))
    assert sec["device"] == "cpu" and sec["genome_bp"] == 20000
    assert sec["cold_md5"] == sec["warm_md5"] == sec["host_md5"]
    for run in ("cold", "warm"):
        table = sec[f"{run}_pipeline"]
        assert list(table) == ["jobs", "pack", "issue", "warm_wait",
                               "drain", "readback", "finalize", "leftovers",
                               "rest"]
        assert all(v >= 0 for v in table.values()), table
        assert sum(table.values()) == pytest.approx(sec[f"{run}_poa_s"])
        assert table["issue"] > 0 and table["jobs"] > 0
        assert sec[f"{run}_windows"] == sec["host_windows"] > 0
    assert "pipeline table" in r.stderr and "MATCH" in r.stderr


def test_bench_without_a_card_exits_with_no_headline():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = _bench("--mbp", "0.02", timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_profile_tool_on_the_cpu(capsys):
    """The tool's rows at B = 64, one sample of one call each: six eager
    parts, then the tile, eager and through the tile program, with
    equal bytes."""
    rows = profile_device.profile(64, 1, CPU, inner=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert [r["part"] for r in rows] == ["rank", "dp", "tb", "merge",
                                         "cons", "step", "tile"]
    assert all(r["ms"] > 0 and r["device_ms"] is None for r in rows[:-1])
    tile = rows[-1]
    assert tile["equal_to_eager"] is True and tile["steps"] == 6
    for name in ("eager", "program"):
        assert tile[name]["ms"] > 0 and tile[name]["device_ms"] is None
        assert tile[name]["host_launches"] is None
    assert [line.split(":")[0].split()[-1] for line in out] == [
        "rank", "dp", "tb", "merge", "cons", "step", "eager", "program"]


def test_profile_tool_state_and_step_equal_the_jax_tool():
    """The port's state (run_arm_steps over 64 windows x 5 arms) equals
    the JAX tool's (its XLA arm step); the state the tool's parts work on
    (a copy with the next arm merged, the caller's state untouched)
    equals device_full._arm_step_batch and JAX's _arm_step_batch on it,
    and the tool's step, which merges that arm again, equals JAX's second
    step."""
    import jax
    jtool = _tool("profile_device")
    L, N, P = profile_device.L, profile_device.N, profile_device.P
    jst, jarm, jalen = jtool.build_state_cpu(64, 5, L, N, P)
    st, arm, alen = profile_device.build_state(CPU)
    for f, a, b in zip(TF.PoaState._fields, st, jst):
        assert np.array_equal(a.numpy(), np.asarray(b)), f
    assert np.array_equal(arm.numpy(), jarm)
    assert np.array_equal(alen.numpy(), jalen)
    inputs = profile_device.step_inputs(64, CPU)
    before = TF.clone_state(inputs[0])
    calls, work = profile_device.parts(*inputs)
    for a, b in zip(inputs[0], before):
        assert torch.equal(a, b)
    direct = TF._arm_step_batch(*inputs, N=N, L=L, P=P,
                                **profile_device.SCORES)
    got = calls["step"]()
    B = 64
    jstep = jax.jit(functools.partial(JDF._arm_step_batch, N=N, L=L, P=P,
                                      m=5, n=-4, g=-8, dp_impl="xla"))
    jin = (jarm, jalen, np.zeros(B, np.int32), np.ones(B, bool))
    jout = jstep(jst, *jin)
    jout2 = jax.tree_util.tree_map(np.asarray, jstep(jout, *jin))
    jout = jax.tree_util.tree_map(np.asarray, jout)
    for f, a, b, c, d, e in zip(TF.PoaState._fields, work, direct, jout, got,
                                jout2):
        assert torch.equal(a, b), f
        assert np.array_equal(a.numpy(), c), f
        assert np.array_equal(d.numpy(), e), f
    assert int(work.n_nodes.min()) > int(before.n_nodes.min())
    assert torch.equal(got.n_nodes, work.n_nodes)


def test_long_window_stats_equal_the_jax_tool(tmp_path, capsys):
    sim = str(tmp_path / "hyb")
    simulate(SimConfig(genome_size=60000, seed=1, long_cov=25,
                       dropout=(0.30, 0.33)), sim)
    _tool("long_window_stats").main(sim)
    jax_out = capsys.readouterr().out
    long_window_stats.main([sim, "--out", str(tmp_path / "port.fa")])
    port_out = capsys.readouterr().out

    def report(text):
        lines = text.splitlines()
        return lines[lines.index(next(x for x in lines
                                      if x.startswith("long windows:"))):]

    assert report(port_out) == report(jax_out)
    assert len(report(port_out)) == 8
    assert int(report(port_out)[0].split()[-1]) >= 3


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_profile_graph_replay_equals_the_eager_step(cuda_device):
    rows = profile_device.profile(256, 1, cuda_device)
    assert [r["part"] for r in rows] == ["rank", "dp", "tb", "merge",
                                         "cons", "step", "step (graph)",
                                         "tile"]
    assert rows[-2]["equal_to_eager"] is True
    assert rows[-1]["equal_to_eager"] is True
    assert all(r["device_ms"] is not None for r in rows[:-2])
    # the tile program's tile: a few graph launches, not one a kernel
    launches = rows[-1]["program"]["host_launches"]
    graphs = sum(n for k, n in launches.items() if "GraphLaunch" in k)
    assert graphs == 1 + rows[-1]["steps"] + 1      # begin, steps, finish


@pytest.mark.cuda
def test_tile_uploads_are_pinned_and_queue_without_a_readback(cuda_device):
    from test_torch_device_full import SC, tile_inputs
    L, N, K, P, B = 40, 80, 6, 8, 12
    tile, _specs = tile_inputs(5, B, K, L, 30, 0.12)
    kw = dict(N=N, L=L, K=K, P=P, B=B, A=tile[0].shape[0], **SC)
    program = TF.build_tile_program(**kw, devices=cuda_device)
    keep = []
    out = program(*tile, keep=keep)
    assert out.device == cuda_device
    assert len(keep) == 7 and all(t.is_pinned() for t in keep)
    ref = TF.build_tile_program(**kw, devices=CPU)(*tile)
    assert np.array_equal(out.cpu().numpy(), ref.numpy())
    up = TF.upload(np.arange(5, dtype=np.int32), cuda_device)
    assert up.device == cuda_device and up.tolist() == list(range(5))
