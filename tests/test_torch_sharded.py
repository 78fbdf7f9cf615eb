"""The port's multi-process and multi-device polish path against the JAX
package, on the CPU (the kernels' plain versions):

- two ranks (``--nproc 2``) over a 12 kbp, 4-contig simulation, as
  threads through the orchestrator with the tile runner on the CPU
  device, and as two command-line processes with the host engine: the
  gathered FASTA equals hypo_tpu's one-process host-engine FASTA and
  hypo_tpu's own two-rank FASTA;
- the tile runner over two CPU devices (each tile split into two
  blocks of rows) against hypo_tpu's runner with ndev = 2: the same
  consensus, tile counts, host routing and rows per device, on the dry
  run's contig and through polish(); the tile program's bytes over 2-4
  devices equal one device's;
- device counts the runner must refuse.

Card tests (the ``cuda`` marker) hold the runner split over two blocks
on one card, and over two cards, against one block and the column-POA
spec.  Every compared value is bytes or an integer: tolerance 0."""
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from hypo_tpu.config import InputFlags as JInputFlags
from hypo_tpu.config import ScoreParams, get_kmer_len
from hypo_tpu.pipeline.polish import polish as jpolish
from hypo_tpu.pipeline.window import Window as JWindow
from hypo_tpu.poa import full_runner as jfull
from hypo_tpu.sim import SimConfig, simulate
from hypo_tpu_torch.cli import build_parser, flags_from_args
from hypo_tpu_torch.entry import (check_against_spec, dryrun_specs,
                                  make_contig)
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.polish import Polisher
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa import full_runner as tfull
from test_torch_device_full import SC, tile_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _md5(path):
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def _in_threads(fn, n):
    errs = []

    def run(pid):
        try:
            fn(pid)
        except Exception as e:  # reported below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs


@pytest.fixture(scope="module")
def sim4(tmp_path_factory):
    """A 12 kbp simulation in 4 contigs (test_e2e's sharded case), the
    md5 of hypo_tpu's one-process host-engine FASTA and of its own
    two-rank FASTA (ranks in threads, fresh aux directories)."""
    tmp = tmp_path_factory.mktemp("sim4")
    paths = simulate(SimConfig(genome_size=12000, num_contigs=4, seed=13),
                     str(tmp / "sim"))

    def flags(out, **kw):
        return JInputFlags(
            sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
            draft_filename=paths["draft"], output_filename=str(tmp / out),
            k=max(2, get_kmer_len(str(paths["genome_size"]))),
            cov=paths["short_cov"], use_device_poa=False, **kw)

    one = flags("jax_one.fa", aux_dir=str(tmp / "aux_one"))
    jpolish(one)
    _in_threads(lambda pid: jpolish(flags(
        "jax_two.fa", aux_dir=str(tmp / "aux_two"), num_processes=2,
        process_id=pid)), 2)
    md5 = _md5(one.output_filename)
    assert _md5(tmp / "jax_two.fa") == md5
    return paths, md5


def _argv(paths, out, aux, *extra):
    return ["-r", paths["reads"], "-d", paths["draft"], "-b",
            paths["sr_bam"], "-c", "30", "-s", str(paths["genome_size"]),
            "-t", "2", "-o", str(out), "--aux-dir", str(aux), *extra]


def test_two_ranks_in_threads_on_the_cpu_device(sim4, tmp_path):
    """--device-poa ranks: each polishes its contigs through the tile
    runner on the CPU device; rank 0 gathers."""
    paths, md5 = sim4
    out = tmp_path / "port.fa"
    polishers = [None, None]

    def rank(pid):
        flags = flags_from_args(build_parser().parse_args(_argv(
            paths, out, tmp_path / "aux", "--nproc", "2", "--procid",
            str(pid), "--device-poa")))
        polishers[pid] = Polisher(flags, device=CPU)
        polishers[pid].polish()

    _in_threads(rank, 2)
    assert _md5(out) == md5
    for pid in range(2):
        assert os.path.exists(f"{out}.shard{pid}.done")
    assert all(p.device_runner.stats["full_windows"] > 0 for p in polishers)


def test_two_rank_command_line_processes(sim4, tmp_path):
    """``python -m hypo_tpu_torch.cli --nproc 2 --procid {0,1}`` with the
    host engine, both processes started together."""
    paths, md5 = sim4
    out = tmp_path / "port.fa"
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("HYPO_POA_NDEV", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hypo_tpu_torch.cli",
         *_argv(paths, out, tmp_path / "aux", "--nproc", "2", "--procid",
                str(pid), "--no-device-poa")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (1, 0)]
    errs = []
    try:
        for p in procs:
            _so, se = p.communicate(timeout=120)
            errs.append((p.returncode, se.decode()[-1500:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, err in errs:
        assert rc == 0, err
    assert _md5(out) == md5


def test_runner_on_the_dry_run_contig_over_two_cpu_devices_equals_jax(
        monkeypatch):
    """run_polish_batch on the dry run's contig at four devices' count
    (80 device windows: two class-0 tiles and a class-1 tile of 64
    rows), the port over [cpu, cpu] and hypo_tpu with HYPO_POA_NDEV=2:
    the same consensus, tiles and rows per device; hypo_tpu counts the
    fallbacks under host_long_windows."""
    if not host_api.available():
        pytest.skip("the native host library did not build")
    sp = ScoreParams()
    specs = dryrun_specs(4)
    ctg = make_contig(specs)
    port = tfull.FullDeviceRunner(sp, [CPU, CPU])
    assert port.run_polish_batch([ctg]) == len(specs)
    monkeypatch.setenv("HYPO_POA_NDEV", "2")
    jctg = make_contig(specs, JWindow)
    jax_runner = jfull.FullDeviceRunner(sp)
    assert jax_runner.ndev == 2
    jax_runner.run_polish_batch([jctg])
    assert [w.consensus for w in ctg.windows] == \
        [w.consensus for w in jctg.windows]
    st, jst = port.stats, jax_runner.stats
    for key in ("full_dispatches", "full_windows", "full_overflows",
                "trivial_windows"):
        assert st[key] == jst[key], key
    assert st["host_long_windows"] + st["host_fallbacks"] == \
        jst["host_long_windows"]
    assert st["rows_per_device"] == jst["rows_per_device"].tolist()
    assert st["full_dispatches"] >= 3 and st["class_tiles"][1] >= 1
    assert st["host_fallbacks"] >= 2 and st["host_long_windows"] >= 2
    assert sum(st["rows_per_device"]) == st["full_windows"]
    assert min(st["rows_per_device"]) > 0
    check_against_spec(ctg, specs)


def test_runner_run_polish_batch_over_two_cpu_devices_equals_jax(
        sim4, tmp_path, monkeypatch):
    """polish() with --device-poa on the native tile path: the port's
    runner over [cpu, cpu] and hypo_tpu's with HYPO_POA_NDEV=2 write
    the host engine's FASTA with the same tiles and rows per device.
    hypo_tpu counts every host-routed window under host_long_windows,
    the port splits them into LONG windows and fallbacks."""
    if not host_api.available():
        pytest.skip("the native host library did not build")
    paths, md5 = sim4
    flags = flags_from_args(build_parser().parse_args(_argv(
        paths, tmp_path / "port.fa", tmp_path / "aux_port",
        "--device-poa")))
    port = Polisher(flags, device=[CPU, CPU])
    port.polish()
    monkeypatch.setenv("HYPO_POA_NDEV", "2")
    jflags = JInputFlags(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        draft_filename=paths["draft"],
        output_filename=str(tmp_path / "jax.fa"),
        aux_dir=str(tmp_path / "aux_jax"), k=flags.k, cov=30,
        use_device_poa=True, device_poa_mode="full")
    from hypo_tpu.pipeline.polish import Polisher as JPolisher
    jp = JPolisher(jflags)
    jp.polish()
    assert _md5(tmp_path / "port.fa") == _md5(tmp_path / "jax.fa") == md5
    st, jst = port.device_runner.stats, jp.device_runner.stats
    assert jp.device_runner.ndev == 2
    for key in ("full_dispatches", "full_windows", "full_overflows",
                "trivial_windows"):
        assert st[key] == jst[key], key
    assert st["host_long_windows"] + st["host_fallbacks"] == \
        jst["host_long_windows"]
    assert st["rows_per_device"] == jst["rows_per_device"].tolist()
    assert st["full_windows"] > 0 and min(st["rows_per_device"]) > 0


@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("case", ["class0_small", "class1_small"])
def test_tile_bytes_over_devices_equal_one_device(case, ndev):
    """A tile's rows split into ndev blocks (12 rows: 6, 4 or 3 a
    block, each looping to its own largest arm count) give the bytes of
    the one-device program."""
    L, N, K, P, B, tlen = {"class0_small": (40, 80, 6, 8, 12, 30),
                           "class1_small": (100, 200, 5, 8, 12, 80)}[case]
    tile, _specs = tile_inputs(7, B, K, L, tlen, 0.12, n_wild=1)
    tile[5][B // 2:] = np.minimum(tile[5][B // 2:], 2)  # ragged blocks
    kw = dict(N=N, L=L, K=K, P=P, B=B, A=tile[0].shape[0], **SC)
    one = TF.build_tile_program(**kw, devices=CPU)(*tile)
    split = TF.build_tile_program(**kw, devices=[CPU] * ndev)(*tile)
    assert split.dtype == torch.int8 and split.device == CPU
    assert np.array_equal(split.numpy(), one.numpy())
    assert one[0, N // 2 + 2] == 1                 # the wild window


@pytest.mark.parametrize("env,devices,message", [
    ("3", 2, "HYPO_POA_NDEV=3"),          # beyond the devices given
    ("0", 2, "HYPO_POA_NDEV=0"),
    (None, 3, "do not split"),            # 64-row CPU tile over 3
    (None, 9, "at most 8 CPU"),
])
def test_runner_refuses_device_counts(monkeypatch, env, devices, message):
    if env is None:
        monkeypatch.delenv("HYPO_POA_NDEV", raising=False)
    else:
        monkeypatch.setenv("HYPO_POA_NDEV", env)
    with pytest.raises(ValueError, match=message):
        tfull.FullDeviceRunner(ScoreParams(), [CPU] * devices)


def test_tile_program_refuses_uneven_blocks():
    with pytest.raises(ValueError, match="do not split"):
        TF.build_tile_program(N=80, L=40, K=6, P=8, B=12, A=72,
                              devices=[CPU] * 5, **SC)


def test_hypo_poa_ndev_caps_the_devices(monkeypatch):
    monkeypatch.setenv("HYPO_POA_NDEV", "2")
    runner = tfull.FullDeviceRunner(ScoreParams(), [CPU] * 4)
    assert runner.devices == [CPU, CPU]
    assert runner.stats["rows_per_device"] == [0, 0]


@pytest.fixture
def cuda_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one_card", "two_cards"])
def test_runner_split_on_the_card(cuda_devices, monkeypatch, layout):
    """Two blocks on cuda:0 twice, or on cuda:0 and cuda:1 (skipped with
    fewer than two cards)."""
    monkeypatch.delenv("HYPO_POA_NDEV", raising=False)
    if layout == "two_cards":
        if len(cuda_devices) < 2:
            pytest.skip("needs two CUDA cards")
        devices = cuda_devices[:2]
    else:
        devices = [cuda_devices[0]] * 2
    sp = ScoreParams()
    specs = dryrun_specs(2)
    runs = []
    for devs in (devices, devices[:1]):
        ctg = make_contig(specs)
        runner = tfull.FullDeviceRunner(sp, devs)
        runner.run_polish_batch([ctg])
        runs.append((ctg, runner))
    (c2, r2), (c1, _r1) = runs
    assert [w.consensus for w in c2.windows] == \
        [w.consensus for w in c1.windows]
    check_against_spec(c2, specs)
    rows = r2.stats["rows_per_device"]
    assert len(rows) == 2 and min(rows) > 0
    assert sum(rows) == r2.stats["full_windows"]
