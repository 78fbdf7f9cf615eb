"""The polish's input pass overlapped, on the CPU: the FASTQ inflated on
a thread of its own into the k-mer counter
(``kmers.counting.decoded_chunks``), and the first batch's short-read
alignments loaded beside the k-mer stage (``pipeline.polish._Prefetch``).

- the streamed counter's table is the sequential stream's and the NumPy
  path's, for FASTQ.gz and FASTA.gz, dense and sparse, with chunks small
  enough to give dozens of them (a chunk overwritten before it is
  counted would show);
- the polished FASTA is the pinned one, and with ``-p 1`` on a draft of
  four contigs (later batches load the old way) and on an ``-i``
  restart it is hypo_tpu's host engine's;
- a BAM naming a contig the draft lacks raises the sequential path's
  ``ValueError`` from ``polish()``, and an unreadable FASTQ its
  ``IOError``, with no producer thread left alive;
- with ``HYPO_TPU_NO_NATIVE=1`` the pass is sequential: no producer
  span, and ``pipeline.alignments_prefetched`` stays 0;
- with the recorder on, ``pipeline.fastq_decode`` and
  ``pipeline.bam_prefetch`` lie under the polish's root, on threads
  other than the polish's, and the counter reads 1 a polish.
"""
import gzip
import hashlib
import os
import threading

import numpy as np
import pytest

from hypo_tpu_torch import cli as tcli
from hypo_tpu_torch.config import InputFlags, get_kmer_len
from hypo_tpu_torch.io.fasta import read_fastx
from hypo_tpu_torch.kmers import counting
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.polish import polish
from hypo_tpu_torch.sim import SimConfig, simulate
from hypo_tpu_torch.utils import trace

PRODUCERS = ("hypo-fastq-decode", "hypo-bam-prefetch")
# hypo_tpu.cli --no-device-poa's FASTA of ``python -m hypo_tpu.sim
# --genome-size 60000 --short-cov 8 --seed 1`` polished with ``-c 8 -s
# 60k`` (test_torch_pipeline's MD5_60K_8X)
MD5_60K_8X = "843907f31cb7ab9c796681d6e7b93c6b"

pytestmark = pytest.mark.skipif(not host_api.available(),
                                reason="the native host library did not "
                                       "build")


def _md5(path):
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def _alive_producers():
    return [t.name for t in threading.enumerate() if t.name in PRODUCERS]


@pytest.fixture
def recorder():
    """The process's recorder, empty and on; off and empty after."""
    trace.RECORDER.reset()
    trace.enable()
    yield trace.RECORDER
    trace.disable()
    trace.RECORDER.reset()


@pytest.fixture(scope="module")
def sim20(tmp_path_factory):
    """A 20 kbp short-read simulation, its reads also as FASTA.gz in
    lines of 60 bases (a read over several lines)."""
    tmp = tmp_path_factory.mktemp("overlap20")
    paths = simulate(SimConfig(genome_size=20000, seed=5), str(tmp))
    fa = str(tmp / "reads.fa.gz")
    with gzip.open(fa, "wt") as fh:
        for name, seq in read_fastx(paths["reads"]):
            lines = "\n".join(seq[i:i + 60] for i in range(0, len(seq), 60))
            fh.write(f">{name}\n{lines}\n")
    return dict(paths, reads_fa=fa)


@pytest.mark.parametrize("k", [9, 15], ids=["dense", "sparse"])
@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_streamed_counter_equals_the_sequential_one(sim20, monkeypatch, fmt,
                                                    k):
    path = sim20["reads" if fmt == "fastq" else "reads_fa"]
    # 16 Ki codes a chunk: ~600 kbp of reads give dozens of chunks
    # (FASTA returns a chunk a read below 64 Ki)
    monkeypatch.setattr(counting, "FASTX_CHUNK", 1 << 14)
    assert sum(1 for _ in counting.decoded_chunks(path)) >= 20
    streamed = counting.count_files([path], k, cap=121, threads=2)
    assert (counting.KmerCounter(k).dense) == (k == 9)

    sequential = counting.KmerCounter(k, cap=121)
    for chunk in host_api.FastxCodeStream(path, 1 << 14):
        sequential.add_codes(chunk)
    codes, counts = streamed.items()
    want_codes, want_counts = sequential.items()
    assert len(codes) > 1000
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(counts, want_counts)
    if k == 9:
        np.testing.assert_array_equal(streamed._table, sequential._table)

    monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    plain = counting.count_files([path], k, cap=121)
    np.testing.assert_array_equal(plain.items()[0], want_codes)
    np.testing.assert_array_equal(plain.items()[1], want_counts)


def test_decoded_chunks_stay_valid_until_the_next_is_asked_for(sim20,
                                                               monkeypatch):
    """Every chunk held (copied) as it comes equals the sequential
    stream's chunk, though the producer decodes ahead into the ring."""
    path = sim20["reads"]
    monkeypatch.setattr(counting, "FASTX_CHUNK", 1 << 14)
    got = [c.copy() for c in counting.decoded_chunks(path)]
    want = [c.copy() for c in host_api.FastxCodeStream(path, 1 << 14)]
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not _alive_producers()


def test_many_streams_at_once_under_fast_thread_switches(sim20,
                                                       monkeypatch):
    """Twelve consumers, each with its own producer (more threads than
    cores), the interpreter switching threads every 10 us: each reads
    the sequential stream's codes."""
    import sys
    path = sim20["reads"]
    monkeypatch.setattr(counting, "FASTX_CHUNK", 1 << 12)
    want = np.concatenate([c.copy() for c in
                           host_api.FastxCodeStream(path, 1 << 12)])
    got = [None] * 12

    def consume(i):
        got[i] = np.concatenate([c.copy()
                                 for c in counting.decoded_chunks(path)])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=consume, args=(i,))
              for i in range(len(got))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    for g in got:
        np.testing.assert_array_equal(g, want)
    assert not _alive_producers()


def test_a_consumer_that_stops_early_ends_the_producer(sim20, monkeypatch):
    monkeypatch.setattr(counting, "FASTX_CHUNK", 1 << 14)
    gen = counting.decoded_chunks(sim20["reads"])
    next(gen)
    gen.close()
    assert not _alive_producers()


def _argv(paths, out, aux, *extra, cov=None, size=None):
    return ["-r", paths["reads"], "-d", paths["draft"], "-b",
            paths["sr_bam"], "-c", str(cov or paths["short_cov"]), "-s",
            str(size or paths["genome_size"]), "-t", "2", "-o", str(out),
            "--aux-dir", str(aux), "--no-device-poa", *extra]


def _counted(rec, name):
    return sum(n for c, n, *_ in rec.counts if c == name)


def test_polished_fasta_is_the_pinned_one(tmp_path, recorder):
    """The pinned 60 kbp simulation at 8x through the host engine, with
    both producers engaged."""
    paths = simulate(SimConfig(genome_size=60000, short_cov=8, seed=1),
                     str(tmp_path / "sim"))
    out = tmp_path / "port.fa"
    tcli.main(_argv(paths, out, tmp_path / "aux", cov=8, size="60k"))
    assert _md5(out) == MD5_60K_8X
    assert _counted(recorder, "pipeline.alignments_prefetched") == 1
    assert not _alive_producers()


@pytest.fixture(scope="module")
def sim4(tmp_path_factory):
    """A 12 kbp simulation in 4 contigs and the md5 of hypo_tpu's
    host-engine FASTA of it."""
    from hypo_tpu.config import InputFlags as JInputFlags
    from hypo_tpu.pipeline.polish import polish as jpolish
    tmp = tmp_path_factory.mktemp("overlap4")
    paths = simulate(SimConfig(genome_size=12000, num_contigs=4, seed=13),
                     str(tmp / "sim"))
    ref = JInputFlags(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        draft_filename=paths["draft"], output_filename=str(tmp / "jax.fa"),
        aux_dir=str(tmp / "aux_jax"),
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"], use_device_poa=False)
    jpolish(ref)
    return paths, _md5(ref.output_filename)


def test_batches_after_the_first_load_the_old_way(sim4, tmp_path, recorder):
    """-p 1: four batches; the first's alignments prefetched, the other
    three loaded in their batch."""
    paths, md5 = sim4
    out = tmp_path / "port.fa"
    tcli.main(_argv(paths, out, tmp_path / "aux", "-p", "1"))
    assert _md5(out) == md5
    assert _counted(recorder, "pipeline.alignments_prefetched") == 1
    loads = [s for s in recorder.spans
             if s.name == "pipeline.load_short_alignments"]
    assert len(loads) == 4
    assert len([s for s in recorder.spans
                if s.name == "pipeline.bam_prefetch"]) == 1


def test_a_restart_from_aux_still_prefetches(sim4, tmp_path, recorder):
    """-i twice: the second run loads the solid k-mers from aux/ (no
    decode) and still loads the BAM beside them."""
    paths, md5 = sim4
    argv = _argv(paths, tmp_path / "port.fa", tmp_path / "aux", "-i")
    tcli.main(argv)
    recorder.reset()
    tcli.main(argv)
    assert _md5(tmp_path / "port.fa") == md5
    names = {s.name for s in recorder.spans}
    assert "pipeline.fastq_decode" not in names
    assert "pipeline.bam_prefetch" in names
    assert _counted(recorder, "pipeline.alignments_prefetched") == 1


def _two_contig_sim_one_contig_draft(tmp_path):
    paths = simulate(SimConfig(genome_size=12000, num_contigs=2, seed=4),
                     str(tmp_path / "sim"))
    name, seq = next(iter(read_fastx(paths["draft"])))
    draft = tmp_path / "one.fa"
    draft.write_text(f">{name}\n{seq}\n")
    return dict(paths, draft=str(draft))


def _flags(paths, tmp_path):
    return InputFlags(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        draft_filename=paths["draft"],
        output_filename=str(tmp_path / "out.fa"),
        aux_dir=str(tmp_path / "aux"),
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"], use_device_poa=False, threads=2)


@pytest.mark.parametrize("native", [True, False])
def test_a_contig_missing_from_the_draft_raises_at_the_join(
        tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    paths = _two_contig_sim_one_contig_draft(tmp_path)
    with pytest.raises(ValueError) as e:
        polish(_flags(paths, tmp_path))
    assert str(e.value) == "contig id 1 in BAM not present in draft"
    assert not _alive_producers()


def test_an_error_in_the_kmer_stage_leaves_no_thread(tmp_path):
    paths = simulate(SimConfig(genome_size=12000, seed=4),
                     str(tmp_path / "sim"))
    paths = dict(paths, reads=str(tmp_path / "missing.fq.gz"))
    with pytest.raises(IOError, match="cannot open"):
        polish(_flags(paths, tmp_path))
    assert not _alive_producers()


def test_without_the_native_library_the_pass_is_sequential(
        sim20, tmp_path, monkeypatch, recorder):
    flags = _flags(sim20, tmp_path)
    polish(flags)
    native_md5 = _md5(flags.output_filename)
    recorder.reset()
    monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    polish(flags)
    assert _md5(flags.output_filename) == native_md5
    names = {s.name for s in recorder.spans}
    assert not names & {"pipeline.fastq_decode", "pipeline.bam_prefetch"}
    assert "pipeline.load_short_alignments" in names
    assert _counted(recorder, "pipeline.alignments_prefetched") == 0


def test_producer_spans_lie_under_the_polish(sim20, tmp_path, monkeypatch,
                                             recorder):
    monkeypatch.setattr(counting, "FASTX_CHUNK", 1 << 14)
    polish(_flags(sim20, tmp_path))
    (root,) = [s for s in recorder.spans if s.name == "polish"]
    by_id = {s.id: s for s in recorder.spans}
    for name in ("pipeline.fastq_decode", "pipeline.bam_prefetch"):
        spans = [s for s in recorder.spans if s.name == name]
        assert spans, name
        for s in spans:
            assert s.polish == root.id
            assert s.thread != root.thread and s.thread in PRODUCERS
            assert root.start <= s.start and s.end <= root.end
            assert by_id[s.parent].thread == root.thread
    decodes = [s for s in recorder.spans if s.name == "pipeline.fastq_decode"]
    assert len(decodes) >= 20
    (kmers,) = [s for s in recorder.spans if s.name == "pipeline.solid_kmers"]
    assert all(by_id[s.parent] is kmers for s in decodes)
    assert _counted(recorder, "pipeline.alignments_prefetched") == 1
    polishes = {p for _c, _n, _t, p, _th in recorder.counts}
    assert polishes == {root.id}
