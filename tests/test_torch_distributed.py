"""The port's multi-process layer (hypo_tpu_torch.parallel) against the
JAX package's (hypo_tpu.parallel.distributed) on the same inputs: the
contig and read-file shards, the filesystem merge of k-mer counts, the
rank-0 FASTA gather, the all-reduce (one process, and two processes
over gloo on localhost), and the solid k-mers of a two-rank run against
one rank and against the JAX package's bitmask.  Every compared value
is an integer or a byte: tolerance 0."""
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from hypo_tpu.kmers.solid import SolidKmers as JSolidKmers
from hypo_tpu.parallel import distributed as jdist
from hypo_tpu_torch.config import InputFlags
from hypo_tpu_torch.io.fasta import read_fastx, write_fasta
from hypo_tpu_torch.kmers.solid import SolidKmers
from hypo_tpu_torch.parallel import distributed as dist
from hypo_tpu_torch.pipeline.polish import Polisher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LENGTHS = {
    "skewed": [100, 5000, 40, 40, 3000, 900, 10],
    "equal": [1000] * 6,
    "one": [12345],
    "two_big": [10, 90000, 80000, 10],
}


@pytest.mark.parametrize("shards", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_contig_and_file_shards_equal_jax(lengths, shards):
    """Contiguous contig ranges (9 shards is more than any list has
    contigs) and round-robin read files, for every rank."""
    ls = LENGTHS[lengths]
    got = dist.shard_contigs_contiguous(ls, shards)
    assert got == jdist.shard_contigs_contiguous(ls, shards)
    assert got[0][0] == 0 and got[-1][1] == len(ls)
    assert all(a <= b for a, b in got)
    paths = [f"r{i}.fq" for i in range(len(ls))]
    for pid in range(shards):
        assert dist.shard_files(paths, pid, shards) == \
            jdist.shard_files(paths, pid, shards)


def _in_threads(fn, n):
    """fn(rank) for every rank, each in its own thread (each blocks on
    the others' files, as processes would); returns the results."""
    results, errs = [None] * n, []

    def run(pid):
        try:
            results[pid] = fn(pid)
        except Exception as e:  # reported below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs
    return results


def test_merge_kmer_counts_files_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    parts = []
    for _ in range(2):
        codes = np.unique(rng.integers(0, 4 ** 8, 300)).astype(np.int64)
        parts.append((codes, rng.integers(1, 50, len(codes)).astype(
            np.uint64)))
    out = {}
    for name, mod in (("port", dist), ("jax", jdist)):
        aux = str(tmp_path / name)
        out[name] = _in_threads(
            lambda pid, mod=mod, aux=aux: mod.merge_kmer_counts_files(
                *parts[pid], aux, pid, 2, timeout_s=60), 2)
    want_c, want_n = out["jax"][0]
    assert len(want_c) > 300
    for codes, counts in out["port"]:
        assert np.array_equal(codes, want_c)
        assert np.array_equal(counts, want_n)
        assert counts.dtype == want_n.dtype


def test_gather_polished_fasta_draft_order_and_missing(tmp_path):
    out = str(tmp_path / "polished.fa")
    draft_order = ["c0 desc", "c1", "c2", "c3"]
    seqs = {n.split()[0]: "ACGT" * (i + 1)
            for i, n in enumerate(draft_order)}
    for pid, names in enumerate((["c1", "c3"], ["c0", "c2"])):
        sp = f"{out}.shard{pid}"
        write_fasta(sp, ((n, seqs[n]) for n in names))
        open(sp + ".done", "w").close()
    dist.gather_polished_fasta(out, 2, 1, draft_order)   # not rank 0
    assert not os.path.exists(out)
    dist.gather_polished_fasta(out, 2, 0, draft_order)
    want = str(tmp_path / "jax.fa")
    for pid in range(2):
        os.link(f"{out}.shard{pid}", f"{want}.shard{pid}")
        open(f"{want}.shard{pid}.done", "w").close()
    jdist.gather_polished_fasta(want, 2, 0, draft_order)
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert [n for n, _ in read_fastx(out)] == [n.split()[0]
                                               for n in draft_order]
    with pytest.raises(RuntimeError, match="missing contigs"):
        dist.gather_polished_fasta(out, 1, 0, draft_order + ["c9"])


def test_psum_is_the_identity_in_one_process():
    h = np.arange(17, dtype=np.int32)
    np.testing.assert_array_equal(dist.psum_across_hosts(h), h)
    np.testing.assert_array_equal(dist.merge_dense_counts_psum(h),
                                  jdist.merge_dense_counts_psum(h))
    assert dist.merge_histograms_psum is dist.psum_across_hosts
    assert dist.initialize() == (0, 1)


_TWO_PROC = r"""
import sys
import numpy as np
from hypo_tpu_torch.parallel import distributed as dist
pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
assert dist.initialize(f"127.0.0.1:{port}", nproc, pid) == (pid, nproc)
local = np.arange(64, dtype=np.int32) * (pid + 1)
np.save(f"{out}.rank{pid}.npy", dist.psum_across_hosts(local))
np.save(f"{out}.dense{pid}.npy", dist.merge_dense_counts_psum(local))
"""


def test_psum_two_processes_over_gloo(tmp_path):
    """Two processes join one gloo group through a localhost
    coordinator; both get the sum of their arrays."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "rank.py"
    script.write_text(_TWO_PROC)
    out = str(tmp_path / "psum")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(p), "2", str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    errs = []
    try:
        for p in procs:
            _so, se = p.communicate(timeout=120)
            errs.append((p.returncode, se.decode()[-800:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, err in errs:
        assert rc == 0, err
    want = np.arange(64, dtype=np.int32) * 3
    for pid in range(2):
        got = np.load(f"{out}.rank{pid}.npy")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.load(f"{out}.dense{pid}.npy"),
                                      want.astype(np.uint32))


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """600 reads of 80 bp from a random 4 kbp genome, in one FASTA file
    and split over three (k = 7, coverage 10)."""
    tmp = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(0)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(600):
        s = int(rng.integers(0, len(genome) - 80))
        reads.append(genome[s:s + 80])
    one = str(tmp / "reads.fa")
    write_fasta(one, ((f"r{i}", s) for i, s in enumerate(reads)))
    three = []
    for f in range(3):
        p = str(tmp / f"reads{f}.fa")
        write_fasta(p, ((f"r{i}", s) for i, s in enumerate(reads)
                        if i % 3 == f))
        three.append(p)
    return {"stride": [one], "files": three}


@pytest.mark.parametrize("split", ["stride", "files"])
def test_two_rank_solid_kmers_equal_one_rank_and_jax(read_files, tmp_path,
                                                      split):
    """The port's orchestrator with nproc 2: reads strided over the
    ranks (one file) or files dealt round robin (three files); both
    ranks' bitmasks equal one rank's and the JAX package's."""
    files = read_files[split]
    k, cov = 7, 10

    def flags(nproc, pid):
        return InputFlags(sr_filenames=files, k=k, cov=cov,
                          aux_dir=str(tmp_path / f"aux{nproc}"),
                          num_processes=nproc, process_id=pid)

    want = JSolidKmers(k).initialise(files, cov)
    assert want.get_num_solid_kmers() > 0
    one = Polisher(flags(1, 0))._get_solid_kmers()
    two = _in_threads(lambda pid: Polisher(flags(2, pid))._get_solid_kmers(),
                      2)
    for sk in [one] + two:
        assert isinstance(sk, SolidKmers)
        np.testing.assert_array_equal(sk.bitset.words, want.bitset.words)
        assert sk.get_num_solid_kmers() == want.get_num_solid_kmers()
    shards = sorted(os.listdir(tmp_path / "aux2"))
    assert shards == [f"kmer_counts.shard{p}.npz{e}" for p in range(2)
                      for e in ("", ".done")]
