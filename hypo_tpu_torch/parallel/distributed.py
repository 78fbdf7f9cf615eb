"""Multi-process distribution for the polishing pipeline.

The reference is a single OpenMP process (SURVEY §2.3); its only scaling
knob beyond threads is contig batching.  The layout over several
processes (one host or many):

- **Contigs shard across processes** (size-balanced contiguous ranges,
  no communication while polishing): each process streams its own
  slice of the BAM (the draft-contig-sorted order lets every process
  skip to its shard) and polishes its contigs end to end.
- **Solid k-mers are global state**: every process must see counts from
  ALL reads.  Read files (or reads) are sharded across processes; the
  per-k-mer tables merge through the shared filesystem
  (``merge_kmer_counts_files``), or dense tables with one all-reduce
  (``merge_dense_counts_psum``).
- **Output gathers at rank 0**: processes write per-shard FASTA; rank 0
  concatenates in draft order (a filesystem gather: polished contigs
  are host data).

The reductions run on ``torch.distributed`` with the gloo backend, on
CPU tensors: the arrays are host state (k-mer tables), no device path
sits behind them, and NCCL could not put two ranks on one GPU, which is
the layout of a one-card run.  On a single process everything degrades
to the local path, which keeps this module testable without a cluster.

Copied from hypo_tpu/parallel/distributed.py: ``initialize`` and
``psum_across_hosts`` are on torch.distributed (jax.distributed and a
pmap psum there); the JAX-free helpers are unchanged, quirks included
(see ``merge_kmer_counts_files`` and ``gather_polished_fasta``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """torch.distributed glue: with a coordinator (``host:port``, which
    rank 0 serves), join the gloo process group of ``num_processes``
    as rank ``process_id``.  Returns (rank, world size) of the group,
    or (0, 1) when there is no coordinator and no group."""
    if coordinator_address and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_contigs_contiguous(lengths: Sequence[int], num_shards: int
                             ) -> List[Tuple[int, int]]:
    """Split contigs into ``num_shards`` contiguous [lo, hi) ranges with
    roughly balanced total length.  Contiguity lets every host stream
    exactly its slice of the draft-contig-sorted BAM (skip to lo, stop
    at hi) with no index.  Deterministic across hosts."""
    total = sum(int(x) for x in lengths)
    n = len(lengths)
    bounds = [0]
    acc = 0
    for s in range(1, num_shards):
        target = total * s / num_shards
        lo = bounds[-1]
        cut = lo
        while cut < n and (acc + lengths[cut] / 2.0) < target:
            acc += int(lengths[cut])
            cut += 1
        # never produce an empty middle shard while contigs remain
        cut = min(max(cut, lo), n)
        bounds.append(cut)
    bounds.append(n)
    return [(bounds[i], bounds[i + 1]) for i in range(num_shards)]


def shard_files(paths: Sequence[str], process_id: int,
                num_processes: int) -> List[str]:
    """Round-robin read-file assignment for distributed k-mer counting."""
    return [p for i, p in enumerate(paths)
            if i % num_processes == process_id]


def psum_across_hosts(arr: np.ndarray) -> np.ndarray:
    """Sum an identically-shaped per-process array across all processes
    with one all-reduce (gloo, on a CPU tensor); the result is identical
    on every process.  The identity when no process group is
    initialised, as the JAX package's single-process psum is."""
    h = np.array(arr)
    if not (dist.is_available() and dist.is_initialized()):
        return h
    t = torch.from_numpy(h)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


# back-compat name: the histogram merge is the same reduction
merge_histograms_psum = psum_across_hosts


def merge_dense_counts_psum(table: np.ndarray) -> np.ndarray:
    """Global per-kmer count merge for DENSE tables (4^k fits memory):
    one all-reduce of the full table — the distributed replacement for
    the reference's single KMC database over all read files
    (external/suk/src/SolidKmers.cpp:104-190)."""
    return psum_across_hosts(np.asarray(table, np.int32)).astype(
        np.uint32)


def merge_kmer_counts_files(codes: np.ndarray, counts: np.ndarray,
                            aux_dir: str, process_id: int,
                            num_processes: int,
                            timeout_s: float = 3600.0):
    """Filesystem-based global per-kmer count merge (sparse tables,
    any k): every rank writes its local shard's (codes, counts) to
    ``aux_dir/kmer_counts.shard{pid}.npz`` plus a ``.done`` marker,
    waits for all shards, and computes the identical merged table.
    This is the command line's multi-process mode (shared filesystem,
    like the output gather); with a process group, dense tables can use
    merge_dense_counts_psum instead.

    Quirk of the reference, kept: the wait is for the ``.done`` markers
    only, so a rerun into an ``aux_dir`` that still holds an earlier
    run's shards and markers may read those old shards.  Give each run
    a fresh ``aux_dir``."""
    import time
    os.makedirs(aux_dir, exist_ok=True)
    shard = os.path.join(aux_dir, f"kmer_counts.shard{process_id}.npz")
    tmp = shard + f".tmp{process_id}.npz"
    np.savez(tmp, codes=codes, counts=counts.astype(np.uint64))
    os.replace(tmp, shard)
    open(shard + ".done", "w").close()
    parts_c, parts_n = [], []
    deadline = time.time() + timeout_s
    for p in range(num_processes):
        sp = os.path.join(aux_dir, f"kmer_counts.shard{p}.npz")
        while not os.path.exists(sp + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"kmer count shard never arrived: {sp}")
            time.sleep(0.2)
        with np.load(sp) as z:
            parts_c.append(z["codes"])
            parts_n.append(z["counts"])
    allc = np.concatenate(parts_c)
    alln = np.concatenate(parts_n)
    if len(allc) == 0:
        return allc, alln
    order = np.argsort(allc, kind="stable")
    allc = allc[order]
    alln = alln[order]
    uniq, start = np.unique(allc, return_index=True)
    sums = np.add.reduceat(alln, start)
    return uniq, sums


def gather_polished_fasta(out_path: str, num_processes: int,
                          process_id: int,
                          draft_order: Sequence[str],
                          timeout_s: float = 3600.0) -> None:
    """Rank-0 filesystem gather: every host writes
    ``{out_path}.shard{pid}`` followed by an empty ``.done`` marker;
    rank 0 waits for all shards and concatenates records back into
    draft order (``draft_order`` = contig names in draft-FASTA order,
    known identically on every host).

    Quirk of the reference, kept: as in merge_kmer_counts_files, a
    ``.done`` marker left by an earlier run into the same output path
    lets rank 0 read that run's shard.  Write each run to a fresh
    path."""
    import time

    from ..io.fasta import read_fastx, write_fasta
    if process_id != 0:
        return
    shard_paths = [f"{out_path}.shard{p}" for p in range(num_processes)]
    deadline = time.time() + timeout_s
    for p in shard_paths:
        while not os.path.exists(p + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"shard never arrived: {p}")
            time.sleep(1)
    by_name = {}
    for p in shard_paths:
        for name, seq in read_fastx(p):
            by_name[name.split()[0]] = seq
    missing = [n for n in draft_order if n.split()[0] not in by_name]
    if missing:
        raise RuntimeError(f"gather missing contigs: {missing[:5]}")
    write_fasta(out_path,
                ((n, by_name[n.split()[0]]) for n in draft_order))
