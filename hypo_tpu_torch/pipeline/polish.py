"""The polishing orchestrator (reference src/Hypo.cpp Hypo::polish).

Pipeline per batch of contigs:
  contigs -> solid k-mers -> solid positions -> [stream short BAM] ->
  k-mer support -> SR/MegaWindows -> minimizer support -> window division
  -> short arms -> window fill/prune -> [optional long pass] -> POA
  consensus -> FASTA.

The input pass overlaps where both of its readers are native (the host
library and the native BAM stream): the FASTQ is inflated on a thread of
its own while the k-mers are counted (kmers.counting.decoded_chunks),
and the first batch's short-read alignments load on another thread
(``_Prefetch``) from the draft's load until ``_polish_batch`` joins it.
Otherwise the BAM loads in ``_polish_batch``, after the k-mer stage.

Stage checkpointing mirrors the reference's aux/ dir (-i): solid kmers in
``aux/solid_kmers.npz`` and ``aux/stage.txt`` appended per stage
(reference main.cpp:326-350, Hypo.cpp:49-77).

Window consensus runs either on the host engine or (use_device_poa) on
a CUDA device: mode ``full`` through the tile runner of
poa.full_runner, mode ``exact`` through the runner of poa.batch.  Mode
``full`` needs the native host and POA libraries (it exits before the
host stages without them); the host engine uses them when they load.
Asking for the device path without CUDA exits with an error: nothing
moves to the CPU quietly.

With ``num_processes`` > 1 each process polishes one contiguous range
of contigs (parallel.distributed): it counts k-mers over its share of
the reads, merges the counts with every other process through
``aux_dir``, skips its streams to its first contig, writes its shard of
the FASTA, and rank 0 gathers the shards in draft order.

Copied from hypo_tpu/pipeline/polish.py with its two device hooks
replaced (``_resolve_device_poa``: auto keeps the host engine, where
the JAX package probed for a TPU; ``_make_device_runner``: the port's
runners on the CUDA devices, or on the CPU device a test passes), and
with spans (``utils.trace``): the root ``polish`` from the Polisher's
construction to ``Overall``, ``pipeline.runner_setup``, and one
``pipeline.*`` span per Monitor stage; with the draft's load moved ahead
of the k-mer stage, and the first batch's alignments prefetched.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import STAGE_BEG, STAGE_SK, InputFlags
from ..io.bam import FDUP, FQCFAIL, FSECONDARY, FUNMAP, read_alignments
from ..io.fasta import read_fastx, write_fasta
from ..kmers.solid import SolidKmers
from ..poa.engine import ConsensusEngine
from ..segment.support import (update_minimisers_support,
                               update_solidkmers_support)
from ..utils import trace
from ..utils.monitor import Monitor
from .alignment import Alignment
from .contig import Contig


def open_stream(path: str, cname_to_id: Dict[str, int]):
    """Prefer the native (C++) streaming BAM loader; fall back to the
    pure-Python reader (also handles SAM and non-draft-ordered BAMs)."""
    if path.endswith(".bam"):
        from ..native import bam_api
        if bam_api.available():
            try:
                return _NativeStream(path, cname_to_id)
            except (ValueError, IOError):
                pass  # e.g. refs not in draft order -> python path
    return _BamStream(path, cname_to_id)


class _NativeStream:
    def __init__(self, path: str, cname_to_id: Dict[str, int]):
        from ..native import bam_api, host_api
        self.inner = bam_api.NativeBamStream(path, cname_to_id)
        # flat AlignmentViews need the native host stages to consume
        # them; with only the BAM lib present fall back to objects
        self.flat = host_api.available()

    def skip_until(self, final_cid: int) -> None:
        """Advance the stream past all records of contigs < final_cid
        (multi-process shard skip).  mapq threshold 256 > uint8 max drops
        every parsed record."""
        self.inner.load_until(final_cid, 256, None)

    def load_until(self, final_cid: int, min_mapq: int,
                   norm_edit_th=None, contig_lens=None):
        """Returns (store: cid -> AlignmentView | [Alignment], n_valid,
        n_invalid).  The flat view path materializes NO per-record
        Python objects (at human scale 20M Alignment objects cost
        ~20 GB RSS and minutes of construction)."""
        if self.flat:
            return self.inner.load_store(final_cid, min_mapq,
                                         norm_edit_th)
        recs, n, n_invalid = self.inner.load_until(final_cid, min_mapq,
                                                   norm_edit_th)
        store: Dict[int, List[Alignment]] = {}
        for cid, rb, re, codes, ops, lens, raw in recs:
            store.setdefault(cid, []).append(
                Alignment.from_parsed(rb, re, codes, ops, lens, raw))
        return store, n, n_invalid


class _BamStream:
    """One-pass BAM reader with a single-record lookahead so batch
    boundaries can be detected (reference Hypo.cpp:320-322 relies on the
    BAM being sorted in draft contig order)."""

    def __init__(self, path: str, cname_to_id: Dict[str, int]):
        refs, it = read_alignments(path)
        self.it = it
        self.tid_to_cid = {}
        for tid, (name, _len) in enumerate(refs):
            if name in cname_to_id:
                self.tid_to_cid[tid] = cname_to_id[name]
            # unknown names fail lazily, matching the reference error
        self.pending = None

    def records_until(self, final_cid: int):
        """Yield (cid, record) while cid < final_cid."""
        if self.pending is not None:
            cid, rec = self.pending
            if cid >= final_cid:
                return
            self.pending = None
            yield cid, rec
        for rec in self.it:
            if rec.flag & (FUNMAP | FSECONDARY | FQCFAIL | FDUP):
                continue
            if rec.tid < 0:
                continue
            if rec.tid not in self.tid_to_cid:
                raise ValueError(
                    f"contig id {rec.tid} in BAM not present in draft")
            cid = self.tid_to_cid[rec.tid]
            if cid >= final_cid:
                self.pending = (cid, rec)
                return
            yield cid, rec

    def skip_until(self, final_cid: int) -> None:
        """Advance the stream past all records of contigs < final_cid."""
        for _ in self.records_until(final_cid):
            pass

    def load_until(self, final_cid: int, min_mapq: int,
                   norm_edit_th=None, contig_lens=None):
        """Same contract as _NativeStream.load_until."""
        store: Dict[int, List[Alignment]] = {}
        n = n_invalid = 0
        for cid, rec in self.records_until(final_cid):
            if rec.mapq < min_mapq:
                continue
            aln = Alignment.from_record(rec, contig_lens[cid],
                                        norm_edit_th=norm_edit_th)
            if aln.is_valid:
                store.setdefault(cid, []).append(aln)
                n += 1
            else:
                n_invalid += 1
        return store, n, n_invalid


class _Prefetch:
    """The first batch's short-read alignments, loaded on a thread of
    their own (``pipeline.bam_prefetch``, under the span open here):
    the stream skipped to ``lo`` when it is past 0, then
    ``load_until(hi, ...)``.  ``join`` waits for them and returns
    ``load_until``'s result, or raises what the load raised.  The
    stream is the thread's until then."""

    def __init__(self, stream, lo: int, hi: int, min_mapq: int,
                 contig_lens: List[int]):
        self._result = self._error = None
        parent = trace.current()

        def run() -> None:
            try:
                with trace.under(parent), trace.span("pipeline.bam_prefetch"):
                    if lo > 0:
                        stream.skip_until(lo)
                    self._result = stream.load_until(
                        hi, min_mapq, contig_lens=contig_lens)
            except BaseException as e:  # raised by join
                self._error = e

        self.thread = threading.Thread(target=run, daemon=True,
                                       name="hypo-bam-prefetch")
        self.thread.start()

    def join(self):
        self.thread.join()
        err, self._error = self._error, None
        if err is not None:
            raise err
        result, self._result = self._result, None
        return result


def cuda_device() -> torch.device:
    """The current CUDA device; exits with an error when there is none."""
    if not torch.cuda.is_available():
        raise SystemExit("hypo_tpu_torch: --device-poa needs a CUDA device, "
                         "and torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device (the runner of mode ``full`` keeps the
    first ``HYPO_POA_NDEV`` of them); exits with an error when there is
    none."""
    from ..parallel.mesh import local_devices
    cuda_device()
    return local_devices()


class Polisher:
    """``device`` is where the device runner computes, a device or a
    list of devices (the tiles of mode ``full`` split into one block of
    rows per device): None means every visible CUDA device in mode
    ``full`` (at most ``HYPO_POA_NDEV``) and the current one in mode
    ``exact``; tests pass torch.device("cpu") to run the kernels' plain
    versions."""

    def __init__(self, flags: InputFlags, device=None):
        self.flags = flags
        self.device = device
        self.monitor = Monitor()
        self.contigs: List[Contig] = []
        self.no_long_reads = flags.lr_bam_filename == ""

    # -- solid kmers (Hypo.cpp:47-78) -------------------------------------
    def _get_solid_kmers(self) -> SolidKmers:
        f = self.flags
        skfile = os.path.join(f.aux_dir, "solid_kmers.npz")
        stagefile = os.path.join(f.aux_dir, "stage.txt")
        if f.intermed and f.done_stage >= STAGE_SK and os.path.exists(skfile):
            sk = SolidKmers.load(skfile)
            self.monitor.stop("[hypo_tpu] Loaded solid kmers. ")
            return sk
        if f.num_processes > 1:
            # distributed counting: each rank counts only its shard of
            # the read files; the per-kmer tables merge globally so the
            # selection semantics equal the reference's single KMC
            # database over ALL reads (suk/src/SolidKmers.cpp:104-190)
            from ..kmers.counting import KmerCounter, count_files
            from ..parallel.distributed import (merge_kmer_counts_files,
                                                shard_files)
            cap = 4 * f.cov + 1
            if len(f.sr_filenames) >= f.num_processes:
                mine = shard_files(f.sr_filenames, f.process_id,
                                   f.num_processes)
                counter = (count_files(mine, f.k, cap=cap,
                                       threads=f.threads) if mine
                           else KmerCounter(f.k, cap=cap))
            else:  # fewer files than ranks: stride over reads instead
                counter = count_files(f.sr_filenames, f.k, cap=cap,
                                      stride=f.num_processes,
                                      offset=f.process_id)
            codes, counts = counter.items()
            codes, counts = merge_kmer_counts_files(
                codes, counts, f.aux_dir, f.process_id, f.num_processes)
            sk = SolidKmers(f.k).initialise_from_counts(codes, counts,
                                                        f.cov)
        else:
            sk = SolidKmers(f.k).initialise(f.sr_filenames, f.cov,
                                            threads=f.threads)
        # checkpoints are written by rank 0 only (shared-fs race; every
        # process computes the identical bitmask deterministically)
        if f.intermed and f.process_id == 0:
            os.makedirs(f.aux_dir, exist_ok=True)
            sk.store(skfile)
            with open(stagefile, "a") as fh:
                fh.write(f"Stage:SolidKmers [{time.ctime()}]\t{STAGE_SK}\n")
        self.monitor.stop("[hypo_tpu] Computed solid kmers. ")
        return sk

    # -- main -------------------------------------------------------------
    def _resolve_device_poa(self) -> None:
        """use_device_poa=None means auto, which keeps the host engine
        (on short-read workloads it beats the device tile path end to
        end); --device-poa forces the device path."""
        if self.flags.use_device_poa is None:
            self.flags.use_device_poa = False

    def _make_device_runner(self):
        """The device consensus runner, its scores checked against the
        DP kernel's int16 cells (and mode ``full``'s native libraries
        checked) and its kernels built (or loaded), before the host
        stages start."""
        f = self.flags
        if not f.use_device_poa:
            return None
        from ..poa.batch import DeviceConsensusRunner
        from ..poa.full_runner import FullDeviceRunner
        runner_cls = (FullDeviceRunner if f.device_poa_mode == "full"
                      else DeviceConsensusRunner)
        try:
            runner_cls.check_scores(f.score_params,
                                    long_reads=not self.no_long_reads)
        except ValueError as e:
            raise SystemExit(f"hypo_tpu_torch: --device-poa-mode "
                             f"{f.device_poa_mode} cannot take these scores "
                             f"({e}); polish with --no-device-poa") from None
        if f.device_poa_mode == "full":
            from ..poa.host_runner import missing_native_libs
            missing = missing_native_libs()
            if missing:
                why = ("HYPO_TPU_NO_NATIVE is set"
                       if os.environ.get("HYPO_TPU_NO_NATIVE")
                       else "a failed build or load")
                raise SystemExit(
                    f"hypo_tpu_torch: --device-poa-mode full needs the "
                    f"native host and POA libraries, and {', '.join(missing)}"
                    f" did not load ({why}); polish with --device-poa-mode "
                    f"exact or --no-device-poa")
            runner = FullDeviceRunner(
                f.score_params, (self.device if self.device is not None
                                 else cuda_devices()), threads=f.threads)
        else:
            runner = DeviceConsensusRunner(
                f.score_params,
                self.device if self.device is not None else cuda_device())
        runner.warm()
        return runner

    def polish(self) -> None:
        f = self.flags
        mon = self.monitor
        if f.coordinator:
            from ..parallel import distributed as dist
            dist.initialize(f.coordinator, f.num_processes, f.process_id)
        self._resolve_device_poa()
        with trace.span("pipeline.runner_setup"):
            self.device_runner = self._make_device_runner()
        mon.start("pipeline.load_contigs")
        cname_to_id: Dict[str, int] = {}
        for cid, (name, seq) in enumerate(read_fastx(f.draft_filename)):
            cname_to_id[name] = cid
            self.contigs.append(Contig(cid, name, seq))
        mon.stop("[hypo_tpu] Loaded contigs. ")

        n_contigs = len(self.contigs)
        if f.num_processes > 1:
            from ..parallel.distributed import shard_contigs_contiguous
            shard_lo, shard_hi = shard_contigs_contiguous(
                [c.length for c in self.contigs],
                f.num_processes)[f.process_id]
            print(f"[hypo_tpu] shard {f.process_id}/{f.num_processes}: "
                  f"contigs [{shard_lo}, {shard_hi})")
        else:
            shard_lo, shard_hi = 0, n_contigs

        batch = f.processing_batch_size or max(1, shard_hi - shard_lo)
        sr_stream = open_stream(f.sr_bam_filename, cname_to_id)
        # a pure-Python load holds the GIL, and would only contend
        first = None
        if (isinstance(sr_stream, _NativeStream) and sr_stream.flat
                and shard_lo < shard_hi):
            first = _Prefetch(sr_stream, shard_lo,
                              min(shard_hi, shard_lo + batch),
                              f.map_qual_th,
                              [c.length for c in self.contigs])
        elif shard_lo > 0:
            sr_stream.skip_until(shard_lo)
        try:
            self._polish_shard(sr_stream, first, cname_to_id, shard_lo,
                               shard_hi, batch)
        finally:
            if first is not None:   # an error left it running
                first.thread.join()

        mon.start("pipeline.write")
        shard = self.contigs[shard_lo:shard_hi]
        if f.num_processes > 1:
            from ..parallel.distributed import gather_polished_fasta
            shard_path = f"{f.output_filename}.shard{f.process_id}"
            write_fasta(shard_path,
                        ((c.name, c.polished_seq(self.no_long_reads))
                         for c in shard))
            open(shard_path + ".done", "w").close()
            gather_polished_fasta(f.output_filename, f.num_processes,
                                  f.process_id,
                                  [c.name for c in self.contigs])
        else:
            write_fasta(f.output_filename,
                        ((c.name, c.polished_seq(self.no_long_reads))
                         for c in shard))
        mon.stop("[hypo_tpu] Wrote results. ")
        mon.root.set(draft_bp=sum(c.length for c in self.contigs),
                     contigs=n_contigs)
        mon.total("[hypo_tpu] Overall. ")

    def _polish_shard(self, sr_stream, first: Optional[_Prefetch],
                      cname_to_id: Dict[str, int], shard_lo: int,
                      shard_hi: int, batch: int) -> None:
        """The k-mer stage, the solid positions and the batches of
        contigs [shard_lo, shard_hi); ``first``, when there is one, is
        the first batch's alignments, loading meanwhile."""
        f = self.flags
        mon = self.monitor
        mon.start("pipeline.solid_kmers")
        sk = self._get_solid_kmers()
        print(f"[hypo_tpu] solid (canonical, non-HP) kmers: "
              f"{sk.get_num_solid_kmers()}")

        mon.start("pipeline.solid_positions")
        for ctg in self.contigs[shard_lo:shard_hi]:
            ctg.find_solid_pos(sk)
        mon.stop("[hypo_tpu] Found solid positions. ")

        lr_stream = (None if self.no_long_reads
                     else open_stream(f.lr_bam_filename, cname_to_id))
        if shard_lo > 0 and lr_stream is not None:
            lr_stream.skip_until(shard_lo)
        engine = ConsensusEngine(f.score_params)

        lo = shard_lo
        while lo < shard_hi:
            hi = min(shard_hi, lo + batch)
            self._polish_batch(sr_stream, lr_stream, engine, lo, hi,
                               first if lo == shard_lo else None)
            lo = hi

    def _polish_batch(self, sr_stream, lr_stream, engine, lo: int,
                      hi: int, prefetched: Optional[_Prefetch] = None
                      ) -> None:
        """Contigs [lo, hi); ``prefetched`` holds their short-read
        alignments when a thread loaded them (the span
        ``pipeline.load_short_alignments`` is then the wait for it)."""
        f = self.flags
        mon = self.monitor
        ws = f.window_settings
        mon.start("pipeline.load_short_alignments")
        clens = [c.length for c in self.contigs]
        if prefetched is not None:
            loaded, num_alns, num_invalid = prefetched.join()
            trace.count("pipeline.alignments_prefetched", 1)
        else:
            loaded, num_alns, num_invalid = sr_stream.load_until(
                hi, f.map_qual_th, contig_lens=clens)
        store: Dict[int, List[Alignment]] = {c: [] for c in range(lo, hi)}
        store.update(loaded)
        mon.stop(f"[hypo_tpu] Loaded {num_alns} short alignments "
                 f"({num_invalid} invalid). ")

        from ..native import host_api
        native_host = host_api.available()

        mon.start("pipeline.kmer_support")
        for cid in range(lo, hi):
            if native_host:
                host_api.skmer_support(self.contigs[cid], store[cid], f.k,
                                       f.threads)
            else:
                update_solidkmers_support(self.contigs[cid], store[cid],
                                          f.k)
        mon.stop("[hypo_tpu] Solid kmer support. ")

        mon.start("pipeline.strong_regions")
        for cid in range(lo, hi):
            self.contigs[cid].prepare_for_division(f.k, ws)
        num_sr = sum(c.num_sr for c in self.contigs[lo:hi])
        len_sr = sum(c.len_sr for c in self.contigs[lo:hi])
        print(f"[hypo_tpu] SRs: {num_sr} covering {len_sr} bp")
        mon.stop("[hypo_tpu] Strong regions. ")

        mon.start("pipeline.minimizer_support")
        for cid in range(lo, hi):
            if native_host:
                from ..config import MINIMIZER_SETTINGS as MS
                host_api.minimizer_support(self.contigs[cid], store[cid],
                                           MS.k, MS.w, f.threads)
            else:
                update_minimisers_support(self.contigs[cid], store[cid])
        mon.stop("[hypo_tpu] Minimizer support. ")

        mon.start("pipeline.window_division")
        for cid in range(lo, hi):
            self.contigs[cid].divide_into_regions(ws)
        mon.stop("[hypo_tpu] Window division. ")

        from ..config import ARMS_SETTINGS, MINIMIZER_SETTINGS as MS2
        # tile fast path: window consensus reads arms straight from
        # the flat native arm table (no per-window Python arm lists).
        # The same native job builder feeds either engine: device tiles
        # (FullDeviceRunner) or the OpenMP jobs-consensus
        # (HostTileRunner); exact mode takes run_windows.
        from ..poa.host_runner import HostTileRunner, missing_native_libs
        tile_runner = self.device_runner
        if f.use_device_poa and f.device_poa_mode == "exact":
            tile_runner = None
        elif tile_runner is None and not missing_native_libs():
            tile_runner = HostTileRunner(f.score_params, threads=f.threads)
        fast_tiles = tile_runner is not None
        mon.start("pipeline.short_arms")
        arm_tables: Dict[int, tuple] = {}
        for cid in range(lo, hi):
            ctg = self.contigs[cid]
            if native_host:
                arm_tables[cid] = host_api.find_arms(
                    ctg, store[cid], f.k, MS2.k, False,
                    ARMS_SETTINGS.short_arm_coef, f.threads)
                if fast_tiles:
                    alns = store[cid]
                    if hasattr(alns, "seq"):   # flat AlignmentView
                        ctg._device_arm_data = (arm_tables[cid],
                                                alns.seq, alns.seq_off)
                    else:
                        buf, off, _rb, _re = host_api._pack_alignments(
                            alns)
                        ctg._device_arm_data = (arm_tables[cid], buf,
                                                off)
            else:
                for aln in store[cid]:
                    aln.find_short_arms(f.k, ctg)
        if native_host:
            host_api.clear_pack_cache()
        mon.stop("[hypo_tpu] Short arms. ")

        mon.start("pipeline.window_fill")
        for cid in range(lo, hi):
            if fast_tiles:
                self.contigs[cid].fill_short_windows_from_table(
                    arm_tables.pop(cid))
            elif native_host:
                self.contigs[cid].add_arm_table(store[cid],
                                                arm_tables.pop(cid))
                self.contigs[cid].fill_short_windows([])
            else:
                self.contigs[cid].fill_short_windows(store[cid])
            store[cid] = []
        mon.stop("[hypo_tpu] Window fill. ")

        if lr_stream is not None:
            mon.start("pipeline.long_arms")
            with trace.span("pipeline.long_load"):
                lloaded, _n, _ninv = lr_stream.load_until(
                    hi, f.map_qual_th, norm_edit_th=f.norm_edit_th,
                    contig_lens=clens)
            with trace.span("pipeline.long_find"):
                lstore: Dict[int, List[Alignment]] = {
                    c: [] for c in range(lo, hi)}
                lstore.update(lloaded)
                for cid in range(lo, hi):
                    self.contigs[cid].prepare_long_windows(ws)
                for cid in range(lo, hi):
                    ctg = self.contigs[cid]
                    if native_host:
                        table = host_api.find_arms(
                            ctg, lstore[cid], f.k, MS2.k, True,
                            ARMS_SETTINGS.short_arm_coef, f.threads)
                        ctg.add_arm_table(lstore[cid], table)
                        ctg.fill_long_windows([])
                    else:
                        for aln in lstore[cid]:
                            aln.find_long_arms(ctg)
                        ctg.fill_long_windows(lstore[cid])
                    lstore[cid] = []
                if native_host:
                    host_api.clear_pack_cache()
            mon.stop("[hypo_tpu] Long arms. ")

        mon.start("pipeline.poa")
        nwin = 0
        if fast_tiles:
            nwin += tile_runner.run_polish_batch(
                self.contigs[lo:hi])
            for cid in range(lo, hi):
                ctg = self.contigs[cid]
                ctg._device_arm_data = None
                for w in ctg.windows:
                    if w is not None:
                        w.clear_arms()
        else:
            all_windows = [w for cid in range(lo, hi)
                           for w in self.contigs[cid].windows
                           if w is not None]
            if self.device_runner is not None:
                nwin += self.device_runner.run_windows(all_windows)
            else:
                nwin += engine.generate_consensus_batch(all_windows,
                                                        f.threads)
            for w in all_windows:
                w.clear_arms()  # arms are dead once consensus is set
        mon.stop(f"[hypo_tpu] POA over {nwin} windows. ")

        if f.inspect:
            os.makedirs(f.aux_dir, exist_ok=True)
            mode = "w" if lo == 0 else "a"
            with open(os.path.join(f.aux_dir, "regions.bed"), mode) as fh:
                for cid in range(lo, hi):
                    self.contigs[cid].write_bed(fh)
            with open(os.path.join(f.aux_dir, "inspect.txt"), mode) as fh:
                for cid in range(lo, hi):
                    self.contigs[cid].write_window_dump(fh)


def polish(flags: InputFlags, device=None) -> Polisher:
    """Polish per ``flags``; returns the Polisher (its ``device_runner``
    holds the device path's stats)."""
    p = Polisher(flags, device)
    p.polish()
    return p
