"""Window consensus through the tile program on a PyTorch device: the
port of hypo_tpu.poa.full_runner.FullDeviceRunner's native tile path
(run_polish_batch).

The host side is hypo_tpu's, unchanged: the native job builder
(host_api.tile_jobs, via host_runner.build_batch_jobs) settles trivial
windows and deduplicates arms, host_api.tile_pack packs B windows into
a tile, host_api.tile_finalize unpacks the tile's output.  Each tile is
one call of the tile program (poa.device_full.build_tile_program) on
this runner's device, read back at once.

LONG windows (wtype != 0), windows that fit no shape class and windows
that overflow a class cap on the device go to the host engine
(engine.ConsensusEngine), as in the JAX package: that routing is part
of the algorithm.  Both are counted in ``stats``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from hypo_tpu.config import ScoreParams
from hypo_tpu.native import host_api
from hypo_tpu.poa.engine import ConsensusEngine
from hypo_tpu.poa.host_runner import build_batch_jobs, materialize_arms_bulk

from .device_full import build_tile_program

# shape classes: (L arm-length cap, N node/column cap, K distinct-arm
# cap, B batch tile, A arm-pool cap) — hypo_tpu full_runner.CLASSES
CLASSES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (126, 256, 16, 2048, 4096),
    (510, 1024, 16, 256, 512),
)
P_FULL = 8
# CPU tensors (tests only): padded windows are real compute, so the
# tile shrinks as in the JAX package off-TPU (full_runner.py:167-174)
_CPU_TILE_B = 64


class FullDeviceRunner:
    """run_polish_batch-compatible device engine over native tile jobs,
    computing on ``device`` (a CUDA device; CPU tensors in tests)."""

    def __init__(self, sp: ScoreParams, device, threads: int = 0):
        self.short_scores = (sp.sr_match, sp.sr_mismatch, sp.sr_gap)
        self.device = torch.device(device)
        self.threads = threads
        self.host_engine = ConsensusEngine(sp)
        self.stats = {"full_dispatches": 0, "full_windows": 0,
                      "full_overflows": 0, "trivial_windows": 0,
                      "host_long_windows": 0, "host_fallbacks": 0,
                      # per shape class (index into CLASSES)
                      "class_tiles": [0] * len(CLASSES),
                      "class_windows": [0] * len(CLASSES)}

    @staticmethod
    def supports_native_tiles() -> bool:
        return host_api.available()

    def _class_shape(self, ci: int):
        L, N, K, B, A = CLASSES[ci]
        if self.device.type == "cpu":
            B = _CPU_TILE_B
            A = 2 * B * K
        return L, N, K, B, A

    def _program(self, ci: int):
        L, N, K, B, A = self._class_shape(ci)
        m, n, g = self.short_scores
        return build_tile_program(N=N, L=L, K=K, P=P_FULL, m=m, n=n, g=g,
                                  B=B, A=A, device=self.device)

    def warm(self) -> None:
        """Build (or load) both kernels on a CUDA device, so the first
        tile pays no build cost.  Build errors propagate."""
        if self.device.type == "cuda":
            from .. import _build
            _build.load("poa_dp")
            _build.load("consensus")

    def run_polish_batch(self, contigs) -> int:
        jobs, job_refs, fallback, host_windows, count = build_batch_jobs(
            contigs, self.stats)
        self.stats["host_long_windows"] += len(host_windows)
        if jobs is not None:
            fallback.extend(self._run_tiles(jobs, job_refs))
        # host-engine leftovers: LONG windows (arms already materialized)
        # + fallbacks (arms rebuilt from the flat table, bulk per contig)
        self.stats["host_fallbacks"] += len(fallback)
        by_ctg: Dict[int, List[int]] = {}
        ctg_of = {}
        for ctg, wi in fallback:
            by_ctg.setdefault(id(ctg), []).append(wi)
            ctg_of[id(ctg)] = ctg
        for key, wis in by_ctg.items():
            ctg = ctg_of[key]
            materialize_arms_bulk(ctg, wis)
            host_windows.extend(ctg.windows[wi] for wi in wis)
        if host_windows:
            self.host_engine.generate_consensus_batch(host_windows,
                                                      self.threads)
        return count

    def _run_tiles(self, jobs, job_refs) -> List:
        """Run every job that fits a shape class through device tiles,
        assigning consensus in place; returns the (contig, window)
        refs left for the host engine (no class, or overflowed)."""
        nj = jobs.n_jobs
        job_th = np.zeros(nj, np.int32)     # short windows keep every base
        need_n = np.maximum(2 * jobs.job_maxlen, jobs.job_maxlen + 32)
        cls = np.full(nj, -1, np.int64)
        for ci, (L, N, K, _B, _A) in enumerate(CLASSES):
            ok = ((cls < 0) & (jobs.job_maxlen <= L) & (need_n <= N)
                  & (jobs.job_next <= K))
            cls[ok] = ci
        left = [job_refs[j] for j in np.nonzero(cls < 0)[0]]
        for ci in range(len(CLASSES)):
            idx = np.nonzero(cls == ci)[0]
            if not len(idx):
                continue
            order = np.ascontiguousarray(
                idx[np.lexsort((-jobs.job_maxlen[idx],
                                -jobs.job_next[idx]))], np.int64)
            L, N, K, B, A = self._class_shape(ci)
            tile_fn = self._program(ci)
            lo = 0
            while lo < len(order):
                hi, pool, plen, idxt, amode, aw, narms, th, row_of = \
                    host_api.tile_pack(order, lo, jobs, job_th, B, K, A, L,
                                       1)
                packed = tile_fn(pool, plen, idxt, amode, aw, narms,
                                 th).cpu().numpy()
                cnt = hi - lo
                out, out_len = host_api.tile_finalize(
                    packed, row_of[:cnt], cnt, 0, N)
                self.stats["full_dispatches"] += 1
                self.stats["full_windows"] += cnt
                self.stats["class_tiles"][ci] += 1
                self.stats["class_windows"][ci] += cnt
                for t in range(cnt):
                    ctg, wi = job_refs[order[lo + t]]
                    if out_len[t] < 0:
                        self.stats["full_overflows"] += 1
                        left.append((ctg, wi))
                    else:
                        ctg.windows[wi].consensus = \
                            out[t, :out_len[t]].tobytes().decode("latin1")
                lo = hi
        return left
