"""Multi-device helpers for the polishing pipeline.

The reference is single-node OpenMP (SURVEY §2.3); the scaling design
of the JAX package carries over:

- windows are embarrassingly parallel after arm fill -> the tile
  program (hypo_tpu_torch.poa.device_full.build_tile_program) splits
  its window batch into one contiguous block of rows per device;
- global k-mer count tables are merged with one all-reduce across
  processes (hypo_tpu_torch.parallel.distributed.merge_dense_counts_psum);
- contigs shard across processes (each streams its own BAM slice;
  distributed.shard_contigs_contiguous), which needs no communication
  inside the tile program.

Copied from hypo_tpu/parallel/mesh.py: ``make_mesh`` (a JAX device
mesh) becomes ``local_devices`` (a list of CUDA devices);
``make_example_inputs`` is unchanged.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def local_devices(n: Optional[int] = None) -> List[torch.device]:
    """The first ``n`` visible CUDA devices (all of them when ``n`` is
    None).  Raises if there are fewer than ``n``, or none."""
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise RuntimeError(f"local_devices: asked for {n} CUDA devices, "
                           f"{count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_example_inputs(B: int, N: int, L: int, Pcap: int, R: int,
                        rng_seed: int = 0):
    """Random-but-valid POA DP inputs (bench/tests): each window's graph
    is a simple chain of N nodes (a fresh backbone), arms are random."""
    rng = np.random.default_rng(rng_seed)
    node_code = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    pred_rows = np.zeros((B, N, Pcap), dtype=np.int32)
    pred_rows[:, :, 0] = np.arange(N)[None, :]  # chain: row r preds row r
    pred_cnt = np.ones((B, N), dtype=np.int32)
    is_end = np.zeros((B, N), dtype=bool)
    is_end[:, -1] = True
    n_nodes = np.full(B, N, dtype=np.int32)
    arm = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    arm_len = np.full(B, L, dtype=np.int32)
    mode = np.zeros(B, dtype=np.int32)
    reads = rng.integers(0, 4, size=(B, R)).astype(np.int32)
    return (node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len,
            mode, reads)
