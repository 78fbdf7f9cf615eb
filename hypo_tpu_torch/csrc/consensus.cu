// spoa heaviest-bundle consensus for a batch of windows, in rank space:
// the Hopper kernel behind hypo_tpu_torch.poa.cuda_consensus
// .heaviest_bundle.
//
// Replaces the Pallas TPU kernel hypo_tpu/poa/pallas_consensus.py
// (_build_kernel, pallas_call in heaviest_bundle_pallas), which runs the
// reference's sequential loop (external/spoa/src/graph.cpp:610-705) on
// the TPU's scalar core out of SMEM.  This kernel runs the same exact
// sequential algorithm with one thread per window:
//   - first pass: in rank order each node takes the in-edge with the
//     highest (weight, then predecessor score), later slots winning
//     ties; the first highest-scoring node is kept;
//   - branch completion, until the chosen node is an end node (at most
//     N rounds): ban (score -1) the other predecessors of the chosen
//     node's successors, reset and re-relax the suffix skipping banned
//     scores, and pick the new best starting from the rank of node id 0
//     with threshold 0;
//   - backtrack: codes and supports emitted backwards, then the length;
//     entries past the length are written 0.
// The Pallas kernel bit-packed its tables only to fit SMEM; here every
// field stays an unpacked int32 (tie rules unchanged).
//
// What bounds it: latency.  Each window is a dependent chain of loads
// (a node's score needs its predecessors' scores) with no arithmetic to
// speak of; the tables (class 0: 2,048 edges + 256 nodes per window,
// ~11 KB) come from global memory and stay in L2.  One warp per block
// spreads the B/32 warps over as many SMs as possible.  A warp per
// window with the tables in shared memory is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);

// Best in-edge of rank r; returns its score (-1 without a usable
// predecessor) and the chosen predecessor rank in *bpr (-1 if none).
__device__ __forceinline__ int relax(const int* __restrict__ pr,
                                     const int* __restrict__ pw, int cnt,
                                     const int* scores, bool banned,
                                     int* bpr_out) {
  int bw = -1, bpr = -1, bsc = kNeg;
  for (int p = 0; p < cnt; ++p) {
    const int q = pr[p];
    const int wt = pw[p];
    const int sc = scores[max(q, 0)];
    bool ok = q >= 0;
    if (banned) ok = ok && sc != -1;
    if (ok && (bw < wt || (bw == wt && bsc <= sc))) {
      bw = wt;
      bpr = q;
      bsc = sc;
    }
  }
  *bpr_out = bpr;
  return bpr >= 0 ? bw + bsc : -1;
}

__global__ void heaviest_bundle_kernel(
    const int* __restrict__ pred_ranks, const int* __restrict__ pred_w,
    const int* __restrict__ pred_cnt, const bool* __restrict__ is_end,
    const int* __restrict__ node_code, const int* __restrict__ node_sup,
    const int* __restrict__ n_nodes, const int* __restrict__ rank0,
    int* __restrict__ codes_bwd, int* __restrict__ sups_bwd,
    int* __restrict__ cons_len, int* scores_all, int* preds_all, int B,
    int N, int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long base = (long long)b * N;
  const int* pr = pred_ranks + base * P;
  const int* pw = pred_w + base * P;
  const int* pc = pred_cnt + base;
  const bool* ie = is_end + base;
  int* scores = scores_all + base;
  int* preds = preds_all + base;
  const int nn = min(max(n_nodes[b], 0), N);
  // slot 0 is always examined (pred_cnt >= 1 from the rank arrays)
  auto slots = [&](int v) { return min(max(pc[v], 1), P); };

  // first pass: relax in rank order, first maximum wins
  int msc = kNeg, mr = 0;
  for (int r = 0; r < nn; ++r) {
    int bpr;
    const int s = relax(pr + (long long)r * P, pw + (long long)r * P,
                        slots(r), scores, false, &bpr);
    scores[r] = s;
    preds[r] = bpr;
    if (msc < s) {
      msc = s;
      mr = r;
    }
  }

  // branch completion (graph.cpp:660-705)
  for (int it = 0; nn > 0 && !ie[max(mr, 0)] && it < N; ++it) {
    const int rb = mr;
    for (int v = 0; v < nn; ++v) {
      const int* pv = pr + (long long)v * P;
      const int cnt = slots(v);
      bool succ = false;
      for (int p = 0; p < cnt; ++p) succ |= pv[p] == rb;
      if (!succ) continue;
      for (int p = 0; p < cnt; ++p) {
        const int q = pv[p];
        if (q != rb && q >= 0) scores[q] = -1;
      }
    }
    int msc2 = 0, mr2 = rank0[b];
    for (int r = rb + 1; r < nn; ++r) {
      scores[r] = -1;
      preds[r] = -1;
      int bpr;
      const int s = relax(pr + (long long)r * P, pw + (long long)r * P,
                          slots(r), scores, true, &bpr);
      scores[r] = s;
      preds[r] = bpr;
      if (msc2 < s) {
        msc2 = s;
        mr2 = r;
      }
    }
    mr = mr2;
  }

  // backtrack (emitted backwards; the caller reverses)
  int r = nn > 0 ? mr : -1;
  int t = 0;
  while (r >= 0 && r < N && t < N) {
    codes_bwd[base + t] = node_code[base + r];
    sups_bwd[base + t] = node_sup[base + r];
    r = preds[r];
    ++t;
  }
  cons_len[b] = t;
  for (; t < N; ++t) {
    codes_bwd[base + t] = 0;
    sups_bwd[base + t] = 0;
  }
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors; returns the
// launch's cudaGetLastError().
int hypo_heaviest_bundle(const void* pred_ranks, const void* pred_w,
                         const void* pred_cnt, const void* is_end,
                         const void* node_code, const void* node_sup,
                         const void* n_nodes, const void* rank0,
                         void* codes_bwd, void* sups_bwd, void* cons_len,
                         void* scores, void* preds, int B, int N, int P,
                         void* stream) {
  if (B == 0) return 0;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  heaviest_bundle_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pred_ranks), static_cast<const int*>(pred_w),
      static_cast<const int*>(pred_cnt), static_cast<const bool*>(is_end),
      static_cast<const int*>(node_code), static_cast<const int*>(node_sup),
      static_cast<const int*>(n_nodes), static_cast<const int*>(rank0),
      static_cast<int*>(codes_bwd), static_cast<int*>(sups_bwd),
      static_cast<int*>(cons_len), static_cast<int*>(scores),
      static_cast<int*>(preds), B, N, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
