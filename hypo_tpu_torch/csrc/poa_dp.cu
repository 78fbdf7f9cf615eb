// Graph-vs-arm POA DP for a batch of windows: the Hopper kernel behind
// hypo_tpu_torch.poa.cuda_poa.poa_dp_batch.
//
// Replaces the Pallas TPU kernel hypo_tpu/poa/pallas_poa.py
// (_build_kernel, pallas_call in _build_run).  Same contract as the
// plain version hypo_tpu_torch/poa/dp.py:poa_dp_batch_ref: linear-gap
// DP of a topologically ranked graph (rows) against one arm (columns);
// int8 backpointers with the reference's tie order (diagonal via
// predecessor 0..P-1, then vertical via 0..P-1, then horizontal; first
// hit wins); max_row = 1 + first best eligible row in column arm_len.
//
// What bounds it: neither bytes nor FLOPs.  A window is ~N*L = 32K
// cells of a few integer operations each, but row r+1 needs rows of
// arbitrary earlier ranks and the in-row horizontal gap is a prefix max,
// so a window is a serial chain of N dependent row steps, each a
// latency-bound block-wide scan.  Design: one CTA per window (B CTAs
// fill the 132 SMs many times over) and one thread per column, so a row
// is one parallel step; the prefix max is a warp shuffle scan plus one
// shared-memory pass over the warp totals; the block loops only to its
// own window's n_nodes (the Pallas kernel ran to the block maximum).
// H lives in global memory ([B, N+1, L+1] int32 scratch, 267 MB for the
// class-0 tile) and stays mostly in L2 for the rows a window touches;
// moving H into shared memory (class 0) or a row ring (class 1) is
// later work.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg16 = -16384;     // cell sentinel (pallas_poa.NEG)
constexpr int kPMax = 8;           // predecessor slots (full_runner.P_FULL)
constexpr int kLow = INT_MIN / 4;  // below every cell; no overflow on +/-
constexpr int kLov = 1, kRov = 2;

// Inclusive prefix max over the threads of the block, in thread order.
__device__ __forceinline__ int block_prefix_max(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, o);
  }
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nwarps ? warp_tot[lane] : kLow;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = max(t, o);
    }
    if (lane < nwarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = max(v, warp_tot[wid - 1]);
  return v;
}

__global__ void __launch_bounds__(1024) poa_dp_kernel(
    const int* __restrict__ node_code, const int* __restrict__ pred_rows,
    const int* __restrict__ pred_cnt, const bool* __restrict__ is_end,
    const int* __restrict__ n_nodes, const int* __restrict__ arm,
    const int* __restrict__ arm_len, const int* __restrict__ mode,
    int8_t* __restrict__ bp, int* __restrict__ max_row, int* H, int N,
    int L, int P, int m, int n, int g) {
  __shared__ int warp_tot[32];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int W = L + 1;
  const bool in_row = j <= L;
  const long long plane = (long long)b * (N + 1) * W;
  int* Hb = H + plane;
  int8_t* bpb = bp + plane;
  const int md = mode[b];
  const int nn = min(max(n_nodes[b], 0), N);
  const int alen = min(max(arm_len[b], 0), L);
  const int base = (in_row && j >= 1) ? arm[(long long)b * L + j - 1] : -1;
  const int jg = j * g;
  if (in_row) {
    Hb[j] = jg;
    bpb[j] = 0;
  }
  int best_v = kNeg16, best_r = 0;  // running first-argmax (owner: j == alen)
  __syncthreads();

  for (int r = 0; r < nn; ++r) {
    const long long nr = (long long)b * N + r;
    const int code = node_code[nr];
    const int cnt = pred_cnt[nr];
    const int* pr = pred_rows + nr * P;
    const int prof = (base == code) ? m : n;
    int h0[kPMax], diag[kPMax], vert[kPMax];
    int tmp = kLow, c0 = kLow;
#pragma unroll
    for (int p = 0; p < kPMax; ++p) {
      // unused slots read as the sentinel row, as in the plain version
      int hj = kNeg16, hjm1 = kNeg16;
      if (p < P && p < cnt && in_row) {
        const int row = min(max(pr[p], 0), N);
        const int* Hr = Hb + (long long)row * W;
        hj = Hr[j];
        if (j > 0) hjm1 = Hr[j - 1];
      }
      h0[p] = hj;
      diag[p] = hjm1 + prof;
      vert[p] = hj + g;
      if (p < P) {
        tmp = max(tmp, max(diag[p], vert[p]));
        c0 = max(c0, hj);
      }
    }
    const int col0 = (md == kRov) ? 0 : c0 + g;
    const int val = (j == 0) ? col0 : tmp;
    const int run = block_prefix_max(in_row ? val - jg : kLow, warp_tot);
    const int h = run + jg;
    if (in_row) {
      int c;
      if (j == 0) {
        c = P;
#pragma unroll
        for (int p = kPMax - 1; p >= 0; --p)
          if (p < P && h0[p] + g == col0) c = P + p;
      } else {
        c = 2 * P;
#pragma unroll
        for (int p = kPMax - 1; p >= 0; --p)
          if (p < P && vert[p] == h) c = P + p;
#pragma unroll
        for (int p = kPMax - 1; p >= 0; --p)
          if (p < P && diag[p] == h) c = p;
      }
      Hb[(long long)(r + 1) * W + j] = h;
      bpb[(long long)(r + 1) * W + j] = (int8_t)c;
      if (j == alen && (md == kLov || is_end[nr]) && h > best_v) {
        best_v = h;
        best_r = r;
      }
    }
    __syncthreads();  // row r+1 complete before any later row reads it
  }
  if (j == alen) max_row[b] = best_r + 1;
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors; returns the
// launch's cudaGetLastError().
int hypo_poa_dp(const void* node_code, const void* pred_rows,
                const void* pred_cnt, const void* is_end,
                const void* n_nodes, const void* arm, const void* arm_len,
                const void* mode, void* bp, void* max_row, void* H, int B,
                int N, int L, int P, int m, int n, int g, void* stream) {
  if (B == 0) return 0;
  const int threads = ((L + 1 + 31) / 32) * 32;
  poa_dp_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_code), static_cast<const int*>(pred_rows),
      static_cast<const int*>(pred_cnt), static_cast<const bool*>(is_end),
      static_cast<const int*>(n_nodes), static_cast<const int*>(arm),
      static_cast<const int*>(arm_len), static_cast<const int*>(mode),
      static_cast<int8_t*>(bp), static_cast<int*>(max_row),
      static_cast<int*>(H), N, L, P, m, n, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
