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
// fill the 132 SMs many times over); each thread owns PER consecutive
// columns (PER = 1 up to 1,024 columns, the tile classes; PER = 2 up to
// 2,048, exact mode's L = 1024 buckets), so a row is one parallel step:
// a serial max over the thread's own columns, a block-wide exclusive
// prefix max over the threads' totals (warp shuffle scan plus one
// shared-memory pass over the warp totals), applied back down the
// columns.  The block loops only to its own window's n_nodes (the
// Pallas kernel ran to the block maximum).  H lives in global memory
// ([B, N+1, L+1] int32 scratch, 267 MB for the class-0 tile) and stays
// mostly in L2 for the rows a window touches; moving H into shared
// memory (class 0) or a row ring (class 1) is later work.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg16 = -16384;     // cell sentinel (pallas_poa.NEG)
constexpr int kPMax = 8;           // predecessor slots (full_runner.P_FULL)
constexpr int kLow = INT_MIN / 4;  // below every cell; no overflow on +/-
constexpr int kLov = 1, kRov = 2;

// Exclusive prefix max over the threads of the block, in thread order
// (kLow for thread 0).
__device__ __forceinline__ int block_excl_prefix_max(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, o);
  }
  int excl = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) excl = kLow;
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
  if (wid > 0) excl = max(excl, warp_tot[wid - 1]);
  return excl;
}

// Thread t owns columns t*PER .. t*PER + PER - 1 of every row.
template <int PER>
__global__ void __launch_bounds__(1024) poa_dp_kernel(
    const int* __restrict__ node_code, const int* __restrict__ pred_rows,
    const int* __restrict__ pred_cnt, const bool* __restrict__ is_end,
    const int* __restrict__ n_nodes, const int* __restrict__ arm,
    const int* __restrict__ arm_len, const int* __restrict__ mode,
    int8_t* __restrict__ bp, int* __restrict__ max_row, int* H, int N,
    int L, int P, int m, int n, int g) {
  __shared__ int warp_tot[32];
  const int b = blockIdx.x;
  const int j0 = threadIdx.x * PER;
  const int W = L + 1;
  const long long plane = (long long)b * (N + 1) * W;
  int* Hb = H + plane;
  int8_t* bpb = bp + plane;
  const int md = mode[b];
  const int nn = min(max(n_nodes[b], 0), N);
  const int alen = min(max(arm_len[b], 0), L);
  // the column this thread holds the running first-argmax for, or -1
  const int own_q = (alen >= j0 && alen < j0 + PER) ? alen - j0 : -1;
  int base[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = j0 + q;
    base[q] = (j >= 1 && j <= L) ? arm[(long long)b * L + j - 1] : -1;
    if (j <= L) {
      Hb[j] = j * g;
      bpb[j] = 0;
    }
  }
  int best_v = kNeg16, best_r = 0;
  __syncthreads();

  for (int r = 0; r < nn; ++r) {
    const long long nr = (long long)b * N + r;
    const int code = node_code[nr];
    const int cnt = pred_cnt[nr];
    const int* pr = pred_rows + nr * P;
    int diag[PER][kPMax], vert[PER][kPMax], tmp[PER];
    int c0 = kLow;
#pragma unroll
    for (int q = 0; q < PER; ++q) tmp[q] = kLow;
#pragma unroll
    for (int p = 0; p < kPMax; ++p) {
      // unused slots read as the sentinel row, as in the plain version
      const bool used = p < P && p < cnt;
      const int* Hr = Hb + (long long)(used ? min(max(pr[p], 0), N) : 0) * W;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = j0 + q;
        int hj = kNeg16, hjm1 = kNeg16;
        if (used && j <= L) {
          hj = Hr[j];
          if (j > 0) hjm1 = Hr[j - 1];
        }
        diag[q][p] = hjm1 + ((base[q] == code) ? m : n);
        vert[q][p] = hj + g;
        if (p < P) {
          tmp[q] = max(tmp[q], max(diag[q][p], vert[q][p]));
          if (j == 0) c0 = max(c0, hj);
        }
      }
    }
    const int col0 = (md == kRov) ? 0 : c0 + g;
    // serial inclusive prefix max of val - j*g over the own columns
    int loc[PER], run = kLow;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = j0 + q;
      if (j <= L) run = max(run, (j == 0 ? col0 : tmp[q]) - j * g);
      loc[q] = run;
    }
    const int excl = block_excl_prefix_max(run, warp_tot);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = j0 + q;
      if (j > L) continue;
      const int h = max(excl, loc[q]) + j * g;
      int c;
      if (j == 0) {
        c = P;
#pragma unroll
        for (int p = kPMax - 1; p >= 0; --p)
          if (p < P && vert[q][p] == col0) c = P + p;
      } else {
        c = 2 * P;
#pragma unroll
        for (int p = kPMax - 1; p >= 0; --p)
          if (p < P && vert[q][p] == h) c = P + p;
#pragma unroll
        for (int p = kPMax - 1; p >= 0; --p)
          if (p < P && diag[q][p] == h) c = p;
      }
      Hb[(long long)(r + 1) * W + j] = h;
      bpb[(long long)(r + 1) * W + j] = (int8_t)c;
      if (q == own_q && (md == kLov || is_end[nr]) && h > best_v) {
        best_v = h;
        best_r = r;
      }
    }
    __syncthreads();  // row r+1 complete before any later row reads it
  }
  if (own_q >= 0) max_row[b] = best_r + 1;
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
  const int W = L + 1;
  const int per = W <= 1024 ? 1 : 2;  // the wrapper refuses W > 2048
  const int threads = (((W + per - 1) / per + 31) / 32) * 32;
  const auto st = static_cast<cudaStream_t>(stream);
#define HYPO_DP_ARGS                                                        \
  static_cast<const int*>(node_code), static_cast<const int*>(pred_rows), \
      static_cast<const int*>(pred_cnt), static_cast<const bool*>(is_end), \
      static_cast<const int*>(n_nodes), static_cast<const int*>(arm),     \
      static_cast<const int*>(arm_len), static_cast<const int*>(mode),    \
      static_cast<int8_t*>(bp), static_cast<int*>(max_row),               \
      static_cast<int*>(H), N, L, P, m, n, g
  if (per == 1)
    poa_dp_kernel<1><<<B, threads, 0, st>>>(HYPO_DP_ARGS);
  else
    poa_dp_kernel<2><<<B, threads, 0, st>>>(HYPO_DP_ARGS);
#undef HYPO_DP_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
