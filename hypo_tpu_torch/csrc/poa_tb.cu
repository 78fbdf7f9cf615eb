// Backpointer traceback of a batch of POA windows: the Hopper kernel
// behind hypo_tpu_torch.poa.cuda_tb.poa_tb_batch.
//
// Replaces the traceback of hypo_tpu/poa/jax_poa.py:poa_dp_tb_batch
// (:85-116, an XLA while_loop vmapped over windows; no Pallas kernel).
// Same contract as the plain version hypo_tpu_torch/poa/dp.py:
// poa_tb_batch_ref: walk bp from (max_row, arm_len) to the stop cell
// ((0, 0) for NW / LOV, row 0 or column 0 for ROV); row 0 moves only
// horizontally; each step emits (graph rank or -1, query index or -1)
// in backward order; at most S = N + L + 1 steps; -2 past the end.
//
// What bounds it: latency.  A walk is a serial chain of dependent
// loads (bp cell -> predecessor row -> next bp cell), at most S steps,
// with no arithmetic to speak of.  Design: one thread per window, so
// the B walks of a call run side by side and their load latencies
// overlap across warps; bp and pred_rows stay in global memory (the DP
// kernel just wrote bp, so the rows a walk visits are mostly in L2).
// Every index read is clamped into its array: rows above a window's
// n_nodes are never written by the DP kernel, and no input may make the
// walk read outside bp or pred_rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRov = 2;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void poa_tb_kernel(const int8_t* __restrict__ bp,
                              const int* __restrict__ pred_rows,
                              const int* __restrict__ max_row,
                              const int* __restrict__ arm_len,
                              const int* __restrict__ mode,
                              int16_t* __restrict__ ti,
                              int16_t* __restrict__ tj,
                              int* __restrict__ steps, int B, int N, int L,
                              int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int W = L + 1;
  const int S = N + L + 1;
  const int8_t* bpb = bp + (long long)b * (N + 1) * W;
  const int* prb = pred_rows + (long long)b * N * P;
  int16_t* tib = ti + (long long)b * S;
  int16_t* tjb = tj + (long long)b * S;
  const bool rov = mode[b] == kRov;
  int i = clampi(max_row[b], 0, N);
  int j = clampi(arm_len[b], 0, L);
  int t = 0;
  for (; t < S; ++t) {
    if (rov ? (i == 0 || j == 0) : (i == 0 && j == 0)) break;
    int pi, pj;
    if (i == 0) {
      pi = 0;
      pj = j - 1;
    } else {
      const int code = bpb[(long long)i * W + clampi(j, 0, L)];
      const bool is_vert = code >= P && code < 2 * P;
      const bool is_horiz = code == 2 * P;
      const int pidx = clampi(code < P ? code : code - P, 0, P - 1);
      const int pred = clampi(prb[(long long)(i - 1) * P + pidx], 0, N);
      pi = is_horiz ? i : pred;
      pj = is_vert ? j : j - 1;
    }
    tib[t] = (int16_t)(pi == i ? -1 : i - 1);
    tjb[t] = (int16_t)(pj == j ? -1 : j - 1);
    i = pi;
    j = pj;
  }
  steps[b] = t;
  for (int u = t; u < S; ++u) {
    tib[u] = -2;
    tjb[u] = -2;
  }
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors; returns the
// launch's cudaGetLastError().
int hypo_poa_tb(const void* bp, const void* pred_rows, const void* max_row,
                const void* arm_len, const void* mode, void* ti, void* tj,
                void* steps, int B, int N, int L, int P, void* stream) {
  if (B == 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  poa_tb_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bp), static_cast<const int*>(pred_rows),
      static_cast<const int*>(max_row), static_cast<const int*>(arm_len),
      static_cast<const int*>(mode), static_cast<int16_t*>(ti),
      static_cast<int16_t*>(tj), static_cast<int*>(steps), B, N, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
