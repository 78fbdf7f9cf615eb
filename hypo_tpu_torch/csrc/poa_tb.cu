// Backpointer traceback of a batch of POA windows on Hopper: kernel 3,
// behind hypo_tpu_torch.poa.cuda_tb.poa_tb_batch (exact mode) and
// poa_tb_matched (the tile program's walk).
//
// Replaces two XLA loops that have no Pallas kernel: exact mode's
// traceback, hypo_tpu/poa/jax_poa.py:poa_dp_tb_batch (:85-116, a
// while_loop vmapped over windows), and the tile program's,
// hypo_tpu/poa/device_full.py:_traceback_matched_batch (:247-307, a
// while_loop over the batch).  Both walk bp the same way, from
// (max_row, arm_len) to the stop cell ((0, 0) for NW / LOV, row 0 or
// column 0 for ROV), row 0 moving only horizontally, at most
// S = N + L + 1 steps.  One walk, two emitters:
//   exact   (plain version poa/dp.py:poa_tb_batch_ref): each step's
//           (graph rank or -1, query index or -1) in backward order,
//           -2 past ``steps``;
//   matched (plain version poa/dp.py:poa_tb_matched_ref): matched[j],
//           the rank arm base j aligned to or -1; a window that is not
//           active starts stopped (the DP wrote none of its rows), so
//           its row is all -1.
//
// What bounds it: latency.  A walk is a serial chain (bp cell ->
// predecessor row -> next bp cell) with no arithmetic to speak of; the
// bytes it needs are a few per step.  A thread per window walking bp
// and pred_rows in device memory pays two dependent loads a step (the
// first version of this kernel).  Design:
// - One warp per window, one window a block: a class-0 tile's 2,048
//   windows are 2,048 blocks over the 132 SMs, and exact mode's buckets
//   of 64 or 8 windows spread over 64 or 8 SMs.  A development sweep
//   over 1, 2, 4 and 8 windows a block found one the fastest at every
//   shape, most of all at the N = 1024 buckets.
// - The window's predecessor ranks (pred_rows[b], N x P int32) go to
//   shared memory first, as int16 clamped into [0, N], by coalesced
//   loads of the whole warp (16 KB at N = 1024, P = 8).  A step's
//   predecessor is then a shared-memory read.
// - Look-ahead: the warp loads the kRows x kCols block of bp that ends
//   at the current cell (rows i - kRows + 1 .. i, columns
//   j - kCols + 1 .. j) into shared memory, lane l one column, one
//   coalesced 32-byte load a row, all kRows loads in flight at once;
//   the walk then runs inside the block from shared memory.  Every
//   move goes to a predecessor row and to column j or j - 1, and in a
//   column graph the predecessor is a few ranks back, so one round trip
//   to device memory serves a stretch of ~kRows / (rank gap) steps of a
//   near-diagonal walk, where the 2P + 1 cells one step can reach would
//   serve two.  A move out of the block (a predecessor further back, or
//   kCols columns walked) reloads it at the new cell.  kRows = kCols =
//   32, from the same sweep over 8, 16, 32, 48 and 64 rows: 32 is the
//   fastest or within noise of it on real tiles' walks (8 rows reload
//   too often, 64 load rows a near-diagonal walk never reaches).
// - Row 0 reads nothing: the rest of the walk is horizontal, and the
//   warp emits it at once.
// - Output is staged in shared memory (int16: ranks < N, indices < L)
//   by lane 0 and written out by the whole warp, coalesced: exact
//   mode's ti / tj with the -2 fill past ``steps``, or the matched row.
// - Every index read is clamped into its array (start cell, rows,
//   columns, predecessor slot and rank): rows above a window's n_nodes
//   are never written by the DP kernel, and no input may make the walk
//   read outside bp, pred_rows or shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRov = 2;
constexpr int kRows = 32;    // look-ahead block rows
constexpr int kCols = 32;    // look-ahead block columns, one a lane
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__host__ __device__ __forceinline__ int align16(int v) {
  return (v + 15) & ~15;
}

// shared memory of a block: predecessor ranks, look-ahead block,
// staged output (exact: ti then tj, S each; matched: L)
__host__ __device__ __forceinline__ int block_bytes(int N, int L, int P,
                                                    bool matched) {
  const int staged = matched ? L : 2 * (N + L + 1);
  return align16(2 * N * P) + kRows * kCols + align16(2 * staged);
}

template <bool kMatched>
__global__ void __launch_bounds__(32)
    poa_tb_kernel(const int8_t* __restrict__ bp,
                  const int* __restrict__ pred_rows,
                  const int* __restrict__ max_row,
                  const int* __restrict__ arm_len,
                  const int* __restrict__ mode,
                  const uint8_t* __restrict__ active,
                  int16_t* __restrict__ ti, int16_t* __restrict__ tj,
                  int* __restrict__ steps, int* __restrict__ matched, int B,
                  int N, int L, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int W = L + 1;
  const int S = N + L + 1;
  int16_t* preds = reinterpret_cast<int16_t*>(smem);
  int8_t* blk = reinterpret_cast<int8_t*>(smem + align16(2 * N * P));
  int16_t* staged =
      reinterpret_cast<int16_t*>(smem + align16(2 * N * P) + kRows * kCols);
  const int8_t* bpb = bp + (long long)b * (N + 1) * W;
  const int* prb = pred_rows + (long long)b * N * P;

  for (int k = lane; k < N * P; k += 32)
    preds[k] = (int16_t)clampi(__ldg(prb + k), 0, N);
  if (kMatched)
    for (int k = lane; k < L; k += 32) staged[k] = -1;
  __syncwarp();

  const bool rov = mode[b] == kRov;
  int i = clampi(max_row[b], 0, N);
  int j = clampi(arm_len[b], 0, L);
  int t = 0;
  bool walking = !kMatched || active[b] != 0;
  while (walking && t < S) {
    if (rov ? (i == 0 || j == 0) : (i == 0 && j == 0)) break;
    if (i == 0) {
      // row 0: horizontal moves to column 0 (NW / LOV), nothing read;
      // the matched emitter's row already holds -1 there.  A column
      // below 0 (only from a bp no DP wrote) never stops: S steps.
      const int n = j > 0 ? min(j, S - t) : S - t;
      if (!kMatched)
        for (int k = lane; k < n; k += 32) {
          staged[t + k] = -1;
          staged[S + t + k] = (int16_t)(j - 1 - k);
        }
      t += n;
      break;
    }
    // the look-ahead block ending at (i0, j0)
    const int i0 = i;
    const int j0 = j;
    {
      const int8_t* col = bpb + max(j0 - (kCols - 1) + lane, 0);
      int8_t v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        v[r] = __ldg(col + (long long)max(i0 - r, 0) * W);
#pragma unroll
      for (int r = 0; r < kRows; ++r) blk[r * kCols + lane] = v[r];
    }
    __syncwarp();
    for (; t < S; ++t) {
      if (rov ? (i == 0 || j == 0) : (i == 0 && j == 0)) {
        walking = false;
        break;
      }
      const unsigned dr = (unsigned)(i0 - i);
      const unsigned dc = (unsigned)(j0 - j);
      // row 0 goes back to the outer loop; so does a cell outside the
      // block (a column below 0 maps onto the lane that read column 0,
      // the clamped read of the plain version)
      if (i == 0 || dr >= kRows || dc >= kCols) break;
      const int code = blk[dr * kCols + (kCols - 1 - dc)];
      const bool vert = code >= P && code < 2 * P;
      const bool horiz = code == 2 * P;
      const int pidx = clampi(code < P ? code : code - P, 0, P - 1);
      const int pi = horiz ? i : preds[(i - 1) * P + pidx];
      const int pj = vert ? j : j - 1;
      if (lane == 0) {
        if (kMatched) {
          if (pj != j && j >= 1)
            staged[j - 1] = (int16_t)(pi != i ? i - 1 : -1);
        } else {
          staged[t] = (int16_t)(pi == i ? -1 : i - 1);
          staged[S + t] = (int16_t)(pj == j ? -1 : j - 1);
        }
      }
      i = pi;
      j = pj;
    }
    __syncwarp();  // the block is read before the next load overwrites it
  }
  __syncwarp();

  if (kMatched) {
    int* mb = matched + (long long)b * L;
    for (int k = lane; k < L; k += 32) mb[k] = staged[k];
  } else {
    int16_t* tib = ti + (long long)b * S;
    int16_t* tjb = tj + (long long)b * S;
    for (int k = lane; k < S; k += 32) {
      tib[k] = k < t ? staged[k] : (int16_t)-2;
      tjb[k] = k < t ? staged[S + k] : (int16_t)-2;
    }
    if (lane == 0) steps[b] = t;
  }
}

template <bool kMatched>
int launch(const void* bp, const void* pred_rows, const void* max_row,
           const void* arm_len, const void* mode, const void* active,
           void* ti, void* tj, void* steps, void* matched, int B, int N,
           int L, int P, void* stream) {
  if (B == 0) return 0;
  // int16 staging holds ranks <= N and indices < L
  if (N < 1 || L < 1 || P < 1 || N > 32766 || L > 32766)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = block_bytes(N, L, P, kMatched);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        poa_tb_kernel<kMatched>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  poa_tb_kernel<kMatched><<<B, 32, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bp), static_cast<const int*>(pred_rows),
      static_cast<const int*>(max_row), static_cast<const int*>(arm_len),
      static_cast<const int*>(mode), static_cast<const uint8_t*>(active),
      static_cast<int16_t*>(ti), static_cast<int16_t*>(tj),
      static_cast<int*>(steps), static_cast<int*>(matched), B, N, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors; each entry
// returns its launch's error code (cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take).

// exact mode: ti, tj int16 [B, S], steps int32 [B]
int hypo_poa_tb(const void* bp, const void* pred_rows, const void* max_row,
                const void* arm_len, const void* mode, void* ti, void* tj,
                void* steps, int B, int N, int L, int P, void* stream) {
  return launch<false>(bp, pred_rows, max_row, arm_len, mode, nullptr, ti,
                       tj, steps, nullptr, B, N, L, P, stream);
}

// the tile walk: matched int32 [B, L]; active is bool (one byte) [B]
int hypo_poa_tb_matched(const void* bp, const void* pred_rows,
                        const void* arm_len, const void* mode,
                        const void* max_row, const void* active,
                        void* matched, int B, int N, int L, int P,
                        void* stream) {
  return launch<true>(bp, pred_rows, max_row, arm_len, mode, active,
                      nullptr, nullptr, nullptr, matched, B, N, L, P,
                      stream);
}

}  // extern "C"
