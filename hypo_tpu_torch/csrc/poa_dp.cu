// Graph-vs-arm POA DP for a batch of windows: the Hopper kernel behind
// hypo_tpu_torch.poa.cuda_poa.poa_dp_batch.
//
// Replaces the Pallas TPU kernel hypo_tpu/poa/pallas_poa.py
// (_build_kernel, pallas_call in _build_run).  Same contract as the
// plain version hypo_tpu_torch/poa/dp.py:poa_dp_batch_ref: linear-gap
// DP of a topologically ranked graph (rows) against one arm (columns);
// int8 backpointers with the reference's tie order (diagonal via
// predecessor 0..P-1, then vertical via 0..P-1, then horizontal; first
// hit wins; unused predecessor slots read as the NEG16 sentinel row);
// max_row = 1 + first best eligible row in column arm_len.  bp rows
// above a window's n_nodes are left unwritten.
//
// What bounds it: neither bytes nor operations.  A window is a serial
// chain of n_nodes dependent row steps (row r+1 reads rows of arbitrary
// earlier ranks), each a prefix max over the columns, so the time is
// rows x the latency of one row step.  The design cuts that latency and
// the work issued per row:
//  * One CTA per window; each thread owns PER consecutive columns, so a
//    row step is a serial pass over the thread's columns, a warp-shuffle
//    prefix max and, for arms wider than 32 * PER columns, one exchange
//    of warp totals.  That exchange is the only barrier of a row
//    (__syncthreads, or __syncwarp for a one-warp CTA); its totals are
//    double-buffered by row parity.
//  * Work follows the row's real predecessor count (a CTA-uniform
//    branch), not the P slots: while reading the predecessors each
//    column keeps the first-best diagonal and vertical candidates, so
//    the backpointer is a compare of three values, not two P-way
//    scans.  Unused slots enter once, as the sentinel row's candidates,
//    and only where a sentinel candidate can win or tie: when the
//    wrapper cannot rule it out from the scores and sizes (``sent``) or
//    the window has a row without predecessors.
//  * max_row leaves the row loop: the thread owning column arm_len
//    keeps that column's cell of every row in shared memory, and the
//    block takes the first argmax over the masked rows at the end.
//  * H stays on chip as int16 (while every row has a predecessor, every
//    cell is a path's score, |cell| <= max(|m|, |n|, |g|) * (N + L); the
//    wrapper checks that this is at most 32767).  The
//    previous row is in registers (a thread's own columns plus column
//    j0-1, which is the block prefix before its first column); row 0 is
//    j*g and is computed; rows up to kRing-1 back are in a ring in
//    shared memory.  Only rows that some later row reads from further
//    back (marked in one pass over pred_rows at the start) are also
//    written to an int16 copy in device memory.  A ring of 16 rows keeps
//    a class-0 CTA at ~11 KB of shared memory; the whole class-0 plane
//    in shared memory (~73 KB, 3 CTAs an SM) was slower (PERF.md).
//  * A window's rows (code, predecessor count and rows, end flag) are
//    staged into shared memory by all threads at the start, in the same
//    pass that marks the far rows; row r+1's are read from there while
//    row r computes, so no row step waits on device memory.
// The wrapper picks PER by the arm's width (cuda_poa.columns_per_thread).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg16 = -16384;     // cell sentinel (pallas_poa.NEG)
constexpr int kPMax = 8;           // predecessor slots (full_runner.P_FULL)
constexpr int kRing = 16;          // rows kept in shared memory (power of 2)
constexpr int kLow = INT_MIN / 4;  // below every cell; no overflow on +/-
constexpr int kLov = 1, kRov = 2;
constexpr unsigned kFull = 0xffffffffu;

// PER int16 cells of one row, moved as one aligned vector.
template <int PER>
struct alignas(2 * PER) Cells {
  short v[PER];
};

// A row's cells at columns j0-1 .. j0+PER-1 into v[0..PER]; the cell
// left of the thread comes from the lane before it (or, for lane 0,
// from memory).  Every lane of the warp calls this together.
template <int PER>
__device__ __forceinline__ void load_row(const short* row, int j0, int lane,
                                         int (&v)[PER + 1]) {
  const Cells<PER> x = *reinterpret_cast<const Cells<PER>*>(row + j0);
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k + 1] = x.v[k];
  int left = __shfl_up_sync(kFull, v[PER], 1);
  if (lane == 0) left = j0 > 0 ? row[j0 - 1] : 0;
  v[0] = left;
}

// The rows of one window staged in shared memory.
struct Rows {
  int* code;          // [N]
  short* pred;        // [N][P], clamped to 0..N
  signed char* cnt;   // [N], clamped to 0..P
  signed char* end;   // [N]
};

__device__ __forceinline__ void read_row(const Rows& rows, int i, int P,
                                         int& code, int& cnt,
                                         int (&pr)[kPMax]) {
  code = rows.code[i];
  cnt = rows.cnt[i];
#pragma unroll
  for (int p = 0; p < kPMax; ++p) pr[p] = p < cnt ? rows.pred[i * P + p] : 0;
}

// Shared memory of a launch: the ring [kRing][Wp] int16, warp totals
// [2][32] int32, the far-row bits, the cells of column arm_len, then the
// staged rows.
__host__ __device__ inline size_t smem_bytes(int Wp, int N, int P) {
  return (size_t)kRing * Wp * sizeof(short) + 64 * sizeof(int) +
         (size_t)(N / 32 + 1) * sizeof(unsigned) +
         (size_t)N * (2 * sizeof(int) + P * sizeof(short) + 2);
}

// (v, r) of the larger v, the smaller r on a tie: first argmax.
__device__ __forceinline__ void argmax_merge(int& v, int& r, int v2, int r2) {
  if (v2 > v || (v2 == v && r2 < r)) {
    v = v2;
    r = r2;
  }
}

// Thread t owns columns t*PER .. t*PER + PER - 1 of every row.
template <int PER>
__global__ void __launch_bounds__(1024) poa_dp_kernel(
    const int* __restrict__ node_code, const int* __restrict__ pred_rows,
    const int* __restrict__ pred_cnt, const bool* __restrict__ is_end,
    const int* __restrict__ n_nodes, const int* __restrict__ arm,
    const int* __restrict__ arm_len, const int* __restrict__ mode,
    int8_t* __restrict__ bp, int* __restrict__ max_row,
    short* __restrict__ Hg, int N, int L, int P, int m, int n, int g,
    int Wp, int sent) {
  extern __shared__ __align__(16) unsigned char smem[];
  short* ring = reinterpret_cast<short*>(smem);
  int* wtot =
      reinterpret_cast<int*>(smem + (size_t)kRing * Wp * sizeof(short));
  unsigned* far = reinterpret_cast<unsigned*>(wtot + 64);
  int* colA = reinterpret_cast<int*>(far + N / 32 + 1);  // [N]
  Rows rows;
  rows.code = colA + N;
  rows.pred = reinterpret_cast<short*>(rows.code + N);
  rows.cnt = reinterpret_cast<signed char*>(rows.pred + (size_t)N * P);
  rows.end = rows.cnt + N;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j0 = tid * PER;
  const int W = L + 1;
  const long long nb = (long long)b * N;
  const int md = mode[b];
  const int nn = min(max(n_nodes[b], 0), N);
  const int alen = min(max(arm_len[b], 0), L);
  // the column this thread holds the running first-argmax for, or -1
  const int own_q = (alen >= j0 && alen < j0 + PER) ? alen - j0 : -1;
  int8_t* bpb = bp + (long long)b * (N + 1) * W;
  short* Hb = Hg + (long long)b * (N + 1) * Wp;

  // stage the window's rows; mark the rows read from more than kRing-1
  // rows back (kept in device memory too)
  for (int k = tid; k <= N / 32; k += blockDim.x) far[k] = 0;
  __syncthreads();
  int no_pred = 0;
  for (int i = tid; i < nn; i += blockDim.x) {
    const int c = min(max(pred_cnt[nb + i], 0), P);
    no_pred |= c == 0;
    rows.code[i] = node_code[nb + i];
    rows.cnt[i] = (signed char)c;
    rows.end[i] = is_end[nb + i] ? 1 : 0;
    for (int p = 0; p < c; ++p) {
      const int r = min(max(pred_rows[(nb + i) * P + p], 0), N);
      rows.pred[i * P + p] = (short)r;
      if (r >= 1 && r <= i - kRing)
        atomicOr(&far[r >> 5], 1u << (r & 31));
    }
  }

  int base[PER];      // arm code at column j - 1 (column j's diagonal)
  int prev[PER + 1];  // the last row at columns j0-1 .. j0+PER-1
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = j0 + q;
    base[q] = (j >= 1 && j <= L) ? arm[(long long)b * L + j - 1] : -1;
    if (j <= L) bpb[j] = 0;
  }
#pragma unroll
  for (int k = 0; k <= PER; ++k) prev[k] = (j0 - 1 + k) * g;
  // rows and far[] complete
  sent = __syncthreads_or(no_pred) || sent;
  int code_n = 0, cnt_n = 0, pr_n[kPMax];
  if (nn > 0) read_row(rows, 0, P, code_n, cnt_n, pr_n);

  for (int i = 0; i < nn; ++i) {
    const int code = code_n, cnt = cnt_n;
    int pr[kPMax];
#pragma unroll
    for (int p = 0; p < kPMax; ++p) pr[p] = pr_n[p];
    if (i + 1 < nn) read_row(rows, i + 1, P, code_n, cnt_n, pr_n);

    // best diagonal candidate and its code, best vertical one and its
    int prof[PER], maxd[PER], di[PER], maxv[PER], vi[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      prof[q] = base[q] == code ? m : n;
      maxd[q] = maxv[q] = kLow;
      di[q] = 0;
      vi[q] = P;
    }
    int z0 = -1;  // first predecessor whose column-0 vertical move is 0
#pragma unroll
    for (int p = 0; p < kPMax; ++p) {
      if (p >= cnt) break;
      const int r = pr[p];
      int v[PER + 1];
      if (r == i) {
#pragma unroll
        for (int k = 0; k <= PER; ++k) v[k] = prev[k];
      } else if (r == 0) {
#pragma unroll
        for (int k = 0; k <= PER; ++k) v[k] = (j0 - 1 + k) * g;
      } else if (r > i - kRing) {
        load_row<PER>(ring + (r & (kRing - 1)) * Wp, j0, lane, v);
      } else {
        load_row<PER>(Hb + (long long)r * Wp, j0, lane, v);
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int d = v[q] + prof[q];
        if (d > maxd[q]) {
          maxd[q] = d;
          di[q] = p;
        }
        const int vv = v[q + 1] + g;
        if (vv > maxv[q]) {
          maxv[q] = vv;
          vi[q] = P + p;
        }
      }
      if (z0 < 0 && v[1] + g == 0) z0 = p;
    }
    if (sent && cnt < P) {  // the unused slots: the sentinel row, at cnt
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (kNeg16 + prof[q] > maxd[q]) {
          maxd[q] = kNeg16 + prof[q];
          di[q] = cnt;
        }
        if (kNeg16 + g > maxv[q]) {
          maxv[q] = kNeg16 + g;
          vi[q] = P + cnt;
        }
      }
    }
    const int col0 = (md == kRov) ? 0 : maxv[0];  // column 0 (thread 0)

    // prefix max of val - j*g: serial over the own columns, then over
    // the lanes, then over the warps
    int loc[PER], tmp[PER], run = kLow;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = j0 + q;
      tmp[q] = max(maxd[q], maxv[q]);
      run = max(run, (j == 0 ? col0 : tmp[q]) - j * g);
      loc[q] = run;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, run, d);
      if (lane >= d) run = max(run, o);
    }
    int excl = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) excl = kLow;
    if (nwarps > 1) {
      int* tot = wtot + (i & 1) * 32;
      if (lane == 31) tot[wid] = run;
      __syncthreads();
      for (int w = 0; w < wid; ++w) excl = max(excl, tot[w]);
    } else {
      __syncwarp();
    }

    int8_t* out = bpb + (long long)(i + 1) * W;
    Cells<PER> row;
    prev[0] = excl + (j0 - 1) * g;  // column j0-1 of the new row
    int at_alen = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = j0 + q;
      const int h = max(excl, loc[q]) + j * g;
      row.v[q] = (short)h;
      prev[q + 1] = h;
      if (q == own_q) at_alen = h;
      if (j > L) continue;
      int c = h > tmp[q] ? 2 * P : (maxd[q] == h ? di[q] : vi[q]);
      if (j == 0) c = md == kRov ? (z0 >= 0 ? P + z0 : P) : vi[0];
      out[j] = (int8_t)c;
    }
    if (own_q >= 0) colA[i] = at_alen;
    const int slot = (i + 1) & (kRing - 1);
    *reinterpret_cast<Cells<PER>*>(ring + slot * Wp + j0) = row;
    if ((far[(i + 1) >> 5] >> ((i + 1) & 31)) & 1u)
      *reinterpret_cast<Cells<PER>*>(Hb + (long long)(i + 1) * Wp + j0) = row;
  }

  // max_row: 1 + the first argmax over rows 0..N-1 of the column-arm_len
  // cell, NEG16 for a row that is not eligible (past n_nodes, or not an
  // end node unless mode LOV)
  __syncthreads();
  int bv = kLow, br = 0;
  for (int i = tid; i < N; i += blockDim.x)
    argmax_merge(bv, br,
                 (i < nn && (md == kLov || rows.end[i])) ? colA[i] : kNeg16,
                 i);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    argmax_merge(bv, br, __shfl_xor_sync(kFull, bv, d),
                 __shfl_xor_sync(kFull, br, d));
  if (nwarps > 1) {
    if (lane == 0) {
      wtot[wid] = bv;
      wtot[32 + wid] = br;
    }
    __syncthreads();
    if (tid == 0)
      for (int w = 1; w < nwarps; ++w)
        argmax_merge(bv, br, wtot[w], wtot[32 + w]);
  }
  if (tid == 0) max_row[b] = br + 1;
}

template <int PER>
int launch(int B, int threads, int Wp, int N, cudaStream_t st,
           const int* node_code, const int* pred_rows, const int* pred_cnt,
           const bool* is_end, const int* n_nodes, const int* arm,
           const int* arm_len, const int* mode, int8_t* bp, int* max_row,
           short* Hg, int L, int P, int m, int n, int g, int sent) {
  const size_t shm = smem_bytes(Wp, N, P);
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        poa_dp_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  poa_dp_kernel<PER><<<B, threads, shm, st>>>(
      node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len, mode, bp,
      max_row, Hg, N, L, P, m, n, g, Wp, sent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors; Hg is an int16
// [B, N+1, Wp] scratch, Wp = threads * per >= L + 1.  per is 2 or 4
// columns a thread; sent = 0 says that no sentinel candidate can win or
// tie while every row has a predecessor.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int hypo_poa_dp(const void* node_code, const void* pred_rows,
                const void* pred_cnt, const void* is_end,
                const void* n_nodes, const void* arm, const void* arm_len,
                const void* mode, void* bp, void* max_row, void* Hg, int B,
                int N, int L, int P, int m, int n, int g, int per, int sent,
                void* stream) {
  if (B == 0) return 0;
  const int W = L + 1;
  const int threads = ((W + 32 * per - 1) / (32 * per)) * 32;
  const int Wp = threads * per;
  if (threads > 1024 || P < 1 || P > kPMax || Hg == nullptr ||
      smem_bytes(Wp, N, P) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define HYPO_DP_ARGS                                                        \
  B, threads, Wp, N, st, static_cast<const int*>(node_code),               \
      static_cast<const int*>(pred_rows), static_cast<const int*>(pred_cnt), \
      static_cast<const bool*>(is_end), static_cast<const int*>(n_nodes),  \
      static_cast<const int*>(arm), static_cast<const int*>(arm_len),      \
      static_cast<const int*>(mode), static_cast<int8_t*>(bp),             \
      static_cast<int*>(max_row), static_cast<short*>(Hg), L, P, m, n, g, \
      sent
  switch (per) {
    case 2: return launch<2>(HYPO_DP_ARGS);
    case 4: return launch<4>(HYPO_DP_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HYPO_DP_ARGS
}

}  // extern "C"
