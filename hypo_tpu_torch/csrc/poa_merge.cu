// Merge of one aligned arm into each window's POA graph on Hopper, in
// place: kernel 5, behind hypo_tpu_torch.poa.cuda_merge.merge_arm.
//
// Replaces hypo_tpu/poa/device_full.py:_merge (:309-424, XLA one-hot
// passes with no Pallas kernel) together with the state selection of
// _arm_step_batch (:473-483); its plain version is
// hypo_tpu_torch/poa/device_full.py:_merge_step (_merge, then the
// selection), tie-exact with colpoa_ref.ColPoa.add.  For each window the
// arm (weight w) is merged along its alignment ``matched`` (the rank each
// base aligned to, or -1; all -1 for an empty graph):
// - a base creates a node unless it matched a node whose column already
//   holds a node of its code; nodes and columns are numbered by the
//   running counts of creations and insertions;
// - every inserted column is anchored after the last matched column
//   position (``lastpos``, a running max); an existing column at
//   position p moves up by the insertions anchored before p (a histogram
//   of anchors and its prefix sum), inserted column t of the run
//   anchored at q lands at q + shift(q) + t;
// - node supports and edge weights grow by w; an edge (previous base's
//   node -> this base's node) takes the first predecessor slot that
//   holds it, else a new slot at pred_cnt;
// - the window overflows when its nodes or columns would pass N, or a
//   new edge would need a slot >= P.
// A window that is not active, has no arm, or overflowed before keeps
// every leaf; one that overflows now keeps every leaf but sets ovf.
//
// What bounds it: bytes, and few of them: O(L + N) words a window
// (class 0: about 12 KB).  The XLA form builds [L, N] one-hots; the
// torch form is about 100 operators.  Design:
// - One block per window, one thread per arm base j (blockDim: L rounded
//   up to 32; 128 threads at class 0, L = 126, 512 at class 1).
// - Phase 1 reads the old state into registers and shared memory: the
//   running counts and maxima over j are one block scan of four values
//   (warp shuffles, then the warp totals); the anchor histogram is built
//   with shared-memory atomics and scanned over N + 1 slots; each edge
//   searches the P slots of its node; the window's overflow is a block
//   OR (__syncthreads_or).
// - Phase 2, after that barrier and only where the merge applies, writes
//   the state in place: the new positions of the existing columns (each
//   read and written by one thread; every other read of col_pos was in
//   phase 1), the new columns, nodes, col_node entries, edges, counts,
//   n_nodes and n_cols.  Every target is unique per window (an alignment
//   path visits each column, node and edge at most once); the additions
//   use atomics all the same, so the result equals the plain version's
//   scatter-add even where that would not hold.
// - Shared memory: N + 1 + L ints and the scan's warp totals, 6.5 KB at
//   class 1: no opt-in attribute, nothing to set under CUDA graph
//   capture, and no host read.
// - Every index is clamped or masked into its array.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCodes = 6;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

int threads_for(int L) {
  return (L + 31) & ~31;
}

// shared ints: histogram / prefix sums [N + 1], node of each base [L],
// then the scans' warp totals (four ints a warp, 32 warps)
int smem_ints(int N, int L) {
  return ((N + 1 + L + 3) & ~3) + 4 * 32;
}

// running values over the bases: two sums (creations, insertions) and
// two maxima (matched column position, matched base index)
struct Run {
  int creates, inserts, pos, j;
};

__device__ __forceinline__ Run join(const Run& x, const Run& y) {
  return {x.creates + y.creates, x.inserts + y.inserts, max(x.pos, y.pos),
          max(x.j, y.j)};
}

__device__ __forceinline__ Run warp_scan(Run x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const Run y = {__shfl_up_sync(kFull, x.creates, d),
                   __shfl_up_sync(kFull, x.inserts, d),
                   __shfl_up_sync(kFull, x.pos, d),
                   __shfl_up_sync(kFull, x.j, d)};
    if (lane >= d) x = join(y, x);
  }
  return x;
}

// Inclusive scan of x over the block's threads; *total gets the block's
// total.  ``tot`` is shared scratch of 32 Runs.
__device__ Run block_scan(Run x, Run* tot, Run* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = warp_scan(x, lane);
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Run t = lane < nwarps ? tot[lane] : Run{0, 0, INT_MIN, INT_MIN};
    t = warp_scan(t, lane);
    if (lane < nwarps) tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x = join(tot[warp - 1], x);
  *total = tot[nwarps - 1];
  __syncthreads();
  return x;
}

// In-place inclusive prefix sum of a[0, n) by the whole block, each
// thread a contiguous chunk; ``warp_sum`` is shared scratch of 32 ints.
__device__ void block_inclusive_scan(int* a, int n, int* warp_sum) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n);
  const int hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? warp_sum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    if (lane < nwarps) warp_sum[lane] = t;
  }
  __syncthreads();
  int run = x - s + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
    poa_merge_kernel(int* __restrict__ node_code, int* __restrict__ node_col,
                     int* __restrict__ node_sup, int* __restrict__ pred_nd,
                     int* __restrict__ pred_w, int* __restrict__ pred_cnt,
                     int* __restrict__ out_cnt, int* __restrict__ col_pos,
                     int* __restrict__ col_node, int* __restrict__ n_nodes,
                     int* __restrict__ n_cols, bool* __restrict__ ovf,
                     const int* __restrict__ node_col_r,
                     const int* __restrict__ matched,
                     const int* __restrict__ arm,
                     const int* __restrict__ arm_len,
                     const int* __restrict__ w,
                     const bool* __restrict__ active, int N, int L, int P) {
  extern __shared__ int smem[];
  int* cs = smem;                  // [N + 1] anchors, then prefix sums
  int* node_sh = smem + N + 1;     // [L] node of base j (-1: none)
  Run* tot = reinterpret_cast<Run*>(smem + ((N + 1 + L + 3) & ~3));
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int al = arm_len[b];
  // nothing to merge: every leaf stays, ovf included
  if (!active[b] || al <= 0 || ovf[b]) return;
  const long long row = (long long)b * N;
  const int nn = n_nodes[b];
  const int nc = n_cols[b];
  const int wt = w[b];
  for (int i = j; i <= N; i += blockDim.x) cs[i] = 0;

  // -- phase 1: read the old state ------------------------------------
  const bool valid = j < L && j < al;
  // an empty graph (the window's first arm): every base is an insertion
  const int m = valid && nn > 0 ? matched[(long long)b * L + j] : -1;
  const bool is_match = m >= 0;
  const int code = valid ? arm[(long long)b * L + j] : 0;
  const int arm_c = clampi(code, 0, kCodes - 1);
  const int c_match = is_match ? node_col_r[row + min(m, N - 1)] : 0;
  const int cm = clampi(c_match, 0, N - 1);
  const int exist = is_match ? col_node[(row + cm) * kCodes + arm_c] : -1;
  const bool creates = valid && (!is_match || exist < 0);
  const bool inserts = valid && !is_match;
  Run total;
  const Run run = block_scan(
      {creates, inserts, is_match ? col_pos[row + cm] : -kBig,
       is_match ? j : -1},
      tot, &total);
  const int node_j = creates ? nn - 1 + run.creates : (is_match ? exist : -1);
  const int new_col = nc - 1 + run.inserts;
  const int col_j = is_match ? c_match : new_col;
  const int lastpos = max(run.pos, -1);
  if (inserts && lastpos + 1 <= N) atomicAdd(&cs[lastpos + 1], 1);
  if (j < L) node_sh[j] = node_j;
  __syncthreads();
  // the edge into this base's node from the previous base's
  const bool edge = valid && j >= 1;
  const int u = edge ? node_sh[j - 1] : -1;
  const bool v_ok = edge && node_j >= 0 && node_j < N;
  bool has = false;
  int slot = 0;
  if (v_ok) {
    const int* pv = pred_nd + (row + node_j) * P;
    for (int p = P - 1; p >= 0; --p)
      if (pv[p] == u) {
        has = true;
        slot = p;
      }
    if (!has) slot = pred_cnt[row + node_j];
  } else if (edge) {
    has = u == 0;  // the plain version compares u with a zero there
  }
  const bool win_ovf =
      __syncthreads_or(edge && !has && slot >= P) ||
      nn + total.creates > N || nc + total.inserts > N;
  if (win_ovf) {
    if (j == 0) ovf[b] = true;
    return;
  }
  block_inclusive_scan(cs, N + 1, reinterpret_cast<int*>(tot));

  // -- phase 2: write the merged state in place ------------------------
  for (int c = j; c < nc; c += blockDim.x) {
    const int p = col_pos[row + c];
    col_pos[row + c] = p + cs[clampi(p, 0, N)];
  }
  if (inserts && new_col >= 0 && new_col < N) {
    const int shift = lastpos >= 0 ? cs[min(lastpos, N)] : 0;
    col_pos[row + new_col] = lastpos + shift + (j - run.j);
  }
  const bool node_ok = node_j >= 0 && node_j < N;
  if (creates && node_ok) {
    node_code[row + node_j] = code;
    node_col[row + node_j] = col_j;
  }
  if (valid && node_ok) atomicAdd(&node_sup[row + node_j], wt);
  if (creates && col_j >= 0 && col_j < N)
    col_node[(row + col_j) * kCodes + arm_c] = node_j;
  const int slot_c = min(slot, P - 1);
  if (v_ok) atomicAdd(&pred_w[(row + node_j) * P + slot_c], wt);
  if (edge && !has) {
    if (v_ok) {
      pred_nd[(row + node_j) * P + slot_c] = u;
      atomicAdd(&pred_cnt[row + node_j], 1);
    }
    if (u >= 0 && u < N) atomicAdd(&out_cnt[row + u], 1);
  }
  if (j == 0) {
    n_nodes[b] = nn + total.creates;
    n_cols[b] = nc + total.inserts;
  }
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors (ovf and active
// are bool, one byte); the twelve state leaves are updated in place.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for
// a shape the kernel does not take.
int hypo_poa_merge(void* node_code, void* node_col, void* node_sup,
                   void* pred_nd, void* pred_w, void* pred_cnt,
                   void* out_cnt, void* col_pos, void* col_node,
                   void* n_nodes, void* n_cols, void* ovf,
                   const void* node_col_r, const void* matched,
                   const void* arm, const void* arm_len, const void* w,
                   const void* active, int B, int N, int L, int P,
                   void* stream) {
  if (B == 0) return 0;
  const long long bytes = 4LL * smem_ints(N, L);
  if (N < 1 || L < 1 || P < 1 || threads_for(L) > 1024 ||
      bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  poa_merge_kernel<<<B, threads_for(L), bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(node_code), static_cast<int*>(node_col),
      static_cast<int*>(node_sup), static_cast<int*>(pred_nd),
      static_cast<int*>(pred_w), static_cast<int*>(pred_cnt),
      static_cast<int*>(out_cnt), static_cast<int*>(col_pos),
      static_cast<int*>(col_node), static_cast<int*>(n_nodes),
      static_cast<int*>(n_cols), static_cast<bool*>(ovf),
      static_cast<const int*>(node_col_r), static_cast<const int*>(matched),
      static_cast<const int*>(arm), static_cast<const int*>(arm_len),
      static_cast<const int*>(w), static_cast<const bool*>(active), N, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
