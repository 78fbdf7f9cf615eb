// Topological rank of a batch of POA graphs on Hopper: kernel 4, behind
// hypo_tpu_torch.poa.cuda_rank.rank_arrays.
//
// Replaces hypo_tpu/poa/device_full.py:_rank_arrays_batch (:144-193), XLA
// one-hot passes with no Pallas kernel; its plain version is
// hypo_tpu_torch/poa/device_full.py:_rank_arrays_batch (an argsort by
// (column position, node id), equal to JAX's counting).  For each window
// the graph's topological order is (column position, node id): a node's
// rank is the number of nodes in columns placed before its column plus
// the number of smaller ids in its own column.  The kernel computes that
// rank by counting, as the JAX package does, then writes the graph's
// per-node arrays permuted into rank order (RankArrays): rows r >=
// n_nodes hold zeros (so pred_cnt_r 1, is_end_r true, pred_rows 1).
//
// The count equals the argsort because two facts hold on every graph the
// merge builds (tests/test_torch_rank_merge.py holds both on real
// tiles): the positions of the n_cols valid columns are a permutation of
// 0..n_cols-1, and col_node[c] lists exactly the valid nodes whose
// node_col is c (at most NCODES = 6 of them, one a code).
//
// What bounds it: bytes.  A window reads its state once (class 0: about
// 28 KB) and writes its rank arrays once (up to 39 KB, fewer for the
// leaves a caller asks for); the arithmetic is a few integer operations
// an element.  Design:
// - One block of 256 threads per window: a class-0 tile's 2,048 windows
//   are 2,048 blocks over the 132 SMs; class 1 (N = 1024) loops four
//   elements a thread.
// - 1. Each valid column writes its node count (its col_node entries >=
//   0) at slot col_pos[c] of a shared array; 2. an exclusive block scan
//   over the positions gives each position's first rank; 3. each valid
//   node takes that base plus its place among its column's ids and
//   writes its rank (by node id) and its id (by rank) into shared
//   memory; 4. the permuted rows are written with consecutive threads
//   on consecutive output words (rank-major, a [N, P] leaf one slot a
//   thread), reading the window's rows (L1/L2-resident) by node id and
//   predecessor ranks from shared memory.
// - Shared memory: three int arrays of N and the scan's warp sums, 12 KB
//   at N = 1024: no opt-in attribute, so nothing to set before a launch
//   and nothing that matters under CUDA graph capture.
// - ``leaves`` (a bit a RankArrays field, cuda_rank.LEAF_BITS) says which
//   outputs to write: the arm step needs five of the eleven, the finish
//   what kernel 2 reads.  An input only those outputs read is not read.
// - Every index is clamped into its array: no input may make the kernel
//   read or write outside the window's rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodes = 6;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// RankArrays fields, in their order (cuda_rank.LEAF_BITS)
enum Leaf : int {
  kOrder = 1 << 0,
  kRankOf = 1 << 1,
  kCodeR = 1 << 2,
  kColR = 1 << 3,
  kSupR = 1 << 4,
  kPredNdR = 1 << 5,
  kPredRanks = 1 << 6,
  kPredRows = 1 << 7,
  kPredCntR = 1 << 8,
  kPredWR = 1 << 9,
  kIsEndR = 1 << 10,
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

int smem_ints(int N) {
  return 3 * N + 32;
}

// In-place exclusive prefix sum of a[0, n) by the whole block (blockDim.x
// a multiple of 32): each thread sums a contiguous chunk, the chunk sums
// are scanned across the block, then each chunk is rewritten.
__device__ void block_exclusive_scan(int* a, int n, int* warp_sum) {
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
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    poa_rank_kernel(const int* __restrict__ node_code,
                    const int* __restrict__ node_col,
                    const int* __restrict__ node_sup,
                    const int* __restrict__ pred_nd,
                    const int* __restrict__ pred_w,
                    const int* __restrict__ pred_cnt,
                    const int* __restrict__ out_cnt,
                    const int* __restrict__ col_pos,
                    const int* __restrict__ col_node,
                    const int* __restrict__ n_nodes,
                    const int* __restrict__ n_cols, int* __restrict__ order,
                    int* __restrict__ rank_of, int* __restrict__ node_code_r,
                    int* __restrict__ node_col_r, int* __restrict__ node_sup_r,
                    int* __restrict__ pred_nd_r, int* __restrict__ pred_ranks,
                    int* __restrict__ pred_rows, int* __restrict__ pred_cnt_r,
                    int* __restrict__ pred_w_r, bool* __restrict__ is_end_r,
                    int N, int P, int leaves) {
  extern __shared__ int smem[];
  int* at_pos = smem;          // [N] nodes of the column at a position,
                               // then the first rank at that position
  int* rank_sh = smem + N;     // [N] rank of node id v (BIG: invalid)
  int* order_sh = smem + 2 * N;  // [N] node id at rank r (0: none)
  int* warp_sum = smem + 3 * N;  // [32]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const long long row = (long long)b * N;
  const int nn = clampi(n_nodes[b], 0, N);
  const int nc = clampi(n_cols[b], 0, N);

  for (int i = tid; i < N; i += blockDim.x) {
    at_pos[i] = 0;
    rank_sh[i] = kBig;
    order_sh[i] = 0;
  }
  __syncthreads();
  // 1. each valid column's node count at its position
  for (int c = tid; c < nc; c += blockDim.x) {
    const int* cn = col_node + (row + c) * kCodes;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kCodes; ++k) cnt += cn[k] >= 0;
    const int p = col_pos[row + c];
    if (p >= 0 && p < N) at_pos[p] = cnt;
  }
  __syncthreads();
  // 2. the first rank at each position
  block_exclusive_scan(at_pos, N, warp_sum);
  // 3. each valid node's rank: its column's base + smaller ids there
  for (int v = tid; v < nn; v += blockDim.x) {
    const int c = clampi(node_col[row + v], 0, N - 1);
    const int* cn = col_node + (row + c) * kCodes;
    int within = 0;
#pragma unroll
    for (int k = 0; k < kCodes; ++k) {
      const int u = cn[k];
      within += u >= 0 && u < v;
    }
    const int r = at_pos[clampi(col_pos[row + c], 0, N - 1)] + within;
    rank_sh[v] = r;
    order_sh[clampi(r, 0, N - 1)] = v;
  }
  __syncthreads();

  // 4. the rank arrays
  if (leaves & kRankOf)
    for (int v = tid; v < N; v += blockDim.x) rank_of[row + v] = rank_sh[v];
  if (leaves & (kOrder | kCodeR | kColR | kSupR | kPredCntR | kIsEndR))
    for (int r = tid; r < N; r += blockDim.x) {
      const bool ok = r < nn;
      const long long v = row + order_sh[r];
      if (leaves & kOrder) order[row + r] = ok ? order_sh[r] : 0;
      if (leaves & kCodeR) node_code_r[row + r] = ok ? node_code[v] : 0;
      if (leaves & kColR) node_col_r[row + r] = ok ? node_col[v] : 0;
      if (leaves & kSupR) node_sup_r[row + r] = ok ? node_sup[v] : 0;
      if (leaves & kPredCntR)
        pred_cnt_r[row + r] = max(ok ? pred_cnt[v] : 0, 1);
      if (leaves & kIsEndR) is_end_r[row + r] = !ok || out_cnt[v] == 0;
    }
  if (leaves & (kPredNdR | kPredRanks | kPredRows | kPredWR)) {
    const long long prow = row * P;
    for (int k = tid; k < N * P; k += blockDim.x) {
      const int r = k / P;
      const bool ok = r < nn;
      const long long src = prow + (long long)order_sh[r] * P + (k - r * P);
      // a padding row is zeros: pred_nd_r 0, pred_ranks 0, so pred_rows 1
      int pn = 0, pr = 0;
      if (ok) {
        pn = pred_nd[src];
        pr = pn >= 0 && pn < N ? rank_sh[pn] : -1;
      }
      if (leaves & kPredNdR) pred_nd_r[prow + k] = pn;
      if (leaves & kPredRanks) pred_ranks[prow + k] = pr;
      if (leaves & kPredRows) pred_rows[prow + k] = pn >= 0 ? pr + 1 : 0;
      if (leaves & kPredWR) pred_w_r[prow + k] = ok ? pred_w[src] : 0;
    }
  }
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers of contiguous tensors (is_end_r is
// bool, one byte); an output whose bit is not in ``leaves`` may be null,
// and so may node_sup / pred_w when no output that reads them is asked
// for.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int hypo_poa_rank(const void* node_code, const void* node_col,
                  const void* node_sup, const void* pred_nd,
                  const void* pred_w, const void* pred_cnt,
                  const void* out_cnt, const void* col_pos,
                  const void* col_node, const void* n_nodes,
                  const void* n_cols, void* order, void* rank_of,
                  void* node_code_r, void* node_col_r, void* node_sup_r,
                  void* pred_nd_r, void* pred_ranks, void* pred_rows,
                  void* pred_cnt_r, void* pred_w_r, void* is_end_r, int B,
                  int N, int P, int leaves, void* stream) {
  if (B == 0) return 0;
  const long long bytes = 4LL * smem_ints(N);
  if (N < 1 || P < 1 || bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  poa_rank_kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_code), static_cast<const int*>(node_col),
      static_cast<const int*>(node_sup), static_cast<const int*>(pred_nd),
      static_cast<const int*>(pred_w), static_cast<const int*>(pred_cnt),
      static_cast<const int*>(out_cnt), static_cast<const int*>(col_pos),
      static_cast<const int*>(col_node), static_cast<const int*>(n_nodes),
      static_cast<const int*>(n_cols), static_cast<int*>(order),
      static_cast<int*>(rank_of), static_cast<int*>(node_code_r),
      static_cast<int*>(node_col_r), static_cast<int*>(node_sup_r),
      static_cast<int*>(pred_nd_r), static_cast<int*>(pred_ranks),
      static_cast<int*>(pred_rows), static_cast<int*>(pred_cnt_r),
      static_cast<int*>(pred_w_r), static_cast<bool*>(is_end_r), N, P,
      leaves);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
