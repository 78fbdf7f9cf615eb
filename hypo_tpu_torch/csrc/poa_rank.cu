// Topological rank of a batch of POA graphs on Hopper: kernel 4, behind
// hypo_tpu_torch.poa.cuda_rank.rank_arrays, and the head of the tile
// program's arm step, behind cuda_rank.step_head.
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
// The step head (hypo_poa_step_head) also does, in the same launch, the
// arm fetch that hypo_tpu's tile body does before its rank
// (hypo_tpu/poa/device_full.py:756-765, with act and nn_eff of :444-445;
// plain version device_full._step_head_batch): for step k, read from the
// tile program's device counter, rows = idx[:, k], active = k < narms and
// rows >= 0, arm = pool[max(rows, 0)] widened to int32, its length where
// active, mode and weight of column k, act = active, an arm and a graph,
// and nn_eff = n_nodes where act.  An inactive window's arm is pool[0],
// as in the plain version: kernel 1 reads it.  It ranks with the arm
// step's leaves.  That removes the 17 small torch kernels of the fetch
// from every step; the head reads k and never writes it (every window
// reads it).  The fetch is a chain of three reads (k, then the window's
// idx entry, then its pool row), so it is spread over the rank's
// rounds: k is read first, the idx and narms entries after the column
// loads, and the arm row is copied after the rank arrays are written,
// which adds one round to the window's chain instead of three.
//
// The count equals the argsort because two facts hold on every graph the
// merge builds (tests/test_torch_rank_merge.py holds both on real
// tiles): the positions of the n_cols valid columns are a permutation of
// 0..n_cols-1, and col_node[c] lists exactly the valid nodes whose
// node_col is c (at most NCODES = 6 of them, one a code).  So a column
// alone gives each of its nodes (its position, its place among the
// column's ids), and the rank needs no read of node_col.
//
// What bounds it: bytes.  A window reads its state once (class 0: about
// 19 KB at full size) and writes its rank arrays once (up to 39 KB, 11 KB
// for the step's leaves); the arithmetic is a few integer operations an
// element.  A tile's windows all fit the card at once, so the time is the
// latency of a window's rounds to device memory, hidden by the loads the
// SM has in flight.  The first form of this kernel (a block of 256
// threads a window) reached 0.35-0.58 of its bound: at class 1 a tile is
// 256 windows, two blocks (16 warps) an SM; each of its seven block
// barriers waited for the block's slowest warp; it zero-filled 3N shared
// ints and scanned all N positions; every store was 4 bytes, and a [N, P]
// leaf split its index with a runtime division.  This form reaches
// 0.70-0.95 of the bound at both classes' tiles on an H100 SXM
// (chip_smoke.py phase 4c).  Design:
// - A window is a group of warps, and a block holds several windows, so
//   that a tile keeps about 32 warps an SM busy (rank_launch::rank_shape:
//   132 SMs x 32 warps over B windows, a power of two, at most a warp per
//   32 nodes): class 0 (B = 2,048) two warps a window, four windows a
//   block of 256 threads, 31 warps an SM (64 registers a thread allowed);
//   class 1 (B = 256) 16 warps a window, a window a block of 512, 31
//   warps an SM.  A group syncs with __syncwarp (one warp) or its own
//   named barrier 1 + group (bar.sync, 32 x warps); the kernel has no
//   __syncthreads, so a window that ends early, or the grid's ragged
//   end, stalls no other window.
// - Four phases, four window syncs: (0) clear the position counts below
//   n_cols and the node keys and rank slots below n_nodes, the only
//   shared words a later phase reads before it writes them; (1) a thread
//   a valid column reads its position and its col_node row (three 8-byte
//   loads) and writes its node count at its position and each of its
//   nodes' key (position << 3 | place among the column's ids); (2) an
//   exclusive scan of the counts over the n_cols positions only: a
//   segment of positions a warp, 32 at a time by shuffles with a carried
//   total, the segments' totals combined by one more shuffle scan in
//   every warp; (3) a thread a valid node turns its key into its rank
//   (its position's first rank, its segment's offset, its place) and
//   writes its id at that rank.  Then (4) the asked leaves.
// - Stores: with N a multiple of 4, P = 8 (the runners' P, a compile-time
//   case) and 16-byte aligned arrays, a thread writes four ranks of a [N]
//   leaf as one 16-byte store (is_end_r as one 4-byte store) and a [N, 8]
//   leaf half a row (16 bytes) at a time, reading that half row of
//   pred_nd / pred_w with one 16-byte load: consecutive threads write
//   consecutive 16-byte words.  Any other N or P (poa_full_batch takes
//   them) takes the generic path: a thread an element, 4-byte stores.
// - ``leaves`` (a bit a RankArrays field, cuda_rank.LEAF_BITS) says which
//   outputs to write: the arm step needs five of the eleven, the finish
//   what kernel 2 reads.  An input only those outputs read is not read.
// - Shared memory: three int arrays of N and the warps' totals, 3 KB a
//   window at class 0 (12 KB a block), 12 KB at class 1: no opt-in
//   attribute, nothing to set before a CUDA graph capture, no host read.
// - Every index is clamped into its array: no input may make the kernel
//   read or write outside the window's rows (or the arm pool's).
#include <cstdint>
#include <cuda_runtime.h>

#include "poa_rank_launch.h"

namespace {

using rank_launch::kMaxThreads;
using rank_launch::r4;
using rank_launch::Shape;
using rank_launch::window_ints;

constexpr int kCodes = 6;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 8;  // the P of the fast path (full_runner.P_FULL)

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
constexpr int kRowLeaves = kOrder | kCodeR | kColR | kSupR | kPredCntR |
                           kIsEndR;
constexpr int kPredLeaves = kPredNdR | kPredRanks | kPredRows | kPredWR;

// the state's leaves (device_full.PoaState), [B, ...] rows
struct State {
  const int *node_code, *node_col, *node_sup, *pred_nd, *pred_w, *pred_cnt,
      *out_cnt, *col_pos, *col_node, *n_nodes, *n_cols;
};

// the rank arrays (device_full.RankArrays); null where not asked
struct Ranks {
  int *order, *rank_of, *node_code_r, *node_col_r, *node_sup_r, *pred_nd_r,
      *pred_ranks, *pred_rows, *pred_cnt_r, *pred_w_r;
  bool* is_end_r;
};

// the step head's inputs (a tile program block's buffers) and outputs
struct Head {
  const int8_t* pool;  // [A, L]
  const int *plen, *idx, *aw, *narms, *k;
  const int8_t* amode;  // [B, K]
  int *arm, *arm_len, *mode, *w, *nn_eff;
  bool *active, *act;
  int L, K, A;
};

struct Args {
  State in;
  Ranks out;
  Head head;
  int B, N, P, leaves, warps;
};

// -- PTX: a window's barrier ------------------------------------------------
// the threads of one window: its warp, or named barrier 1 + group over
// the group's warps (barrier 0 is __syncthreads, never used here)
__device__ __forceinline__ void window_sync(int warps, int group) {
  if (warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(32 * warps)
                 : "memory");
}
// -- end of PTX -------------------------------------------------------------

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The arm fetch of step k for window b (its idx entry ``rows`` at bk =
// b * K + k and its narms, read earlier), by the window's T threads: the
// arm row (consecutive threads on consecutive bases) and, by thread 0,
// the window's scalars.
__device__ __forceinline__ void fetch_arm(const Head& h, int b, int n_nodes,
                                          int k, long long bk, int rows,
                                          int narms, int t, int T) {
  const bool active = k < narms && rows >= 0;
  const int rr = clampi(rows, 0, h.A - 1);
  const int8_t* src = h.pool + (long long)rr * h.L;
  int* dst = h.arm + (long long)b * h.L;
  for (int j = t; j < h.L; j += T) dst[j] = src[j];
  if (t == 0) {
    const int al = active ? h.plen[rr] : 0;
    const bool act = active && al > 0 && n_nodes > 0;
    h.arm_len[b] = al;
    h.mode[b] = h.amode[bk];
    h.w[b] = h.aw[bk];
    h.active[b] = active;
    h.act[b] = act;
    h.nn_eff[b] = act ? n_nodes : 0;
  }
}

__device__ __forceinline__ void st4(int* p, int x, int y, int z, int w) {
  *reinterpret_cast<int4*>(p) = make_int4(x, y, z, w);
}

// The [N] leaves of ranks r, 4 at a time (kFast) or one at a time.
template <bool kFast>
__device__ __forceinline__ void row_leaves(const Args& a, long long row,
                                           const int* key,
                                           const int* order_sh, int nn,
                                           int t, int T) {
  const int N = a.N;
  const int leaves = a.leaves;
  const State& s = a.in;
  const Ranks& o = a.out;
  if (leaves & kRankOf) {
    if constexpr (kFast) {
      for (int v = 4 * t; v < N; v += 4 * T) {
        const int4 r = *reinterpret_cast<const int4*>(key + v);
        st4(o.rank_of + row + v, v < nn ? r.x : kBig,
            v + 1 < nn ? r.y : kBig, v + 2 < nn ? r.z : kBig,
            v + 3 < nn ? r.w : kBig);
      }
    } else {
      for (int v = t; v < N; v += T)
        o.rank_of[row + v] = v < nn ? key[v] : kBig;
    }
  }
  if (!(leaves & kRowLeaves)) return;
  constexpr int E = kFast ? 4 : 1;
  for (int r0 = E * t; r0 < N; r0 += E * T) {
    int v[E], code[E], col[E], sup[E], cnt[E];
    bool ok[E], end[E];
    if constexpr (kFast) {
      const int4 x = *reinterpret_cast<const int4*>(order_sh + r0);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      v[0] = order_sh[r0];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ok[e] = r0 + e < nn;
      v[e] = ok[e] ? clampi(v[e], 0, N - 1) : 0;
      const long long src = row + v[e];
      code[e] = ok[e] && (leaves & kCodeR) ? s.node_code[src] : 0;
      col[e] = ok[e] && (leaves & kColR) ? s.node_col[src] : 0;
      sup[e] = ok[e] && (leaves & kSupR) ? s.node_sup[src] : 0;
      cnt[e] = max(ok[e] && (leaves & kPredCntR) ? s.pred_cnt[src] : 0, 1);
      end[e] = !ok[e] || ((leaves & kIsEndR) && s.out_cnt[src] == 0);
    }
    const long long d = row + r0;
    if constexpr (kFast) {
      if (leaves & kOrder) st4(o.order + d, v[0], v[1], v[2], v[3]);
      if (leaves & kCodeR)
        st4(o.node_code_r + d, code[0], code[1], code[2], code[3]);
      if (leaves & kColR)
        st4(o.node_col_r + d, col[0], col[1], col[2], col[3]);
      if (leaves & kSupR)
        st4(o.node_sup_r + d, sup[0], sup[1], sup[2], sup[3]);
      if (leaves & kPredCntR)
        st4(o.pred_cnt_r + d, cnt[0], cnt[1], cnt[2], cnt[3]);
      if (leaves & kIsEndR)
        *reinterpret_cast<uint32_t*>(o.is_end_r + d) =
            uint32_t(end[0]) | uint32_t(end[1]) << 8 |
            uint32_t(end[2]) << 16 | uint32_t(end[3]) << 24;
    } else {
      if (leaves & kOrder) o.order[d] = v[0];
      if (leaves & kCodeR) o.node_code_r[d] = code[0];
      if (leaves & kColR) o.node_col_r[d] = col[0];
      if (leaves & kSupR) o.node_sup_r[d] = sup[0];
      if (leaves & kPredCntR) o.pred_cnt_r[d] = cnt[0];
      if (leaves & kIsEndR) o.is_end_r[d] = end[0];
    }
  }
}

// A predecessor id's rank: its node's where it is a valid node, BIG for a
// node id at or past n_nodes (rank_of's padding), -1 for an empty slot
// (or an id past N).
__device__ __forceinline__ int pred_rank(int pn, const int* key, int nn,
                                         int N) {
  return pn >= 0 && pn < N ? (pn < nn ? key[pn] : kBig) : -1;
}

// The [N, P] leaves.  kFast (P = kSlots): half a row a thread, one
// 16-byte load of each input and one 16-byte store of each output;
// otherwise a slot a thread.  A padding row is zeros: pred_nd_r 0,
// pred_ranks 0, so pred_rows 1.
template <bool kFast>
__device__ __forceinline__ void pred_leaves(const Args& a, long long row,
                                            const int* key,
                                            const int* order_sh, int nn,
                                            int t, int T) {
  const int leaves = a.leaves;
  if (!(leaves & kPredLeaves)) return;
  const int N = a.N;
  const State& s = a.in;
  const Ranks& o = a.out;
  const bool need_nd = leaves & (kPredNdR | kPredRanks | kPredRows);
  if constexpr (kFast) {
    const long long prow = row * kSlots;
    for (int q = t; q < 2 * N; q += T) {
      const int r = q >> 1;
      int4 pn = make_int4(0, 0, 0, 0), pw = pn, pr = pn;
      if (r < nn) {
        const int v = clampi(order_sh[r], 0, N - 1);
        const long long src = prow + (long long)v * kSlots + 4 * (q & 1);
        if (need_nd) {
          pn = __ldg(reinterpret_cast<const int4*>(s.pred_nd + src));
          pr = make_int4(pred_rank(pn.x, key, nn, N),
                         pred_rank(pn.y, key, nn, N),
                         pred_rank(pn.z, key, nn, N),
                         pred_rank(pn.w, key, nn, N));
        }
        if (leaves & kPredWR)
          pw = __ldg(reinterpret_cast<const int4*>(s.pred_w + src));
      }
      const long long d = prow + 4LL * q;
      if (leaves & kPredNdR) st4(o.pred_nd_r + d, pn.x, pn.y, pn.z, pn.w);
      if (leaves & kPredRanks) st4(o.pred_ranks + d, pr.x, pr.y, pr.z, pr.w);
      if (leaves & kPredRows)
        st4(o.pred_rows + d, pn.x >= 0 ? pr.x + 1 : 0,
            pn.y >= 0 ? pr.y + 1 : 0, pn.z >= 0 ? pr.z + 1 : 0,
            pn.w >= 0 ? pr.w + 1 : 0);
      if (leaves & kPredWR) st4(o.pred_w_r + d, pw.x, pw.y, pw.z, pw.w);
    }
  } else {
    const int P = a.P;
    const long long prow = row * P;
    for (int k = t; k < N * P; k += T) {
      const int r = k / P;
      int pn = 0, pr = 0, pw = 0;
      if (r < nn) {
        const long long src =
            prow + (long long)clampi(order_sh[r], 0, N - 1) * P + (k - r * P);
        if (need_nd) {
          pn = s.pred_nd[src];
          pr = pred_rank(pn, key, nn, N);
        }
        if (leaves & kPredWR) pw = s.pred_w[src];
      }
      const long long d = prow + k;
      if (leaves & kPredNdR) o.pred_nd_r[d] = pn;
      if (leaves & kPredRanks) o.pred_ranks[d] = pr;
      if (leaves & kPredRows) o.pred_rows[d] = pn >= 0 ? pr + 1 : 0;
      if (leaves & kPredWR) o.pred_w_r[d] = pw;
    }
  }
}

template <bool kFast, bool kHead>
__global__ void __launch_bounds__(kMaxThreads, 2)
    poa_rank_kernel(const Args a) {
  extern __shared__ int4 smem4[];
  const int G = a.warps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / G;  // the block's window this warp serves
  const int wg = warp - group * G;
  const int T = 32 * G;
  const int t = wg * 32 + lane;
  const int b = blockIdx.x * (blockDim.x / T) + group;
  if (b >= a.B) return;
  const int N = a.N;
  int* const key = reinterpret_cast<int*>(smem4) + group * window_ints(N, G);
  int* const order_sh = key + r4(N);
  int* const at_pos = order_sh + r4(N);
  int* const tot = at_pos + r4(N);
  const long long row = (long long)b * N;
  const int n_nodes = a.in.n_nodes[b];
  const int nn = clampi(n_nodes, 0, N);
  const int nc = clampi(a.in.n_cols[b], 0, N);

  // the head's step, read now, used after phase 1 (its window's idx
  // entry and narms) and at the end (its arm)
  int step = 0;
  if constexpr (kHead) step = *a.head.k;

  // 0. clear what a later phase reads before it is written: the counts
  // below n_cols (position 0 at least), keys and rank slots below n_nodes
  for (int i = t; i < max(nc, 1); i += T) at_pos[i] = 0;
  for (int i = t; i < nn; i += T) {
    key[i] = 0;
    order_sh[i] = 0;
  }
  window_sync(G, group);

  // 1. per valid column: its node count at its position, and each of its
  // nodes' key (position << 3 | place among the column's ids)
  for (int c = t; c < nc; c += T) {
    const long long cr = (row + c) * kCodes;
    int cn[kCodes];
    if constexpr (kFast) {
#pragma unroll
      for (int k = 0; k < kCodes; k += 2) {
        const int2 x =
            __ldg(reinterpret_cast<const int2*>(a.in.col_node + cr + k));
        cn[k] = x.x;
        cn[k + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCodes; ++k) cn[k] = a.in.col_node[cr + k];
    }
    const int p = a.in.col_pos[row + c];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kCodes; ++k) cnt += cn[k] >= 0;
    if (p >= 0 && p < nc) at_pos[p] = cnt;
    const int pk = clampi(p, 0, nc - 1) << 3;
#pragma unroll
    for (int k = 0; k < kCodes; ++k) {
      const int u = cn[k];
      if (u < 0 || u >= N) continue;
      int within = 0;
#pragma unroll
      for (int k2 = 0; k2 < kCodes; ++k2) within += cn[k2] >= 0 && cn[k2] < u;
      key[u] = pk | within;
    }
  }
  long long bk = 0;
  int rows = -1, narms = 0;
  if constexpr (kHead) {
    bk = (long long)b * a.head.K + clampi(step, 0, a.head.K - 1);
    rows = a.head.idx[bk];
    narms = a.head.narms[b];
  }
  window_sync(G, group);

  // 2. the first rank at each position: warp wg scans positions [wg <<
  // shift, (wg + 1) << shift) below n_cols, 32 at a time, carrying its
  // running total; woff (lane i) is segment i's offset
  int shift = 5;
  while ((G << shift) < nc) ++shift;
  {
    const int hi = min((wg + 1) << shift, nc);
    int carry = 0;
    for (int i0 = min(wg << shift, nc); i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int x = i < hi ? at_pos[i] : 0;
      const int s = warp_inclusive_scan(x, lane);
      if (i < hi) at_pos[i] = carry + s - x;
      carry += __shfl_sync(kFull, s, 31);
    }
    if (G > 1 && lane == 0) tot[wg] = carry;
  }
  window_sync(G, group);
  int woff = 0;
  if (G > 1) {
    const int x = lane < G ? tot[lane] : 0;
    woff = warp_inclusive_scan(x, lane) - x;
  }

  // 3. each valid node's rank: its position's first rank, its segment's
  // offset, its place; and its id at that rank.  The loop's trip count is
  // the warp's, so every lane takes part in the shuffle.
  for (int v0 = wg * 32; v0 < nn; v0 += T) {
    const int v = v0 + lane;
    const int kk = v < nn ? key[v] : 0;
    const int p = kk >> 3;
    const int off = __shfl_sync(kFull, woff, (p >> shift) & 31);
    if (v < nn) {
      const int r = at_pos[p] + off + (kk & 7);
      key[v] = r;
      order_sh[clampi(r, 0, N - 1)] = v;
    }
  }
  window_sync(G, group);

  // 4. the rank arrays, then the head's arm
  row_leaves<kFast>(a, row, key, order_sh, nn, t, T);
  pred_leaves<kFast>(a, row, key, order_sh, nn, t, T);
  if constexpr (kHead)
    fetch_arm(a.head, b, n_nodes, step, bk, rows, narms, t, T);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kFast, bool kHead>
int launch(const Args& a, const Shape& s, cudaStream_t stream) {
  poa_rank_kernel<kFast, kHead>
      <<<rank_launch::blocks(s, a.B), rank_launch::threads(s),
         rank_launch::smem_bytes(s, a.N), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch of ``a`` (its leaves' outputs set), at rank_shape(B, N); the
// fast path where every array it reads or writes by 16 bytes allows.
int run(Args a, bool head, void* stream) {
  if (a.B == 0) return 0;
  const Shape s = rank_launch::rank_shape(a.B, a.N);
  if (a.P < 1 || !rank_launch::shape_ok(s, a.N))
    return static_cast<int>(cudaErrorInvalidValue);
  a.warps = s.warps;
  const void* wide[] = {a.in.pred_nd,    a.in.pred_w,      a.in.col_node,
                        a.out.order,     a.out.rank_of,    a.out.node_code_r,
                        a.out.node_col_r, a.out.node_sup_r, a.out.pred_nd_r,
                        a.out.pred_ranks, a.out.pred_rows,  a.out.pred_cnt_r,
                        a.out.pred_w_r,  a.out.is_end_r};
  bool fast = a.N % 4 == 0 && a.P == kSlots;
  for (const void* p : wide) fast = fast && aligned16(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head)
    return fast ? launch<true, true>(a, s, st) : launch<false, true>(a, s, st);
  return fast ? launch<true, false>(a, s, st) : launch<false, false>(a, s, st);
}

State state_of(const void* const* p) {
  const int* const* q = reinterpret_cast<const int* const*>(p);
  return {q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10]};
}

Ranks ranks_of(void* const* p) {
  int* const* q = reinterpret_cast<int* const*>(p);
  return {q[0], q[1], q[2], q[3], q[4], q[5],
          q[6], q[7], q[8], q[9], static_cast<bool*>(p[10])};
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..3]: the launch kernel 4 makes over B windows of N nodes (warps a
// window, windows a block, threads and shared bytes a block); returns
// whether the kernel takes it.
int hypo_poa_rank_shape(int B, int N, int* out) {
  const Shape s = rank_launch::rank_shape(B, N);
  out[0] = s.warps;
  out[1] = s.windows;
  out[2] = rank_launch::threads(s);
  out[3] = static_cast<int>(rank_launch::smem_bytes(s, N));
  return rank_launch::shape_ok(s, N);
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
  const void* in[] = {node_code, node_col, node_sup, pred_nd,
                      pred_w,    pred_cnt, out_cnt,  col_pos,
                      col_node,  n_nodes,  n_cols};
  void* out[] = {order,     rank_of,    node_code_r, node_col_r,
                 node_sup_r, pred_nd_r, pred_ranks,  pred_rows,
                 pred_cnt_r, pred_w_r,  is_end_r};
  Args a{state_of(in), ranks_of(out), {}, B, N, P, leaves, 1};
  return run(a, false, stream);
}

// The step head: for step *k (a device int), each window's arm fetch
// (arm [B, L], arm_len, mode, w, nn_eff int32 [B], active, act bool [B])
// from the tile's pool (int8 [A, L]), plen [A], idx, amode (int8), aw
// [B, K] and narms [B], then the rank arrays of ``leaves`` (state and
// ranks: the 11 leaves of hypo_poa_rank each, in its order).  Returns as
// hypo_poa_rank does; also cudaErrorInvalidValue for L, K or A < 1.
int hypo_poa_step_head(const void* const* state, const void* pool,
                       const void* plen, const void* idx, const void* amode,
                       const void* aw, const void* narms, const void* k,
                       void* arm, void* arm_len, void* mode, void* w,
                       void* active, void* act, void* nn_eff,
                       void* const* ranks, int B, int N, int P, int L, int K,
                       int A, int leaves, void* stream) {
  if (L < 1 || K < 1 || A < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Head h{static_cast<const int8_t*>(pool),
         static_cast<const int*>(plen),
         static_cast<const int*>(idx),
         static_cast<const int*>(aw),
         static_cast<const int*>(narms),
         static_cast<const int*>(k),
         static_cast<const int8_t*>(amode),
         static_cast<int*>(arm),
         static_cast<int*>(arm_len),
         static_cast<int*>(mode),
         static_cast<int*>(w),
         static_cast<int*>(nn_eff),
         static_cast<bool*>(active),
         static_cast<bool*>(act),
         L,
         K,
         A};
  Args a{state_of(state), ranks_of(ranks), h, B, N, P, leaves, 1};
  return run(a, true, stream);
}

}  // extern "C"
