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
//   position p moves up by the insertions anchored before p, inserted
//   column t of the run anchored at q lands at q + shift(q) + t;
// - node supports and edge weights grow by w; an edge (previous base's
//   node -> this base's node) takes the first predecessor slot that
//   holds it, else a new slot at pred_cnt;
// - the window overflows when its nodes or columns would pass N, or a
//   new edge would need a slot >= P.
// A window that is not active, has no arm, or overflowed before keeps
// every leaf; one that overflows now keeps every leaf but sets ovf.
//
// What bounds it: a chain of dependent reads of scattered words.  The
// bytes a window needs are few, O(L + N) words (about 7 KB at class 0),
// but most are single words at data-dependent places (a column's
// col_node entry is 4 of its 24 bytes, an edge weight 4 of its node's 32),
// so the card moves whole 32-byte sectors, and each lookup waits on the
// one before it: flags -> a base's rank -> its column -> the column's
// node -> that node's predecessors.  A tile's windows all fit the card at
// once, so they walk that chain in step.  The first form of this kernel
// (a block a window, a thread a base) added a block scan, a histogram of
// anchors over N + 1 slots and its scan, nine block barriers and a second
// read of every column position.  Design:
// - A window is one warp, or a group of warps, and a block holds several
//   windows: ``per`` bases a lane, interleaved (base j = t + T e for
//   thread t of T, e < per), so that a warp's load reads neighbouring
//   ranks, columns and nodes in a few lines.  (Contiguous bases a lane
//   read up to 32 lines a load and were slower at every launch.)
//   merge_launch::merge_shape (poa_merge_launch.h) picks 2 bases a lane
//   at class 0 (L = 126: two warps a window, four windows a block) and 1
//   at class 1 (L = 510: 16 warps, a window a block), the fastest of a
//   sweep of bases a lane (1, 2, 4) and windows a block (1-8) on an H100
//   at both classes' tiles.  A group's threads sync with named
//   barrier 1 + group (bar.sync, 32 x warps), a single warp with
//   __syncwarp and shuffles.  The kernel has no __syncthreads: a window
//   that returns (nothing to merge, an overflow, the grid's ragged end)
//   stalls no other window.
// - Four rounds to device memory, each issued at once: (1) the flags and
//   counts with every base's alignment and code; (2) a matched base's
//   column (node_col_r[rank]), and the col_pos row [:n_cols] into shared
//   memory by 16-byte cp.async copies (the rewrite needs it whole);
//   (3) a matched base's position (from shared memory) and col_node
//   entry, then at once its existing node's P predecessor ids (two
//   16-byte copies through L1, so that the second finds the line the
//   first brought) and count, copied to shared memory while the running
//   values are scanned; (4) after the scan, the same for every created
//   node, whose slots hold the reset value on every real state, which
//   the kernel does not assume.  (Staging whole node_col_r and pred_cnt
//   rows instead read more bytes and gained nothing; an L2 prefetch of
//   the edge weights the atomics add to, the read-only path for the
//   lookups, and issuing the col_node loads before the col_pos row has
//   landed gained nothing either.)
// - The running counts and maxima are a scan of four values: a warp
//   scan per e, the warps' totals of a group combined by one more warp
//   scan, carried from e to e; the creation and insertion counts travel
//   packed in one word.
// - No histogram: lastpos is a running maximum, so the insertions'
//   anchors are non-decreasing in j, and one thread writes each, in order
//   of insertion, to shared memory.  An existing column's shift, and a
//   new column's, is the count of anchors below its position: a
//   branchless binary search of that sorted list (log2 of the
//   insertions steps, four columns a thread at a time).
// - Every read of the old state comes before the window's first write,
//   and one window sync separates them (it also ORs the edges'
//   overflow); the existing columns' positions are written from their
//   staged copies.  Additions are atomics, so the result equals the
//   plain version's scatter-add even where two bases of an alignment
//   share a target (a real alignment visits each column once, in order:
//   the tests hold that).  Every index is clamped or range-checked into
//   its window, as the plain version's scatter drops what falls outside.
// - Shared memory: a window's col_pos row, its bases' anchors, nodes,
//   counts and slot copies, and its warps' totals, 6.6 KB at class 0 and
//   26.5 KB at class 1, under 48 KB a block: no opt-in attribute,
//   nothing to set before a CUDA graph capture, no host read.  L > 512
//   is refused (16 warps of a base a lane), as is a window past 48 KB
//   (N > 6,528 at L = 512).
#include <cstdint>
#include <cuda_runtime.h>

#include "poa_merge_launch.h"

namespace {

using merge_launch::kMaxThreads;
using merge_launch::kSlots;
using merge_launch::r4;
using merge_launch::Shape;
using merge_launch::window_ints;

constexpr int kCodes = 6;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// -- PTX: copies into shared memory and a window's barrier --------------
// 16 bytes, past L1 (.cg) or through it (.ca: a node's two halves)
__device__ __forceinline__ void copy16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy16_l1(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the threads of one window: its warp, or named barrier 1 + group over
// the group's warps (barrier 0 is __syncthreads, never used here)
__device__ __forceinline__ void window_sync(int warps, int group) {
  if (warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(32 * warps)
                 : "memory");
}
// -- end of PTX ---------------------------------------------------------

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// running values over the bases: two sums (creations, insertions) and
// two maxima (matched column position, matched base index)
struct Run {
  int creates, inserts, pos, j;
};

__device__ __forceinline__ Run none() { return {0, 0, -kBig, -1}; }

__device__ __forceinline__ Run join(const Run& x, const Run& y) {
  return {x.creates + y.creates, x.inserts + y.inserts, max(x.pos, y.pos),
          max(x.j, y.j)};
}

// inclusive scan over the warp's lanes; the creation and insertion
// counts (at most 32 x 16 a scan) travel packed in one word
__device__ __forceinline__ Run warp_scan(Run x, int lane) {
  int counts = x.creates | x.inserts << 16;
  for (int d = 1; d < 32; d <<= 1) {
    const int c = __shfl_up_sync(kFull, counts, d);
    const int p = __shfl_up_sync(kFull, x.pos, d);
    const int j = __shfl_up_sync(kFull, x.j, d);
    if (lane >= d) {
      counts += c;
      x.pos = max(x.pos, p);
      x.j = max(x.j, j);
    }
  }
  return {counts & 0xffff, counts >> 16, x.pos, x.j};
}

__device__ __forceinline__ Run shfl(const Run& x, int src) {
  return {__shfl_sync(kFull, x.creates, src),
          __shfl_sync(kFull, x.inserts, src), __shfl_sync(kFull, x.pos, src),
          __shfl_sync(kFull, x.j, src)};
}

// the bits of a base
constexpr int kValid = 1, kMatch = 2, kCreates = 4, kInserts = 8, kHas = 16;

// Copies src[0, n) to shared dst, 16 bytes a copy where the row allows
// (n is rounded up to 4 within a row of N, a multiple of 4), by the
// window's T threads.
__device__ __forceinline__ void stage(int* dst, const int* src, int n, int N,
                                      int t, int T) {
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * t; i < n; i += 4 * T) copy16(dst + i, src + i);
  } else {
    for (int i = t; i < n; i += T) copy4(dst + i, src + i);
  }
}

// Copies a node's first kSlots predecessor ids to shared memory (two
// 16-byte copies where ``vec``: P = kSlots and 16-byte rows; through L1,
// so that the second finds the line the first brought).
__device__ __forceinline__ void fetch_slots(int* dst, const int* pv, int P,
                                            bool vec) {
  if (vec) {
    copy16_l1(dst, pv);
    copy16_l1(dst + 4, pv + 4);
  } else {
    for (int q = 0; q < min(P, kSlots); ++q) copy4(dst + q, pv + q);
  }
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
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
                     const bool* __restrict__ active, int B, int N, int L,
                     int P, int G) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / G;   // the block's window this warp serves
  const int wg = warp - group * G;
  const int t = wg * 32 + lane;  // thread of the window: bases t + T e
  const int T = 32 * G;
  const int b = blockIdx.x * (blockDim.x / T) + group;
  if (b >= B) return;

  // -- round 1: flags and counts, and the bases' alignment and codes ------
  const int al = arm_len[b];
  const bool act = active[b];
  const bool old_ovf = ovf[b];
  const int nn = n_nodes[b];
  const int nc = n_cols[b];
  const int wt = w[b];
  const int* const wm = matched + (long long)b * L;
  const int* const warm = arm + (long long)b * L;
  int m[E], code[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    m[e] = j < L ? wm[j] : -1;
    code[e] = j < L ? warm[j] : 0;
  }
  // nothing to merge: every leaf stays, ovf included
  if (!act || al <= 0 || old_ovf) return;

  // the window's rows; indices below are the window's own
  const long long row = (long long)b * N;
  int* const wcode = node_code + row;
  int* const wcol = node_col + row;
  int* const wsup = node_sup + row;
  int* const wpnd = pred_nd + row * P;
  int* const wpw = pred_w + row * P;
  int* const wpc = pred_cnt + row;
  int* const wout = out_cnt + row;
  int* const wcp = col_pos + row;
  int* const wcn = col_node + row * kCodes;
  const int* const wncr = node_col_r + row;
  int* sh = reinterpret_cast<int*>(smem4) + group * window_ints(N, L, E, G);
  int* const cp_sh = sh;                   // col_pos[:n_cols]
  int* const anc = cp_sh + r4(N);          // insertions' anchors, in order
  int* const node_sh = anc + r4(L);        // node of base j
  int* const cnt_sh = node_sh + r4(L);     // pred_cnt of base j's node
  int* const slot_sh = cnt_sh + r4(L);     // its first kSlots pred ids
  Run* const tot_sh = reinterpret_cast<Run*>(slot_sh + kSlots * r4(L));
  int* const any_sh = reinterpret_cast<int*>(tot_sh + E * G);
  const int nc_s = clampi(nc, 0, N);
  const bool vec =
      P == kSlots && (reinterpret_cast<uintptr_t>(wpnd) & 15) == 0;

  // -- round 2: a matched base's column; the col_pos row into shared
  // memory ---------------------------------------------------------------
  int cm[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    // an empty graph (the window's first arm): every base an insertion
    if (!(j < al && nn > 0)) m[e] = -1;
    if (!(j < al)) code[e] = 0;
    cm[e] = m[e] >= 0 ? wncr[min(m[e], N - 1)] : 0;
  }
  stage(cp_sh, wcp, nc_s, N, t, T);
  copies_done();
  window_sync(G, group);

  // -- round 3: position and col_node entry of a matched base --------------
  int mpos[E], node[E], bits[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    const bool valid = j < L && j < al;
    int p = -kBig, ex = -1;
    if (m[e] >= 0) {
      const int cc = clampi(cm[e], 0, N - 1);
      p = cc < nc_s ? cp_sh[cc] : wcp[cc];
      ex = wcn[cc * kCodes + clampi(code[e], 0, kCodes - 1)];
    }
    mpos[e] = p;
    node[e] = ex;
    bits[e] = (valid ? kValid : 0) | (m[e] >= 0 ? kMatch : 0);
  }
  // an existing node's slots, copied while the scan runs
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    const bool valid = bits[e] & kValid;
    const bool is_match = bits[e] & kMatch;
    const bool creates = valid && (!is_match || node[e] < 0);
    bits[e] |= (creates ? kCreates : 0) | (valid && !is_match ? kInserts : 0);
    if (valid && j >= 1 && !creates && node[e] < N) {
      fetch_slots(slot_sh + kSlots * j, wpnd + node[e] * P, P, vec);
      copy4(cnt_sh + j, wpc + node[e]);
    }
  }

  // -- the scan of the running values: per base index e a scan over the
  // window's threads, carried from e - 1 ---------------------------------
  Run inc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    inc[e] = warp_scan({(bits[e] & kCreates) != 0, (bits[e] & kInserts) != 0,
                        mpos[e], (bits[e] & kMatch) ? j : -1},
                       lane);
  }
  if (G > 1) {
    if (lane == 31)
#pragma unroll
      for (int e = 0; e < E; ++e) tot_sh[e * G + wg] = inc[e];
    window_sync(G, group);
  }
  Run carry = none();  // the bases before t + T e's row of the window
  int col[E], lp[E], dj[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    Run before = carry, row_total;
    if (G == 1) {
      row_total = shfl(inc[e], 31);
    } else {
      // lane k scans warp k's total: the warps before this one, and all
      const Run ws = warp_scan(lane < G ? tot_sh[e * G + lane] : none(), lane);
      row_total = shfl(ws, G - 1);
      const Run pre = shfl(ws, max(wg - 1, 0));
      if (wg > 0) before = join(before, pre);
    }
    const Run run = join(before, inc[e]);
    carry = join(carry, row_total);
    if (bits[e] & kCreates) {
      node[e] = nn - 1 + run.creates;
      // a created node's slots and count (the reset values on a real
      // state)
      if (j >= 1 && node[e] >= 0 && node[e] < N) {
        fetch_slots(slot_sh + kSlots * j, wpnd + node[e] * P, P, vec);
        copy4(cnt_sh + j, wpc + node[e]);
      }
    }
    col[e] = (bits[e] & kMatch) ? cm[e] : nc - 1 + run.inserts;
    lp[e] = max(run.pos, -1);
    dj[e] = j - run.j;
    if (bits[e] & kInserts) anc[run.inserts - 1] = lp[e];
    if (j < L) node_sh[j] = node[e];
  }
  const Run total = carry;
  copies_done();  // this thread's slot copies
  window_sync(G, group);  // every base's node and anchor

  // -- round 4: each edge's slot ------------------------------------------
  int slot[E];
  bool bad = false;  // an edge needs a slot past P
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    const bool edge = (bits[e] & kValid) && j >= 1;
    const int u = edge ? node_sh[j - 1] : -1;
    const int v = node[e];
    bool has = false;
    int s = 0;
    if (edge && v >= 0 && v < N) {
      const int4 lo = reinterpret_cast<const int4*>(slot_sh + kSlots * j)[0];
      const int4 hi = reinterpret_cast<const int4*>(slot_sh + kSlots * j)[1];
      const int sl[kSlots] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        if (!has && q < P && sl[q] == u) {
          has = true;
          s = q;
        }
      for (int q = kSlots; q < P && !has; ++q)
        if (wpnd[v * P + q] == u) {
          has = true;
          s = q;
        }
      if (!has) s = cnt_sh[j];
    } else if (edge) {
      has = u == 0;  // the plain version compares u with a zero there
    }
    slot[e] = s;
    if (has) bits[e] |= kHas;
    bad = bad || (edge && !has && s >= P);
  }
  // every read of the old state is done: the window's threads agree on
  // its overflow
  bool win_ovf = __any_sync(kFull, bad);
  if (G > 1) {
    if (lane == 0) any_sh[wg] = win_ovf;
    window_sync(G, group);
    win_ovf = __any_sync(kFull, lane < G && any_sh[lane]);
  }
  if (win_ovf || nn + total.creates > N || nc + total.inserts > N) {
    if (t == 0) ovf[b] = true;
    return;
  }

  // -- the writes ----------------------------------------------------------
  const int n_anc = total.inserts;
  // existing columns, four a lane at a time: p + #(anchors < p)
  for (int c0 = t; c0 < nc_s; c0 += 4 * T) {
    int x[4], base[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q * T;
      x[q] = c < nc_s ? cp_sh[c] : 0;
      base[q] = 0;
    }
    for (int n = n_anc; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (anc[base[q] + half] < clampi(x[q], 0, N)) base[q] += half;
      n -= half;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q * T;
      if (c < nc_s)
        wcp[c] = x[q] + (n_anc > 0 ? base[q] + (anc[base[q]] <
                                                clampi(x[q], 0, N))
                                   : 0);
    }
  }
  const int slots = N * P;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = t + T * e;
    const bool valid = bits[e] & kValid;
    const bool creates = bits[e] & kCreates;
    const bool edge = valid && j >= 1;
    const int u = edge ? node_sh[j - 1] : -1;
    const int v = node[e];
    const bool node_ok = v >= 0 && v < N;
    const bool v_ok = edge && node_ok;
    if ((bits[e] & kInserts) && col[e] >= 0 && col[e] < N) {
      int shift = 0;
      if (lp[e] >= 0) {
        const int x = min(lp[e], N);
        int base = 0;
        for (int n = n_anc; n > 1;) {
          const int half = n >> 1;
          if (anc[base + half] < x) base += half;
          n -= half;
        }
        shift = base + (anc[base] < x);  // n_anc >= 1: this base
      }
      wcp[col[e]] = lp[e] + shift + dj[e];
    }
    if (creates && node_ok) {
      wcode[v] = code[e];
      wcol[v] = col[e];
    }
    if (valid && node_ok) atomicAdd(&wsup[v], wt);
    if (creates && col[e] >= 0 && col[e] < N)
      wcn[col[e] * kCodes + clampi(code[e], 0, kCodes - 1)] = v;
    // the plain version's flat slot index, kept if it falls in the window
    const int flat = v * P + min(slot[e], P - 1);
    const bool flat_ok = flat >= 0 && flat < slots;
    if (v_ok && flat_ok) atomicAdd(&wpw[flat], wt);
    if (edge && !(bits[e] & kHas)) {
      if (v_ok) {
        if (flat_ok) wpnd[flat] = u;
        atomicAdd(&wpc[v], 1);
      }
      if (u >= 0 && u < N) atomicAdd(&wout[u], 1);
    }
  }
  if (t == 0) {
    n_nodes[b] = nn + total.creates;
    n_cols[b] = nc + total.inserts;
  }
}

template <int E>
int launch(void* const* p, int B, int N, int L, int P, const Shape& s,
           cudaStream_t stream) {
  const int grid = merge_launch::blocks(s, B);
  const int threads = merge_launch::threads(s);
  const int bytes = static_cast<int>(merge_launch::smem_bytes(s, N, L));
  poa_merge_kernel<E><<<grid, threads, bytes, stream>>>(
      static_cast<int*>(p[0]), static_cast<int*>(p[1]),
      static_cast<int*>(p[2]), static_cast<int*>(p[3]),
      static_cast<int*>(p[4]), static_cast<int*>(p[5]),
      static_cast<int*>(p[6]), static_cast<int*>(p[7]),
      static_cast<int*>(p[8]), static_cast<int*>(p[9]),
      static_cast<int*>(p[10]), static_cast<bool*>(p[11]),
      static_cast<const int*>(p[12]), static_cast<const int*>(p[13]),
      static_cast<const int*>(p[14]), static_cast<const int*>(p[15]),
      static_cast<const int*>(p[16]), static_cast<const bool*>(p[17]), B,
      N, L, P, s.warps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..4]: the launch hypo_poa_merge makes at (N, L) (bases a thread,
// warps a window, windows a block, threads and shared bytes a block);
// returns whether the kernel takes it.
int hypo_poa_merge_shape(int N, int L, int* out) {
  const Shape s = merge_launch::merge_shape(N, L);
  out[0] = s.per;
  out[1] = s.warps;
  out[2] = s.windows;
  out[3] = merge_launch::threads(s);
  out[4] = static_cast<int>(merge_launch::smem_bytes(s, N, L));
  return merge_launch::shape_ok(s, N, L);
}

// All pointers are device pointers of contiguous tensors (ovf and active
// are bool, one byte); the twelve state leaves are updated in place, at
// the launch merge_launch::merge_shape(N, L).  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel
// does not take.
int hypo_poa_merge(void* node_code, void* node_col, void* node_sup,
                   void* pred_nd, void* pred_w, void* pred_cnt,
                   void* out_cnt, void* col_pos, void* col_node,
                   void* n_nodes, void* n_cols, void* ovf,
                   const void* node_col_r, const void* matched,
                   const void* arm, const void* arm_len, const void* w,
                   const void* active, int B, int N, int L, int P,
                   void* stream) {
  if (B == 0) return 0;
  const Shape s = merge_launch::merge_shape(N, L);
  if (P < 1 || !merge_launch::shape_ok(s, N, L))
    return static_cast<int>(cudaErrorInvalidValue);
  void* const p[18] = {node_code, node_col, node_sup, pred_nd, pred_w,
                       pred_cnt, out_cnt, col_pos, col_node, n_nodes,
                       n_cols, ovf, const_cast<void*>(node_col_r),
                       const_cast<void*>(matched), const_cast<void*>(arm),
                       const_cast<void*>(arm_len), const_cast<void*>(w),
                       const_cast<void*>(active)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.per == 1 ? launch<1>(p, B, N, L, P, s, st)
                    : launch<2>(p, B, N, L, P, s, st);
}

}  // extern "C"
