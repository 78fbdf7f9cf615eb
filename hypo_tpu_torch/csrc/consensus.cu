// spoa heaviest-bundle consensus for a batch of windows, in rank space:
// kernel 2, behind hypo_tpu_torch.poa.cuda_consensus.heaviest_bundle.
//
// Replaces the Pallas TPU kernel hypo_tpu/poa/pallas_consensus.py
// (_build_kernel :44-156, pallas_call in heaviest_bundle_pallas), which
// runs the reference's sequential loop (external/spoa/src/graph.cpp:
// 610-705) on the TPU's scalar core out of SMEM.  The tie rules, each
// kept exactly (the plain version poa/device_full.py:_consensus_wavefront
// and the Pallas kernel in interpret mode hold it to them in the tests):
//   1. relax (pallas_consensus.py:53-73): a node takes the in-edge of the
//      highest weight, then the highest predecessor score, the LATER slot
//      winning ties (take when bw < w, or bw == w and bsc <= sc, from
//      bw = -1, bsc = NEG); slot 0 is always examined (max(pred_cnt, 1)
//      slots, at most P), an empty slot has rank -1 and is never taken;
//      the score is bw + bsc, or -1 without a usable predecessor;
//   2. first pass (:76-86): ranks in order, the FIRST maximum kept
//      (strict <, from NEG at rank 0);
//   3. branch completion (:89-138), while n_nodes > 0, the chosen rank is
//      not an end node and fewer than N rounds have run: ban (score -1)
//      the other predecessors of every successor of the chosen rank;
//      reset the suffix after it and re-relax it, a predecessor whose
//      score is -1 counting as banned (a genuine -1 too, as in spoa);
//      the new choice is the first rank of the suffix with the highest
//      score above 0 (threshold 0, strict <), else rank0, the rank of
//      node id 0;
//   4. backtrack (:141-154): code and support from the chosen rank along
//      the chosen predecessors, emitted backward, stopping at rank -1 or
//      after N steps; then the length.  Entries past it are written 0.
// The Pallas kernel bit-packed its tables only to fit the TPU's SMEM;
// here weights and scores stay int32.
//
// What bounds it: latency.  Each pass is a serial chain (a node's score
// needs its predecessors' scores) of a few integer operations a node;
// the bytes (13 + 8 per real in-edge, a node) are read once.  The first
// form of this kernel ran one thread per window out of device memory:
// a class-1 tile (256 windows) was 8 blocks on 8 SMs, no load was
// coalesced, and every step of the chain waited on L2.  Design:
// - One warp per window.  Two windows share a block where that keeps
//   more windows on an SM (windows_per_block): a class-0 tile's 2,048
//   windows then fit the 132 SMs in one wave, 16 an SM, where blocks of
//   one hold 15 (each block costs 1 KB of shared memory more).  A
//   class-1 tile (256 windows) gets one a block, which spreads it over
//   the most SMs.
// - The warp stages the window's rows below n_nodes into shared memory
//   with coalesced 16-byte loads, 8 in flight a lane: predecessor ranks
//   as int16 (clamped into [-1, N - 1], so that no input reads outside
//   the window's tables), weights as int32; for all N rows a byte of
//   slot count and end flag; scores (int32) and chosen predecessors
//   (int16) start at -1.  13.75 KB a window at class 0 (N = 256, P = 8),
//   55 KB at class 1 (N = 1024; above 48 KB, so the launch raises the
//   block's dynamic shared memory limit).
// - The serial chains (first pass, each re-relax) run on lane 0 from
//   shared memory.  Most nodes have one in-edge, and most of those come
//   from the previous rank, so the loop loads the next rank's slot 0
//   (count, rank, weight, its predecessor's score) while it relaxes this
//   one, and takes rank r - 1's score from a register.  Further slots
//   are read in the loop.  Lanes sharing a node's slots would pay a
//   shuffle reduction and a broadcast on every node with more than one
//   in-edge (a quarter of a real tile's nodes), and save nothing on the
//   rest; loading two ranks ahead adds more than it hides.
// - The parts that are not a chain go across the warp: the ban and the
//   suffix reset in one pass over the ranks above the chosen one (every
//   write stores -1, so the lanes need no order; successors of a rank,
//   and the predecessors a suffix node reads, lie above / below it, an
//   edge joining two columns in order), and the output: lane 0 records
//   the backtrack's ranks in shared memory (over the dead scores), then
//   the warp gathers codes and supports and writes them, with the zero
//   tail, coalesced.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kMaxP = 8;          // slots in a flag byte's low nibble
constexpr int kEnd = 0x80;        // flag byte: end node
constexpr int kSlots = 0x0f;      // flag byte: slots examined
constexpr int kUnroll = 8;        // 16-byte loads in flight a lane
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kSmemPerSm = 233472;  // an SM's shared memory
constexpr int kBlockReserve = 1024;  // shared memory the system keeps a block
constexpr int kMaxBlocksPerSm = 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int align16(int v) {
  return (v + 15) & ~15;
}

// shared memory of one window: ranks int16 [N, P], weights int32 [N, P],
// scores int32 [N], chosen predecessors int16 [N], flags uint8 [N]
__host__ __device__ __forceinline__ int window_bytes(int N, int P) {
  return align16(2 * N * P) + align16(4 * N * P) + align16(4 * N) +
         align16(2 * N) + align16(N);
}

// shared memory of a window at (N, P), or -1 for a shape the kernel
// does not hold (P outside [1, 8], N outside [1, 32767], or more than a
// block's 227 KB)
int shape_bytes(int N, int P) {
  if (N < 1 || N > 32767 || P < 1 || P > kMaxP) return -1;
  const long long bytes = window_bytes(N, P);
  return bytes > kMaxSmem ? -1 : static_cast<int>(bytes);
}

// windows an SM holds at `per` windows of `bytes` a block
int resident(int per, int bytes) {
  return per *
         std::min(kMaxBlocksPerSm, kSmemPerSm / (per * bytes + kBlockReserve));
}

// Windows a block: two where that keeps more windows on an SM than one
// does (the 16th class-0 window of an SM fits only beside another in a
// block: 15 blocks of one, 8 of two), else one, which spreads a small
// batch (a class-1 tile) over the most SMs.
int windows_per_block(int bytes) {
  return resident(2, bytes) > resident(1, bytes) ? 2 : 1;
}

struct Window {
  int16_t* prk;
  int* pw;
  int* scores;
  int16_t* preds;
  uint8_t* flags;
  int P;
};

// Takes slot (q, w, sc) into (bw, bpr, bsc) by rule 1.
template <bool kBanned>
__device__ __forceinline__ void take(int q, int w, int sc, int& bw,
                                     int& bpr, int& bsc) {
  const bool ok = q >= 0 && (!kBanned || sc != -1);
  if (ok && (bw < w || (bw == w && bsc <= sc))) {
    bw = w;
    bpr = q;
    bsc = sc;
  }
}

// Relaxes ranks [lo, hi) in order on one thread, storing scores and
// chosen predecessors; (msc, mr) keeps the first maximum (strict <).
// The predecessors of rank r lie below r and are final.
template <bool kBanned>
__device__ void relax_run(const Window& w, int lo, int hi, int& msc,
                          int& mr) {
  const int P = w.P;
  int prev = lo > 0 ? w.scores[lo - 1] : -1;  // score of rank r - 1
  // slot 0 of rank r; sc is the score of q read before rank r - 1 was
  // stored, so that q == r - 1 takes prev instead
  int c = 0, q = -1, wt = 0, sc = -1;
  if (lo < hi) {
    c = w.flags[lo] & kSlots;
    q = w.prk[lo * P];
    wt = w.pw[lo * P];
    sc = w.scores[max(q, 0)];
  }
  for (int r = lo; r < hi; ++r) {
    int c1 = 0, q1 = -1, w1 = 0, sc1 = -1;
    if (r + 1 < hi) {
      c1 = w.flags[r + 1] & kSlots;
      q1 = w.prk[(r + 1) * P];
      w1 = w.pw[(r + 1) * P];
      sc1 = w.scores[max(q1, 0)];
    }
    int bw = -1, bpr = -1, bsc = kNeg;
    take<kBanned>(q, wt, q == r - 1 ? prev : sc, bw, bpr, bsc);
    for (int p = 1; p < c; ++p) {
      const int qp = w.prk[r * P + p];
      take<kBanned>(qp, w.pw[r * P + p],
                    qp == r - 1 ? prev : w.scores[max(qp, 0)], bw, bpr, bsc);
    }
    const int s = bpr >= 0 ? bw + bsc : -1;
    w.scores[r] = s;
    w.preds[r] = (int16_t)bpr;
    if (msc < s) {
      msc = s;
      mr = r;
    }
    prev = s;
    c = c1;
    q = q1;
    wt = w1;
    sc = sc1;
  }
}

template <int kWindows>
__global__ void __launch_bounds__(32 * kWindows) heaviest_bundle_kernel(
    const int* __restrict__ pred_ranks, const int* __restrict__ pred_w,
    const int* __restrict__ pred_cnt, const bool* __restrict__ is_end,
    const int* __restrict__ node_code, const int* __restrict__ node_sup,
    const int* __restrict__ n_nodes, const int* __restrict__ rank0,
    int* __restrict__ codes_bwd, int* __restrict__ sups_bwd,
    int* __restrict__ cons_len, int B, int N, int P) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWindows + (threadIdx.x >> 5);
  if (b >= B) return;
  unsigned char* smem = block_smem + (threadIdx.x >> 5) * window_bytes(N, P);
  const long long base = (long long)b * N;
  Window w;
  w.prk = reinterpret_cast<int16_t*>(smem);
  w.pw = reinterpret_cast<int*>(smem + align16(2 * N * P));
  w.scores = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(w.pw) +
                                    align16(4 * N * P));
  w.preds = reinterpret_cast<int16_t*>(
      reinterpret_cast<unsigned char*>(w.scores) + align16(4 * N));
  w.flags = reinterpret_cast<uint8_t*>(w.preds) + align16(2 * N);
  w.P = P;
  const int nn = min(max(n_nodes[b], 0), N);
  const int r0 = min(max(rank0[b], 0), N - 1);

  // -- stage the window ------------------------------------------------------
  const int* gpr = pred_ranks + base * P;
  const int* gpw = pred_w + base * P;
  const int E = nn * P;
  auto rank16 = [N](int v) { return (int16_t)min(max(v, -1), N - 1); };
  const bool vec = (P & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(gpr) |
                     reinterpret_cast<uintptr_t>(gpw)) & 15) == 0;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(gpr);
    const int4* w4 = reinterpret_cast<const int4*>(gpw);
    const int E4 = E >> 2;
    for (int k0 = 0; k0 < E4; k0 += 32 * kUnroll) {
      int4 rv[kUnroll], wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * 32 + lane;
        if (k < E4) {
          rv[u] = __ldg(r4 + k);
          wv[u] = __ldg(w4 + k);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * 32 + lane;
        if (k < E4) {
          reinterpret_cast<short4*>(w.prk)[k] =
              make_short4(rank16(rv[u].x), rank16(rv[u].y), rank16(rv[u].z),
                          rank16(rv[u].w));
          reinterpret_cast<int4*>(w.pw)[k] = wv[u];
        }
      }
    }
  } else {
    for (int k = lane; k < E; k += 32) {
      w.prk[k] = rank16(__ldg(gpr + k));
      w.pw[k] = __ldg(gpw + k);
    }
  }
  for (int v = lane; v < N; v += 32) {
    const int c = min(max(__ldg(pred_cnt + base + v), 1), P);
    w.flags[v] = (uint8_t)(c | (is_end[base + v] ? kEnd : 0));
    w.scores[v] = -1;
    w.preds[v] = -1;
  }
  __syncwarp();

  // -- first pass ------------------------------------------------------------
  int mr = 0;
  if (lane == 0) {
    int msc = kNeg;
    relax_run<false>(w, 0, nn, msc, mr);
  }
  __syncwarp();
  mr = __shfl_sync(kFull, mr, 0);

  // -- branch completion -----------------------------------------------------
  for (int it = 0; nn > 0 && !(w.flags[mr] & kEnd) && it < N; ++it) {
    const int rb = mr;
    for (int v = rb + 1 + lane; v < nn; v += 32) {
      const int c = w.flags[v] & kSlots;
      const int16_t* pv = w.prk + v * P;
      bool succ = false;
      for (int p = 0; p < c; ++p) succ |= pv[p] == rb;
      if (succ)
        for (int p = 0; p < c; ++p) {
          const int q = pv[p];
          if (q != rb && q >= 0) w.scores[q] = -1;
        }
      w.scores[v] = -1;
      w.preds[v] = -1;
    }
    __syncwarp();
    if (lane == 0) {
      int msc = 0;
      mr = r0;
      relax_run<true>(w, rb + 1, nn, msc, mr);
    }
    __syncwarp();
    mr = __shfl_sync(kFull, mr, 0);
  }

  // -- backtrack -------------------------------------------------------------
  int16_t* chain = reinterpret_cast<int16_t*>(w.scores);  // scores are dead
  int len = 0;
  if (lane == 0) {
    int r = nn > 0 ? mr : -1;
    while (r >= 0 && len < N) {
      chain[len++] = (int16_t)r;
      r = w.preds[r];
    }
  }
  __syncwarp();
  len = __shfl_sync(kFull, len, 0);
  for (int t = lane; t < N; t += 32) {
    int code = 0, sup = 0;
    if (t < len) {
      const int r = chain[t];
      code = __ldg(node_code + base + r);
      sup = __ldg(node_sup + base + r);
    }
    codes_bwd[base + t] = code;
    sups_bwd[base + t] = sup;
  }
  if (lane == 0) cons_len[b] = len;
}

// Launches kernel<kWindows> with kWindows windows of `bytes` a block.
template <int kWindows>
int launch(const void* pred_ranks, const void* pred_w, const void* pred_cnt,
           const void* is_end, const void* node_code, const void* node_sup,
           const void* n_nodes, const void* rank0, void* codes_bwd,
           void* sups_bwd, void* cons_len, int B, int N, int P, int bytes,
           void* stream) {
  const int smem = kWindows * bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        heaviest_bundle_kernel<kWindows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + kWindows - 1) / kWindows;
  heaviest_bundle_kernel<kWindows>
      <<<grid, 32 * kWindows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pred_ranks), static_cast<const int*>(pred_w),
      static_cast<const int*>(pred_cnt), static_cast<const bool*>(is_end),
      static_cast<const int*>(node_code), static_cast<const int*>(node_sup),
      static_cast<const int*>(n_nodes), static_cast<const int*>(rank0),
      static_cast<int*>(codes_bwd), static_cast<int*>(sups_bwd),
      static_cast<int*>(cons_len), B, N, P);
  return static_cast<int>(cudaGetLastError());
}

// Windows of `bytes` resident on one SM at kWindows a block, from the
// occupancy calculator.
template <int kWindows>
int occupancy(int bytes) {
  const int smem = kWindows * bytes;
  int blocks = 0;
  if (cudaFuncSetAttribute(heaviest_bundle_kernel<kWindows>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, heaviest_bundle_kernel<kWindows>, 32 * kWindows, smem) !=
          cudaSuccess)
    return 0;
  return kWindows * blocks;
}

}  // namespace

extern "C" {

const char* hypo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Windows resident on one SM at (N, P), at the launch's windows a
// block; 0 for a shape the kernel does not hold.
int hypo_heaviest_bundle_occupancy(int N, int P) {
  const int bytes = shape_bytes(N, P);
  if (bytes < 0) return 0;
  return windows_per_block(bytes) == 2 ? occupancy<2>(bytes)
                                       : occupancy<1>(bytes);
}

// All pointers are device pointers of contiguous tensors (is_end is
// bool, one byte); returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not hold.
int hypo_heaviest_bundle(const void* pred_ranks, const void* pred_w,
                         const void* pred_cnt, const void* is_end,
                         const void* node_code, const void* node_sup,
                         const void* n_nodes, const void* rank0,
                         void* codes_bwd, void* sups_bwd, void* cons_len,
                         int B, int N, int P, void* stream) {
  if (B == 0) return 0;
  const int bytes = shape_bytes(N, P);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return (windows_per_block(bytes) == 2 ? launch<2> : launch<1>)(
      pred_ranks, pred_w, pred_cnt, is_end, node_code, node_sup, n_nodes,
      rank0, codes_bwd, sups_bwd, cons_len, B, N, P, bytes, stream);
}

}  // extern "C"
