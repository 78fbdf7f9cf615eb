// The launch of kernel 4 (poa_rank.cu) over B windows of N nodes: warps
// a window, windows a block, and the shared memory a block needs.  Plain
// C++ apart from the qualifiers below, so that the CPU tests build it
// with g++ and hold it to the card's limits at every shape the runners
// launch (tests/test_torch_rank_merge.py).
#pragma once

#ifndef HYPO_HD
#ifdef __CUDACC__
#define HYPO_HD __host__ __device__
#else
#define HYPO_HD
#endif
#endif

namespace rank_launch {

constexpr int kSMs = 132;            // an H100 SXM
constexpr int kWarpsPerSM = 32;      // the aim: half the SM's 64 warps
constexpr int kMaxWarps = 16;        // a window
constexpr int kBlockWarps = 8;       // a block of several windows
constexpr int kMaxThreads = 512;     // a block: the kernel's launch bound
constexpr int kMaxSmem = 48 * 1024;  // a block, without the opt-in

HYPO_HD constexpr int r4(int x) { return (x + 3) & ~3; }

// shared ints of a window: each node's key, then its rank; the node at
// each rank; each position's node count, then its first rank; the warps'
// column totals
HYPO_HD constexpr int window_ints(int N, int warps) {
  return 3 * r4(N) + r4(warps);
}

// ``warps`` a window, ``windows`` a block
struct Shape {
  int warps, windows;
};

inline int threads(const Shape& s) { return 32 * s.warps * s.windows; }

// blocks of a launch over B windows: the last one may be part empty
inline int blocks(const Shape& s, int B) {
  return (B + s.windows - 1) / s.windows;
}

inline long long smem_bytes(const Shape& s, int N) {
  return 4LL * window_ints(N, s.warps) * s.windows;
}

// Whether the kernel takes the launch: a named barrier (ids 1-15) for
// each window of several warps, and the block within its threads and
// shared memory.
inline bool shape_ok(const Shape& s, int N) {
  return N >= 1 && s.warps >= 1 && s.warps <= kMaxWarps &&
         (s.warps & (s.warps - 1)) == 0 && s.windows >= 1 &&
         (s.warps == 1 || s.windows <= 15) && threads(s) <= kMaxThreads &&
         smem_bytes(s, N) <= kMaxSmem;
}

// The launch over B windows of N nodes.  The kernel is bound by bytes,
// and a tile's windows all fit the card at once, so what counts is the
// loads in flight: the warps a window are the power of two (1-16) that
// brings B windows closest below kWarpsPerSM warps an SM, and no more
// than a warp per 32 nodes.  Class 0 (B = 2,048, N = 256): 4,224 / 2,048
// = 2.06, so two warps a window, four windows a block of 256 threads, 31
// warps an SM; class 1 (B = 256, N = 1,024): 16.5, so 16 warps, a window
// a block of 512 threads, 31 warps an SM.  Fewer windows a block while
// the block would pass its shared memory; past 48 KB for one window (N >
// 4,088 at 16 warps a window) shape_ok refuses it.
inline Shape rank_shape(int B, int N) {
  const int want = kSMs * kWarpsPerSM / (B > 0 ? B : 1);
  const int cap = (N + 31) / 32;
  Shape s{1, 1};
  while (2 * s.warps <= kMaxWarps && 2 * s.warps <= want &&
         2 * s.warps <= cap)
    s.warps *= 2;
  s.windows = s.warps >= kBlockWarps ? 1 : kBlockWarps / s.warps;
  while (s.windows > 1 && !shape_ok(s, N)) --s.windows;
  return s;
}

}  // namespace rank_launch
