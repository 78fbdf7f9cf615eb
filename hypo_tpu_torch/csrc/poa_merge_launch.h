// The launch of kernel 5 (poa_merge.cu) at (N, L): arm bases a thread,
// warps a window, windows a block, and the shared memory a block needs.
// Plain C++ apart from the qualifiers below, so that the CPU tests build
// it with g++ and hold it to the card's limits at every shape the
// runners launch (tests/test_torch_rank_merge.py).
#pragma once

#ifdef __CUDACC__
#define HYPO_HD __host__ __device__
#else
#define HYPO_HD
#endif

namespace merge_launch {

constexpr int kSlots = 8;            // predecessor ids a base copies
constexpr int kMaxThreads = 512;     // a block: the kernel's launch bound
constexpr int kMaxWarps = 16;        // a window's warps: L <= 512
constexpr int kMaxSmem = 48 * 1024;  // a block, without the opt-in

HYPO_HD constexpr int r4(int x) { return (x + 3) & ~3; }

// shared ints of a window: its col_pos row; per base its anchor, node,
// and its node's predecessor count and first kSlots predecessor ids; the
// warps' totals for each of the per bases a thread (a Run a warp and
// base) and their overflow flags
HYPO_HD constexpr int window_ints(int N, int L, int per, int warps) {
  return r4(N) + (3 + kSlots) * r4(L) + 4 * warps * (per + 1);
}

// ``per`` arm bases a thread, ``warps`` a window, ``windows`` a block
struct Shape {
  int per, warps, windows;
};

inline int threads(const Shape& s) { return 32 * s.warps * s.windows; }

// blocks of a launch over B windows: the last one may be part empty
inline int blocks(const Shape& s, int B) {
  return (B + s.windows - 1) / s.windows;
}

inline long long smem_bytes(const Shape& s, int N, int L) {
  return 4LL * window_ints(N, L, s.per, s.warps) * s.windows;
}

// Whether the kernel takes the launch: warps enough for the arm, a named
// barrier (ids 1-15) for each window of several warps, and the block
// within its threads and shared memory.
inline bool shape_ok(const Shape& s, int N, int L) {
  return N >= 1 && L >= 1 && (s.per == 1 || s.per == 2) && s.warps >= 1 &&
         s.warps <= kMaxWarps && 32 * s.warps * s.per >= L &&
         s.windows >= 1 && (s.warps == 1 || s.windows <= 15) &&
         threads(s) <= kMaxThreads && smem_bytes(s, N, L) <= kMaxSmem;
}

// The launch at (N, L): 2 bases a lane up to L = 128 (two warps a window
// at class 0's L = 126), else 1 (a warp per 32 bases, 16 at class 1's
// L = 510); 8 warps a block, fewer windows while the block would pass
// its shared memory.  Past L = 512, or past 48 KB for a single window
// (N > 6,528 at L = 512), shape_ok refuses it.
inline Shape merge_shape(int N, int L) {
  const int per = L <= 128 ? 2 : 1;
  Shape s{per, (L + 32 * per - 1) / (32 * per), 1};
  s.windows = s.warps >= 8 ? 1 : 8 / (s.warps > 0 ? s.warps : 1);
  while (s.windows > 1 && !shape_ok(s, N, L)) --s.windows;
  return s;
}

}  // namespace merge_launch
