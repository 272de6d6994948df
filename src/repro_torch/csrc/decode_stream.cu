// Hand-written Hopper (sm_90a) kernel: B2's streamed route.
//
// Built by nvcc into its own shared library with a plain C interface and
// loaded with ctypes (src/repro_torch/kernels/build.py), beside
// csrc/decode_fused.cu, whose layouts it leaves alone.  The entry point
// launches on the stream it is given, never synchronises, allocates
// nothing but its 4-byte error word in mapped host memory, once (the
// Python wrapper allocates outputs and scratch with torch.empty), and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// decode_stream: K closed-loop decode steps in one launch, at the shapes
// csrc/decode_fused.cu has no layout for.
//
// Replaces: src/repro/kernels/diag_scan.py::decode_fused_pallas_raw (body
//   _decode_kernel), as decode_fused.cu does: each step drives the state
//   from the carried output (y . wd), runs the masked diagonal update,
//   reads out on the NEW state with the CARRIED y (b_out + y . wy + h . wh),
//   optionally takes the mean over live rows, and frozen rows keep their
//   state and y.  The TPU kernel has no shape limit.  decode_fused.cu keeps
//   a row's lane operands (2 + 4D values a lane) in the shared memory of at
//   most one thread-block cluster, its D <= 128, and its mean grid at most
//   the clusters the card holds at once; past those
//   (kernels/diag_scan.py::decode_layout raises) the port runs this route.
// Bound on this card.  Resident mode: the lane operands live in shared
//   memory for the whole wave, so a step moves only the exchange's few KB
//   and does 8 D multiply-adds a lane and row; what bounds it is the
//   step's serial chain: the block's arithmetic (a 1 / G share of the
//   lanes) and the grid's waits through L2 (one or two a step).  Streamed
//   and direct modes: a step reads every block's share of the operands
//   once, from L2 where they fit its 50 MB, else from device memory; those
//   bytes bound it.
// Design:
//   * One cooperative grid of G blocks, all resident at once: the launcher
//     asks cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's
//     shared memory and refuses a grid the card cannot hold (code 10001)
//     instead of launching one that would wait for ever.  Block g owns row
//     group g / S (rows [r0, r0 + R)) and lane segment g % S (lanes
//     [s L, (s + 1) L)).  With shared weights up to kRows rows of a group
//     (a row tile) share one read of each operand element.
//   * Three modes, chosen from the shapes before the launch
//     (kernels/diag_scan.py::decode_stream_layout), never switched after:
//     - resident: the block's lane operands (a, wd, wh: 2 + 4D values a
//       lane, per row with per-slot weights) and its rows' state are
//       copied into shared memory once (cp.async), before step 0; the
//       state goes back to o_h once, after the last step;
//     - streamed: the operands pass through a ring of two shared-memory
//       tiles of up to `tile` lanes, one cp.async commit group a tile: one
//       tile is in flight while the other computes, across steps too (the
//       operands do not depend on y), so the next step's first tile loads
//       during the step's exchange (deeper rings ran slower on the card:
//       narrower tiles).  A step takes its lane tiles in turn, each over
//       the block's row tiles, so shared weights are copied once a step
//       however many rows the block holds;
//     - direct: where not one lane's operands fit a ring tile (D past
//       about 3000 at float64), the block reads them from global memory
//       where it uses them, as loads coalesced over a warp's lanes
//       (drive) or outputs (readout).
//     Streamed or direct, the state stays in shared memory where the
//     layout says it fits (state_on_chip); otherwise a tile's state is
//     loaded at its turn (after its last write-back) into room beside its
//     operands and written back to o_h as it is updated.
//   * The carried y of the block's rows, their readouts and their mask
//     live in shared memory where the layout says they fit (y_on_chip),
//     else in the block's own slice of the global scratch (many rows a
//     block, or a wide D), read through L1.  Four instantiations a type:
//     y on chip or not (so that its pointers are known to be shared memory
//     where they are), the direct mode or not (so that a kernel holds one
//     mode's tile code).  A row
//     tile's step: the drive y . wd, each lane's D terms split over qa
//     thread groups (summed through warp shuffles, then shared memory, in
//     one order), the masked update of each (row, lane); then the readout
//     on the new state, each output's lanes split over qb thread groups
//     likewise, accumulated over the tiles of the segment in tile order;
//     then the segment's share of the feedback y . wy (rows [s Ks,
//     (s + 1) Ks) of wy, Ks = ceil(D / S)) and, in segment 0, the bias.
//     The contractions run as FMAs on the CUDA cores with y broadcast from
//     shared memory: with at most kRows rows a tile the product is one
//     8-row tile, far below the tensor cores' shapes, and the arithmetic
//     is a small part of a step (see the bound).
//   * The exchange, through global memory: after a block barrier, thread 0
//     stores the block's count of waits in its own arrival flag (a release:
//     fence.acq_rel, then a relaxed store); warp 0 polls every block's flag
//     (relaxed loads, lane l the flags l, l + 32, ...) until all read that
//     count, then an acquire fence and a block barrier: no atomic, each
//     block writes only its own flag.  A block's partials: off, its rows'
//     R D outputs; mean, D, its rows' readouts times their 0/1 mask summed
//     in row order; stored four outputs side by side, the blocks' next to
//     each other, so a lane reads one block's four as 16-byte loads and a
//     warp's loads are contiguous.  An output's sum over the blocks that
//     hold partials of it (off: the S segments of its row group; mean: all
//     G blocks) is always taken by one warp in one order (lane l takes the
//     blocks l, l + 32, ..., then an xor-shuffle tree; every load issued
//     before any add), read from L2 (__ldcg), so every block of a row
//     group (off) or of the grid (mean) feeds back the same y, bit for
//     bit, whoever sums it; no floating-point atomic is used.
//     - rounds = 2 (reduce-scatter, then gather): after the first wait,
//       block s of a row group (every block, for mean) sums its slice of
//       the outputs and publishes the new y; after the second wait every
//       block reads its rows' y.  A block reads O(R D) values a step (mean:
//       O(D)), whatever G.
//     - rounds = 1: after the one wait every block sums all the outputs of
//       its rows itself: S R D (mean: G D) values a block, so the rule
//       takes it only where that is small (kernels/diag_scan.py::
//       DECODE_STREAM_ONE_ROUND) and saves a wait a step.
//     Two parity slots of partials: with one round a block writes step
//     x + 1's before another has read step x's (the one wait of step x + 1
//     orders step x + 2's writes after every read of step x's).
//   * A wait has a bound: past it the block sets an error word in mapped
//     host memory and stops waiting, so no grid hangs the card; the next
//     launch, or kernels/diag_scan.py::decode_grid_check after a
//     synchronise, raises (code 10002).  Launches of this route never
//     overlap on a device, whatever their streams.
//   Semantics kept from the TPU kernel: the mask is 0/1 with
//   denom = max(sum m, 1); the mean multiplies every row's readout by its
//   m (so a non-finite frozen row reaches the mean, as in the reference);
//   with seed_mean (the packed entry's mean) every live row starts from
//   the live rows' mean of y0.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

#include <type_traits>

// The threads of a block (a multiple of 32 and a power of two; a CPU
// rehearsal builds it smaller).
#ifndef DECODE_STREAM_THREADS
#define DECODE_STREAM_THREADS 256
#endif

// The arguments of one call, as the launcher packs them: decode_fused.cu's
// DecodeCall up to n_k, then the route's own fields (described beside the
// entry points below).
struct StreamCall {
  long long a_re, a_im, a_sb, h_re, h_im, h_sb, y0, wd_re, wd_im, wd_sb,
      wd_ld, wy, wy_sb, b_out, bo_sb, wh_re, wh_im, wh_sb, mask, o_h_re,
      o_h_im, o_y, o_ys, n_b, n_c, n_r, packed, n_d, n_k, mean, seed_mean,
      blocks, groups, rows, segs, lanes, qa, qb, mode, tile,
      state_on_chip, y_on_chip, rounds, smem, scratch, stream;
};

namespace {

constexpr int kThreads = DECODE_STREAM_THREADS;
constexpr int kWarps = kThreads / 32;
// The rows of a tile: with shared weights they share one read of each
// operand element, each holding 2 (drive) or 1 (readout) accumulators a
// thread.
constexpr int kRows = 8;
// A block's dynamic shared memory at most (the H100's 227 KB).
constexpr int kMaxSmem = 232448;
// The codes the entry returns (not CUDA error codes; cuda_error_string
// names them): the card cannot hold the grid's blocks at once, and an
// earlier launch's wait passed its bound.
constexpr int kGridTooLarge = 10001;
constexpr int kGridTimedOut = 10002;
// A block's wait for the step's blocks: past kGridSlowNs it also reads the
// error word (another block gave up), past kGridSpinNs it gives up itself.
constexpr unsigned long long kGridSlowNs = 100000ull;
constexpr unsigned long long kGridSpinNs = 200000000ull;
constexpr int kMaxDevices = 64;
// The modes (kernels/diag_scan.py::DECODE_STREAM_MODES, in order).
constexpr int kResident = 0;
constexpr int kStreamed = 1;
constexpr int kDirect = 2;

template <typename T>
struct StreamArgs {
  const T* a_re;
  const T* a_im;
  const T* h_re;
  const T* h_im;
  const T* y0;
  const T* wd_re;
  const T* wd_im;
  const T* wy;     // nullptr: no feedback rows (zeros)
  const T* b_out;  // nullptr: no bias row (zeros)
  const T* wh_re;
  const T* wh_im;
  const unsigned char* mask;
  T* o_h_re;
  T* o_h_im;
  T* o_y;
  T* o_ys;
  long long a_sb, h_sb, wd_sb, wd_ld, wy_sb, bo_sb, wh_sb;
  int n_b, n_c, n_r, packed, n_d, n_k, mean, seed_mean;
  // The layout: row groups, rows a group (the last may hold fewer),
  // segments a group, lanes a segment (the last may hold fewer), the
  // thread groups of the drive (qa) and of the readout (qb), the mode,
  // a tile's lanes (streamed, direct), whether the state stays in shared
  // memory, whether the rows' y, readouts and mask do, and the exchange's
  // rounds.
  int groups, rows, segs, lanes, qa, qb, mode, tile, state_on_chip,
      y_on_chip, rounds;
  // Global scratch: the blocks' arrival flags [G], the partials
  // [2][slot / 4][G][4] (slot rounded up to 4: four outputs of a block
  // side by side, the blocks' next to each other), the published y
  // ([B][D] off, [D] mean) and, unless y_on_chip, each block's rows' y,
  // readouts and mask [G][2 R D + R]; the error word in mapped host
  // memory.
  unsigned* flags;
  T* part;
  T* ybuf;
  T* ywork;
  volatile int* err;
};

// The shared memory of a block, in values of T, region by region (the
// Python rule, kernels/diag_scan.py::_stream_smem, counts the same): the
// reductions' buffer [2][kRows][kThreads], the rows' carried y [R][D], the
// rows' readouts [R][D] and the rows' 0/1 mask [R] (y_on_chip), the state
// [2][R][L] (state_on_chip), then the operands: resident, a set of L
// lanes a row (per-slot) or one set; streamed, the ring's two tiles, each
// with room for the state of its row tile unless it stays on chip;
// direct, no operands, one tile's room for the state unless it stays on
// chip.  A set of W lanes is a_re[W], a_im[W], wd_re[D][W], wd_im[D][W],
// wh[W][2D] (a lane's re row, then its im row).
struct SmemPlan {
  long long red, y, acc, live, state, ops, set, stage, total;
};

__host__ __device__ inline SmemPlan smem_plan(int rows, int lanes, int n_d,
                                              int batched, int mode,
                                              int tile, int state_on_chip,
                                              int y_on_chip) {
  const long long nt = batched ? 1 : (rows < kRows ? rows : kRows);
  const long long ny = y_on_chip ? (long long)rows * n_d : 0;
  SmemPlan p;
  p.red = 0;
  p.y = p.red + 2LL * kRows * kThreads;
  p.acc = p.y + ny;
  p.live = p.acc + ny;
  p.state = p.live + (y_on_chip ? rows : 0);
  p.ops = p.state + (state_on_chip ? 2LL * rows * lanes : 0);
  const long long per_lane = 2 + 4LL * n_d;
  if (mode == kResident) {
    p.set = per_lane * lanes;
    p.stage = p.set;
    p.total = p.ops + (batched ? rows : 1) * p.set;
  } else {
    p.set = mode == kStreamed ? per_lane * tile : 0;
    p.stage = p.set + (state_on_chip ? 0 : 2 * nt * tile);
    p.total = p.ops + (mode == kStreamed ? 2 : 1) * p.stage;
  }
  return p;
}

// PTX wrappers: the exchange's arrival flags (a release store after the
// block's partials, the relaxed loads that poll every block's and the
// acquire fence after them), the clock of its bound, and the ring's
// asynchronous copies (cp.async of one value, a commit group a tile, a
// wait for all but the newest N groups).
__device__ __forceinline__ void flag_release(unsigned* p, unsigned v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
// End of the PTX wrappers.

// Warp 0 of a block: until every block's flag reads at least epoch
// (true: each lane polls the flags l, l + 32, ..., then an acquire fence),
// or false once the wait passed kGridSpinNs (setting *err) or, past
// kGridSlowNs, found *err set by another block: a grid whose blocks cannot
// all run at once then ends (its outputs invalid, the next launch raises)
// instead of hanging.  The clock is read every 32 polls, by lane 0, whose
// verdict the warp takes.
__device__ bool grid_wait(const unsigned* flags, int nblk, unsigned epoch,
                          volatile int* err) {
  const int lane = threadIdx.x & 31;
  unsigned long long t0 = 0;
  for (int spin = 1;; ++spin) {
    // Every flag's load is issued before any is compared, so a poll costs
    // one round trip to L2 (eight flags a lane at a time).
    bool ok = true;
    for (int i0 = 0; i0 < nblk; i0 += 8 * 32) {
      unsigned f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * 32 + lane;
        f[k] = i < nblk ? ld_relaxed(flags + i) : epoch;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) ok = ok && f[k] >= epoch;
    }
    if (__all_sync(0xffffffffu, ok)) {
      fence_acquire();
      return true;
    }
    if ((spin & 31) == 0) {
      int quit = 0;
      if (lane == 0) {
        const unsigned long long now = global_ns();
        if (t0 == 0) t0 = now;
        const unsigned long long dt = now - t0;
        if (dt > kGridSlowNs && *err != 0) quit = 1;
        if (dt > kGridSpinNs) {
          *err = 1;
          __threadfence_system();
          quit = 1;
        }
      }
      if (__shfl_sync(0xffffffffu, quit, 0)) return false;
    }
  }
}

// Offsets of lane j's re and im parts along a lane row.  Split lanes: j in
// separate re / im arrays.  Packed Q: a real slot j < n_r at j (no im),
// pair lane j at n_r + 2 (j - n_r) with its im right after, in one array.
__device__ __forceinline__ void lane_offsets(int j, int n_r, int packed,
                                             int& o_re, int& o_im,
                                             bool& has_im) {
  if (packed) {
    has_im = j >= n_r;
    o_re = has_im ? 2 * j - n_r : j;
    o_im = o_re + 1;
  } else {
    has_im = true;
    o_re = o_im = j;
  }
}

// One block's geometry and views.
template <typename T>
struct Block {
  int g, grp, sg, r0, nrows, lo, nl, k0, nk, nt_max, batched;
  T denom;
  T* red;
  T* y;      // [nrows][D], the carried y
  T* acc;    // [R][D], the rows' readouts over the tiles so far
  T* live;   // [R], the rows' mask as 0 / 1
  T* state;  // [2][R][L] when it stays on chip
  T* ops;
  SmemPlan plan;
};

// The operands (and the state) of one tile: W lanes a row of a_*, wd_*,
// lanes [lane0, lane0 + nl) of the segment; h rows hld apart.  Direct:
// a_*, wd_* and wh (re) / wh_im point at the operand row in global
// memory, indexed by a lane's offsets (lane_offsets).
template <typename T>
struct Tile {
  const T* a_re;
  const T* a_im;
  const T* wd_re;
  const T* wd_im;
  const T* wh;
  const T* wh_im;
  T* h_re;
  T* h_im;
  int w, hld, lane0, nl;
  bool h_global;  // the state rides in the tile: write it back to o_h
};

template <typename T>
__device__ Tile<T> set_view(T* base, int w, int n_d) {
  Tile<T> t;
  t.w = w;
  t.a_re = base;
  t.a_im = base + w;
  t.wd_re = base + 2 * w;
  t.wd_im = t.wd_re + (long long)n_d * w;
  t.wh = t.wd_im + (long long)n_d * w;
  t.wh_im = t.wh + n_d;
  return t;
}

// Issue the copies of lanes [lane0, lane0 + nl) of the segment, of
// operand row orow (0 with shared weights), into a set of stride W; a
// packed real lane's im parts are zeros.
template <typename T>
__device__ void fill_ops(const StreamArgs<T>& s, const Block<T>& b,
                         const Tile<T>& t, int orow) {
  const int tid = threadIdx.x, n_d = s.n_d, nl = t.nl;
  T* a_re = const_cast<T*>(t.a_re);
  T* a_im = const_cast<T*>(t.a_im);
  T* wd_re = const_cast<T*>(t.wd_re);
  T* wd_im = const_cast<T*>(t.wd_im);
  T* wh = const_cast<T*>(t.wh);
  const long long a_off = (long long)orow * s.a_sb;
  const long long wd_off = (long long)orow * s.wd_sb;
  const long long wh_off = (long long)orow * s.wh_sb;
  // a and wd: lanes across the threads, D rows split over thread rows.
  {
    const int cw = nl < kThreads ? nl : kThreads;
    const int rn = kThreads / cw;
    const int cx = tid % cw, ey = tid / cw;
    if (ey < rn) {
      for (int c = cx; c < nl; c += cw) {
        int ore, oim;
        bool him;
        lane_offsets(b.lo + t.lane0 + c, s.n_r, s.packed, ore, oim, him);
        if (ey == 0) {
          cp_async(a_re + c, s.a_re + a_off + ore);
          if (him)
            cp_async(a_im + c, s.a_im + a_off + oim);
          else
            a_im[c] = T(0);
        }
        for (int e = ey; e < n_d; e += rn) {
          const long long src = wd_off + (long long)e * s.wd_ld;
          cp_async(wd_re + (long long)e * t.w + c, s.wd_re + src + ore);
          if (him)
            cp_async(wd_im + (long long)e * t.w + c, s.wd_im + src + oim);
          else
            wd_im[(long long)e * t.w + c] = T(0);
        }
      }
    }
  }
  // wh: a lane's D outputs across the threads (its re row, then its im
  // row), lanes split over thread rows.
  {
    const int ew = n_d < kThreads ? n_d : kThreads;
    const int cn = kThreads / ew;
    const int ex = tid % ew, cy = tid / ew;
    if (cy < cn) {
      for (int c = cy; c < nl; c += cn) {
        int ore, oim;
        bool him;
        lane_offsets(b.lo + t.lane0 + c, s.n_r, s.packed, ore, oim, him);
        T* dst = wh + (long long)c * 2 * n_d;
        const T* sre = s.wh_re + wh_off + (long long)ore * n_d;
        const T* sim = s.wh_im + wh_off + (long long)oim * n_d;
        for (int e = ex; e < n_d; e += ew) {
          cp_async(dst + e, sre + e);
          if (him)
            cp_async(dst + n_d + e, sim + e);
          else
            dst[n_d + e] = T(0);
        }
      }
    }
  }
}

// Copy rows [rt, rt + nt) (block-relative) of the state at lanes
// [lane0, lane0 + nl) of the segment from src (h, or o_h) into h_re / h_im
// rows hld apart (Async: issue cp.async; else load now); a packed real
// lane's im is zero.
template <bool Async, typename T>
__device__ void fill_state(const StreamArgs<T>& s, const Block<T>& b,
                           const T* src_re, const T* src_im, T* h_re,
                           T* h_im, int hld, int rt, int nt, int lane0,
                           int nl) {
  for (long long i = threadIdx.x; i < (long long)nt * nl; i += kThreads) {
    const int rr = (int)(i / nl), c = (int)(i - (long long)rr * nl);
    int ore, oim;
    bool him;
    lane_offsets(b.lo + lane0 + c, s.n_r, s.packed, ore, oim, him);
    const long long row = (long long)(b.r0 + rt + rr) * s.h_sb;
    T* dre = h_re + (long long)rr * hld + c;
    T* dim = h_im + (long long)rr * hld + c;
    if (Async) {
      cp_async(dre, src_re + row + ore);
      if (him) cp_async(dim, src_im + row + oim);
    } else {
      *dre = src_re[row + ore];
      if (him) *dim = src_im[row + oim];
    }
    if (!him) *dim = T(0);
  }
}

// The first half of a sum over the thread groups that share tid % width
// (a power of two): each thread's n values v[0..n) summed across a warp's
// lanes (xor shuffles), then stashed in red, value k of index i < width
// of slice q (a warp, or a group of whole warps) at red[k kThreads +
// q width + i].  Ends at a block barrier; returns the slices.
template <typename T, int N>
__device__ int group_stash(T (&v)[N], int n, int width, T* red) {
  const int tid = threadIdx.x;
  for (int off = width; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  const int span = width < 32 ? 32 : width;  // threads of one slice
  const int i = tid % span;
  if (i < width) {
    const int at = (tid / span) * width + i;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) red[k * kThreads + at] = v[k];
  }
  __syncthreads();
  return kThreads / span;
}

// The second half: value k of index i summed over the slices in order.
template <typename T>
__device__ T group_total(const T* red, int k, int i, int width,
                         int slices) {
  const T* p = red + k * kThreads + i;
  T sum = p[0];
  for (int q = 1; q < slices; ++q) sum += p[q * width];
  return sum;
}

// log2 of a power of two.
__device__ __forceinline__ int log2_pow2(int v) { return __ffs(v) - 1; }

// An index into a tile's operands: 32-bit in shared memory, 64-bit into
// the operand rows in global memory (direct).
template <bool Direct>
using TileIdx = typename std::conditional<Direct, long long, int>::type;

// Lane j of tile t's offsets in its operand rows: j itself in a set of
// shared memory; direct, lane_offsets of its lane in the row.
template <bool Direct, typename T>
__device__ __forceinline__ void tile_offsets(const StreamArgs<T>& s,
                                             const Block<T>& b,
                                             const Tile<T>& t, int j,
                                             int& o_re, int& o_im,
                                             bool& has_im) {
  if (Direct) {
    lane_offsets(b.lo + t.lane0 + j, s.n_r, s.packed, o_re, o_im, has_im);
  } else {
    o_re = o_im = j;
    has_im = true;
  }
}

// The drive y . wd and the masked update of NT rows from rt on tile t.  NT
// is a template parameter so that the row loops unroll without a branch a
// row (each row's loads issue together); register arrays are indexed only
// in unrolled loops (a runtime index puts them in local memory).
template <bool Direct, int NT, typename T>
__device__ void drive_rows(const StreamArgs<T>& s, const Block<T>& b,
                           const Tile<T>& t, int rt) {
  const int tid = threadIdx.x, n_d = s.n_d, hld = t.hld;
  // wd's stride over outputs.
  const TileIdx<Direct> ld = Direct ? (TileIdx<Direct>)s.wd_ld : t.w;
  const int ca = kThreads / s.qa, lca = log2_pow2(ca);
  const int q = tid >> lca, c = tid & (ca - 1);
  const T* yt = b.y + rt * n_d;
  const T* live = b.live + rt;
  auto update = [&](int rr, int j, T vr, T vi) {
    if (live[rr] == T(0)) return;
    int jre, jim;
    bool jhas;
    tile_offsets<Direct>(s, b, t, j, jre, jim, jhas);
    const T ar = t.a_re[jre], ai = jhas ? t.a_im[jim] : T(0);
    T* hre = t.h_re + rr * hld + j;
    T* him = t.h_im + rr * hld + j;
    const T hr = *hre, hi = *him;
    const T nr = ar * hr - ai * hi + vr;
    const T ni = ar * hi + ai * hr + vi;
    *hre = nr;
    *him = ni;
    if (t.h_global) {
      int ore, oim;
      bool has;
      lane_offsets(b.lo + t.lane0 + j, s.n_r, s.packed, ore, oim, has);
      const long long row = (long long)(b.r0 + rt + rr) * s.h_sb;
      s.o_h_re[row + ore] = nr;
      if (has) s.o_h_im[row + oim] = ni;
    }
  };
  for (int j0 = 0; j0 < t.nl; j0 += ca) {
    const int j = j0 + c;
    // Row rr's re part is d[2 rr], its im part d[2 rr + 1].
    T d[2 * NT];
#pragma unroll
    for (int k = 0; k < 2 * NT; ++k) d[k] = T(0);
    if (j < t.nl) {
      int jre, jim;
      bool jhas;
      tile_offsets<Direct>(s, b, t, j, jre, jim, jhas);
      const T* pr = t.wd_re + jre;
      const T* pi = t.wd_im + jim;
#pragma unroll 2
      for (int e = q; e < n_d; e += s.qa) {
        const T wr = pr[e * ld], wi = jhas ? pi[e * ld] : T(0);
#pragma unroll
        for (int rr = 0; rr < NT; ++rr) {
          const T ye = yt[rr * n_d + e];
          d[2 * rr] += ye * wr;
          d[2 * rr + 1] += ye * wi;
        }
      }
    }
    if (s.qa == 1) {
      if (j < t.nl) {
#pragma unroll
        for (int rr = 0; rr < NT; ++rr) update(rr, j, d[2 * rr], d[2 * rr + 1]);
      }
    } else {
      const int slices = group_stash(d, 2 * NT, ca, b.red);
      for (int v = tid; v < NT * ca; v += kThreads) {
        const int rr = v >> lca, cc = v & (ca - 1);
        if (j0 + cc < t.nl)
          update(rr, j0 + cc, group_total(b.red, 2 * rr, cc, ca, slices),
                 group_total(b.red, 2 * rr + 1, cc, ca, slices));
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// The readout on the new state of NT rows from rt over tile t, added to
// those rows' readouts (first: set).
template <bool Direct, int NT, typename T>
__device__ void readout_rows(const StreamArgs<T>& s, const Block<T>& b,
                             const Tile<T>& t, int rt, bool first) {
  const int tid = threadIdx.x, n_d = s.n_d, hld = t.hld;
  // A lane's row of wh: 2 D apart in a set (re, then im), D apart direct.
  const TileIdx<Direct> lw = Direct ? n_d : 2 * n_d;
  const int teb = kThreads / s.qb, lteb = log2_pow2(teb);
  const int q = tid >> lteb, te = tid & (teb - 1);
  for (int e0 = 0; e0 < n_d; e0 += teb) {
    const int e = e0 + te;
    T acc[NT];
#pragma unroll
    for (int rr = 0; rr < NT; ++rr) acc[rr] = T(0);
    if (e < n_d) {
      const T* wp = t.wh + e;
      const T* wq = t.wh_im + e;
#pragma unroll 2
      for (int j = q; j < t.nl; j += s.qb) {
        int jre, jim;
        bool jhas;
        tile_offsets<Direct>(s, b, t, j, jre, jim, jhas);
        const T wr = wp[jre * lw], wi = jhas ? wq[jim * lw] : T(0);
#pragma unroll
        for (int rr = 0; rr < NT; ++rr)
          acc[rr] += t.h_re[rr * hld + j] * wr + t.h_im[rr * hld + j] * wi;
      }
    }
    if (s.qb == 1) {
      if (e < n_d) {
#pragma unroll
        for (int rr = 0; rr < NT; ++rr) {
          T* a = b.acc + (rt + rr) * n_d + e;
          *a = first ? acc[rr] : *a + acc[rr];
        }
      }
    } else {
      const int slices = group_stash(acc, NT, teb, b.red);
      for (int v = tid; v < NT * teb; v += kThreads) {
        const int rr = v >> lteb, tt = v & (teb - 1);
        if (e0 + tt >= n_d) continue;
        T* a = b.acc + (rt + rr) * n_d + e0 + tt;
        const T x = group_total(b.red, rr, tt, teb, slices);
        *a = first ? x : *a + x;
      }
      __syncthreads();
    }
  }
}

// The drive and the masked update, then the readout, of rows [rt, rt + nt)
// on tile t, at the row count's instantiation.
template <bool Direct, typename T>
__device__ void tile_step(const StreamArgs<T>& s, const Block<T>& b,
                          const Tile<T>& t, int rt, int nt, bool first) {
  switch (nt) {
#define DECODE_STREAM_ROWS_CASE(n)               \
  case n:                                        \
    drive_rows<Direct, n>(s, b, t, rt);          \
    readout_rows<Direct, n>(s, b, t, rt, first); \
    break;
    DECODE_STREAM_ROWS_CASE(1)
    DECODE_STREAM_ROWS_CASE(2)
    DECODE_STREAM_ROWS_CASE(3)
    DECODE_STREAM_ROWS_CASE(4)
    DECODE_STREAM_ROWS_CASE(5)
    DECODE_STREAM_ROWS_CASE(6)
    DECODE_STREAM_ROWS_CASE(7)
    DECODE_STREAM_ROWS_CASE(8)
#undef DECODE_STREAM_ROWS_CASE
    default:
      break;
  }
}

// Four values from p (16-byte aligned), through L2.
__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

// The sums of outputs o0 .. o0 + m - 1 (o0 a multiple of 4, m <= 4) over
// the partials of n blocks from g0, in the layout [slot / 4][G][4], by one
// warp, each in one order that depends on n alone: lane l adds blocks l,
// l + 32, ... in order, then an xor tree over the lanes.  A lane reads a
// block's four outputs at once, and up to 160 blocks' loads are issued
// before any add.  out(o, sum) runs on lane 0.
template <typename T, typename Out>
__device__ void warp_sums(const T* part, int nblk, int g0, int n, int o0,
                          int m, Out out) {
  const int lane = threadIdx.x & 31;
  const T* p = part + ((long long)(o0 >> 2) * nblk + g0) * 4;
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = T(0);
  for (int t0 = 0; t0 < n; t0 += 5 * 32) {
    T x[5][4];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const int t = t0 + c * 32 + lane;
      if (t < n) {
        load4(p + (long long)t * 4, x[c]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[c][k] = T(0);
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (t0 + c * 32 + lane < n) v[k] += x[c][k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < m) out(o0 + k, v[k]);
  }
}

// YOn: the rows' y, readouts and mask in shared memory (y_on_chip), a
// template parameter so that their loads and stores compile to shared
// memory's own instructions (a pointer that may be either is generic);
// Direct: the direct mode, so that each kernel holds one mode's tile code.
template <typename T, bool YOn, bool Direct>
__global__ void __launch_bounds__(kThreads, 1)
decode_stream_kernel(StreamArgs<T> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nblk = (int)gridDim.x;
  const int n_d = s.n_d;
  Block<T> b;
  b.g = (int)blockIdx.x;
  b.grp = b.g / s.segs;
  b.sg = b.g - b.grp * s.segs;
  b.r0 = b.grp * s.rows;
  b.nrows = max(0, min(s.rows, s.n_b - b.r0));
  b.lo = b.sg * s.lanes;
  b.nl = max(0, min(s.lanes, s.n_c - b.lo));
  const int kseg = (n_d + s.segs - 1) / s.segs;
  b.k0 = b.sg * kseg;
  b.nk = max(0, min(kseg, n_d - b.k0));
  b.batched = (s.a_sb | s.wd_sb | s.wh_sb) != 0;
  b.nt_max = b.batched ? 1 : min(s.rows, kRows);
  b.plan = smem_plan(s.rows, s.lanes, n_d, b.batched, s.mode, s.tile,
                     s.state_on_chip, s.y_on_chip);
  b.red = sm + b.plan.red;
  if constexpr (YOn) {
    b.y = sm + b.plan.y;
    b.acc = sm + b.plan.acc;
    b.live = sm + b.plan.live;
  } else {
    b.y = s.ywork + (long long)b.g * (2LL * s.rows * n_d + s.rows);
    b.acc = b.y + (long long)s.rows * n_d;
    b.live = b.acc + (long long)s.rows * n_d;
  }
  b.state = sm + b.plan.state;
  b.ops = sm + b.plan.ops;
  // A block's partials: its outputs, four side by side ([slot / 4][G][4]).
  const int slot_len = s.mean ? n_d : s.rows * n_d;
  const long long part_len = (long long)((slot_len + 3) / 4) * nblk * 4;
  auto part_at = [&](T* part, int o) -> T& {
    return part[((long long)(o >> 2) * nblk + b.g) * 4 + (o & 3)];
  };
  const bool resident = s.mode == kResident;
  const int nrt = (b.nrows + b.nt_max - 1) / b.nt_max;  // row tiles
  const int w = resident ? s.lanes : s.tile;             // a tile's lanes
  const int nlt = resident ? 1 : (b.nl + w - 1) / w;     // lane tiles

  int live_rows = 0;
  for (int i = 0; i < s.n_b; ++i) live_rows += s.mask[i] != 0;
  b.denom = live_rows > 1 ? T(live_rows) : T(1);
  for (int rl = tid; rl < b.nrows; rl += kThreads)
    b.live[rl] = s.mask[b.r0 + rl] != 0 ? T(1) : T(0);

  // The carried y; with the seed every live row's is the live rows' mean
  // of y0 (each block sums it in one order).
  for (int e = tid; e < n_d; e += kThreads) {
    T seed = T(0);
    if (s.seed_mean) {
      for (int i = 0; i < s.n_b; ++i)
        seed += s.y0[(long long)i * n_d + e] *
                (s.mask[i] != 0 ? T(1) : T(0));
      seed = seed / b.denom;
    }
    for (int rl = 0; rl < b.nrows; ++rl) {
      const int r = b.r0 + rl;
      b.y[(long long)rl * n_d + e] = s.seed_mean && s.mask[r] != 0
                                         ? seed
                                         : s.y0[(long long)r * n_d + e];
    }
  }
  T* st_re = b.state;
  T* st_im = b.state + (long long)s.rows * s.lanes;
  // The state: into shared memory, or (riding in the tiles) copied to o_h
  // first, every row (a frozen row's is its output).
  if (s.state_on_chip) {
    fill_state<true>(s, b, s.h_re, s.h_im, st_re, st_im, s.lanes, 0,
                     b.nrows, 0, b.nl);
  } else {
    for (long long i = tid; i < (long long)b.nrows * b.nl; i += kThreads) {
      const int rl = (int)(i / b.nl), jl = (int)(i - (long long)rl * b.nl);
      const long long hrow = (long long)(b.r0 + rl) * s.h_sb;
      int ore, oim;
      bool him;
      lane_offsets(b.lo + jl, s.n_r, s.packed, ore, oim, him);
      s.o_h_re[hrow + ore] = s.h_re[hrow + ore];
      if (him) s.o_h_im[hrow + oim] = s.h_im[hrow + oim];
    }
  }
  // Resident: every set of operands once.
  if (resident && s.n_k > 0) {
    const int sets = b.batched ? b.nrows : 1;
    for (int set = 0; set < sets; ++set) {
      Tile<T> t = set_view(b.ops + set * b.plan.set, w, n_d);
      t.lane0 = 0;
      t.nl = b.nl;
      fill_ops(s, b, t, b.batched ? b.r0 + set : 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // The tiles of a step: row tile rtile (rows rt, nt of them) by lane
  // tile lt; streamed, in ring stage st (direct: 0).
  auto tile_of = [&](int rtile, int lt, int st, Tile<T>& t, int& rt,
                     int& nt) {
    rt = rtile * b.nt_max;
    nt = min(b.nt_max, b.nrows - rt);
    if (!resident) {
      T* base = b.ops + st * b.plan.stage;
      t = set_view(base, w, n_d);
      if (Direct) {
        const long long orow = b.batched ? b.r0 + rt : 0;
        t.a_re = s.a_re + orow * s.a_sb;
        t.a_im = s.a_im + orow * s.a_sb;
        t.wd_re = s.wd_re + orow * s.wd_sb;
        t.wd_im = s.wd_im + orow * s.wd_sb;
        t.wh = s.wh_re + orow * s.wh_sb;
        t.wh_im = s.wh_im + orow * s.wh_sb;
      }
      t.lane0 = lt * w;
      t.nl = min(w, b.nl - t.lane0);
      if (s.state_on_chip) {
        t.h_re = st_re + rt * s.lanes + t.lane0;
        t.h_im = st_im + rt * s.lanes + t.lane0;
        t.hld = s.lanes;
        t.h_global = false;
      } else {
        t.h_re = base + b.plan.set;
        t.h_im = t.h_re + b.nt_max * w;
        t.hld = w;
        t.h_global = true;
      }
    } else {
      t = set_view(b.ops + (b.batched ? rtile : 0) * b.plan.set, w, n_d);
      t.lane0 = 0;
      t.nl = b.nl;
      t.h_re = st_re + rt * s.lanes;
      t.h_im = st_im + rt * s.lanes;
      t.hld = s.lanes;
      t.h_global = false;
    }
  };
  // A step runs its lane tiles in order, each over the row tiles in
  // order.  The streamed ring holds units of operands in that order, unit
  // i in stage i % 2: with shared weights a lane tile's (every row tile
  // of it reads the one copy), per-slot a row tile's of it.  The next
  // unit to fetch goes out as one commit group (empty past the wave's
  // end, so that the groups still count units).
  const int nru = b.batched ? nrt : 1;  // row tiles a unit
  int f_step = 0, f_rtile = 0, f_lt = 0, f_stage = 0;
  auto issue = [&]() {
    if (f_step < s.n_k) {
      Tile<T> t;
      int rt, nt;
      tile_of(f_rtile, f_lt, f_stage, t, rt, nt);
      fill_ops(s, b, t, b.batched ? b.r0 + rt : 0);
      if (++f_rtile == nru) {
        f_rtile = 0;
        if (++f_lt == nlt) {
          f_lt = 0;
          ++f_step;
        }
      }
      f_stage ^= 1;
    }
    cp_async_commit();
  };
  if (s.mode == kStreamed) issue();

  bool gave_up = false;
  unsigned waits = 0;
  // Every block's partials (or published y) written: the block's flag
  // says so, and warp 0 waits for every block's.
  auto arrive_wait = [&]() {
    __syncthreads();
    ++waits;
    if (tid == 0) flag_release(s.flags + b.g, waits);
    if (warp == 0 && !gave_up)
      gave_up = !grid_wait(s.flags, nblk, waits, s.err);
    __syncthreads();
  };

  // The ring stage of the unit being computed (direct: always 0).
  int stage = 0;
  for (int step = 0; step < s.n_k; ++step) {
    T* part = s.part + (step & 1) * part_len;
    for (int lt = 0; lt < nlt; ++lt) {
      for (int rtile = 0; rtile < nrt; ++rtile) {
        Tile<T> t;
        int rt, nt;
        tile_of(rtile, lt, stage, t, rt, nt);
        const bool unit = s.mode == kStreamed && (b.batched || rtile == 0);
        if (!resident) {
          // Streamed, at a unit's first tile: the unit has landed, and
          // the stage of the one before is free for the next.  A state
          // riding in the tile is loaded now, after its last write-back,
          // once every thread is done with the tile that used its room.
          if (unit) cp_async_wait<0>();
          if (t.h_global) {
            __syncthreads();
            fill_state<false>(s, b, s.o_h_re, s.o_h_im, t.h_re, t.h_im,
                              t.hld, rt, nt, t.lane0, t.nl);
          }
          __syncthreads();
          if (unit) issue();
        }
        tile_step<Direct>(s, b, t, rt, nt, lt == 0);
        // After a unit's last tile the next unit is in the other stage
        // (with shared weights every row tile of a lane tile reads one).
        if (s.mode == kStreamed && (b.batched || rtile == nrt - 1))
          stage ^= 1;
      }
    }
    __syncthreads();
    // The partials: each row's readout over the segment's lanes, the
    // segment's share of the feedback and (segment 0) the bias, every
    // (row, output) at once.  mean: then the rows' readouts times their
    // m, summed in row order.
    for (int i = tid; i < b.nrows * n_d; i += kThreads) {
      const int rl = i / n_d, e = i - rl * n_d;
      const int r = b.r0 + rl;
      T v = b.acc[i];
      if (s.wy != nullptr) {
        const T* yr = b.y + (long long)rl * n_d;
        const T* wy = s.wy + (long long)r * s.wy_sb + e;
#pragma unroll 4
        for (int k = b.k0; k < b.k0 + b.nk; ++k)
          v += yr[k] * wy[(long long)k * n_d];
      }
      if (b.sg == 0 && s.b_out != nullptr)
        v += s.b_out[(long long)r * s.bo_sb + e];
      if (s.mean)
        b.acc[i] = v * b.live[rl];
      else
        part_at(part, i) = v;
    }
    if (s.mean) {
      __syncthreads();
      for (int e = tid; e < n_d; e += kThreads) {
        T m = T(0);
        for (int rl = 0; rl < b.nrows; ++rl) m += b.acc[rl * n_d + e];
        part_at(part, e) = m;
      }
    }

    // The exchange.
    arrive_wait();
    // Blocks holding partials of an output, the first of them, and the
    // outputs of the domain (off: the row group's; mean: the grid's).
    const int members = s.mean ? nblk : s.segs;
    const int g0 = s.mean ? 0 : b.grp * s.segs;
    const int outs = s.mean ? n_d : b.nrows * n_d;
    // The new y of output o (off: row o / D of the group) into the
    // block's rows.
    auto set_y = [&](int o, T v) {
      if (s.mean) {
        const T yv = v / b.denom;
        for (int rl = 0; rl < b.nrows; ++rl)
          if (b.live[rl] != T(0)) b.y[rl * n_d + o] = yv;
      } else if (b.live[o / n_d] != T(0)) {
        b.y[o] = v;
      }
    };
    if (s.rounds == 1) {
      for (int o0 = 4 * warp; o0 < outs; o0 += 4 * kWarps)
        warp_sums(part, nblk, g0, members, o0, min(4, outs - o0), set_y);
    } else {
      // Reduce-scatter: this block's slice of the domain's outputs (a
      // multiple of 4) ...
      const int me = s.mean ? b.g : b.sg;
      const int per = 4 * ((outs + 4 * members - 1) / (4 * members));
      const int o1 = min(outs, (me + 1) * per);
      for (int o0 = me * per + 4 * warp; o0 < o1; o0 += 4 * kWarps)
        warp_sums(part, nblk, g0, members, o0, min(4, o1 - o0),
                  [&](int o, T v) {
                    if (s.mean)
                      s.ybuf[o] = v / b.denom;
                    else
                      s.ybuf[(long long)b.r0 * n_d + o] =
                          b.live[o / n_d] != T(0) ? v : b.y[o];
                  });
      arrive_wait();
      // ... then gather every output of the block's rows (mean: the D
      // means into every live row).
      if (s.mean) {
        for (int e = tid; e < n_d; e += kThreads) {
          const T v = __ldcg(s.ybuf + e);
          for (int rl = 0; rl < b.nrows; ++rl)
            if (b.live[rl] != T(0)) b.y[rl * n_d + e] = v;
        }
      } else {
        const T* src = s.ybuf + (long long)b.r0 * n_d;
        const int n = b.nrows * n_d;
        for (int i0 = 0; i0 < n; i0 += 4 * kThreads) {
          T x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = i0 + k * kThreads + tid;
            x[k] = i < n ? __ldcg(src + i) : T(0);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = i0 + k * kThreads + tid;
            if (i < n) b.y[i] = x[k];
          }
        }
      }
    }
    __syncthreads();
    if (b.sg == 0) {
      T* ys = s.o_ys + ((long long)step * s.n_b + b.r0) * n_d;
      for (int i = tid; i < b.nrows * n_d; i += kThreads) ys[i] = b.y[i];
    }
  }
  if (s.state_on_chip) {
    for (long long i = tid; i < (long long)b.nrows * b.nl; i += kThreads) {
      const int rl = (int)(i / b.nl), jl = (int)(i - (long long)rl * b.nl);
      const long long hrow = (long long)(b.r0 + rl) * s.h_sb;
      int ore, oim;
      bool him;
      lane_offsets(b.lo + jl, s.n_r, s.packed, ore, oim, him);
      s.o_h_re[hrow + ore] = st_re[(long long)rl * s.lanes + jl];
      if (him) s.o_h_im[hrow + oim] = st_im[(long long)rl * s.lanes + jl];
    }
  }
  if (b.sg == 0) {
    for (int i = tid; i < b.nrows * n_d; i += kThreads)
      s.o_y[(long long)b.r0 * n_d + i] = b.y[i];
  }
}

// This library's process state: the error word (mapped host memory,
// allocated once: the kernel sets it, the host reads and clears it), and a
// device's last launch (its stream and an event after it), so that two
// launches never share the card at once, whatever their streams.
struct StreamState {
  int* err_host = nullptr;
  int* err_dev = nullptr;
  cudaEvent_t done[kMaxDevices] = {};
  cudaStream_t on[kMaxDevices] = {};
};
StreamState g_state;

// The scratch's first bytes: one 4-byte arrival flag a block, rounded up
// to 128 (the partials begin there).
inline long long flag_bytes(long long blocks) {
  return (4 * blocks + 127) / 128 * 128;
}

int error_word() {
  if (g_state.err_host != nullptr) return 0;
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&g_state.err_host),
                                  sizeof(int), cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  *g_state.err_host = 0;
  return (int)cudaHostGetDevicePointer(
      reinterpret_cast<void**>(&g_state.err_dev), g_state.err_host, 0);
}

// The blocks of decode_stream_kernel<T, YOn, Direct> the card holds at
// once at `smem` bytes of dynamic shared memory a block (the SMs times the
// blocks an SM holds), or a negative CUDA error code.
template <typename T, bool YOn, bool Direct>
int max_blocks(int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_stream_kernel<T, YOn, Direct>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_stream_kernel<T, YOn, Direct>, kThreads, smem);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// The fewest of a type's four instantiations' (or the first error).
template <typename T>
int max_blocks_all(int smem) {
  const int n[4] = {max_blocks<T, true, false>(smem),
                    max_blocks<T, false, false>(smem),
                    max_blocks<T, true, true>(smem),
                    max_blocks<T, false, true>(smem)};
  int most = n[0];
  for (int v : n) {
    if (v < 0) return v;
    most = v < most ? v : most;
  }
  return most;
}

template <typename T>
int stream_go(const StreamArgs<T>& s, int blocks, int smem,
              cudaStream_t stream) {
  const bool direct = s.mode == kDirect;
  auto kernel = s.y_on_chip ? (direct ? decode_stream_kernel<T, true, true>
                                      : decode_stream_kernel<T, true, false>)
                            : (direct ? decode_stream_kernel<T, false, true>
                                      : decode_stream_kernel<T, false, false>);
  const bool pow2 = (s.qa & (s.qa - 1)) == 0 && (s.qb & (s.qb - 1)) == 0;
  const int batched = (s.a_sb | s.wd_sb | s.wh_sb) != 0;
  const long long need = smem_plan(s.rows, s.lanes, s.n_d, batched, s.mode,
                                   s.tile, s.state_on_chip, s.y_on_chip)
                             .total * (long long)sizeof(T);
  if (blocks < 1 || s.groups < 1 || s.segs < 1 || s.rows < 1 ||
      s.lanes < 1 || blocks != s.groups * s.segs ||
      (long long)s.groups * s.rows < s.n_b ||
      (long long)(s.groups - 1) * s.rows >= s.n_b ||
      (long long)s.segs * s.lanes < s.n_c ||
      (long long)(s.segs - 1) * s.lanes >= s.n_c || !pow2 || s.qa < 1 ||
      kThreads % s.qa != 0 || s.qb < 1 || kThreads % s.qb != 0 ||
      s.mode < kResident || s.mode > kDirect ||
      (s.mode != kResident && (s.tile < 1 || s.tile > s.lanes)) ||
      (s.mode == kResident && !s.state_on_chip) ||
      (s.rounds != 1 && s.rounds != 2) || need != smem || smem > kMaxSmem ||
      s.flags == nullptr || s.part == nullptr || s.ybuf == nullptr ||
      s.ywork == nullptr || s.err == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // The blocks the card holds at once at this shared memory, asked again
  // when it changes.
  static int held[kMaxDevices] = {}, held_smem[kMaxDevices] = {};
  if (held[dev] == 0 || held_smem[dev] != smem) {
    const int most = max_blocks_all<T>(smem);
    if (most < 0) return -most;
    held[dev] = most;
    held_smem[dev] = smem;
  }
  if (blocks > held[dev]) return kGridTooLarge;
  if (*g_state.err_host != 0) {
    *g_state.err_host = 0;
    return kGridTimedOut;
  }
  if (g_state.done[dev] == nullptr) {
    err = cudaEventCreateWithFlags(&g_state.done[dev], cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
  } else if (g_state.on[dev] != stream) {
    err = cudaStreamWaitEvent(stream, g_state.done[dev], 0);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(s.flags, 0, flag_bytes(blocks), stream);
  if (err != cudaSuccess) return (int)err;
  // Cooperative: the runtime refuses (cudaErrorCooperativeLaunchTooLarge)
  // a grid it cannot hold at once.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g_state.on[dev] = stream;
  return (int)cudaEventRecord(g_state.done[dev], stream);
}

template <typename T>
int stream_call(const StreamCall* c) {
  if (c->n_d < 1 || c->n_c < 1 || c->n_b < 0 || c->n_k < 0 ||
      c->scratch == 0)
    return (int)cudaErrorInvalidValue;
  if (c->n_b == 0) return (int)cudaGetLastError();
  const int err = error_word();
  if (err != 0) return err;
  auto cp = [](long long v) { return reinterpret_cast<const T*>(v); };
  auto mp = [](long long v) { return reinterpret_cast<T*>(v); };
  const long long slot = ((c->mean ? c->n_d : c->rows * c->n_d) + 3) / 4 * 4;
  T* part = mp(c->scratch + flag_bytes(c->blocks));
  T* ybuf = part + 2 * c->blocks * slot;
  StreamArgs<T> s{cp(c->a_re), cp(c->a_im), cp(c->h_re), cp(c->h_im),
                  cp(c->y0), cp(c->wd_re), cp(c->wd_im), cp(c->wy),
                  cp(c->b_out), cp(c->wh_re), cp(c->wh_im),
                  reinterpret_cast<const unsigned char*>(c->mask),
                  mp(c->o_h_re), mp(c->o_h_im), mp(c->o_y), mp(c->o_ys),
                  c->a_sb, c->h_sb, c->wd_sb, c->wd_ld, c->wy_sb, c->bo_sb,
                  c->wh_sb, (int)c->n_b, (int)c->n_c, (int)c->n_r,
                  (int)c->packed, (int)c->n_d, (int)c->n_k, (int)c->mean,
                  (int)c->seed_mean, (int)c->groups, (int)c->rows,
                  (int)c->segs, (int)c->lanes, (int)c->qa, (int)c->qb,
                  (int)c->mode, (int)c->tile, (int)c->state_on_chip,
                  (int)c->y_on_chip, (int)c->rounds,
                  reinterpret_cast<unsigned*>(c->scratch), part, ybuf,
                  ybuf + (c->mean ? c->n_d : c->n_b * c->n_d),
                  g_state.err_dev};
  return stream_go<T>(s, (int)c->blocks, (int)c->smem,
                      reinterpret_cast<cudaStream_t>(c->stream));
}

}  // namespace

// The entry points take one argument: a block of 64-bit integers (pointers
// as integers, 0 for none) in the field order of StreamCall, which
// kernels/diag_scan.py packs.  In the packed layout the _im pointers equal
// the _re ones.  blocks (G = groups x segs), groups, rows (a group), segs
// (a group's lane segments), lanes (a segment), qa and qb (the thread
// groups of the drive and the readout, powers of two dividing the block's
// threads), mode (kResident, kStreamed, kDirect), tile (a tile's lanes),
// state_on_chip, y_on_chip, rounds (1 or 2) and smem (the block's dynamic
// shared memory, which must equal smem_plan's) come from the launcher's
// rule; scratch is the global scratch (a 4-byte arrival flag a block,
// zeroed by the entry on the stream, then flag_bytes(G) in the partials
// [2][slot / 4][G][4], slot = D for mean and rows x D off rounded up to 4,
// then the published y, B x D off and D mean, then, unless y_on_chip,
// G x (2 rows x D + rows) for the blocks' rows).  The entry refuses
// (cudaErrorInvalidValue) a layout that does not cover the rows and lanes
// exactly, whose thread groups do not divide the block, whose shared
// memory is not the plan's or is past the card's; (kGridTooLarge) a grid
// the card cannot hold at once; and (kGridTimedOut) any launch after one
// whose wait passed its bound.
extern "C" {

const char* cuda_error_string(int err) {
  if (err == kGridTooLarge)
    return "the card cannot hold this decode_stream grid's blocks at once "
           "(cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs is below "
           "the grid's blocks)";
  if (err == kGridTimedOut)
    return "an earlier decode_stream launch waited past its bound for its "
           "blocks (they did not all run at once): its outputs are not "
           "valid";
  return cudaGetErrorString((cudaError_t)err);
}

int decode_stream_f32(const StreamCall* c) { return stream_call<float>(c); }
int decode_stream_f64(const StreamCall* c) { return stream_call<double>(c); }

// 1 (and cleared) if a launch's wait passed its bound since the last ask,
// else 0; the host asks after synchronising.
int decode_stream_timed_out() {
  int* err = g_state.err_host;
  if (err == nullptr || *err == 0) return 0;
  *err = 0;
  return 1;
}

// The blocks of the float32 (f64 = 0) or float64 instantiations the card
// holds at once at the most shared memory a layout takes (the fewest of
// its four), or a negative CUDA error code.
int decode_stream_max_blocks(int f64) {
  return f64 ? max_blocks_all<double>(kMaxSmem)
             : max_blocks_all<float>(kMaxSmem);
}

}  // extern "C"
