// Hand-written Hopper (sm_90a) kernel for the fused closed-loop decode.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).  The entry point launches
// on the stream it is given, never synchronises, allocates nothing but the
// grid route's 4-byte error word in mapped host memory, once (the Python
// wrapper allocates outputs and scratch with torch.empty), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Parts: the instantiations fall into six parts, one for each (T, DM)
// pair, DM 1, 8 and 0 (the wide family, D read at run time).  The build
// compiles this file once a part, in parallel (-DDECODE_PART=0..5; the
// compile time grows with the instantiations, 186 in all), and links the
// objects into one library; part 0 (double, DM 1) also holds the grid
// route's process state and the C entry points.
// Without DECODE_PART the file holds every part, as one translation unit.
//
// ---------------------------------------------------------------------------
// decode_fused: K closed-loop decode steps in one launch.
//
// Replaces: src/repro/kernels/diag_scan.py::decode_fused_pallas_raw (body
//   _decode_kernel).  Each step drives the state from the carried output
//   (y . wd), runs the masked diagonal update, reads out on the NEW state
//   with the CARRIED y (b_out + y . wy + h . wh), optionally takes the mean
//   over live rows, and frozen rows keep their state and y.
// Bound on this card: latency.  The data (state, weights) is a few hundred
//   KB and the flops a few million, so bytes and flops both bound a call at
//   well under a microsecond; the K steps are serially dependent and each
//   needs a reduction over every lane of a row, so the time is K times the
//   critical path of one step: the update, the readout's sum over lanes,
//   and whatever synchronisation hands the new y to every thread.
// Design:
//   * ensemble == off: one block per slot row (grid B), W warps a row, so
//     independent rows run on separate SMs.  Thread t owns lanes
//     j = t + p * 32W (p < PER) and keeps their h (re, im) in registers for
//     all K steps.  W comes from NC, the dtype and D alone
//     (kernels/diag_scan.py::decode_layout), never from B, so a row's bits
//     do not depend on the arena's other rows or its size.  A frozen row's
//     block copies its state and y through and exits.
//   * A row too wide for one block's 227 KB of shared memory (2 + 4D
//     values a lane) splits into S <= 16 segments of L = ceil(NC / S)
//     lanes, segment s on its own block (lanes [s L, (s + 1) L), thread t
//     lane s L + t + p * 32W), the row's S blocks one thread-block cluster
//     (grid B x S, cluster dimension S, launched with cudaLaunchKernelEx;
//     past 8 the non-portable size).  S, W and PER come from NC, D and the
//     dtype alone, and S = 1 wherever one block holds the row, so those
//     shapes keep their layout and bits.  Each step the S blocks exchange
//     their warps' readout partials by the mean route's exchange below,
//     over the row's (row, segment) units, and every block adds them in
//     one order, so every block drives its lanes with the same y, bit for
//     bit; segment 0 adds the row's feedback term and writes the outputs.
//     The split is a template flag (SPLIT) chosen at launch: an unsplit
//     launch runs an instantiation whose segment arithmetic folds away,
//     since in one code path the (row, segment) indexing had slowed the
//     unsplit mean route by 3-4 % a call on an H100.
//     (A block that first summed its warps' partials, behind one barrier
//     a step, and sent one value a block sent fewer messages, but ran the
//     off route's split rows slower on an H100 and made two
//     instantiations spill: PERF.md section 6.)  The packed layout's
//     boundary between real slots and (re, im) pairs may fall in any
//     segment.  A frozen row's S blocks copy their lanes through
//     together and meet no barrier.
//   * ensemble == mean: every step's fed-back y is the mean over all live
//     rows, so the rows must meet each step.  They are spread over ONE
//     thread-block cluster of G <= 16 blocks (launched with
//     cudaLaunchKernelEx and a cluster dimension of G; past 8 the
//     non-portable size): R rows a block (R = 1 up to 16 rows), each row
//     run as the off route runs its one row, at the fewest warps a row
//     that fit (the exchange grows with W); or, a row past one block,
//     G = B x S blocks of one segment each.  A step's exchange: the warp
//     butterfly leaves every lane with its warp's readout partial; lane g
//     sends it by st.async into block g's shared slot
//     part[step & 1][unit][warp][e] (distributed shared memory; a unit is
//     a (row, segment) pair, row r's segment s at r S + s), the bytes
//     completing block g's mbarrier of that parity, whose one local
//     arrival a phase expects the step's units x W x D values.  No block
//     waits on a remote load or on a cluster-wide barrier: each waits on
//     its own mbarrier, then reads the units' partials from its own shared
//     memory: lane l takes units l, l + span, ... (span: the units rounded
//     up to a power of two, at most 32), sums each unit's W partials in
//     warp order, multiplies by its row's 0/1 m (mean only) and adds its
//     units in order; a butterfly of log2(span) shuffle levels then sums
//     the lanes.  Float addition commutes, so every lane of every warp of
//     every block ends with the same bits: every member feeds back the
//     same y, as in the reference.  Two parity slots suffice: a block sends
//     step s + 2's partials only after its mbarrier saw every block's step
//     s + 1 partials, each sent after that block's reads of step s.  A
//     cluster barrier before the loop (after the mbarriers' init) keeps
//     every st.async off a block that has not started, and one after it
//     keeps every block alive until its sends have landed.  Per-slot
//     operands take one shared-memory copy a row a block holds, so the
//     227 KB budget bounds R rows, not B.  The launcher refuses a layout no
//     cluster of which fits the card (cudaOccupancyMaxActiveClusters ==
//     0): no other path is swapped in.
//   * ensemble == mean past one cluster (GRID, a template flag, so the
//     one-cluster loop compiles as before): G clusters of C blocks (C <= 2
//     where the rows allow; a split row's S segments share one), cluster
//     c holding rows [c Bc, (c + 1) Bc) laid out as above, every block
//     keeping the mask and partials of its own cluster's rows only.  A
//     step's exchange runs within the cluster as above, which leaves every
//     block with its cluster's sum of m_r y_r; then the cluster's rank-0
//     block writes it into slot part[x & 1][c] of a global scratch and
//     adds one to the arrival counter (red.release.gpu); every lane of
//     warp 0 of every block waits (ld.acquire.gpu) until the counter reads
//     G (x + 1), reads the G sums (L2, __ldcg) and adds them in one fixed
//     order (a butterfly over cluster order), so every block of every
//     cluster has the same bits; one barrier hands them to the block, and
//     y = sum / max(sum m, 1) (the block counts the whole mask once, an
//     integer).  x counts the exchanges: the seed (the live rows' mean of
//     y0) runs as exchange 0 when the packed entry asks for it, through
//     the same path.  Two parity slots suffice: a leader writes
//     part[(x + 2) & 1] only after exchange x + 1's count completed, which
//     needs every cluster's leader to have published x + 1, after its
//     cluster's exchange x + 1, which needs every block of that cluster to
//     have sent its step-(x + 1) partials, each after its reads of
//     exchange x.  The G clusters must all run at once: the rule's G is at
//     most the clusters of C blocks the card holds at one block an SM
//     (kernels/diag_scan.py::DECODE_MAX_GRID_CLUSTERS), the launcher
//     refuses a grid cudaOccupancyMaxActiveClusters says the card cannot
//     hold and launches it cooperatively (the runtime refuses one it
//     cannot hold at once), after the device's last grid launch on any
//     stream, with the counter zeroed on the stream.  A wait has a bound:
//     past it the block sets an error word in mapped host memory and stops
//     waiting (past a shorter one it also gives up once another block
//     set it), so no grid hangs the card; the next grid launch, or
//     kernels/diag_scan.py::decode_grid_check after a synchronise, raises.
//   * The coefficients a and the weights wd, wh of a thread's lanes are
//     loaded once, before the K loop, into shared memory laid out so that
//     thread t reads column t (conflict-free); wy and b_out too.  Nothing is
//     read from device memory inside the loop.  (Registers cannot hold
//     2 + 4D values a lane at the engine's lane counts; only h lives there.)
//     A step is straight-line code over the thread's PER lane slots (a
//     padded slot holds zeros and a select keeps its h), so the shared
//     loads of every slot issue ahead of the arithmetic; per-lane branches
//     had serialised them (on an H100: 0.091 -> 0.062 ms a call at the
//     serving shape).
//   * off, one block a row: one barrier a step: each warp sums its D
//     readout partials with
//     __shfl_xor_sync (warp 0's lane 0 first adds b_out + y . wy), lane 0
//     writes them into a slot of shared memory double-buffered by
//     step & 1, one __syncthreads, and every thread re-sums the W partials
//     in the same fixed order, so every thread holds the same new y without
//     a second barrier or a broadcast.  A single warp (W == 1) needs no
//     barrier at all: lane 0's sum is broadcast by a shuffle.  Fixed orders
//     throughout, so results are bit-identical run to run.
//   * Operands are read in place in either layout: split (re, im) lanes,
//     or the engine's packed Q layout (real slots j < n_r first, then the
//     (re, im) pairs interleaved at n_r + 2p), with w_out read through row
//     offsets for the bias, feedback and state rows.  The packed layout's
//     new state is written back packed, so the engine's decode is one
//     launch.  Per-slot (3D) operands are read through their batch stride.
//   * D > 8 (or a call that asks for it) runs the wide family (DM = 0,
//     decode_wide below): the same routes, with y in shared memory, the
//     lane operands unpadded and the readout reduced in tiles of 8 outputs.
//   Semantics kept from the TPU kernel: the mask is 0/1 with
//   denom = max(sum m, 1); the mean multiplies every row's readout by its
//   m (so a non-finite frozen row reaches the mean, as in the reference).
// ---------------------------------------------------------------------------
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifdef DECODE_PART
#define DECODE_PART_HAS(p) (DECODE_PART == (p))
#else
#define DECODE_PART_HAS(p) 1
#endif

// The arguments of one call, as the launcher packs them (described beside
// the entry points below).
struct DecodeCall {
  long long a_re, a_im, a_sb, h_re, h_im, h_sb, y0, wd_re, wd_im, wd_sb,
      wd_ld, wy, wy_sb, b_out, bo_sb, wh_re, wh_im, wh_sb, mask, o_h_re,
      o_h_im, o_y, o_ys, n_b, n_c, n_r, packed, n_d, n_k, warps, per, mean,
      seed_mean, rows, blocks, copies, segs, smem, stream, grid, crows,
      scratch, wide;
};

// What the parts share: the grid route's state in this process (defined
// in part 0) and one entry a part.
namespace decode_parts {
constexpr int kMaxDevices = 64;
struct GridState {
  int* err_host = nullptr;
  int* err_dev = nullptr;
  cudaEvent_t done[kMaxDevices] = {};
  cudaStream_t on[kMaxDevices] = {};
};
extern GridState g_grid;
int grid_error_word();
int call_f64_d1(const DecodeCall* c);
int call_f64_d8(const DecodeCall* c);
int call_f32_d1(const DecodeCall* c);
int call_f32_d8(const DecodeCall* c);
int call_f64_d0(const DecodeCall* c);
int call_f32_d0(const DecodeCall* c);
}  // namespace decode_parts

namespace {

using decode_parts::g_grid;
using decode_parts::grid_error_word;

// The most threads a block of the <T, PER, DM, SPLIT, GRID> instantiation
// runs, which sets its register cap (65536 / threads, at most 255): the
// largest at which ptxas held every instantiation without spilling on
// sm_90a (chip_smoke.py phase 2 fails on a spill).  words = sizeof(T) / 4.
// The launcher's rule (kernels/diag_scan.py::decode_max_threads) repeats
// it.
__host__ __device__ constexpr int decode_max_threads(int per, int dm,
                                                     int words, bool split,
                                                     bool grid = false) {
  if (dm == 0) return 256;  // the wide family (float32 spilled at 512)
  if (words == 2)
    return dm == 1 ? (per <= 10 ? 512 : 256)
                   : (per == 1 && !split ? 512 : 256);
  return dm == 1 ? (per <= 3 ? 1024 : per <= (grid ? 10 : 12) ? 512 : 256)
                 : 512;
}

template <typename T>
struct DecodeArgs {
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
  int n_b, n_c, n_r, packed, n_d, n_k, warps, mean, seed_mean, rows, copies,
      segs, seg_len;
  // The mean route's grid (GRID): clusters, blocks a cluster, rows a
  // cluster (the last may hold fewer), the arrival counter and the
  // clusters' sums [2][grid][D] in global scratch, and the error word (in
  // mapped host memory) a wait past its bound sets.
  int grid, cluster, crows;
  unsigned* counter;
  T* gpart;
  volatile int* err;
};

// The most blocks in the mean route's cluster (the H100's non-portable
// cluster size), and the codes the entry returns when no cluster of the
// layout fits the card, when the card cannot hold a grid's clusters at
// once, and when an earlier grid launch's wait passed its bound (not CUDA
// error codes; cuda_error_string names them).
constexpr int kMaxCluster = 16;
// The most outputs D of the wide family (DM = 0); the DM = 8 family takes
// D <= 8.  The wide family's lanes a thread: its rule takes the fewest
// (at most 4 at every shape it has a layout for), so it instantiates only
// these (at 16, float64, its grid instantiation spilled on sm_90a at the
// 255-register cap).
constexpr int kMaxD = 128;
__host__ __device__ constexpr bool decode_wide_per(int per) {
  return per <= 4 || per == 6 || per == 8 || per == 12;
}
constexpr int kNoCluster = 10000;
constexpr int kGridTooLarge = 10001;
constexpr int kGridTimedOut = 10002;
// A grid block's wait for the step's clusters: past kGridSlowNs it also
// reads the error word (another block gave up), past kGridSpinNs it gives
// up itself.  A step takes microseconds.
constexpr unsigned long long kGridSlowNs = 100000ull;
constexpr unsigned long long kGridSpinNs = 200000000ull;

// PTX wrappers: the mean route's exchange through distributed shared
// memory.  A block's two mbarriers (one a parity) each count one local
// arrival a phase, which also expects the phase's bytes; every warp's
// partials land in each block by st.async, whose bytes complete the
// receiving block's mbarrier.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised mbarriers visible to the cluster (a cluster
// barrier follows before any remote use).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This block's arrival of the phase, expecting `bytes` of st.async data.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` completes; its data then visible.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p_done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p_done, "
      "[%0], %1;\n"
      "@!p_done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// v into block `rank`'s copy of *dst (this block's address of it), the
// bytes completing block `rank`'s copy of *bar.
__device__ __forceinline__ void st_async(double* dst, double v,
                                         unsigned long long* bar,
                                         unsigned rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" :: "r"(d), "l"(__double_as_longlong(v)), "r"(b) : "memory");
}

__device__ __forceinline__ void st_async(float* dst, float v,
                                         unsigned long long* bar,
                                         unsigned rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(d), "r"(__float_as_uint(v)), "r"(b) : "memory");
}

// The grid's arrival counter: a cluster's release add after writing its
// sum, and the acquire loads that wait for every cluster's.
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// End of the PTX wrappers.

// Until *counter reaches target (true), or false once the wait passed
// kGridSpinNs (setting *err) or, past kGridSlowNs, found *err set by
// another block: a grid whose clusters cannot all run at once then ends
// (its outputs invalid, the next launch raises) instead of hanging.
__device__ bool grid_wait(const unsigned* counter, unsigned target,
                          volatile int* err) {
  if (ld_acquire(counter) >= target) return true;
  const unsigned long long t0 = global_ns();
  for (;;) {
    if (ld_acquire(counter) >= target) return true;
    const unsigned long long dt = global_ns() - t0;
    if (dt > kGridSlowNs && *err != 0) return false;
    if (dt > kGridSpinNs) {
      *err = 1;
      __threadfence_system();
      return false;
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

// v[0] + v[stride] + ... + v[(W - 1) stride], in that order, with all W
// loads issued first.
template <int W, typename T>
__device__ __forceinline__ T sum_warps(const T* v, int stride) {
  T x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = v[k * stride];
  T s = x[0];
#pragma unroll
  for (int k = 1; k < W; ++k) s += x[k];
  return s;
}

// The same for the block's W (a power of two up to 32).
template <typename T>
__device__ __forceinline__ T sum_warps(const T* v, int stride, int warps) {
  switch (warps) {
    case 1: return sum_warps<1>(v, stride);
    case 2: return sum_warps<2>(v, stride);
    case 4: return sum_warps<4>(v, stride);
    case 8: return sum_warps<8>(v, stride);
    case 16: return sum_warps<16>(v, stride);
    default: return sum_warps<32>(v, stride);
  }
}

// The warp's sum of each of a lane's 8 values in 9 shuffles: a
// reduce-scatter over lane bits 4, 3 and 2 (each level a lane keeps half
// its values and adds its partner's half of them), then a butterfly over
// bits 1 and 0.  Lane l returns the sum over the 32 lanes of a[l >> 2],
// as do the other three lanes of its group of four.  Fixed order.
template <typename T>
__device__ __forceinline__ T warp_sum8(const T (&a)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  T u[4], v[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (b4 ? a[i + 4] : a[i]) +
           __shfl_xor_sync(0xffffffffu, b4 ? a[i] : a[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v[i] = (b3 ? u[i + 2] : u[i]) +
           __shfl_xor_sync(0xffffffffu, b3 ? u[i] : u[i + 2], 8);
  T x = (b2 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, b2 ? v[0] : v[1], 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// The wide-D family (DM = 0: D read at run time, up to kMaxD outputs), every
// route of the kernel below: off (one block a row, or a row split over a
// cluster), mean (one cluster, or a grid of clusters).  The lanes, their
// operands and the exchange are laid out as there, but D no longer lives
// in registers:
//   * The carried y of each row of the block is in shared memory, y_s[row][D]
//     (every thread of the row reads all of it for the drive), and the lane
//     operands are stored unpadded, [copies][2 + 4D][L] for the row's L =
//     ceil(NC / S) lanes of a segment, lane jl at column jl (thread t reads
//     column t + p 32W, clamped into the segment: a padded slot's h is 0 and
//     its update is dropped, so it reads the last lane's finite values and
//     adds nothing).  At 2 + 4D values a lane the padding to 32W lanes a
//     slot would have cost a quarter of a block at D = 128.
//   * A step: the drive loops over the D outputs (each y[e] read once, for
//     all the thread's lanes); the readout runs in tiles of 8 outputs, each
//     thread's 8 partial sums reduced over the warp by warp_sum8 (9 shuffles
//     a tile, not 40).  The feedback y . wy joins the partials, spread over
//     the row's threads: segment s holds rows [s Ks, (s + 1) Ks) of wy (Ks =
//     ceil(D / S)), transposed so that thread t reads column t, and thread t
//     adds y[k] wy[k][e] for its k = s Ks + t, + 32W, ...; the bias joins at
//     thread 0 of segment 0.  So every segment adds a share of the feedback,
//     and a block holds D Ks + D of its values, not D^2 + D.
//   * The warp's partials go where the other routes send theirs: lane l
//     (one of four holding output e) stores it (one block a row), or sends
//     it by st.async to blocks l & 3, + 4, ... of the cluster.  Then one
//     thread an output (tid, tid + blockDim, ...) sums its output over the
//     units in unit order (each unit's W partials in warp order, times its
//     row's m), across a grid's clusters in cluster order, and writes the new
//     y of the block's live rows into y_s and the outputs; a barrier hands
//     it to every thread.  So every block of a split row and every member of
//     a mean arena feeds back the same y, bit for bit.  The parity argument
//     of the exchange holds as there: a block sends step x + 2's partials
//     after its wait for step x + 1's, which each block sent after its
//     barrier of step x, after its reads of step x's.
// The frozen-row, mask and non-finite semantics are the other family's.
template <typename T, int PER, bool SPLIT, bool GRID>
__device__ __forceinline__ void decode_wide(const DecodeArgs<T>& s,
                                            unsigned char* smem_raw) {
  const int n_d = s.n_d;
  const int tpr = s.warps * 32;            // threads a row
  const int nv = 2 + 4 * n_d;              // shared values a lane
  const int tid = threadIdx.x;
  const int lr = tid / tpr;                // row within the block
  const int t = tid - lr * tpr;
  const int w = t >> 5, lane = tid & 31;
  const int rows = s.mean ? s.rows : 1;    // rows a block
  const int segs = SPLIT ? s.segs : 1;     // blocks a row (segments)
  const bool xchg = SPLIT || s.mean;
  const int cl = GRID ? (int)blockIdx.x / s.cluster : 0;
  const int bic = GRID ? (int)blockIdx.x - cl * s.cluster : (int)blockIdx.x;
  const int r0 = GRID ? cl * s.crows : 0;
  const int nbc = GRID ? min(s.crows, s.n_b - r0) : s.n_b;
  const int blk = SPLIT ? bic / segs : bic;
  const int sg = SPLIT ? bic - blk * segs : 0;  // this segment
  const int rc = blk * rows + lr;          // row within the cluster
  const int r = r0 + rc;                   // slot row
  const bool valid = rc < nbc;
  const int len = s.seg_len;               // the segment's lane stride L
  const int lo = sg * len;
  const int n_seg = !valid ? 0 : max(0, min(len, s.n_c - lo));
  // This segment's rows of wy: [k0, k0 + nk), Ks = kseg a segment.
  const int kseg = (n_d + segs - 1) / segs;
  const int k0 = sg * kseg;
  const int nk = max(0, min(kseg, n_d - k0));
  const int nfb = n_d * kseg + n_d;        // wy^T [D][Ks], then b_out
  const int copy_sz = nv * len;
  const int units = (s.mean ? nbc : 1) * segs;
  const int unit = (s.mean ? rc : 0) * segs + sg;
  // Shared memory: the exchange's two mbarriers (16 bytes); lane operands
  // [copies][nv][L]; the feedback [rows][nfb]; each unit's row's 0/1 mask
  // [units]; readout partials [2][units][W][D] (one block a row: [2][W][D]);
  // the carried y [rows][D].
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem_raw);
  T* lane_s = reinterpret_cast<T*>(smem_raw + (xchg ? 16 : 0));
  T* fb_s = lane_s + s.copies * copy_sz;
  T* m_s = fb_s + rows * nfb;
  T* part_s = m_s + units;
  const int part_sz = (xchg ? units : 1) * s.warps * n_d;
  T* y_s = part_s + 2 * part_sz;

  const bool live = valid && s.mask[r] != 0;
  const long long hrow = (long long)r * s.h_sb;
  if (!s.mean && !live) {
    // A frozen row keeps its state and y for all K steps (each of its
    // blocks copies its own lanes; segment 0 the outputs).
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int jl = t + p * tpr;
      if (jl < n_seg) {
        int ore, oim;
        bool him;
        lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
        s.o_h_re[hrow + ore] = s.h_re[hrow + ore];
        if (him) s.o_h_im[hrow + oim] = s.h_im[hrow + oim];
      }
    }
    if (SPLIT && sg != 0) return;
    for (int i = t; i < s.n_k * n_d; i += tpr) {
      const int step = i / n_d, e = i - step * n_d;
      s.o_ys[((long long)step * s.n_b + r) * n_d + e] = s.y0[r * n_d + e];
    }
    for (int e = t; e < n_d; e += tpr) s.o_y[r * n_d + e] = s.y0[r * n_d + e];
    return;
  }

  // Load this row's lane operands once (a shared copy: row 0 loads it),
  // zeros past the segment's lanes.
  if (s.copies > 1 || lr == 0) {
    T* q0 = lane_s + (s.copies > 1 ? lr : 0) * copy_sz;
    const T* a_re = s.a_re + r * s.a_sb;
    const T* a_im = s.a_im + r * s.a_sb;
    const T* wd_re = s.wd_re + r * s.wd_sb;
    const T* wd_im = s.wd_im + r * s.wd_sb;
    const T* wh_re = s.wh_re + r * s.wh_sb;
    const T* wh_im = s.wh_im + r * s.wh_sb;
    for (int jl = t; jl < len; jl += tpr) {
      const bool ok = jl < n_seg;
      int ore = 0, oim = 0;
      bool him = false;
      if (ok) lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
      T* q = q0 + jl;
      q[0] = ok ? a_re[ore] : T(0);
      q[len] = ok && him ? a_im[oim] : T(0);
      for (int e = 0; e < n_d; ++e) {
        q[(2 + 4 * e) * len] = ok ? wd_re[e * s.wd_ld + ore] : T(0);
        q[(3 + 4 * e) * len] = ok && him ? wd_im[e * s.wd_ld + oim] : T(0);
        q[(4 + 4 * e) * len] = ok ? wh_re[(long long)ore * n_d + e] : T(0);
        q[(5 + 4 * e) * len] =
            ok && him ? wh_im[(long long)oim * n_d + e] : T(0);
      }
    }
  }
  for (int i = t; i < nfb; i += tpr) {
    T v = T(0);
    if (valid && i < n_d * kseg) {
      const int e = i / kseg, kl = i - e * kseg;
      if (kl < nk && s.wy != nullptr)
        v = s.wy[r * s.wy_sb + (long long)(k0 + kl) * n_d + e];
    } else if (valid && s.b_out != nullptr) {
      v = s.b_out[r * s.bo_sb + (i - n_d * kseg)];
    }
    fb_s[lr * nfb + i] = v;
  }
  if (xchg) {  // off: a live row's units (a frozen row has left)
    for (int i = tid; i < units; i += blockDim.x)
      m_s[i] = !s.mean || s.mask[r0 + i / segs] != 0 ? T(1) : T(0);
  }

  // The row's state lanes, in registers for all K steps.
  T hr[PER], hi[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int jl = t + p * tpr;
    hr[p] = hi[p] = T(0);
    if (jl < n_seg) {
      int ore, oim;
      bool him;
      lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
      hr[p] = s.h_re[hrow + ore];
      if (him) hi[p] = s.h_im[hrow + oim];
    }
  }
  T denom = T(1);
  if (GRID) {
    int live_rows = 0;
    for (int i = 0; i < s.n_b; i += (int)blockDim.x)
      live_rows += __syncthreads_count(i + tid < s.n_b &&
                                       s.mask[i + tid] != 0);
    denom = live_rows > 1 ? T(live_rows) : T(1);
  } else if (s.mean) {
    T msum = T(0);
    for (int i = 0; i < s.n_b; ++i) msum += s.mask[i] != 0 ? T(1) : T(0);
    denom = msum > T(1) ? msum : T(1);
  }
  T* yr = y_s + lr * n_d;                  // this row's carried y
  for (int e = t; e < n_d; e += tpr) {
    T v = T(0);
    if (valid) {
      v = s.y0[r * n_d + e];
      if (!GRID && s.seed_mean && live) {
        T acc = T(0);
        for (int i = 0; i < s.n_b; ++i)
          acc += s.y0[i * n_d + e] * (s.mask[i] != 0 ? T(1) : T(0));
        v = acc / denom;
      }
    }
    yr[e] = v;
  }
  namespace cg = cooperative_groups;
  if (xchg) {
    if (tid == 0) {
      mbar_init(mbar, 1);
      mbar_init(mbar + 1, 1);
      mbar_init_fence();
    }
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  const unsigned step_bytes = (unsigned)(part_sz * (int)sizeof(T));
  // The blocks a partial goes to (lanes l & 3, + 4, ... of a group of 4).
  const int nsend = SPLIT && !s.mean ? segs
                    : GRID ? s.cluster : (int)gridDim.x;
  const bool lead = t == 0 && sg == 0;     // adds the bias
  const T* lq = lane_s + (s.copies > 1 ? lr : 0) * copy_sz;
  const T* fb = fb_s + lr * nfb;
  int col[PER];  // each slot's column, clamped into the segment
  bool ok[PER];  // which slots hold a lane; the rest keep h = 0
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    col[p] = min(t + p * tpr, len - 1);
    ok[p] = t + p * tpr < n_seg;
  }
  const int first = GRID && s.seed_mean ? -1 : 0;
  bool gave_up = false;
  for (int step = first; step < s.n_k; ++step) {
    const int x = step - first;
    const int par = x & 1;
    const bool run = !GRID || step >= 0;   // (the seed exchanges y0 only)
    T* pb = part_s + par * part_sz;
    if (xchg && tid == 0) mbar_expect(mbar + par, step_bytes);
    if (live && run) {
      T dr[PER], di[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) dr[p] = di[p] = T(0);
      for (int e = 0; e < n_d; ++e) {
        const T ye = yr[e];
        const T* qr = lq + (2 + 4 * e) * len;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          dr[p] += ye * qr[col[p]];
          di[p] += ye * qr[len + col[p]];
        }
      }
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const T ar = lq[col[p]], ai = lq[len + col[p]];
        const T nr = ar * hr[p] - ai * hi[p] + dr[p];
        const T ni = ar * hi[p] + ai * hr[p] + di[p];
        hr[p] = ok[p] ? nr : hr[p];
        hi[p] = ok[p] ? ni : hi[p];
      }
    }
    // The readout in tiles of 8 outputs: each thread's partials (its
    // lanes, its share of the feedback, the bias at the lead), summed over
    // the warp, then stored or sent by the lanes holding them.
    for (int e0 = 0; e0 < n_d; e0 += 8) {
      T acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = T(0);
      if (run) {
#pragma unroll
        for (int p = 0; p < PER; ++p) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = e0 + j;
            if (e < n_d) {
              const T* qh = lq + (4 + 4 * e) * len + col[p];
              acc[j] += hr[p] * qh[0] + hi[p] * qh[len];
            }
          }
        }
        for (int kl = t; kl < nk; kl += tpr) {
          const T yk = yr[k0 + kl];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (e0 + j < n_d) acc[j] += yk * fb[(e0 + j) * kseg + kl];
        }
        if (lead) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (e0 + j < n_d) acc[j] += fb[n_d * kseg + e0 + j];
        }
      } else if (lead && valid) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (e0 + j < n_d) acc[j] = yr[e0 + j];
      }
      const T v = warp_sum8(acc, lane);
      const int e = e0 + (lane >> 2);
      if (e < n_d && valid) {
        T* dst = pb + (unit * s.warps + w) * n_d + e;
        if (xchg) {
          for (int g = lane & 3; g < nsend; g += 4)
            st_async(dst, v, mbar + par, (unsigned)g);
        } else if ((lane & 3) == 0) {
          *dst = v;
        }
      }
    }
    if (xchg)
      mbar_wait(mbar + par, (unsigned)((x >> 1) & 1));
    else
      __syncthreads();
    // One thread an output: its sum over the units (each its W partials in
    // warp order, times its row's m), in unit order.
    T vs[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int e = tid + i * (int)blockDim.x;
      vs[i] = T(0);
      if (e < n_d) {
        if (xchg) {
          for (int u = 0; u < units; ++u)
            vs[i] += sum_warps(pb + u * s.warps * n_d + e, n_d, s.warps) *
                     m_s[u];
        } else {
          vs[i] = sum_warps(pb + e, n_d, s.warps);
        }
      }
    }
    if (GRID) {
      // Across the clusters: the rank-0 block publishes its cluster's sums
      // into slot part[x & 1][cl] and, after a barrier, adds one to the
      // counter (release); each thread holding an output waits (acquire)
      // until all s.grid clusters have added theirs this exchange and sums
      // the s.grid sums of its outputs in cluster order.
      T* slot = s.gpart + par * s.grid * n_d;
      if (bic == 0) {
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i) {
          const int e = tid + i * (int)blockDim.x;
          if (e < n_d) slot[cl * n_d + e] = vs[i];
        }
        __threadfence();
      }
      __syncthreads();
      if (tid == 0 && bic == 0) red_release_add(s.counter, 1u);
      if (tid < n_d) {
        if (!gave_up)
          gave_up = !grid_wait(s.counter, (unsigned)(s.grid * (x + 1)),
                               s.err);
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i) {
          const int e = tid + i * (int)blockDim.x;
          if (e < n_d) {
            T g = T(0);
            for (int c = 0; c < s.grid; ++c) g += __ldcg(slot + c * n_d + e);
            vs[i] = g;
          }
        }
      }
    }
    // The new y of the block's live rows (frozen rows keep theirs); segment
    // 0 writes each valid row's step output.
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int e = tid + i * (int)blockDim.x;
      if (e >= n_d) continue;
      for (int q = 0; q < rows; ++q) {
        const int rq = blk * rows + q;
        if (rq >= nbc) break;
        const bool q_live = s.mean ? m_s[rq * segs] != T(0) : live;
        if (q_live) y_s[q * n_d + e] = s.mean ? vs[i] / denom : vs[i];
        if (sg == 0 && run)
          s.o_ys[((long long)step * s.n_b + r0 + rq) * n_d + e] =
              y_s[q * n_d + e];
      }
    }
    __syncthreads();
  }
  // No block exits while its own st.async may still be in flight.
  if (xchg) cg::this_cluster().sync();

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    if (ok[p]) {
      int ore, oim;
      bool him;
      lane_offsets(lo + t + p * tpr, s.n_r, s.packed, ore, oim, him);
      s.o_h_re[hrow + ore] = hr[p];
      if (him) s.o_h_im[hrow + oim] = hi[p];
    }
  }
  if (sg == 0 && valid)
    for (int e = t; e < n_d; e += tpr) s.o_y[r * n_d + e] = yr[e];
}

// SPLIT: a row's lanes split over s.segs > 1 blocks.  Without it the
// segment arithmetic folds away (one segment, lanes [0, NC)), so the
// unsplit routes compile to the code they had before the split existed.
// GRID (with SPLIT, s.segs >= 1): the mean route over s.grid clusters that
// meet once a step through global memory; without it every grid term folds
// away, so the one-cluster routes compile to the code they had before.
template <typename T, int PER, int DM, bool SPLIT, bool GRID>
__global__ void __launch_bounds__(
    decode_max_threads(PER, DM, (int)(sizeof(T) / 4), SPLIT, GRID), 1)
decode_fused_kernel(DecodeArgs<T> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DM == 0) {
    decode_wide<T, PER, SPLIT, GRID>(s, smem_raw);
  } else {
    const int n_d = DM == 1 ? 1 : s.n_d;
    const int tpr = s.warps * 32;            // threads a row
    const int nv = 2 + 4 * n_d;              // shared values a lane
    const int tid = threadIdx.x;
    const int lr = tid / tpr;                // row within the block
    const int t = tid - lr * tpr;
    const int w = t >> 5, lane = tid & 31;
    const int rows = s.mean ? s.rows : 1;    // rows a block
    const int segs = SPLIT ? s.segs : 1;     // blocks a row (segments)
    // The cluster exchange: the mean route, or a row split over blocks.
    const bool xchg = SPLIT || s.mean;
    // GRID: this block's cluster, its rank there, the cluster's first row
    // and its rows (the last cluster may hold fewer than s.crows).
    const int cl = GRID ? (int)blockIdx.x / s.cluster : 0;
    const int bic = GRID ? (int)blockIdx.x - cl * s.cluster : (int)blockIdx.x;
    const int r0 = GRID ? cl * s.crows : 0;
    const int nbc = GRID ? min(s.crows, s.n_b - r0) : s.n_b;
    const int blk = SPLIT ? bic / segs : bic;
    const int sg = SPLIT ? bic - blk * segs : 0;  // this segment
    const int rc = blk * rows + lr;          // row within the cluster
    const int r = r0 + rc;                   // slot row
    // The mean route's last block (of a cluster) may hold padding rows past
    // its rows: they hold no lanes, write nothing and only meet the
    // cluster's barriers.
    const bool valid = rc < nbc;
    // This block's lanes of the row: [lo, lo + n_seg).
    const int lo = SPLIT ? sg * s.seg_len : 0;
    const int n_seg = !valid ? 0
                      : SPLIT ? max(0, min(s.seg_len, s.n_c - lo)) : s.n_c;
    const int nfb = n_d * n_d + n_d;
    const int copy_sz = PER * nv * tpr;
    // The (row, segment) units whose partials a step exchanges: every row of
    // the cluster for mean, this row's segments off; this block's unit.
    const int units = (s.mean ? nbc : 1) * segs;
    const int unit = (s.mean ? rc : 0) * segs + sg;
    // Shared memory: the exchange's two mbarriers (16 bytes); lane operands
    // [copies][PER][nv][tpr]; wy, b_out [rows][nfb]; each unit's row's 0/1
    // mask [units] (1 off); readout partials [2][units][W][D] (the exchange)
    // or [2][W][D] (off, one block a row); GRID: the step's y [2][D].
    unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem_raw);
    T* lane_s = reinterpret_cast<T*>(smem_raw + (xchg ? 16 : 0));
    T* fb_s = lane_s + s.copies * copy_sz;
    T* m_s = fb_s + rows * nfb;
    T* part_s = m_s + units;

    const bool live = valid && s.mask[r] != 0;
    const long long hrow = (long long)r * s.h_sb;
    if (!s.mean && !live) {
      // A frozen row keeps its state and y for all K steps (each of its
      // blocks copies its own lanes; segment 0 the outputs).
  #pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int jl = t + p * tpr;
        if (jl < n_seg) {
          int ore, oim;
          bool him;
          lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
          s.o_h_re[hrow + ore] = s.h_re[hrow + ore];
          if (him) s.o_h_im[hrow + oim] = s.h_im[hrow + oim];
        }
      }
      if (SPLIT && sg != 0) return;
      for (int i = t; i < s.n_k * n_d; i += tpr) {
        const int step = i / n_d, e = i - step * n_d;
        s.o_ys[((long long)step * s.n_b + r) * n_d + e] = s.y0[r * n_d + e];
      }
      if (t < n_d) s.o_y[r * n_d + t] = s.y0[r * n_d + t];
      return;
    }

    // Load this row's lane operands once (a shared copy: row 0 loads it).
    if (s.copies > 1 || lr == 0) {
      T* q0 = lane_s + (s.copies > 1 ? lr : 0) * copy_sz + t;
      const T* a_re = s.a_re + r * s.a_sb;
      const T* a_im = s.a_im + r * s.a_sb;
      const T* wd_re = s.wd_re + r * s.wd_sb;
      const T* wd_im = s.wd_im + r * s.wd_sb;
      const T* wh_re = s.wh_re + r * s.wh_sb;
      const T* wh_im = s.wh_im + r * s.wh_sb;
  #pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int jl = t + p * tpr;
        const bool ok = jl < n_seg;  // a padded slot holds zeros
        int ore = 0, oim = 0;
        bool him = false;
        if (ok) lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
        T* q = q0 + p * nv * tpr;
        q[0] = ok ? a_re[ore] : T(0);
        q[tpr] = ok && him ? a_im[oim] : T(0);
        for (int e = 0; e < n_d; ++e) {
          q[(2 + 4 * e) * tpr] = ok ? wd_re[e * s.wd_ld + ore] : T(0);
          q[(3 + 4 * e) * tpr] = ok && him ? wd_im[e * s.wd_ld + oim] : T(0);
          q[(4 + 4 * e) * tpr] = ok ? wh_re[(long long)ore * n_d + e] : T(0);
          q[(5 + 4 * e) * tpr] =
              ok && him ? wh_im[(long long)oim * n_d + e] : T(0);
        }
      }
    }
    for (int i = t; i < nfb; i += tpr) {
      const int nyy = n_d * n_d;
      T v = T(0);
      if (valid && i < nyy) {
        if (s.wy != nullptr) v = s.wy[r * s.wy_sb + i];
      } else if (valid && s.b_out != nullptr) {
        v = s.b_out[r * s.bo_sb + (i - nyy)];
      }
      fb_s[lr * nfb + i] = v;
    }
    if (xchg) {  // off: a live row's units (a frozen row has left)
      for (int i = tid; i < units; i += blockDim.x)
        m_s[i] = !s.mean || s.mask[r0 + i / segs] != 0 ? T(1) : T(0);
    }

    // The row's state lanes and carried y, in registers for all K steps.
    T hr[PER], hi[PER];
  #pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int jl = t + p * tpr;
      hr[p] = hi[p] = T(0);
      if (jl < n_seg) {
        int ore, oim;
        bool him;
        lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
        hr[p] = s.h_re[hrow + ore];
        if (him) hi[p] = s.h_im[hrow + oim];
      }
    }
    T denom = T(1);
    if (GRID) {
      // The block counts the live rows of the whole mask together (an
      // integer, so every block of every cluster has the same denom).
      int live_rows = 0;
      for (int i = 0; i < s.n_b; i += (int)blockDim.x)
        live_rows += __syncthreads_count(i + tid < s.n_b &&
                                         s.mask[i + tid] != 0);
      denom = live_rows > 1 ? T(live_rows) : T(1);
    } else if (s.mean) {
      T msum = T(0);
      for (int i = 0; i < s.n_b; ++i) msum += s.mask[i] != 0 ? T(1) : T(0);
      denom = msum > T(1) ? msum : T(1);
    }
    T y[DM];
  #pragma unroll
    for (int e = 0; e < DM; ++e) {
      y[e] = T(0);
      if (e < n_d && valid) {
        y[e] = s.y0[r * n_d + e];
        if (!GRID && s.seed_mean && live) {
          // Seed parity with the engine's closed loop: every live row starts
          // from the mean of the live rows' outputs.
          T acc = T(0);
          for (int i = 0; i < s.n_b; ++i)
            acc += s.y0[i * n_d + e] * (s.mask[i] != 0 ? T(1) : T(0));
          y[e] = acc / denom;
        }
      }
    }
    // The exchange's first cluster barrier: no block stores into another
    // block's shared memory, or arrives on its mbarriers, before that block
    // runs and has initialised them.
    namespace cg = cooperative_groups;
    if (xchg) {
      if (tid == 0) {
        mbar_init(mbar, 1);
        mbar_init(mbar + 1, 1);
        mbar_init_fence();
      }
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    // The units a step exchanges and this block's (unsplit, the exchange is
    // the mean route's: its B rows, this row), so that the unsplit loop
    // indexes as before the split existed.
    const int xu = SPLIT ? units : s.n_b;
    const int xme = SPLIT ? unit : r;
    // The bytes of a step's partials that land in each block.
    const unsigned step_bytes =
        (unsigned)(xu * s.warps * n_d * (int)sizeof(T));

    int span = 1;  // the units a lane group covers (a power of two)
    while (span < xu && span < 32) span <<= 1;
    // Lane g of each warp sends to block g of the cluster.
    const bool sender =
        valid && lane < (SPLIT && !s.mean ? segs
                         : GRID ? s.cluster : (int)gridDim.x);
    const bool lead = t == 0 && (!SPLIT || sg == 0);  // adds the feedback
    const T* lq = lane_s + (s.copies > 1 ? lr : 0) * copy_sz + t;
    const T* fb = fb_s + lr * nfb;
    bool ok[PER];  // which slots hold a lane; the rest stay 0 and add 0
  #pragma unroll
    for (int p = 0; p < PER; ++p) ok[p] = t + p * tpr < n_seg;
    // GRID: the seed (the live rows' mean of y0) runs as step -1 through the
    // same exchange; x counts the exchanges (its parity picks the slots).
    const int first = GRID && s.seed_mean ? -1 : 0;
    T* gy = part_s + 2 * xu * s.warps * n_d;  // GRID: the step's y [2][D]
    bool gave_up = false;                     // GRID: a wait passed its bound
    for (int step = first; step < s.n_k; ++step) {
      const int x = step - first;
      // Drive from the carried y, then the masked complex update.  Straight
      // line over every slot (selects, no branches), so the shared loads of
      // all slots issue ahead of the arithmetic.
      if (live && (!GRID || step >= 0)) {
  #pragma unroll
        for (int p = 0; p < PER; ++p) {
          const T* q = lq + p * nv * tpr;
          T dr = T(0), di = T(0);
  #pragma unroll
          for (int e = 0; e < DM; ++e) {
            if (e < n_d) {
              dr += y[e] * q[(2 + 4 * e) * tpr];
              di += y[e] * q[(3 + 4 * e) * tpr];
            }
          }
          const T ar = q[0], ai = q[tpr];
          const T nr = ar * hr[p] - ai * hi[p] + dr;
          const T ni = ar * hi[p] + ai * hr[p] + di;
          hr[p] = ok[p] ? nr : hr[p];
          hi[p] = ok[p] ? ni : hi[p];
        }
      }
      // Readout partials on the new state; the feedback term joins once.
      // (The seed's: the row's y0, once.)
      T acc[DM];
  #pragma unroll
      for (int e = 0; e < DM; ++e) {
        acc[e] = T(0);
        if (e < n_d) {
          T f = fb[n_d * n_d + e];
  #pragma unroll
          for (int k = 0; k < DM; ++k)
            if (k < n_d) f += y[k] * fb[k * n_d + e];
          acc[e] = lead ? f : T(0);
          if (GRID && step < 0) acc[e] = lead && valid ? y[e] : T(0);
        }
      }
      if (!GRID || step >= 0) {
  #pragma unroll
        for (int p = 0; p < PER; ++p) {
          const T* q = lq + p * nv * tpr;
  #pragma unroll
          for (int e = 0; e < DM; ++e) {
            if (e < n_d)
              acc[e] += hr[p] * q[(4 + 4 * e) * tpr] +
                        hi[p] * q[(5 + 4 * e) * tpr];
          }
        }
      }
  #pragma unroll
      for (int e = 0; e < DM; ++e) {
        if (e < n_d) {
  #pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        }
      }
      // The new y (frozen rows keep theirs).
      if (xchg) {
        // The butterfly left every lane of the warp with its partial: lane g
        // sends it by st.async into block g's parity slot, completing block
        // g's mbarrier of that parity; each block waits on its own mbarrier
        // and reads the units x W partials of the step from its own shared
        // memory, reduced in one fixed order.  A block sends step s + 2's
        // partials only after every block has sent step s + 1's, each after
        // its reads of step s, so the parity slot is free again.
        const int par = x & 1;
        T* pb = part_s + par * xu * s.warps * n_d;
        if (tid == 0) mbar_expect(mbar + par, step_bytes);
        if (sender) {
  #pragma unroll
          for (int e = 0; e < DM; ++e)
            if (e < n_d)
              st_async(pb + (xme * s.warps + w) * n_d + e, acc[e],
                       mbar + par, (unsigned)lane);
        }
        mbar_wait(mbar + par, (unsigned)((x >> 1) & 1));
        // Lane l takes units l, l + span, ... (span: the units, rounded up
        // to a power of two, at most 32), each its W partials in warp order
        // times its row's m (1 off), so the butterfly needs log2(span)
        // levels and every group of span lanes ends with the same sum; off,
        // m and denom are 1 and change no bit.
  #pragma unroll
        for (int e = 0; e < DM; ++e) {
          if (e >= n_d) continue;
          T v = T(0);
          for (int i = lane & (span - 1); i < xu; i += span)
            v += sum_warps(pb + i * s.warps * n_d + e, n_d, s.warps) * m_s[i];
          for (int o = span >> 1; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (GRID)
            acc[e] = v;  // the cluster's sum
          else if (live)
            y[e] = v / denom;
        }
        if (GRID) {
          // Across the clusters: the cluster's rank-0 block publishes its
          // sum into slot part[x & 1][cl] and adds one to the counter
          // (release); warp 0 of every block waits (acquire) until all
          // s.grid clusters have added theirs this exchange, reads the
          // s.grid sums, lane l clusters l, l + gspan, ..., and sums them in
          // one fixed order (a butterfly), so every block of every cluster
          // ends with the same bits; one barrier hands them to the block.
          T* slot = s.gpart + par * s.grid * n_d;
          if (tid == 0 && bic == 0) {
  #pragma unroll
            for (int e = 0; e < DM; ++e)
              if (e < n_d) slot[cl * n_d + e] = acc[e];
            red_release_add(s.counter, 1u);
          }
          if (tid < 32) {
            // Each lane waits itself (one coalesced load a poll), so each
            // lane's own acquire orders its reads of the sums.
            if (!gave_up)
              gave_up = !grid_wait(s.counter,
                                   (unsigned)(s.grid * (x + 1)), s.err);
            int gspan = 1;
            while (gspan < s.grid && gspan < 32) gspan <<= 1;
  #pragma unroll
            for (int e = 0; e < DM; ++e) {
              if (e >= n_d) continue;
              T v = T(0);
              for (int i = lane & (gspan - 1); i < s.grid; i += gspan)
                v += __ldcg(slot + i * n_d + e);
              for (int o = gspan >> 1; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
              if (lane == 0) gy[par * n_d + e] = v;
            }
          }
          __syncthreads();
  #pragma unroll
          for (int e = 0; e < DM; ++e)
            if (e < n_d && live) y[e] = gy[par * n_d + e] / denom;
        }
      } else if (s.warps == 1) {
        // One warp: lane 0's sum, by shuffle; no barrier.
  #pragma unroll
        for (int e = 0; e < DM; ++e) {
          const T v = __shfl_sync(0xffffffffu, acc[e], 0);
          if (live) y[e] = v;
        }
      } else {
        T* pb = part_s + (step & 1) * s.warps * n_d;
        if (lane == 0) {
  #pragma unroll
          for (int e = 0; e < DM; ++e)
            if (e < n_d) pb[w * n_d + e] = acc[e];
        }
        __syncthreads();
  #pragma unroll
        for (int e = 0; e < DM; ++e)
          if (e < n_d && live) y[e] = sum_warps(pb + e, n_d, s.warps);
      }
      if (lead && valid && (!GRID || step >= 0)) {
        T* ys = s.o_ys + ((long long)step * s.n_b + r) * n_d;
  #pragma unroll
        for (int e = 0; e < DM; ++e)
          if (e < n_d) ys[e] = y[e];
      }
    }
    // No block exits while its own st.async may still be in flight.
    if (xchg) cg::this_cluster().sync();

  #pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int jl = t + p * tpr;
      if (jl < n_seg) {
        int ore, oim;
        bool him;
        lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
        s.o_h_re[hrow + ore] = hr[p];
        if (him) s.o_h_im[hrow + oim] = hi[p];
      }
    }
    if (lead && valid) {
  #pragma unroll
      for (int e = 0; e < DM; ++e)
        if (e < n_d) s.o_y[r * n_d + e] = y[e];
    }
  }
}

template <typename T, int PER, int DM, bool SPLIT, bool GRID>
int decode_go(const DecodeArgs<T>& s, int blocks, int smem,
              cudaStream_t stream) {
  auto kernel = decode_fused_kernel<T, PER, DM, SPLIT, GRID>;
  const int threads = (s.mean ? s.rows : 1) * s.warps * 32;
  if (threads >
      decode_max_threads(PER, DM, (int)(sizeof(T) / 4), SPLIT, GRID))
    return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // the most this kernel may use
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if ((GRID ? s.segs < 1 : (s.segs > 1) != SPLIT) || s.segs > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (!s.mean && !SPLIT) {
    kernel<<<s.n_b, threads, smem, stream>>>(s);
    return (int)cudaGetLastError();
  }
  // The mean route: one cluster of `blocks` blocks, R rows a block, or (a
  // row split over S blocks) one segment a block; GRID: s.grid such
  // clusters, each of s.crows rows.  The off route with a row split: B
  // clusters of S blocks.
  long long grid = blocks;
  if (GRID) {
    if (!s.mean || s.rows < 1 || blocks < 1 || blocks > kMaxCluster ||
        blocks != s.cluster || s.grid < 2 || s.crows < 1 ||
        (long long)(s.grid - 1) * s.crows >= s.n_b ||
        (long long)s.grid * s.crows < s.n_b ||
        (s.segs > 1 ? s.rows != 1 || blocks != s.crows * s.segs
                    : (long long)blocks * s.rows < s.crows) ||
        s.counter == nullptr || s.gpart == nullptr || s.err == nullptr)
      return (int)cudaErrorInvalidValue;
    grid = (long long)s.grid * blocks;
  } else if (s.mean) {
    if (s.rows < 1 || blocks < 1 || blocks > kMaxCluster ||
        (s.segs > 1 ? s.rows != 1 || blocks != s.n_b * s.segs
                    : (long long)blocks * s.rows < s.n_b))
      return (int)cudaErrorInvalidValue;
  } else {
    if (blocks != s.segs) return (int)cudaErrorInvalidValue;
    grid = (long long)s.n_b * s.segs;
  }
  static bool non_portable = false;
  if (blocks > 8 && !non_portable) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    non_portable = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Refuse a cluster the card cannot hold, and a grid whose clusters it
  // cannot hold at once; asked once a cluster shape.
  static long long fits = -1;
  static int held = 0;
  const long long key =
      ((long long)blocks << 40) | ((long long)threads << 20) | smem;
  if (key != fits) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kNoCluster;
    fits = key;
    held = clusters;
  }
  if (!GRID) {
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (held < s.grid) return kGridTooLarge;
  // A grid: after the device's last grid launch, the counter zeroed on
  // this stream, launched cooperatively (the runtime refuses, with
  // cudaErrorCooperativeLaunchTooLarge, a grid it cannot hold at once).
  if (*g_grid.err_host != 0) {
    *g_grid.err_host = 0;
    return kGridTimedOut;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= decode_parts::kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (g_grid.done[dev] == nullptr) {
    err = cudaEventCreateWithFlags(&g_grid.done[dev], cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
  } else if (g_grid.on[dev] != stream) {
    err = cudaStreamWaitEvent(stream, g_grid.done[dev], 0);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(s.counter, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g_grid.on[dev] = stream;
  return (int)cudaEventRecord(g_grid.done[dev], stream);
}

// Lanes a thread, instantiated (the wide family those of decode_wide_per):
// the launcher rounds up to the next of these.
#define DECODE_PER_LIST(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(12) X(16)

template <typename T, int DM>
int decode_per(const DecodeArgs<T>& s, int per, int blocks, int smem,
               cudaStream_t stream) {
  switch (per) {
#define DECODE_CASE(P)                                                     \
  case P:                                                                  \
    if constexpr (DM == 0 && !decode_wide_per(P))                          \
      return (int)cudaErrorInvalidValue;                                   \
    else                                                                   \
      return s.grid > 1                                                    \
          ? decode_go<T, P, DM, true, true>(s, blocks, smem, stream)       \
          : s.segs > 1                                                     \
          ? decode_go<T, P, DM, true, false>(s, blocks, smem, stream)      \
          : decode_go<T, P, DM, false, false>(s, blocks, smem, stream);
    DECODE_PER_LIST(DECODE_CASE)
#undef DECODE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The entry points take one argument: a block of 64-bit integers (pointers
// as integers, 0 for none) in the field order of DecodeCall, which
// kernels/diag_scan.py packs.  In the packed layout the _im pointers equal
// the _re ones.  warps, per, rows (a block), blocks (the blocks of one
// cluster: the mean route's cluster, or a split row's segments), copies,
// segs (blocks a row), smem, grid (the mean route's clusters) and crows
// (rows a cluster) come from the launcher's rule; scratch is the grid's
// global scratch (the counter, then its sums 128 bytes in); wide (non-zero)
// runs the wide family at any D, which D > 8 always runs.  The entry
// refuses (cudaErrorInvalidValue) a per that is not instantiated, n_d past
// its family's (8, or kMaxD for the wide one),
// a block larger than the instantiation allows, or a cluster of more than
// 16 blocks or other than its rows need; (kNoCluster) a cluster the card
// cannot hold; (kGridTooLarge) a grid whose clusters the card cannot hold
// at once; and (kGridTimedOut) any grid launch after one whose wait passed
// its bound.

namespace {

template <typename T, int DM>
int decode_call(const DecodeCall* c) {
  if (c->n_d < 1 || c->n_d > (DM == 0 ? kMaxD : DM) || c->segs < 1 ||
      c->grid < 1)
    return (int)cudaErrorInvalidValue;
  if (c->n_b == 0) return (int)cudaGetLastError();
  if (c->grid > 1) {
    const int err = grid_error_word();
    if (err != 0) return err;
  }
  auto cp = [](long long v) { return reinterpret_cast<const T*>(v); };
  auto mp = [](long long v) { return reinterpret_cast<T*>(v); };
  DecodeArgs<T> s{cp(c->a_re), cp(c->a_im), cp(c->h_re), cp(c->h_im),
                  cp(c->y0), cp(c->wd_re), cp(c->wd_im), cp(c->wy),
                  cp(c->b_out), cp(c->wh_re), cp(c->wh_im),
                  reinterpret_cast<const unsigned char*>(c->mask),
                  mp(c->o_h_re), mp(c->o_h_im), mp(c->o_y), mp(c->o_ys),
                  c->a_sb, c->h_sb, c->wd_sb, c->wd_ld, c->wy_sb, c->bo_sb,
                  c->wh_sb, (int)c->n_b, (int)c->n_c, (int)c->n_r,
                  (int)c->packed, (int)c->n_d, (int)c->n_k, (int)c->warps,
                  (int)c->mean, (int)c->seed_mean, (int)c->rows,
                  (int)c->copies, (int)c->segs,
                  (int)((c->n_c + c->segs - 1) / c->segs), (int)c->grid,
                  (int)c->blocks, (int)c->crows,
                  reinterpret_cast<unsigned*>(c->scratch),
                  c->scratch ? mp(c->scratch + 128) : nullptr,
                  g_grid.err_dev};
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(c->stream);
  return decode_per<T, DM>(s, (int)c->per, (int)c->blocks, (int)c->smem,
                           stream);
}

}  // namespace

// Each part's entry; D = 1 runs the DM = 1 instantiations, D = 2..8 the
// DM = 8 ones, D = 9..kMaxD (or a call that asks for it) the wide family's
// (DM = 0).
namespace decode_parts {
#if DECODE_PART_HAS(0)
int call_f64_d1(const DecodeCall* c) { return decode_call<double, 1>(c); }

// The grid route's state in this process: its error word (mapped host
// memory, allocated once: the kernel sets it, the host reads and clears
// it), and a device's last grid launch (its stream and an event after it),
// so that grid launches never run at once, whatever their streams: two
// grids sharing the card might each keep the other's clusters waiting.
GridState g_grid;

int grid_error_word() {
  if (g_grid.err_host != nullptr) return 0;
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&g_grid.err_host),
                                  sizeof(int), cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  *g_grid.err_host = 0;
  return (int)cudaHostGetDevicePointer(
      reinterpret_cast<void**>(&g_grid.err_dev), g_grid.err_host, 0);
}
#endif
#if DECODE_PART_HAS(1)
int call_f64_d8(const DecodeCall* c) { return decode_call<double, 8>(c); }
#endif
#if DECODE_PART_HAS(2)
int call_f32_d1(const DecodeCall* c) { return decode_call<float, 1>(c); }
#endif
#if DECODE_PART_HAS(3)
int call_f32_d8(const DecodeCall* c) { return decode_call<float, 8>(c); }
#endif
#if DECODE_PART_HAS(4)
int call_f64_d0(const DecodeCall* c) { return decode_call<double, 0>(c); }
#endif
#if DECODE_PART_HAS(5)
int call_f32_d0(const DecodeCall* c) { return decode_call<float, 0>(c); }
#endif
}  // namespace decode_parts

#if DECODE_PART_HAS(0)
extern "C" {

const char* cuda_error_string(int err) {
  if (err == kNoCluster)
    return "no cluster of this decode_fused layout fits the card "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (err == kGridTooLarge)
    return "the card cannot hold this decode_fused grid's clusters at once "
           "(cudaOccupancyMaxActiveClusters is below the grid's clusters)";
  if (err == kGridTimedOut)
    return "an earlier decode_fused grid launch waited past its bound for "
           "its clusters (they did not all run at once): its outputs are "
           "not valid";
  return cudaGetErrorString((cudaError_t)err);
}

int decode_fused_f32(const DecodeCall* c) {
  return c->wide || c->n_d > 8 ? decode_parts::call_f32_d0(c)
         : c->n_d == 1         ? decode_parts::call_f32_d1(c)
                               : decode_parts::call_f32_d8(c);
}
int decode_fused_f64(const DecodeCall* c) {
  return c->wide || c->n_d > 8 ? decode_parts::call_f64_d0(c)
         : c->n_d == 1         ? decode_parts::call_f64_d1(c)
                               : decode_parts::call_f64_d8(c);
}

// 1 (and cleared) if a grid launch's wait passed its bound since the last
// ask, else 0; the host asks after synchronising.
int decode_grid_timed_out() {
  int* err = decode_parts::g_grid.err_host;
  if (err == nullptr || *err == 0) return 0;
  *err = 0;
  return 1;
}

// The most clusters of `cluster` blocks the card holds at once at one
// block an SM (the grid instantiation at 64 threads and the most dynamic
// shared memory), or a negative CUDA error code.
int decode_max_active_clusters(int cluster) {
  auto kernel = decode_fused_kernel<double, 1, 1, true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = 232448;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // extern "C"
#endif
