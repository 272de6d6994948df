// Hand-written Hopper (sm_90a) kernel for the fused closed-loop decode.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).  The entry point launches
// on the stream it is given, never synchronises, allocates nothing (the
// Python wrapper allocates outputs with torch.empty), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
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
//   * ensemble == mean: every step's fed-back y is the mean over all live
//     rows, so the rows must meet each step.  They are spread over ONE
//     thread-block cluster of G <= 16 blocks (launched with
//     cudaLaunchKernelEx and a cluster dimension of G; past 8 the
//     non-portable size), R rows a block (R = 1 up to 16 rows), each row
//     run as the off route runs its one row, at the fewest warps a row
//     that fit (the exchange grows with W).  A step's exchange: the warp
//     butterfly leaves every lane with its warp's readout partial; lane g
//     sends it by st.async into block g's shared slot
//     part[step & 1][row][warp][e] (distributed shared memory), the bytes
//     completing block g's mbarrier of that parity, whose one local
//     arrival a phase expects the step's B x W x D values.  No block waits
//     on a remote load or on a cluster-wide barrier: each waits on its own
//     mbarrier, then reads the B x W partials from its own shared memory:
//     lane l takes rows l, l + span, ... (span: B rounded up to a power of
//     two, at most 32), sums each row's W partials in warp order,
//     multiplies by the row's 0/1 m and adds its rows in order; a
//     butterfly of log2(span) shuffle levels then sums the lanes.  Float
//     addition commutes, so every lane of every warp of every block ends
//     with the same bits: every member feeds back the same y, as in the
//     reference.  Two parity slots suffice: a block sends step s + 2's
//     partials only after its mbarrier saw every block's step s + 1
//     partials, each sent after that block's reads of step s.  A cluster
//     barrier before the loop (after the mbarriers' init) keeps every
//     st.async off a block that has not started, and one after it keeps
//     every block alive until its sends have landed.  Per-slot operands
//     take one shared-memory copy a row a block holds, so the 227 KB
//     budget bounds R rows, not B.  The launcher refuses a layout no
//     cluster of which fits the card (cudaOccupancyMaxActiveClusters ==
//     0): no other path is swapped in.
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
//   * off: one barrier a step: each warp sums its D readout partials with
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
//   Semantics kept from the TPU kernel: the mask is 0/1 with
//   denom = max(sum m, 1); the mean multiplies every row's readout by its
//   m (so a non-finite frozen row reaches the mean, as in the reference).
// ---------------------------------------------------------------------------
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// The most threads a block of the <T, PER, DM> instantiation runs, which
// sets its register cap (65536 / threads, at most 255): the largest at
// which ptxas held every instantiation without spilling on sm_90a
// (chip_smoke.py phase 2 fails on a spill).  words = sizeof(T) / 4.  The
// launcher's rule (kernels/diag_scan.py::decode_max_threads) repeats it.
__host__ __device__ constexpr int decode_max_threads(int per, int dm,
                                                     int words) {
  if (words == 2)
    return dm == 1 ? (per <= 10 ? 512 : 256) : (per == 1 ? 512 : 256);
  return dm == 1 ? (per <= 3 ? 1024 : per <= 12 ? 512 : 256) : 512;
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
  int n_b, n_c, n_r, packed, n_d, n_k, warps, mean, seed_mean, rows, copies;
};

// The most blocks in the mean route's cluster (the H100's non-portable
// cluster size), and the code the entry returns when no cluster of the
// layout fits the card (not a CUDA error code; cuda_error_string names it).
constexpr int kMaxCluster = 16;
constexpr int kNoCluster = 10000;

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
// End of the PTX wrappers.

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

template <typename T, int PER, int DM>
__global__ void __launch_bounds__(
    decode_max_threads(PER, DM, (int)(sizeof(T) / 4)), 1)
decode_fused_kernel(DecodeArgs<T> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_d = DM == 1 ? 1 : s.n_d;
  const int tpr = s.warps * 32;            // threads a row
  const int nv = 2 + 4 * n_d;              // shared values a lane
  const int tid = threadIdx.x;
  const int lr = tid / tpr;                // row within the block
  const int t = tid - lr * tpr;
  const int w = t >> 5, lane = tid & 31;
  const int rows = s.mean ? s.rows : 1;    // rows a block
  const int r = blockIdx.x * rows + lr;    // slot row
  // The mean route's last block may hold padding rows past B: they hold no
  // lanes, write nothing and only meet the cluster's barriers.
  const bool valid = r < s.n_b;
  const int n_c = valid ? s.n_c : 0;
  const int nfb = n_d * n_d + n_d;
  const int copy_sz = PER * nv * tpr;
  // Shared memory: mean: two mbarriers (16 bytes); lane operands
  // [copies][PER][nv][tpr]; wy, b_out
  // [rows][nfb]; the 0/1 mask of every row [B] (mean; 1 slot off);
  // readout partials [2][B][W][D] (mean: every row of the cluster) or
  // [2][W][D] (off).
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem_raw);
  T* lane_s = reinterpret_cast<T*>(smem_raw + (s.mean ? 16 : 0));
  T* fb_s = lane_s + s.copies * copy_sz;
  T* m_s = fb_s + rows * nfb;
  T* part_s = m_s + (s.mean ? s.n_b : 1);

  const bool live = valid && s.mask[r] != 0;
  const long long hrow = (long long)r * s.h_sb;
  if (!s.mean && !live) {
    // A frozen row keeps its state and y for all K steps.
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = t + p * tpr;
      if (j < n_c) {
        int ore, oim;
        bool him;
        lane_offsets(j, s.n_r, s.packed, ore, oim, him);
        s.o_h_re[hrow + ore] = s.h_re[hrow + ore];
        if (him) s.o_h_im[hrow + oim] = s.h_im[hrow + oim];
      }
    }
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
      const int j = t + p * tpr;
      const bool ok = j < n_c;  // a padded slot holds zeros
      int ore = 0, oim = 0;
      bool him = false;
      if (ok) lane_offsets(j, s.n_r, s.packed, ore, oim, him);
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
  if (s.mean) {
    for (int i = tid; i < s.n_b; i += blockDim.x)
      m_s[i] = s.mask[i] != 0 ? T(1) : T(0);
  }

  // The row's state lanes and carried y, in registers for all K steps.
  T hr[PER], hi[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = t + p * tpr;
    hr[p] = hi[p] = T(0);
    if (j < n_c) {
      int ore, oim;
      bool him;
      lane_offsets(j, s.n_r, s.packed, ore, oim, him);
      hr[p] = s.h_re[hrow + ore];
      if (him) hi[p] = s.h_im[hrow + oim];
    }
  }
  T denom = T(1);
  if (s.mean) {
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
      if (s.seed_mean && live) {
        // Seed parity with the engine's closed loop: every live row starts
        // from the mean of the live rows' outputs.
        T acc = T(0);
        for (int i = 0; i < s.n_b; ++i)
          acc += s.y0[i * n_d + e] * (s.mask[i] != 0 ? T(1) : T(0));
        y[e] = acc / denom;
      }
    }
  }
  // The mean route's first cluster barrier: no block stores into another
  // block's shared memory, or arrives on its mbarriers, before that block
  // runs and has initialised them.
  namespace cg = cooperative_groups;
  if (s.mean) {
    if (tid == 0) {
      mbar_init(mbar, 1);
      mbar_init(mbar + 1, 1);
      mbar_init_fence();
    }
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  // The bytes of a step's partials that land in each block.
  const unsigned step_bytes =
      (unsigned)(s.n_b * s.warps * n_d * (int)sizeof(T));

  int span = 1;  // mean: the rows a lane group covers (a power of two)
  while (span < s.n_b && span < 32) span <<= 1;
  const T* lq = lane_s + (s.copies > 1 ? lr : 0) * copy_sz + t;
  const T* fb = fb_s + lr * nfb;
  bool ok[PER];  // which slots hold a lane; the rest stay 0 and add 0
#pragma unroll
  for (int p = 0; p < PER; ++p) ok[p] = t + p * tpr < n_c;
  for (int step = 0; step < s.n_k; ++step) {
    // Drive from the carried y, then the masked complex update.  Straight
    // line over every slot (selects, no branches), so the shared loads of
    // all slots issue ahead of the arithmetic.
    if (live) {
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
    T acc[DM];
#pragma unroll
    for (int e = 0; e < DM; ++e) {
      acc[e] = T(0);
      if (e < n_d) {
        T f = fb[n_d * n_d + e];
#pragma unroll
        for (int k = 0; k < DM; ++k)
          if (k < n_d) f += y[k] * fb[k * n_d + e];
        acc[e] = t == 0 ? f : T(0);
      }
    }
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
#pragma unroll
    for (int e = 0; e < DM; ++e) {
      if (e < n_d) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      }
    }
    // The new y (frozen rows keep theirs).
    if (s.mean) {
      // The butterfly left every lane of the warp with its partial: lane g
      // sends it by st.async into block g's parity slot, completing block
      // g's mbarrier of that parity; each block waits on its own mbarrier
      // and reads the B x W partials of the step from its own shared
      // memory, reduced in one fixed order.  A block sends step s + 2's
      // partials only after every block has sent step s + 1's, each after
      // its reads of step s, so the parity slot is free again.
      const int par = step & 1;
      T* pb = part_s + par * s.n_b * s.warps * n_d;
      if (tid == 0) mbar_expect(mbar + par, step_bytes);
      if (valid && lane < (int)gridDim.x) {
#pragma unroll
        for (int e = 0; e < DM; ++e)
          if (e < n_d)
            st_async(pb + (r * s.warps + w) * n_d + e, acc[e], mbar + par,
                     (unsigned)lane);
      }
      mbar_wait(mbar + par, (unsigned)((step >> 1) & 1));
      // Lane l takes rows l, l + span, ... (span: the rows, rounded up to a
      // power of two, at most 32), so the butterfly needs log2(span)
      // levels and every group of span lanes ends with the same sum.
#pragma unroll
      for (int e = 0; e < DM; ++e) {
        if (e >= n_d) continue;
        T v = T(0);
        for (int i = lane & (span - 1); i < s.n_b; i += span)
          v += sum_warps(pb + i * s.warps * n_d + e, n_d, s.warps) * m_s[i];
        for (int o = span >> 1; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (live) y[e] = v / denom;
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
    if (t == 0 && valid) {
      T* ys = s.o_ys + ((long long)step * s.n_b + r) * n_d;
#pragma unroll
      for (int e = 0; e < DM; ++e)
        if (e < n_d) ys[e] = y[e];
    }
  }
  // No block exits while its own st.async may still be in flight.
  if (s.mean) cg::this_cluster().sync();

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = t + p * tpr;
    if (j < n_c) {
      int ore, oim;
      bool him;
      lane_offsets(j, s.n_r, s.packed, ore, oim, him);
      s.o_h_re[hrow + ore] = hr[p];
      if (him) s.o_h_im[hrow + oim] = hi[p];
    }
  }
  if (t == 0 && valid) {
#pragma unroll
    for (int e = 0; e < DM; ++e)
      if (e < n_d) s.o_y[r * n_d + e] = y[e];
  }
}

template <typename T, int PER, int DM>
int decode_go(const DecodeArgs<T>& s, int blocks, int smem,
              cudaStream_t stream) {
  auto kernel = decode_fused_kernel<T, PER, DM>;
  const int threads = (s.mean ? s.rows : 1) * s.warps * 32;
  if (threads > decode_max_threads(PER, DM, (int)(sizeof(T) / 4)))
    return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // the most this kernel may use
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (!s.mean) {
    kernel<<<s.n_b, threads, smem, stream>>>(s);
    return (int)cudaGetLastError();
  }
  // The mean route: the whole grid is one cluster of `blocks` blocks.
  if (s.rows < 1 || blocks < 1 || blocks > kMaxCluster ||
      (long long)blocks * s.rows < s.n_b)
    return (int)cudaErrorInvalidValue;
  static bool non_portable = false;
  if (blocks > 8 && !non_portable) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    non_portable = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Refuse a cluster the card cannot hold; checked once a layout.
  static long long fits = -1;
  const long long key =
      ((long long)blocks << 40) | ((long long)threads << 20) | smem;
  if (key != fits) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kNoCluster;
    fits = key;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Lanes a thread, instantiated: the launcher rounds up to the next of these.
#define DECODE_PER_LIST(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(12) X(16)

template <typename T, int DM>
int decode_per(const DecodeArgs<T>& s, int per, int blocks, int smem,
               cudaStream_t stream) {
  switch (per) {
#define DECODE_CASE(P) \
  case P:              \
    return decode_go<T, P, DM>(s, blocks, smem, stream);
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
// the _re ones.  warps, per, rows (a block), blocks (the mean route's
// cluster), copies and smem come from the launcher's rule; the entry
// refuses (cudaErrorInvalidValue) a per that is not instantiated, n_d > 8,
// a block larger than the instantiation allows, or a cluster of more than
// 16 blocks or too few for B rows; and (kNoCluster) a cluster the card
// cannot hold.
struct DecodeCall {
  long long a_re, a_im, a_sb, h_re, h_im, h_sb, y0, wd_re, wd_im, wd_sb,
      wd_ld, wy, wy_sb, b_out, bo_sb, wh_re, wh_im, wh_sb, mask, o_h_re,
      o_h_im, o_y, o_ys, n_b, n_c, n_r, packed, n_d, n_k, warps, per, mean,
      seed_mean, rows, blocks, copies, smem, stream;
};

namespace {

template <typename T>
int decode_call(const DecodeCall* c) {
  if (c->n_d < 1 || c->n_d > 8) return (int)cudaErrorInvalidValue;
  if (c->n_b == 0) return (int)cudaGetLastError();
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
                  (int)c->copies};
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(c->stream);
  const int per = (int)c->per, blocks = (int)c->blocks, smem = (int)c->smem;
  return c->n_d == 1 ? decode_per<T, 1>(s, per, blocks, smem, stream)
                     : decode_per<T, 8>(s, per, blocks, smem, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  if (err == kNoCluster)
    return "no cluster of this decode_fused layout fits the card "
           "(cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString((cudaError_t)err);
}

int decode_fused_f32(const DecodeCall* c) { return decode_call<float>(c); }
int decode_fused_f64(const DecodeCall* c) { return decode_call<double>(c); }

}  // extern "C"
