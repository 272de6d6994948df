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
// Bound on this card: the lane operands, read once a step.  Where they fit
//   the 50 MB L2 (shared weights: 5.3 MB at n = 5000, D = 64, float64) a
//   step reads them from L2; per-slot operands past it stream from device
//   memory every step.  The flops (8 D multiply-adds a lane and row a
//   step) bound it far below either, and the K steps are serially
//   dependent, each ending in one exchange across the grid.
// Design:
//   * One cooperative grid of G blocks, all resident at once: the launcher
//     asks cudaOccupancyMaxActiveBlocksPerMultiprocessor and refuses a grid
//     the card cannot hold (code 10001) instead of launching one that would
//     wait for ever.  Block g owns row group g / S (rows [r0, r0 + R)) and
//     lane segment g % S (lanes [s L, (s + 1) L)) and loops over both, so
//     no NC, B or D is too large for a block: only device memory bounds
//     the route.  With shared weights up to kRows rows of a group share
//     one read of each operand element a step.
//   * The state lanes live in the output buffer (o_h, the input copied in
//     first); each (row, lane) is read and written by its own block only.
//     The carried y of a block's rows lives in the block's slice of a
//     global scratch.  Shared memory holds only the reductions' buffer, so
//     it does not grow with NC, B or D.
//   * A step, for each tile of up to kRows rows of the block: the drive
//     y . wd in chunks of kThreads / qa lanes, each lane's D terms split
//     over qa thread groups and summed in group order through shared
//     memory, then the masked update of each (row, lane); then the readout
//     in chunks of kThreads / qb outputs, each output's lanes split over
//     qb thread groups, with the segment's share of the feedback y . wy
//     (rows [s Ks, (s + 1) Ks) of wy, Ks = ceil(D / S)) and, in segment 0,
//     the bias, summed in group order.  The block's partials go to global
//     scratch: off, a [R][D] slot; mean, one D-vector, its rows' readouts
//     times their 0/1 mask summed in row order.
//   * One exchange a step through global memory (the machinery of
//     decode_fused.cu's mean grid): after a fence, a release add on an
//     arrival counter; an acquire wait until it reads G (step + 1); then
//     each block sums the partials it needs from L2 (__ldcg): off, the S
//     segments of its row group; mean, all G blocks.  The sum is split over
//     thread groups and combined in one fixed order that depends on the
//     shapes only, so every block of a row group (off) or of the grid
//     (mean) feeds back the same y, bit for bit; no floating-point atomic
//     is used.  Two parity slots of partials suffice: a block writes step
//     x + 2's after its wait of step x + 1, which no block passes before
//     every block has arrived at step x + 1, after its reads of step x's.
//     Exchange volume: a block reads S R D (off) or G D (mean) partials a
//     step, so G^2 B D in all; the rule (kernels/diag_scan.py::
//     decode_stream_layout) picks S where that volume meets the block's
//     operand reads, rather than the most blocks: at path 23's shape (8
//     shared rows, 2529 lanes, D = 64, float64) S = G = 39, 160 KB of
//     partials and 134 KB of operands a block a step.  (A second round,
//     each block summing a slice of the outputs, would cut the partials to
//     O(G B D) at the cost of a second wait a step.)
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

// The threads of a block (a power of two; a CPU rehearsal builds it
// smaller).
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
      blocks, groups, rows, segs, lanes, qa, qb, scratch, stream;
};

namespace {

constexpr int kThreads = DECODE_STREAM_THREADS;
// The rows of a tile: with shared weights they share one read of each
// operand element, each holding 2 (drive) or 1 (readout) accumulators a
// thread.
constexpr int kRows = 8;
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
  // segments a group, lanes a segment (the last may hold fewer), and the
  // thread groups of the drive (qa) and of the readout (qb).
  int groups, rows, segs, lanes, qa, qb;
  // Global scratch: the arrival counter, the partials [2][G][slot] and the
  // blocks' carried y [G][rows][D]; the error word in mapped host memory.
  unsigned* counter;
  T* part;
  T* ybuf;
  volatile int* err;
};

// PTX wrappers: the exchange's arrival counter (a release add after the
// block's partials, the acquire loads that wait for every block's) and the
// clock of its bound.
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
// another block: a grid whose blocks cannot all run at once then ends
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

// For each output o < n_out, the sum over t < n_terms of src[t stride + o]
// (read from L2), handed to use(o, sum) by one thread: the terms split
// over qx thread groups (group q takes t = q, q + qx, ..., in order), the
// groups' sums added in group order.  tx and qx follow from n_out alone,
// so every block that sums the same terms gets the same bits.  red holds
// kThreads values; the call begins and ends at a block barrier.
template <typename T, typename Use>
__device__ void sum_terms(const T* src, long long stride, int n_terms,
                          int n_out, T* red, Use use) {
  const int tid = threadIdx.x;
  int tx = 1;
  while (tx < n_out && tx < kThreads) tx <<= 1;
  const int qx = kThreads / tx;
  const int to = tid % tx, tq = tid / tx;
  for (int o0 = 0; o0 < n_out; o0 += tx) {
    const int o = o0 + to;
    T v = T(0);
    if (o < n_out) {
#pragma unroll 4
      for (int t = tq; t < n_terms; t += qx)
        v += __ldcg(src + (long long)t * stride + o);
    }
    red[tid] = v;
    __syncthreads();
    if (tid < tx && o0 + tid < n_out) {
      T sum = red[tid];
      for (int q = 1; q < qx; ++q) sum += red[q * tx + tid];
      use(o0 + tid, sum);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decode_stream_kernel(StreamArgs<T> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The reductions' buffer: [kRows][kThreads] values, twice (the drive's
  // re and im parts).
  T* red = reinterpret_cast<T*>(smem_raw);
  T* red_im = red + kRows * kThreads;
  const int tid = threadIdx.x;
  const int nblk = (int)gridDim.x, g = (int)blockIdx.x;
  const int grp = g / s.segs, sg = g - grp * s.segs;  // row group, segment
  const int n_d = s.n_d;
  const int r0 = grp * s.rows;
  const int nrows = max(0, min(s.rows, s.n_b - r0));
  const int lo = sg * s.lanes;
  const int nl = max(0, min(s.lanes, s.n_c - lo));
  // This segment's rows of wy: [k0, k0 + nk), Ks = kseg a segment.
  const int kseg = (n_d + s.segs - 1) / s.segs;
  const int k0 = sg * kseg;
  const int nk = max(0, min(kseg, n_d - k0));
  const long long slot_len = s.mean ? n_d : (long long)s.rows * n_d;
  T* yb = s.ybuf + (long long)g * s.rows * n_d;  // [rows][D]
  const int ca = kThreads / s.qa;   // lanes a chunk of the drive
  const int teb = kThreads / s.qb;  // outputs a chunk of the readout

  int live_rows = 0;
  for (int i = 0; i < s.n_b; ++i) live_rows += s.mask[i] != 0;
  const T denom = live_rows > 1 ? T(live_rows) : T(1);

  // The block's state lanes, every row (a frozen row's are its output).
  for (long long i = tid; i < (long long)nrows * nl; i += kThreads) {
    const int rl = (int)(i / nl), jl = (int)(i - (long long)rl * nl);
    const long long hrow = (long long)(r0 + rl) * s.h_sb;
    int ore, oim;
    bool him;
    lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
    s.o_h_re[hrow + ore] = s.h_re[hrow + ore];
    if (him) s.o_h_im[hrow + oim] = s.h_im[hrow + oim];
  }
  // The carried y; with the seed every live row's is the live rows' mean
  // of y0 (each block sums it in one order).
  for (int e = tid; e < n_d; e += kThreads) {
    T seed = T(0);
    if (s.seed_mean) {
      for (int i = 0; i < s.n_b; ++i)
        seed += s.y0[(long long)i * n_d + e] *
                (s.mask[i] != 0 ? T(1) : T(0));
      seed = seed / denom;
    }
    for (int rl = 0; rl < nrows; ++rl) {
      const int r = r0 + rl;
      yb[(long long)rl * n_d + e] = s.seed_mean && s.mask[r] != 0
                                        ? seed
                                        : s.y0[(long long)r * n_d + e];
    }
  }
  __syncthreads();

  bool gave_up = false;
  for (int step = 0; step < s.n_k; ++step) {
    const int par = step & 1;
    T* slot = s.part + ((long long)par * nblk + g) * slot_len;
    for (int t0 = 0; t0 < nrows; t0 += kRows) {
      const int nt = min(kRows, nrows - t0);
      const int rt = r0 + t0;                      // the tile's first row
      const T* yt = yb + (long long)t0 * n_d;      // its carried y
      // The drive y . wd and the masked update, ca lanes at a time: thread
      // (q, c) sums the terms e = q, q + qa, ... of lane j0 + c.
      for (int j0 = 0; j0 < nl; j0 += ca) {
        {
          const int q = tid / ca, c = tid - q * ca;
          T dr[kRows], di[kRows];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) dr[rr] = di[rr] = T(0);
          if (j0 + c < nl) {
            int ore, oim;
            bool him;
            lane_offsets(lo + j0 + c, s.n_r, s.packed, ore, oim, him);
            for (int e = q; e < n_d; e += s.qa) {
              const long long off = (long long)e * s.wd_ld;
              if (s.wd_sb == 0) {
                const T wr = s.wd_re[off + ore];
                const T wi = him ? s.wd_im[off + oim] : T(0);
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) {
                  if (rr < nt) {
                    const T ye = yt[(long long)rr * n_d + e];
                    dr[rr] += ye * wr;
                    di[rr] += ye * wi;
                  }
                }
              } else {
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) {
                  if (rr < nt) {
                    const long long w = (long long)(rt + rr) * s.wd_sb + off;
                    const T ye = yt[(long long)rr * n_d + e];
                    dr[rr] += ye * s.wd_re[w + ore];
                    di[rr] += ye * (him ? s.wd_im[w + oim] : T(0));
                  }
                }
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            red[rr * kThreads + tid] = dr[rr];
            red_im[rr * kThreads + tid] = di[rr];
          }
        }
        __syncthreads();
        for (int i = tid; i < nt * ca; i += kThreads) {
          const int rr = i / ca, c = i - rr * ca;
          const int r = rt + rr;
          if (j0 + c >= nl || s.mask[r] == 0) continue;
          T vr = red[rr * kThreads + c], vi = red_im[rr * kThreads + c];
          for (int q = 1; q < s.qa; ++q) {
            vr += red[rr * kThreads + q * ca + c];
            vi += red_im[rr * kThreads + q * ca + c];
          }
          int ore, oim;
          bool him;
          lane_offsets(lo + j0 + c, s.n_r, s.packed, ore, oim, him);
          const long long hrow = (long long)r * s.h_sb;
          const long long arow = (long long)r * s.a_sb;
          const T ar = s.a_re[arow + ore];
          const T ai = him ? s.a_im[arow + oim] : T(0);
          const T hr = s.o_h_re[hrow + ore];
          const T hi = him ? s.o_h_im[hrow + oim] : T(0);
          s.o_h_re[hrow + ore] = ar * hr - ai * hi + vr;
          if (him) s.o_h_im[hrow + oim] = ar * hi + ai * hr + vi;
        }
        __syncthreads();
      }
      // The readout on the new state, teb outputs at a time: thread (q, te)
      // sums lanes q, q + qb, ... and the feedback rows k0 + q, ... of
      // output e0 + te; the bias joins at q = 0 of segment 0.
      for (int e0 = 0; e0 < n_d; e0 += teb) {
        {
          const int q = tid / teb, te = tid - q * teb;
          const int e = e0 + te;
          T acc[kRows];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) acc[rr] = T(0);
          if (e < n_d) {
            for (int jl = q; jl < nl; jl += s.qb) {
              int ore, oim;
              bool him;
              lane_offsets(lo + jl, s.n_r, s.packed, ore, oim, him);
              const long long wre = (long long)ore * n_d + e;
              const long long wim = (long long)oim * n_d + e;
              if (s.wh_sb == 0) {
                const T wr = s.wh_re[wre];
                const T wi = him ? s.wh_im[wim] : T(0);
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) {
                  if (rr < nt) {
                    const long long hrow = (long long)(rt + rr) * s.h_sb;
                    const T hr = s.o_h_re[hrow + ore];
                    const T hi = him ? s.o_h_im[hrow + oim] : T(0);
                    acc[rr] += hr * wr + hi * wi;
                  }
                }
              } else {
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) {
                  if (rr < nt) {
                    const long long hrow = (long long)(rt + rr) * s.h_sb;
                    const long long w = (long long)(rt + rr) * s.wh_sb;
                    const T hr = s.o_h_re[hrow + ore];
                    const T hi = him ? s.o_h_im[hrow + oim] : T(0);
                    acc[rr] += hr * s.wh_re[w + wre] +
                               hi * (him ? s.wh_im[w + wim] : T(0));
                  }
                }
              }
            }
            if (s.wy != nullptr) {
              for (int kl = q; kl < nk; kl += s.qb) {
                const long long k = k0 + kl;
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) {
                  if (rr < nt)
                    acc[rr] += yt[(long long)rr * n_d + k] *
                               s.wy[(long long)(rt + rr) * s.wy_sb +
                                    k * n_d + e];
                }
              }
            }
            if (q == 0 && sg == 0 && s.b_out != nullptr) {
#pragma unroll
              for (int rr = 0; rr < kRows; ++rr)
                if (rr < nt) acc[rr] += s.b_out[(long long)(rt + rr) * s.bo_sb + e];
            }
          }
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) red[rr * kThreads + tid] = acc[rr];
        }
        __syncthreads();
        if (tid < teb && e0 + tid < n_d) {
          const int e = e0 + tid;
          // mean: the block's rows' readouts times their m, in row order
          // (a tile after the first adds to the earlier tiles' sum).
          T msum = s.mean && t0 > 0 ? slot[e] : T(0);
          for (int rr = 0; rr < nt; ++rr) {
            T v = red[rr * kThreads + tid];
            for (int q = 1; q < s.qb; ++q) v += red[rr * kThreads + q * teb + tid];
            if (s.mean)
              msum += v * (s.mask[rt + rr] != 0 ? T(1) : T(0));
            else
              slot[(long long)(t0 + rr) * n_d + e] = v;
          }
          if (s.mean) slot[e] = msum;
        }
        __syncthreads();
      }
    }
    // The exchange: every block's partials of this step, then the sums.
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      red_release_add(s.counter, 1u);
      if (!gave_up)
        gave_up = !grid_wait(s.counter, (unsigned)nblk * (unsigned)(step + 1),
                             s.err);
      __threadfence();
    }
    __syncthreads();
    const T* part = s.part + (long long)par * nblk * slot_len;
    T* ys = s.o_ys + (long long)step * s.n_b * n_d;
    if (s.mean) {
      // Every block: the G blocks' sums, the live rows' new y.
      sum_terms(part, slot_len, nblk, n_d, red, [&](int e, T v) {
        const T y = v / denom;
        for (int rl = 0; rl < nrows; ++rl) {
          const int r = r0 + rl;
          T* yr = yb + (long long)rl * n_d + e;
          if (s.mask[r] != 0) *yr = y;
          if (sg == 0) ys[(long long)r * n_d + e] = *yr;
        }
      });
    } else {
      // The row group's S segments, each live row's new y.
      sum_terms(part + (long long)grp * s.segs * slot_len, slot_len, s.segs,
                nrows * n_d, red, [&](int o, T v) {
                  const int rl = o / n_d;
                  const int r = r0 + rl;
                  if (s.mask[r] != 0) yb[o] = v;
                  if (sg == 0)
                    ys[(long long)r * n_d + (o - rl * n_d)] = yb[o];
                });
    }
  }
  if (sg == 0) {
    for (long long i = tid; i < (long long)nrows * n_d; i += kThreads)
      s.o_y[(long long)r0 * n_d + i] = yb[i];
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

int error_word() {
  if (g_state.err_host != nullptr) return 0;
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&g_state.err_host),
                                  sizeof(int), cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  *g_state.err_host = 0;
  return (int)cudaHostGetDevicePointer(
      reinterpret_cast<void**>(&g_state.err_dev), g_state.err_host, 0);
}

// The shared memory of a block: the reductions' buffer.
template <typename T>
constexpr int stream_smem() {
  return 2 * kRows * kThreads * (int)sizeof(T);
}

// The blocks of decode_stream_kernel<T> the card holds at once (the SMs
// times the blocks an SM holds), or a negative CUDA error code.
template <typename T>
int max_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_stream_kernel<T>, kThreads, stream_smem<T>());
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

template <typename T>
int stream_go(const StreamArgs<T>& s, int blocks, cudaStream_t stream) {
  auto kernel = decode_stream_kernel<T>;
  if (blocks < 1 || s.groups < 1 || s.segs < 1 || s.rows < 1 ||
      s.lanes < 1 || blocks != s.groups * s.segs ||
      (long long)s.groups * s.rows < s.n_b ||
      (long long)(s.groups - 1) * s.rows >= s.n_b ||
      (long long)s.segs * s.lanes < s.n_c || s.qa < 1 ||
      kThreads % s.qa != 0 || s.qb < 1 || kThreads % s.qb != 0 ||
      s.counter == nullptr || s.part == nullptr || s.ybuf == nullptr ||
      s.err == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // The blocks the card holds at once, asked once a device.
  static int held[kMaxDevices] = {};
  if (held[dev] == 0) {
    const int most = max_blocks<T>();
    if (most < 0) return -most;
    held[dev] = most;
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
  err = cudaMemsetAsync(s.counter, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  // Cooperative: the runtime refuses (cudaErrorCooperativeLaunchTooLarge)
  // a grid it cannot hold at once.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = (size_t)stream_smem<T>();
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
  const long long slot = c->mean ? c->n_d : c->rows * c->n_d;
  T* part = mp(c->scratch + 128);
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
                  reinterpret_cast<unsigned*>(c->scratch), part,
                  part + 2 * c->blocks * slot, g_state.err_dev};
  return stream_go<T>(s, (int)c->blocks,
                      reinterpret_cast<cudaStream_t>(c->stream));
}

}  // namespace

// The entry points take one argument: a block of 64-bit integers (pointers
// as integers, 0 for none) in the field order of StreamCall, which
// kernels/diag_scan.py packs.  In the packed layout the _im pointers equal
// the _re ones.  blocks (G = groups x segs), groups, rows (a group), segs
// (a group's lane segments), lanes (a segment), qa and qb (the thread
// groups of the drive and the readout, each dividing the block's threads)
// come from the launcher's rule; scratch is the global scratch (the
// counter, then 128 bytes in the partials [2][G][slot], slot = D for mean
// and rows x D off, then the carried y [G][rows][D]).  The entry refuses
// (cudaErrorInvalidValue) a layout that does not cover the rows and lanes
// or whose thread groups do not divide the block; (kGridTooLarge) a grid
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

// The blocks of the float32 (f64 = 0) or float64 instantiation the card
// holds at once, or a negative CUDA error code.
int decode_stream_max_blocks(int f64) {
  return f64 ? max_blocks<double>() : max_blocks<float>();
}

}  // extern "C"
