// Hand-written Hopper (sm_90a) kernels for the diagonal reservoir.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).  Every entry point launches
// on the stream it is given, never synchronises, allocates nothing (the
// Python wrapper allocates outputs and scratch with torch.empty), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// diag_scan: h_t = a_t * h_{t-1} + x_t on (re, im) lanes.
//
// Replaces: src/repro/kernels/diag_scan.py::diag_scan_pallas_raw (body
//   _kernel) as the forward of the scan.
// Bound on this card: device-memory bytes.  Each lane-step reads x (re, im)
//   and writes h (re, im): 32 bytes in float64 against 8 flops, far below
//   the H100's flop/byte balance.  HBM3 needs ~2 MB in flight to run at its
//   rate, so the design's job is enough independent loads in flight.
// Design: a time-chunked schedule over C chunks of L = ceil(T / C) steps,
//   one thread per (b, lane, chunk), consecutive threads on consecutive
//   lanes so every load and store is coalesced; grid (ceil(N/128), B, C).
//   Two launches on one stream:
//   1. diag_scan_chunk_kernel (reduce), chunks 0 .. C-2: scan the chunk
//      from a zero carry and write its end state e[b, c, n]; where `a`
//      varies in time also the chunk's coefficient product P = prod a_t.
//      For a static `a`, P = a^L is formed in registers by the next kernel.
//      The last chunk's e is never composed, so it is not computed.
//   2. diag_scan_kernel (scan with prefix), every chunk: compose the carry
//      into chunk c from h0 and e[b, 0 .. c-1] (carry = P * carry + e, in
//      chunk order: at most C-1 small L2-resident reads), then rescan the
//      chunk from that carry and write h.
//   x is read 2 - 1/C times, so the bytes are ~1.5x the minimum at the
//   training shape, and C times as many threads run.  C is chosen by the
//   launcher from the shape alone (kernels/diag_scan.py::scan_chunks); with
//   C = 1 only the second kernel runs, without a prefix.  Each thread loads
//   kStep steps into registers before the dependent arithmetic on them
//   (register prefetch rather than cp.async: the data is used once, by the
//   thread that loads it, so staging it in shared memory buys nothing).
//   `a` is read through explicit (b, t) strides, so static (N,) and shared
//   (T, N) coefficients are read with stride 0 instead of being broadcast to
//   (B, T, N) in memory; a static `a` is loaded once.  No padding: the
//   ragged lane and time edges are masked.  Real-only inputs (cplx == 0)
//   skip the imaginary lanes entirely.
//
// ---------------------------------------------------------------------------
// diag_scan_bwd: the gradient of diag_scan, in reverse time.
//
// Replaces: the backward of src/repro/kernels/ops.py::diag_scan (_bwd), which
//   runs diag_scan_pallas_raw again on flipped arrays with right-shifted
//   coefficients and reduces da / dh0 in separate XLA ops.  Here every flip
//   would be a copy, so the kernels walk time backwards instead.
// Computes, with g the incoming gradient and h the saved forward output
//   (PyTorch's convention for complex gradients, which on the (re, im) lanes
//   is exactly the real gradient):
//     s_t = g_t + conj(a_{t+1}) * s_{t+1}      (s_T = 0)
//     dx_t = s_t,  da_t = s_t * conj(h_{t-1}) (h_{-1} = h0, zero if absent),
//     dh0 = conj(a_0) * s_0.
//   The carry the kernels pass from step t to step t-1 is k_t =
//   conj(a_t) s_t, so s_{t-1} = g_{t-1} + k_t and dh0 = k_0.
// Bound on this card: device-memory bytes.  Each lane-step reads g and h
//   (re, im) and writes dx (re, im): 48 bytes in float32 against 16 flops.
// Design: the forward's chunked schedule in reverse time, grid
//   (ceil(N/128), B, C):
//   1. diag_scan_bwd_chunk_kernel (reduce), chunks 1 .. C-1: walk back from
//      the chunk's last step with k = 0, reading g, and write the carry it
//      hands to the chunk before, e[b, c, n] = conj(a_{t0}) s_local_{t0};
//      where `a` varies in time also P = prod conj(a_t) over the chunk,
//      which maps the carry entering the chunk to the carry leaving it
//      (conj(a)^L for a static `a`, formed in registers).  Chunk 0's carry
//      is never composed, so it is not computed.
//   2. diag_scan_bwd_kernel, every chunk: compose the carry entering chunk
//      c from e[b, C-1 .. c+1] (k = P * k + e; the last chunk starts from
//      k = 0 and needs no P), then rescan the chunk, writing dx and da.
//      For `a` varying in time da is written per step as (B, T, N); for a
//      static `a` it is summed over the chunk in registers and written once
//      per (b, chunk, lane) as (B, C, N) partials, which the wrapper sums
//      down to a's own shape.  Chunk 0 writes dh0 = k_0.
//   g is read 2 - 1/C times, h once, dx written once: ~1.33x the minimum.
// ---------------------------------------------------------------------------
// decode_fused: K closed-loop decode steps in one launch.
//
// Replaces: src/repro/kernels/diag_scan.py::decode_fused_pallas_raw (body
//   _decode_kernel).
// Bound on this card: latency.  The data (state, weights) is a few hundred
//   KB and the flops a few million, so bytes and flops both bound it at well
//   under a microsecond; the K steps are serially dependent and each needs a
//   reduction over every lane, so block-wide barriers per step set the time.
// Design: ONE thread block covers the whole slot block, because
//   ensemble == mean reduces across slots at every step.  Threads are laid
//   out as B rows of TPR threads (TPR a power of two); thread (b, t) owns
//   lanes j = t + p*TPR of row b (p < PER <= 8), and keeps their h (re, im)
//   in registers across all K steps.  The fed-back y (B, D) lives in shared
//   memory.  The readout reduction over lanes is a fixed-order tree in shared memory, so
//   results are deterministic run to run.  Weights are read through a batch
//   stride (0 for shared 2D weights, the slot stride for 3D), which replaces
//   the per-slot broadcast and the 8/128 padding of the TPU wrapper.
//   Semantics kept from the TPU kernel: the mask is a 0/1 float with
//   denom = max(sum m, 1); the readout uses the NEW state and the CARRIED y;
//   the mean is over live rows, then frozen rows restore their y.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 128;  // lanes a block of the scan kernels
constexpr int kStep = 4;           // time steps loaded ahead per thread

// h = a * h + x (complex when CPLX, else on the re lanes alone).
template <typename T, bool CPLX>
__device__ __forceinline__ void madd(T ar, T ai, T& hr, T& hi, T xr, T xi) {
  if (CPLX) {
    const T nr = ar * hr - ai * hi + xr;
    hi = ar * hi + ai * hr + xi;
    hr = nr;
  } else {
    hr = ar * hr + xr;
  }
}

// p = p * q.
template <typename T, bool CPLX>
__device__ __forceinline__ void mul(T& pr, T& pi, T qr, T qi) {
  madd<T, CPLX>(qr, qi, pr, pi, T(0), T(0));
}

// (pr, pi) = a^e by squaring (e >= 0).
template <typename T, bool CPLX>
__device__ void cpow(T ar, T ai, int e, T& pr, T& pi) {
  pr = T(1);
  pi = T(0);
  while (e > 0) {
    if (e & 1) mul<T, CPLX>(pr, pi, ar, ai);
    e >>= 1;
    if (e > 0) mul<T, CPLX>(ar, ai, ar, ai);
  }
}

// Arguments shared by the scan kernels: the coefficients through their
// (b, t) strides, the lane count, the chunking and the scratch of the
// per-chunk carries e and products p, (B, C, N) each.
template <typename T>
struct ScanArgs {
  const T* a_re;
  const T* a_im;
  long long a_sb, a_st;
  T* e_re;
  T* e_im;
  T* p_re;
  T* p_im;
  int n_t, n_lanes, chunk_len, n_chunks;
};

// Walks lane (b, n) forward over the steps [t0, t1) from the carry h:
// h = a_t h + x_t, with kStep steps loaded ahead of the arithmetic on them.
// OUT: writes each h_t to o.  PROD: multiplies p by each a_t (only for an
// `a` varying in time).
template <typename T, bool CPLX, bool STAT, bool OUT, bool PROD>
__device__ __forceinline__ void scan_steps(
    const ScanArgs<T>& s, const T* __restrict__ x_re,
    const T* __restrict__ x_im, T* __restrict__ o_re, T* __restrict__ o_im,
    long long a_off, T ar, T ai, int b, int n, int t0, int t1, T& hr, T& hi,
    T& pr, T& pi) {
  long long off = ((long long)b * s.n_t + t0) * s.n_lanes + n;
  for (int t = t0; t < t1; t += kStep, off += kStep * s.n_lanes) {
    T xr[kStep], xi[kStep], tr[kStep], ti[kStep];
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      xr[k] = xi[k] = tr[k] = ti[k] = T(0);
      if (t + k < t1) {
        xr[k] = x_re[off + k * s.n_lanes];
        if (CPLX) xi[k] = x_im[off + k * s.n_lanes];
        if (!STAT) {
          tr[k] = s.a_re[a_off + (t + k) * s.a_st];
          if (CPLX) ti[k] = s.a_im[a_off + (t + k) * s.a_st];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if (t + k < t1) {
        if (STAT) {
          madd<T, CPLX>(ar, ai, hr, hi, xr[k], xi[k]);
        } else {
          madd<T, CPLX>(tr[k], ti[k], hr, hi, xr[k], xi[k]);
        }
        if (PROD) mul<T, CPLX>(pr, pi, tr[k], ti[k]);
        if (OUT) {
          o_re[off + k * s.n_lanes] = hr;
          if (CPLX) o_im[off + k * s.n_lanes] = hi;
        }
      }
    }
  }
}

template <typename T, bool CPLX, bool STAT>
__global__ void __launch_bounds__(kScanThreads)
diag_scan_chunk_kernel(ScanArgs<T> s, const T* __restrict__ x_re,
                       const T* __restrict__ x_im) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, c = blockIdx.z;
  if (n >= s.n_lanes) return;
  const int t0 = c * s.chunk_len;
  const int t1 = min(s.n_t, t0 + s.chunk_len);
  const long long a_off = b * s.a_sb + n;
  T ar = T(0), ai = T(0);
  if (STAT) {
    ar = s.a_re[a_off];
    if (CPLX) ai = s.a_im[a_off];
  }
  T hr = T(0), hi = T(0), pr = T(1), pi = T(0);
  scan_steps<T, CPLX, STAT, false, !STAT>(s, x_re, x_im, nullptr, nullptr,
                                          a_off, ar, ai, b, n, t0, t1, hr,
                                          hi, pr, pi);
  const long long o = ((long long)b * s.n_chunks + c) * s.n_lanes + n;
  s.e_re[o] = hr;
  if (CPLX) s.e_im[o] = hi;
  if (!STAT) {
    s.p_re[o] = pr;
    if (CPLX) s.p_im[o] = pi;
  }
}

template <typename T, bool CPLX, bool STAT>
__global__ void __launch_bounds__(kScanThreads)
diag_scan_kernel(ScanArgs<T> s, const T* __restrict__ x_re,
                 const T* __restrict__ x_im, const T* __restrict__ h0_re,
                 const T* __restrict__ h0_im, long long h0_sb,
                 T* __restrict__ o_re, T* __restrict__ o_im) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, c = blockIdx.z;
  if (n >= s.n_lanes) return;
  const int t0 = c * s.chunk_len;
  const int t1 = min(s.n_t, t0 + s.chunk_len);
  T hr = T(0), hi = T(0);
  if (h0_re != nullptr) {
    hr = h0_re[b * h0_sb + n];
    if (CPLX) hi = h0_im[b * h0_sb + n];
  }
  const long long a_off = b * s.a_sb + n;
  T ar = T(0), ai = T(0);
  if (STAT) {
    ar = s.a_re[a_off];
    if (CPLX) ai = s.a_im[a_off];
  }
  T pr = T(0), pi = T(0);
  if (c > 0) {
    // The carry into chunk c: h = P_k * h + e_k over the chunks k < c,
    // all full, so a static P is a^L.
    if (STAT) cpow<T, CPLX>(ar, ai, s.chunk_len, pr, pi);
    long long o = (long long)b * s.n_chunks * s.n_lanes + n;
#pragma unroll 4
    for (int k = 0; k < c; ++k, o += s.n_lanes) {
      if (!STAT) {
        pr = s.p_re[o];
        if (CPLX) pi = s.p_im[o];
      }
      madd<T, CPLX>(pr, pi, hr, hi, s.e_re[o], CPLX ? s.e_im[o] : T(0));
    }
  }
  scan_steps<T, CPLX, STAT, true, false>(s, x_re, x_im, o_re, o_im, a_off,
                                         ar, ai, b, n, t0, t1, hr, hi, pr,
                                         pi);
}

// k = conj(a) * s: the carry from step t (with a = a_t, s = s_t) to t-1.
template <typename T, bool CPLX>
__device__ __forceinline__ void cmul_conj(T ar, T ai, T sr, T si, T& kr,
                                          T& ki) {
  if (CPLX) {
    kr = ar * sr + ai * si;
    ki = ar * si - ai * sr;
  } else {
    kr = ar * sr;
  }
}

// Walks lane (b, n) back over the steps [t0, t1) from the carry k:
// s_t = g_t + k, k = conj(a_t) s_t, with kStep steps loaded ahead.  OUT:
// writes dx_t = s_t and da_t = s_t conj(h_{t-1}) (h_{-1} = h0) — per step
// for an `a` varying in time, summed into (dar, dai) for a static one.
// PROD: multiplies p by each conj(a_t) (only for an `a` varying in time).
template <typename T, bool CPLX, bool STAT, bool OUT, bool PROD>
__device__ __forceinline__ void scan_steps_bwd(
    const ScanArgs<T>& s, const T* __restrict__ h_re,
    const T* __restrict__ h_im, const T* __restrict__ g_re,
    const T* __restrict__ g_im, T h0r, T h0i, T* __restrict__ dx_re,
    T* __restrict__ dx_im, T* __restrict__ da_re, T* __restrict__ da_im,
    long long a_off, T ar, T ai, int b, int n, int t0, int t1, T& kr, T& ki,
    T& pr, T& pi, T& dar, T& dai) {
  long long off = ((long long)b * s.n_t + (t1 - 1)) * s.n_lanes + n;
  for (int t = t1 - 1; t >= t0; t -= kStep, off -= kStep * s.n_lanes) {
    T gr[kStep], gi[kStep], hr[kStep], hi[kStep], tr[kStep], ti[kStep];
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      gr[k] = gi[k] = tr[k] = ti[k] = T(0);
      hr[k] = h0r;
      hi[k] = h0i;
      if (t - k >= t0) {
        gr[k] = g_re[off - k * s.n_lanes];
        if (CPLX) gi[k] = g_im[off - k * s.n_lanes];
        if (OUT && t - k > 0) {  // h_{t-1}; h0 before the first step
          hr[k] = h_re[off - (k + 1) * s.n_lanes];
          if (CPLX) hi[k] = h_im[off - (k + 1) * s.n_lanes];
        }
        if (!STAT) {
          tr[k] = s.a_re[a_off + (t - k) * s.a_st];
          if (CPLX) ti[k] = s.a_im[a_off + (t - k) * s.a_st];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if (t - k >= t0) {
        const long long ok = off - k * s.n_lanes;
        const T sr = gr[k] + kr, si = gi[k] + ki;
        if (OUT) {
          dx_re[ok] = sr;
          if (CPLX) dx_im[ok] = si;
          const T cr = CPLX ? sr * hr[k] + si * hi[k] : sr * hr[k];
          const T ci = CPLX ? si * hr[k] - sr * hi[k] : T(0);
          if (STAT) {
            dar += cr;
            dai += ci;
          } else {
            da_re[ok] = cr;
            if (CPLX) da_im[ok] = ci;
          }
        }
        if (STAT) {
          cmul_conj<T, CPLX>(ar, ai, sr, si, kr, ki);
        } else {
          cmul_conj<T, CPLX>(tr[k], ti[k], sr, si, kr, ki);
        }
        if (PROD) mul<T, CPLX>(pr, pi, tr[k], CPLX ? -ti[k] : T(0));
      }
    }
  }
}

template <typename T, bool CPLX, bool STAT>
__global__ void __launch_bounds__(kScanThreads)
diag_scan_bwd_chunk_kernel(ScanArgs<T> s, const T* __restrict__ g_re,
                           const T* __restrict__ g_im) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, c = blockIdx.z + 1;  // chunks 1 .. C-1
  if (n >= s.n_lanes) return;
  const int t0 = c * s.chunk_len;
  const int t1 = min(s.n_t, t0 + s.chunk_len);
  const long long a_off = b * s.a_sb + n;
  T ar = T(0), ai = T(0);
  if (STAT) {
    ar = s.a_re[a_off];
    if (CPLX) ai = s.a_im[a_off];
  }
  T kr = T(0), ki = T(0), pr = T(1), pi = T(0), dar = T(0), dai = T(0);
  scan_steps_bwd<T, CPLX, STAT, false, !STAT>(
      s, nullptr, nullptr, g_re, g_im, T(0), T(0), nullptr, nullptr, nullptr,
      nullptr, a_off, ar, ai, b, n, t0, t1, kr, ki, pr, pi, dar, dai);
  const long long o = ((long long)b * s.n_chunks + c) * s.n_lanes + n;
  s.e_re[o] = kr;
  if (CPLX) s.e_im[o] = ki;
  if (!STAT) {
    s.p_re[o] = pr;
    if (CPLX) s.p_im[o] = pi;
  }
}

template <typename T, bool CPLX, bool STAT>
__global__ void __launch_bounds__(kScanThreads)
diag_scan_bwd_kernel(ScanArgs<T> s, const T* __restrict__ h_re,
                     const T* __restrict__ h_im, const T* __restrict__ g_re,
                     const T* __restrict__ g_im,
                     const T* __restrict__ h0_re,
                     const T* __restrict__ h0_im, long long h0_sb,
                     T* __restrict__ dx_re, T* __restrict__ dx_im,
                     T* __restrict__ da_re, T* __restrict__ da_im,
                     T* __restrict__ dh0_re, T* __restrict__ dh0_im) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y, c = blockIdx.z;
  if (n >= s.n_lanes) return;
  const int t0 = c * s.chunk_len;
  const int t1 = min(s.n_t, t0 + s.chunk_len);
  T h0r = T(0), h0i = T(0);
  if (h0_re != nullptr) {
    h0r = h0_re[b * h0_sb + n];
    if (CPLX) h0i = h0_im[b * h0_sb + n];
  }
  const long long a_off = b * s.a_sb + n;
  T ar = T(0), ai = T(0);
  if (STAT) {
    ar = s.a_re[a_off];
    if (CPLX) ai = s.a_im[a_off];
  }
  T kr = T(0), ki = T(0), pr = T(0), pi = T(0);
  if (c < s.n_chunks - 1) {
    // The carry into chunk c: k = P_j * k + e_j over the chunks j > c, from
    // the last (which starts at k = 0, so needs no P); the others are full,
    // so a static P is conj(a)^L.
    if (STAT) {
      cpow<T, CPLX>(ar, ai, s.chunk_len, pr, pi);
      pi = -pi;
    }
    long long o = ((long long)b * s.n_chunks + (s.n_chunks - 1)) * s.n_lanes
                  + n;
    kr = s.e_re[o];
    if (CPLX) ki = s.e_im[o];
#pragma unroll 4
    for (int j = s.n_chunks - 2; j > c; --j) {
      o -= s.n_lanes;
      if (!STAT) {
        pr = s.p_re[o];
        if (CPLX) pi = s.p_im[o];
      }
      madd<T, CPLX>(pr, pi, kr, ki, s.e_re[o], CPLX ? s.e_im[o] : T(0));
    }
  }
  T dar = T(0), dai = T(0);
  scan_steps_bwd<T, CPLX, STAT, true, false>(
      s, h_re, h_im, g_re, g_im, h0r, h0i, dx_re, dx_im, da_re, da_im, a_off,
      ar, ai, b, n, t0, t1, kr, ki, pr, pi, dar, dai);
  if (STAT) {
    const long long o = ((long long)b * s.n_chunks + c) * s.n_lanes + n;
    da_re[o] = dar;
    if (CPLX) da_im[o] = dai;
  }
  if (c == 0) {
    const long long bn = (long long)b * s.n_lanes + n;
    dh0_re[bn] = kr;
    if (CPLX) dh0_im[bn] = ki;
  }
}

// Runs GO(CPLX, STAT) for the instantiation the flags select.
#define SCAN_DISPATCH(GO)                    \
  if (cplx) {                                \
    if (stat) GO(true, true) else GO(true, false)   \
  } else {                                   \
    if (stat) GO(false, true) else GO(false, false) \
  }

template <typename T>
int diag_scan_launch(const ScanArgs<T>& s, const T* x_re, const T* x_im,
                     const T* h0_re, const T* h0_im, long long h0_sb,
                     T* o_re, T* o_im, int n_b, int cplx,
                     cudaStream_t stream) {
  if (n_b == 0 || s.n_t == 0 || s.n_lanes == 0) return (int)cudaGetLastError();
  const bool stat = s.a_st == 0;
  const unsigned tiles = (s.n_lanes + kScanThreads - 1) / kScanThreads;
  cudaError_t err = cudaSuccess;
#define SCAN_GO(C, S)                                                    \
  {                                                                      \
    if (s.n_chunks > 1) {                                                \
      diag_scan_chunk_kernel<T, C, S>                                    \
          <<<dim3(tiles, n_b, s.n_chunks - 1), kScanThreads, 0, stream>>>( \
              s, x_re, x_im);                                            \
      err = cudaGetLastError();                                          \
    }                                                                    \
    if (err == cudaSuccess)                                              \
      diag_scan_kernel<T, C, S>                                          \
          <<<dim3(tiles, n_b, s.n_chunks), kScanThreads, 0, stream>>>(   \
              s, x_re, x_im, h0_re, h0_im, h0_sb, o_re, o_im);           \
  }
  SCAN_DISPATCH(SCAN_GO)
#undef SCAN_GO
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int diag_scan_bwd_launch(const ScanArgs<T>& s, const T* h_re, const T* h_im,
                         const T* g_re, const T* g_im, const T* h0_re,
                         const T* h0_im, long long h0_sb, T* dx_re, T* dx_im,
                         T* da_re, T* da_im, T* dh0_re, T* dh0_im, int n_b,
                         int cplx, cudaStream_t stream) {
  if (n_b == 0 || s.n_t == 0 || s.n_lanes == 0) return (int)cudaGetLastError();
  const bool stat = s.a_st == 0;
  const unsigned tiles = (s.n_lanes + kScanThreads - 1) / kScanThreads;
  cudaError_t err = cudaSuccess;
#define SCAN_GO(C, S)                                                    \
  {                                                                      \
    if (s.n_chunks > 1) {                                                \
      diag_scan_bwd_chunk_kernel<T, C, S>                                \
          <<<dim3(tiles, n_b, s.n_chunks - 1), kScanThreads, 0, stream>>>( \
              s, g_re, g_im);                                            \
      err = cudaGetLastError();                                          \
    }                                                                    \
    if (err == cudaSuccess)                                              \
      diag_scan_bwd_kernel<T, C, S>                                      \
          <<<dim3(tiles, n_b, s.n_chunks), kScanThreads, 0, stream>>>(   \
              s, h_re, h_im, g_re, g_im, h0_re, h0_im, h0_sb, dx_re,     \
              dx_im, da_re, da_im, dh0_re, dh0_im);                      \
  }
  SCAN_DISPATCH(SCAN_GO)
#undef SCAN_GO
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

#undef SCAN_DISPATCH

// Each thread keeps PER <= 8 lanes in registers.  With 1024 threads a block
// may use at most 64 registers a thread; 8 lanes of (re, im) float64 take 32.
// The coefficients and weights are re-read each step through the L1 cache.
constexpr int kMaxThreads = 1024;

template <typename T, int PER>
__global__ void __launch_bounds__(kMaxThreads)
decode_fused_kernel(const T* __restrict__ a_re, const T* __restrict__ a_im,
                    long long a_sb, const T* __restrict__ h_re,
                    const T* __restrict__ h_im, const T* __restrict__ y0,
                    const T* __restrict__ wd_re, const T* __restrict__ wd_im,
                    long long wd_sb, const T* __restrict__ wy, long long wy_sb,
                    const T* __restrict__ b_out, long long bo_sb,
                    const T* __restrict__ wh_re, const T* __restrict__ wh_im,
                    long long wh_sb, const T* __restrict__ mask,
                    T* __restrict__ o_h_re, T* __restrict__ o_h_im,
                    T* __restrict__ o_y, T* __restrict__ o_ys, int n_b,
                    int n_c, int n_d, int n_k, int tpr, int mean) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y_s = reinterpret_cast<T*>(smem_raw);   // (B, D) carried output
  T* yn_s = y_s + n_b * n_d;                 // (B, D) this step's readout
  T* m_s = yn_s + n_b * n_d;                 // (B,)   0/1 mask
  T* red = m_s + n_b;                        // (B * TPR) reduction tree

  const int tid = threadIdx.x;
  const int b = tid / tpr;
  const int t = tid % tpr;
  const int nbd = n_b * n_d;

  for (int i = tid; i < nbd; i += blockDim.x) y_s[i] = y0[i];
  for (int i = tid; i < n_b; i += blockDim.x) m_s[i] = mask[i];
  __syncthreads();
  T msum = T(0);
  for (int i = 0; i < n_b; ++i) msum += m_s[i];
  const T denom = msum > T(1) ? msum : T(1);
  const bool live = m_s[b] > T(0.5);

  T hr[PER], hi[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = t + p * tpr;
    const bool ok = j < n_c;
    hr[p] = ok ? h_re[b * n_c + j] : T(0);
    hi[p] = ok ? h_im[b * n_c + j] : T(0);
  }
  const T* arb = a_re + b * a_sb;
  const T* aib = a_im + b * a_sb;
  const T* wdr = wd_re + b * wd_sb;
  const T* wdi = wd_im + b * wd_sb;
  const T* whr = wh_re + b * wh_sb;
  const T* whi = wh_im + b * wh_sb;
  const T* wyb = wy + b * wy_sb;
  const T* bob = b_out + b * bo_sb;
  const T* yb = y_s + b * n_d;

  for (int step = 0; step < n_k; ++step) {
    // Drive from the carried y, then the masked complex update.
    if (live) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int j = t + p * tpr;
        if (j < n_c) {
          T dr = T(0), di = T(0);
          for (int k = 0; k < n_d; ++k) {
            dr += yb[k] * wdr[k * n_c + j];
            di += yb[k] * wdi[k * n_c + j];
          }
          const T ar = arb[j], ai = aib[j];
          const T nr = ar * hr[p] - ai * hi[p] + dr;
          hi[p] = ar * hi[p] + ai * hr[p] + di;
          hr[p] = nr;
        }
      }
    }
    // Readout on the new state: fixed-order tree over the row's TPR threads.
    for (int e = 0; e < n_d; ++e) {
      T part = T(0);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int j = t + p * tpr;
        if (j < n_c) part += hr[p] * whr[j * n_d + e] + hi[p] * whi[j * n_d + e];
      }
      red[tid] = part;
      __syncthreads();
      for (int s = tpr >> 1; s > 0; s >>= 1) {
        if (t < s) red[tid] += red[tid + s];
        __syncthreads();
      }
      if (t == 0) {
        T acc = bob[e];
        for (int k = 0; k < n_d; ++k) acc += yb[k] * wyb[k * n_d + e];
        yn_s[b * n_d + e] = acc + red[tid];
      }
      __syncthreads();
    }
    // Optional mean over live rows; frozen rows keep their y.
    for (int i = tid; i < nbd; i += blockDim.x) {
      const int bi = i / n_d;
      const int e = i - bi * n_d;
      T v = yn_s[i];
      if (mean) {
        T s = T(0);
        for (int r = 0; r < n_b; ++r) s += yn_s[r * n_d + e] * m_s[r];
        v = s / denom;
      }
      const T y_next = m_s[bi] > T(0.5) ? v : y_s[i];
      y_s[i] = y_next;
      o_ys[(long long)step * nbd + i] = y_next;
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = t + p * tpr;
    if (j < n_c) {
      o_h_re[b * n_c + j] = hr[p];
      o_h_im[b * n_c + j] = hi[p];
    }
  }
  for (int i = tid; i < nbd; i += blockDim.x) o_y[i] = y_s[i];
}

template <typename T, int PER>
void decode_fused_go(dim3 block, size_t smem, cudaStream_t stream,
                     const T* a_re, const T* a_im, long long a_sb,
                     const T* h_re, const T* h_im, const T* y0,
                     const T* wd_re, const T* wd_im, long long wd_sb,
                     const T* wy, long long wy_sb, const T* b_out,
                     long long bo_sb, const T* wh_re, const T* wh_im,
                     long long wh_sb, const T* mask, T* o_h_re, T* o_h_im,
                     T* o_y, T* o_ys, int n_b, int n_c, int n_d, int n_k,
                     int tpr, int mean) {
  decode_fused_kernel<T, PER><<<1, block, smem, stream>>>(
      a_re, a_im, a_sb, h_re, h_im, y0, wd_re, wd_im, wd_sb, wy, wy_sb, b_out,
      bo_sb, wh_re, wh_im, wh_sb, mask, o_h_re, o_h_im, o_y, o_ys, n_b, n_c,
      n_d, n_k, tpr, mean);
}

template <typename T>
int decode_fused_launch(const T* a_re, const T* a_im, long long a_sb,
                        const T* h_re, const T* h_im, const T* y0,
                        const T* wd_re, const T* wd_im, long long wd_sb,
                        const T* wy, long long wy_sb, const T* b_out,
                        long long bo_sb, const T* wh_re, const T* wh_im,
                        long long wh_sb, const T* mask, T* o_h_re, T* o_h_im,
                        T* o_y, T* o_ys, int n_b, int n_c, int n_d, int n_k,
                        int tpr, int per, int mean, cudaStream_t stream) {
  dim3 block(n_b * tpr);
  size_t smem = sizeof(T) * (size_t)(2 * n_b * n_d + n_b + n_b * tpr);
#define DECODE_GO(P)                                                        \
  decode_fused_go<T, P>(block, smem, stream, a_re, a_im, a_sb, h_re, h_im, \
                        y0, wd_re, wd_im, wd_sb, wy, wy_sb, b_out, bo_sb,  \
                        wh_re, wh_im, wh_sb, mask, o_h_re, o_h_im, o_y,    \
                        o_ys, n_b, n_c, n_d, n_k, tpr, mean)
  switch (per) {
    case 1: DECODE_GO(1); break;
    case 2: DECODE_GO(2); break;
    case 3: DECODE_GO(3); break;
    case 4: DECODE_GO(4); break;
    case 5: DECODE_GO(5); break;
    case 6: DECODE_GO(6); break;
    case 7: DECODE_GO(7); break;
    case 8: DECODE_GO(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_GO
  return (int)cudaGetLastError();
}

}  // namespace

// The scan entry points take one argument: a block of 64-bit integers
// (pointers as integers, 0 for none) in the field order of ScanCall /
// ScanBwdCall, which kernels/diag_scan.py packs.  One pointer crosses the
// ctypes boundary instead of 22 or 28 converted arguments.  The scratch
// e_* / p_* holds the per-chunk carries and products, (B, C, N) each, or is
// 0 when n_chunks == 1 (p_* also for a static `a`, a_st == 0);
// n_chunks = ceil(n_t / chunk_len).
struct ScanCall {
  long long a_re, a_im, a_sb, a_st, x_re, x_im, h0_re, h0_im, h0_sb, o_re,
      o_im, e_re, e_im, p_re, p_im, n_b, n_t, n_lanes, n_chunks, chunk_len,
      cplx, stream;
};
struct ScanBwdCall {
  long long a_re, a_im, a_sb, a_st, h_re, h_im, g_re, g_im, h0_re, h0_im,
      h0_sb, dx_re, dx_im, da_re, da_im, dh0_re, dh0_im, e_re, e_im, p_re,
      p_im, n_b, n_t, n_lanes, n_chunks, chunk_len, cplx, stream;
};

namespace {

template <typename T>
const T* cptr(long long v) {
  return reinterpret_cast<const T*>(v);
}
template <typename T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(v);
}

template <typename T, typename Call>
ScanArgs<T> scan_args(const Call& c) {
  return ScanArgs<T>{cptr<T>(c.a_re), cptr<T>(c.a_im),   c.a_sb,
                     c.a_st,          ptr<T>(c.e_re),    ptr<T>(c.e_im),
                     ptr<T>(c.p_re),  ptr<T>(c.p_im),    (int)c.n_t,
                     (int)c.n_lanes,  (int)c.chunk_len,  (int)c.n_chunks};
}

template <typename T>
int diag_scan_call(const ScanCall* c) {
  return diag_scan_launch<T>(scan_args<T>(*c), cptr<T>(c->x_re),
                             cptr<T>(c->x_im), cptr<T>(c->h0_re),
                             cptr<T>(c->h0_im), c->h0_sb, ptr<T>(c->o_re),
                             ptr<T>(c->o_im), (int)c->n_b, (int)c->cplx,
                             reinterpret_cast<cudaStream_t>(c->stream));
}

template <typename T>
int diag_scan_bwd_call(const ScanBwdCall* c) {
  return diag_scan_bwd_launch<T>(
      scan_args<T>(*c), cptr<T>(c->h_re), cptr<T>(c->h_im), cptr<T>(c->g_re),
      cptr<T>(c->g_im), cptr<T>(c->h0_re), cptr<T>(c->h0_im), c->h0_sb,
      ptr<T>(c->dx_re), ptr<T>(c->dx_im), ptr<T>(c->da_re),
      ptr<T>(c->da_im), ptr<T>(c->dh0_re), ptr<T>(c->dh0_im), (int)c->n_b,
      (int)c->cplx, reinterpret_cast<cudaStream_t>(c->stream));
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int diag_scan_f32(const ScanCall* c) { return diag_scan_call<float>(c); }
int diag_scan_f64(const ScanCall* c) { return diag_scan_call<double>(c); }
int diag_scan_bwd_f32(const ScanBwdCall* c) {
  return diag_scan_bwd_call<float>(c);
}
int diag_scan_bwd_f64(const ScanBwdCall* c) {
  return diag_scan_bwd_call<double>(c);
}

int decode_fused_f32(const float* a_re, const float* a_im, long long a_sb,
                     const float* h_re, const float* h_im, const float* y0,
                     const float* wd_re, const float* wd_im, long long wd_sb,
                     const float* wy, long long wy_sb, const float* b_out,
                     long long bo_sb, const float* wh_re, const float* wh_im,
                     long long wh_sb, const float* mask, float* o_h_re,
                     float* o_h_im, float* o_y, float* o_ys, int n_b, int n_c,
                     int n_d, int n_k, int tpr, int per, int mean,
                     void* stream) {
  return decode_fused_launch<float>(
      a_re, a_im, a_sb, h_re, h_im, y0, wd_re, wd_im, wd_sb, wy, wy_sb, b_out,
      bo_sb, wh_re, wh_im, wh_sb, mask, o_h_re, o_h_im, o_y, o_ys, n_b, n_c,
      n_d, n_k, tpr, per, mean, (cudaStream_t)stream);
}

int decode_fused_f64(const double* a_re, const double* a_im, long long a_sb,
                     const double* h_re, const double* h_im, const double* y0,
                     const double* wd_re, const double* wd_im,
                     long long wd_sb, const double* wy, long long wy_sb,
                     const double* b_out, long long bo_sb,
                     const double* wh_re, const double* wh_im,
                     long long wh_sb, const double* mask, double* o_h_re,
                     double* o_h_im, double* o_y, double* o_ys, int n_b,
                     int n_c, int n_d, int n_k, int tpr, int per, int mean,
                     void* stream) {
  return decode_fused_launch<double>(
      a_re, a_im, a_sb, h_re, h_im, y0, wd_re, wd_im, wd_sb, wy, wy_sb, b_out,
      bo_sb, wh_re, wh_im, wh_sb, mask, o_h_re, o_h_im, o_y, o_ys, n_b, n_c,
      n_d, n_k, tpr, per, mean, (cudaStream_t)stream);
}

}  // extern "C"
