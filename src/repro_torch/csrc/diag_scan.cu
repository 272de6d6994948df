// Hand-written Hopper (sm_90a) kernels for the diagonal reservoir.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).  Every entry point launches
// on the stream it is given, never synchronises, allocates nothing (the
// Python wrapper allocates outputs with torch.empty), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// diag_scan: h_t = a_t * h_{t-1} + x_t on (re, im) lanes.
//
// Replaces: src/repro/kernels/diag_scan.py::diag_scan_pallas_raw (body
//   _kernel), forward only.
// Bound on this card: device-memory bytes.  Each lane-step reads x (re, im)
//   and writes h (re, im): 32 bytes in float64 against 8 flops, far below
//   the H100's flop/byte balance.
// Design: one thread per (b, lane), consecutive threads on consecutive
//   lanes so every x load and h store is coalesced; grid (ceil(N/128), B).
//   The time loop runs inside the thread with the carry in registers — the
//   counterpart of the TPU's sequential time-grid axis and VMEM carry
//   scratch.  `a` is read through explicit (b, t) strides, so static (N,)
//   and shared (T, N) coefficients are read with stride 0 instead of being
//   broadcast to (B, T, N) in memory; a static `a` is loaded once.  No
//   padding: the ragged lane edge is masked.  Real-only inputs (cplx == 0)
//   skip the imaginary lanes entirely.
// Known weak spot: a single long sequence (B = 1, N ~ 525 lanes) launches
//   only ceil(N/128) blocks on 132 SMs; a time-parallel chunked schedule is
//   later work.
//
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

template <typename T, bool CPLX>
__global__ void diag_scan_kernel(const T* __restrict__ a_re,
                                 const T* __restrict__ a_im,
                                 long long a_sb, long long a_st,
                                 const T* __restrict__ x_re,
                                 const T* __restrict__ x_im,
                                 const T* __restrict__ h0_re,
                                 const T* __restrict__ h0_im,
                                 long long h0_sb,
                                 T* __restrict__ o_re, T* __restrict__ o_im,
                                 int n_t, int n_lanes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= n_lanes) return;
  T hr = T(0), hi = T(0);
  if (h0_re != nullptr) {
    hr = h0_re[b * h0_sb + n];
    if (CPLX) hi = h0_im[b * h0_sb + n];
  }
  const long long a_off = b * a_sb + n;
  long long off = (long long)b * n_t * n_lanes + n;
  if (a_st == 0) {
    const T ar = a_re[a_off];
    const T ai = CPLX ? a_im[a_off] : T(0);
#pragma unroll 4
    for (int t = 0; t < n_t; ++t, off += n_lanes) {
      if (CPLX) {
        const T nr = ar * hr - ai * hi + x_re[off];
        hi = ar * hi + ai * hr + x_im[off];
        hr = nr;
        o_im[off] = hi;
      } else {
        hr = ar * hr + x_re[off];
      }
      o_re[off] = hr;
    }
  } else {
#pragma unroll 4
    for (int t = 0; t < n_t; ++t, off += n_lanes) {
      const T ar = a_re[a_off + t * a_st];
      if (CPLX) {
        const T ai = a_im[a_off + t * a_st];
        const T nr = ar * hr - ai * hi + x_re[off];
        hi = ar * hi + ai * hr + x_im[off];
        hr = nr;
        o_im[off] = hi;
      } else {
        hr = ar * hr + x_re[off];
      }
      o_re[off] = hr;
    }
  }
}

template <typename T>
int diag_scan_launch(const T* a_re, const T* a_im, long long a_sb,
                     long long a_st, const T* x_re, const T* x_im,
                     const T* h0_re, const T* h0_im, long long h0_sb, T* o_re,
                     T* o_im, int n_b, int n_t, int n_lanes, int cplx,
                     cudaStream_t stream) {
  if (n_b == 0 || n_t == 0 || n_lanes == 0) return (int)cudaGetLastError();
  const int threads = 128;
  dim3 grid((n_lanes + threads - 1) / threads, n_b);
  if (cplx) {
    diag_scan_kernel<T, true><<<grid, threads, 0, stream>>>(
        a_re, a_im, a_sb, a_st, x_re, x_im, h0_re, h0_im, h0_sb, o_re, o_im,
        n_t, n_lanes);
  } else {
    diag_scan_kernel<T, false><<<grid, threads, 0, stream>>>(
        a_re, a_im, a_sb, a_st, x_re, x_im, h0_re, h0_im, h0_sb, o_re, o_im,
        n_t, n_lanes);
  }
  return (int)cudaGetLastError();
}

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

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int diag_scan_f32(const float* a_re, const float* a_im, long long a_sb,
                  long long a_st, const float* x_re, const float* x_im,
                  const float* h0_re, const float* h0_im, long long h0_sb,
                  float* o_re, float* o_im, int n_b, int n_t, int n_lanes,
                  int cplx, void* stream) {
  return diag_scan_launch<float>(a_re, a_im, a_sb, a_st, x_re, x_im, h0_re,
                                 h0_im, h0_sb, o_re, o_im, n_b, n_t, n_lanes,
                                 cplx, (cudaStream_t)stream);
}

int diag_scan_f64(const double* a_re, const double* a_im, long long a_sb,
                  long long a_st, const double* x_re, const double* x_im,
                  const double* h0_re, const double* h0_im, long long h0_sb,
                  double* o_re, double* o_im, int n_b, int n_t, int n_lanes,
                  int cplx, void* stream) {
  return diag_scan_launch<double>(a_re, a_im, a_sb, a_st, x_re, x_im, h0_re,
                                  h0_im, h0_sb, o_re, o_im, n_b, n_t, n_lanes,
                                  cplx, (cudaStream_t)stream);
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
