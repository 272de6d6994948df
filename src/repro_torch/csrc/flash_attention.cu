// Hand-written Hopper (sm_90a) kernel: blocked online-softmax attention.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (src/repro_torch/kernels/build.py).  The entry point launches
// on the stream it is given, never synchronises, allocates nothing (the
// Python wrapper allocates the outputs with torch.empty), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// flash_attention_fwd: o = softmax(mask(q k^T * scale)) v, and its lse.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (body _kernel).  Same function: GQA (query head h reads KV head
//   h / (Hq / Hkv)), causal, sliding-window, q_offset and kv_len masks,
//   masked scores set to -1e30 and p re-masked to 0 after the exp, f32
//   accumulators and softmax, zeros for a row with no visible key (l == 0),
//   and for bfloat16 inputs p rounded to bfloat16 before the p.v product
//   (p.astype(v.dtype)).  It also writes lse = m + log(l) per query row
//   (float32; -1e30 for a fully masked row), which the model's backward
//   (models/attention.py) reads; the TPU kernel held it in scratch only.
// Bound on this card: operations.  At the training shapes of smollm-135m
//   (q (8, 9, 1024, 64) against k/v (8, 3, 1024 or 2048, 64), causal) a
//   launch does 10-29 GFLOP (4 * head_dim per visible query-key pair) on
//   ~60 MB of q/k/v/o: 0.15-0.43 ms at the 67 TFLOP/s float32 rate outside
//   the tensor cores, against 0.02 ms for the bytes.
// Design (simple, SIMT, float32 FMAs; no wgmma or TMA yet):
//   * one block per (b * Hq + h, 64-row query tile).  The TPU grid's
//     sequential kv axis with (m, l, acc) in VMEM scratch becomes a loop over
//     key tiles inside the block; each query row's m, l, q and accumulator
//     live in registers;
//   * a row is served by TPR = DP / 32 neighbouring threads (DP the head
//     dimension rounded up to 32, 64 or 128), each holding 32 of its
//     dimensions as 8 float4 chunks interleaved with its partners', so the
//     TPR threads of a row read TPR adjacent 16-byte chunks of shared
//     memory (no bank conflict) and the rest of the warp reads the same
//     ones (broadcast); a score's partial dots are summed with __shfl_xor;
//   * key and value tiles of BK keys (64, or 32 for DP = 128) are staged
//     through shared memory as float32 (bfloat16 is widened on load):
//     2 * 64 * 64 * 4 = 32 KB at head_dim 64;
//   * the online softmax runs 16 keys at a time, so the accumulator is
//     rescaled once per 16 keys;
//   * key tiles that the causal, window or kv_len masks leave wholly empty
//     for every row of the block are never visited (the Pallas kernel visits
//     and masks them; skipping is exact: a fully masked tile leaves m, l and
//     acc unchanged).  Causal attention thus does about half the tiles;
//   * heavy query tiles (late rows of a causal launch) are scheduled first;
//   * q, k and v are read through their (batch, head, sequence) strides, so
//     sequence slices and permuted layouts need no copy; the head dimension
//     must have unit stride.  The ragged edges (Sq and Skv not multiples of
//     the tiles) are masked in the kernel: no padding.
// ---------------------------------------------------------------------------
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int KC = 16;  // keys per online-softmax step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// p as the p.v product sees it: p.astype(v.dtype) in the TPU kernel.
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

template <typename T, int DP>
__global__ void __launch_bounds__(BQ * (DP / 32))
    flash_attention_fwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
        int hq, int hkv, int sq, int skv, int d, long long q_sb,
        long long q_sh, long long q_ss, long long k_sb, long long k_sh,
        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
        int causal, int has_window, int window, int q_offset, int kv_len,
        float scale) {
  constexpr int TPR = DP / 32;            // threads per query row
  constexpr int NT = BQ * TPR;            // threads per block
  constexpr int BK = DP <= 64 ? 64 : 32;  // keys per shared-memory tile
  constexpr int C4 = 8;                   // float4 chunks a thread owns
  constexpr int ROW4 = DP / 4;            // float4 chunks per staged row
  __shared__ float4 ks[BK * ROW4];
  __shared__ float4 vs[BK * ROW4];

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  // Late query tiles see the most keys under a causal mask: start them first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid - row * TPR;
  const int qi = q0 + row;
  const bool live = qi < sq;
  const int qpos = q_offset + qi;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  float qr[4 * C4], acc[4 * C4];
  {
    const T* qp = q + b * q_sb + h * q_sh + (long long)(live ? qi : 0) * q_ss;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dim = 4 * (c * TPR + part) + e;
        qr[4 * c + e] = (live && dim < d) ? to_f32(qp[dim]) : 0.f;
        acc[4 * c + e] = 0.f;
      }
    }
  }
  float m = NEG_INF, l = 0.f;

  // The keys any row of this block can see: [k_begin, k_end).
  const int kv_lim = kv_len < skv ? kv_len : skv;
  const int q_hi = q0 + BQ < sq ? q0 + BQ : sq;
  int k_end = kv_lim;
  if (causal && q_offset + q_hi < k_end) k_end = q_offset + q_hi;
  int k_begin = 0;
  if (has_window && q_offset + q0 - window + 1 > 0)
    k_begin = (q_offset + q0 - window + 1) / BK * BK;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      const int key = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < kv_lim && c < d) {
        kv = to_f32(kb[key * k_ss + c]);
        vv = to_f32(vb[key * v_ss + c]);
      }
      kf[i] = kv;
      vf[i] = vv;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += KC) {
      float s[KC];
      float m_cur = NEG_INF;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float4* kr = ks + (j0 + j) * ROW4;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 kk = kr[c * TPR + part];
          dot = fmaf(qr[4 * c + 0], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kpos = t0 + j0 + j;
        const bool ok = kpos < kv_lim && (!causal || kpos <= qpos) &&
                        (!has_window || kpos > qpos - window);
        s[j] = ok ? dot * scale : NEG_INF;
        m_cur = fmaxf(m_cur, s[j]);
      }
      const float m_new = fmaxf(m, m_cur);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < 4 * C4; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kpos = t0 + j0 + j;
        const bool ok = kpos < kv_lim && (!causal || kpos <= qpos) &&
                        (!has_window || kpos > qpos - window);
        // Explicit re-mask: a fully masked row would get exp(0) = 1.
        const float p = ok ? expf(s[j] - m_new) : 0.f;
        l += p;
        const float pv = round_p<T>(p);
        const float4* vr = vs + (j0 + j) * ROW4;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 vv = vr[c * TPR + part];
          acc[4 * c + 0] = fmaf(pv, vv.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(pv, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(pv, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(pv, vv.w, acc[4 * c + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  // Rows with no visible key have l == 0 (and acc == 0): zeros, not NaNs.
  const float safe = l == 0.f ? 1.f : l;
  T* op = o + ((long long)bh * sq + qi) * d;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (c * TPR + part) + e;
      if (dim < d) op[dim] = from_f32<T>(acc[4 * c + e] / safe);
    }
  }
  if (part == 0) lse[(long long)bh * sq + qi] = m + logf(safe);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int skv, int d, long long q_sb,
           long long q_sh, long long q_ss, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           int causal, int has_window, int window, int q_offset, int kv_len,
           float scale, cudaStream_t stream) {
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_attention_fwd_kernel<T, DP><<<grid, BQ * (DP / 32), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, sq, skv, d, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, causal, has_window, window, q_offset, kv_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int hq, int hkv, int sq, int skv, int d, long long q_sb,
             long long q_sh, long long q_ss, long long k_sb, long long k_sh,
             long long k_ss, long long v_sb, long long v_sh, long long v_ss,
             int causal, int has_window, int window, int q_offset, int kv_len,
             float scale, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;  // nothing to launch
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DP)                                                       \
  return launch<T, DP>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, q_sb, q_sh, \
                       q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, causal,    \
                       has_window, window, q_offset, kv_len, scale, s)
  if (d <= 32) FA_LAUNCH(32);
  if (d <= 64) FA_LAUNCH(64);
  FA_LAUNCH(128);
#undef FA_LAUNCH
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#define FA_ENTRY(SUFFIX, T)                                                   \
  int flash_attention_fwd_##SUFFIX(                                           \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int hq, int hkv, int sq, int skv, int d, long long q_sb,                \
      long long q_sh, long long q_ss, long long k_sb, long long k_sh,         \
      long long k_ss, long long v_sb, long long v_sh, long long v_ss,         \
      int causal, int has_window, int window, int q_offset, int kv_len,       \
      float scale, void* stream) {                                            \
    return dispatch<T>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, q_sb, q_sh,   \
                       q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, causal,      \
                       has_window, window, q_offset, kv_len, scale, stream);  \
  }

FA_ENTRY(f32, float)
FA_ENTRY(bf16, __nv_bfloat16)
#undef FA_ENTRY

}  // extern "C"
