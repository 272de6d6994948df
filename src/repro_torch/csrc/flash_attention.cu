// Hand-written Hopper (sm_90a) kernel: blocked online-softmax attention on
// the tensor cores.
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
//   Head dims up to 128 take the kernel described here; 129..256 take the
//   second kernel of this file ("head_dim 129..256 route"), which splits
//   the head dim between two warpgroups.  Each head dim has one route.
//
// Bound on this card: operations.  At the training shapes of smollm-135m
//   (q (8, 9, 1024, 64) against k/v (8, 3, 1024 or 2048, 64), causal) a
//   launch does 10-29 GFLOP of float32 work (4 * head_dim per visible
//   query-key pair) on ~60 MB of q/k/v/o.  float32 inputs run as 3xTF32
//   (three TF32 products per float32 product, below): 0.06-0.18 ms at the
//   495 TFLOP/s TF32 tensor-core rate, against 0.02 ms for the bytes;
//   bfloat16 inputs run one bf16 product at 989 TFLOP/s.
//
// Design:
//   * Both products as Hopper warpgroup MMAs (wgmma.mma_async: m64nNk8
//     TF32 for float32 inputs, m64nNk16 bf16 for bfloat16 inputs, float32
//     accumulators).  One warpgroup (4 warps) owns one head's 64-row query
//     tile.  S = Q K^T reads Q and K from shared memory through matrix
//     descriptors; O += P V reads P from the S accumulator registers and
//     V^T from shared memory.  TF32 wgmma takes K-major operands only, so
//     every operand tile is stored K-major in the canonical no-swizzle
//     layout (8-row x 16-byte core matrices, those of one 8-row group side
//     by side along K: leading byte offset 128, stride byte offset 128 x the
//     core matrices along K), V transposed; bf16 uses the same layouts.
//   * float32 accuracy from TF32 units (3xTF32): every operand x is split
//     into big, x rounded to a TF32 value (explicitly, so that small =
//     x - big is exact whatever the unit does with the low 13 bits of a
//     register), and small, and a product is small*big + big*small +
//     big*big in float32, the two small terms first within each 8-deep
//     step.  That keeps ~22 bits of each operand against TF32's 11: one
//     TF32 pass would miss the 2e-4 / 1e-5 (lse) tolerances at head_dim 64
//     (tests/test_torch_attention.py emulates both).  Q is split once into
//     shared memory, K and V once per tile (every warpgroup of the block
//     reuses them), P in registers.  bfloat16 inputs take one bf16 product.
//   * The S accumulator is not the TF32 A layout: within each 8-column
//     group a thread holds columns {2t, 2t+1} of the accumulator (PTX ISA,
//     wgmma / mma fragments; lane = 4g + t) but k = {t, t + 4} of an A
//     fragment.  The sum over keys does not care about their order, so
//     P's logical k = t stands for key 2t and k = t + 4 for key 2t + 1, and
//     V^T lists each 8-key group's keys in that order (0 2 4 6 1 3 5 7):
//     the accumulator is the P operand as it lies.
//     For bf16 (k16) the two layouts coincide: P is packed to bf16 pairs
//     as it lies (p.astype(v.dtype)) and V^T keeps the keys' order.
//   * K/V staging: a ring of two raw tiles in dynamic shared memory (above
//     48 KB, cudaFuncSetAttribute), filled by 16-byte cp.async copies: the
//     copies of tile j + 1 run while tile j is split and multiplied.  A
//     tensor whose rows are not 16-byte aligned (a sequence slice of an odd
//     head dimension, an offset view) is staged by scalar loads in the same
//     kernel.  Keys past kv_len and dimensions past head_dim are zero in
//     shared memory (zero-filling copies), so tiny and odd head dims (8, 16,
//     96) run with no padding copy; zeros are exact.
//   * GQA: one block takes gb query heads of one KV head (gb the largest
//     divisor of Hq/Hkv up to MaxHeads) for one 64-row query tile, so each
//     K/V tile is staged and split once for all of them: 3 x 64 rows, 12
//     warps at smollm-135m.
//   * float32 accumulation of O: each key tile's P V goes into a zeroed
//     accumulator of its own, and joins the running O on the CUDA cores,
//     o = o corr + tile (one FFMA, round to nearest).  The tensor core's
//     float32 accumulate truncates; with one accumulator across the whole
//     key loop, every one of the 3 BK / 8 products of every tile truncated
//     against O's full magnitude, and the bias grew with the key count
//     (whisper's encoder, 1500 keys: 1.34e-5 off float64 against SDPA's
//     1.38e-6, 3.6e-6 at 256 keys, 2.6e-6 at 32; scripts/b3_f32_error.py).
//     S and the tile sum live within one tile and not at once (S is split
//     into P before the P V products), and the descriptors of the
//     products are computed where they issue (desc_at), so the tile
//     accumulator costs no registers at head_dim 64 and no spill at 128.
//   * Online softmax on the accumulator fragments: a row's scores sit in
//     the 4 threads of a quad, so row max takes 2 shuffles; the row sum
//     stays per thread until the end.  Scores are kept in log2 units
//     (exp2).  Only tiles that cross a mask edge are masked element by
//     element, and p is re-masked to 0 after the exp there.
//   * Key tiles that the causal, window or kv_len masks leave wholly empty
//     for every row of the block are never visited (exact: a fully masked
//     tile leaves m, l and acc unchanged), and heavy query tiles (late rows
//     of a causal launch) are scheduled first.
//   * q, k and v are read through their (batch, head, sequence) strides;
//     the head dimension must have unit stride.  Rows past Sq (Sq = 1 at
//     decode) compute on zeros and are never written.
//   * Occupancy: one block an SM.  At head_dim 64, float32, the two raw
//     stages (64 KB), the K and V^T operand tiles (64 KB) and three heads'
//     Q tiles (96 KB) fill 224 KB of shared memory, and ptxas fits the 12
//     warps in 168 registers with no spill (220 at head_dim 128, one head
//     a block).  Between the block's two
//     barriers of a tile every warp splits operands, so the tensor cores
//     idle there; the softmax of a warpgroup waits on its own products.
//     A producer warp and ping-ponged consumer warpgroups are the next
//     step (PERF.md).
// ---------------------------------------------------------------------------
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 64;  // query rows of one head per block (one warpgroup)

// ------------------------------------------------------------ index math --
// Lane l of a warp is (g, t) = (l / 4, l % 4) in the PTX fragment tables.
__host__ __device__ constexpr int lane_g(int lane) { return lane >> 2; }
__host__ __device__ constexpr int lane_t(int lane) { return lane & 3; }

// Accumulator (16 rows of a warp x 8 columns of each 8-column group):
// register e holds row g + 8 (e / 2), column 2t + e % 2.
__host__ __device__ constexpr int acc_row(int lane, int e) {
  return lane_g(lane) + 8 * (e >> 1);
}
__host__ __device__ constexpr int acc_col(int lane, int e) {
  return 2 * lane_t(lane) + (e & 1);
}

// TF32 A fragment (k8): register i holds row g + 8 (i % 2), logical k
// t + 4 (i / 2).  For P, logical k = t + 4 h is key 2t + h of the 8-key
// group, which the accumulator register tf32_p_from_acc(i) holds.
__host__ __device__ constexpr int tf32_p_from_acc(int i) {
  return 2 * (i & 1) + (i >> 1);
}
// The logical k of a key in V^T (0 2 4 6 1 3 5 7 within each 8-key group).
__host__ __device__ constexpr int tf32_vt_k(int key) {
  return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
}
// bf16 A fragment (k16): register i holds the pair row g + 8 (i % 2),
// k 2t + 8 (i / 2) + {0, 1}: accumulator registers 2 (i % 2) and
// 2 (i % 2) + 1 of the 8-key group i / 2 of the 16-key step.
__host__ __device__ constexpr int bf16_p_group(int i) { return i >> 1; }
__host__ __device__ constexpr int bf16_p_first(int i) { return 2 * (i & 1); }

// Element offset of (r, k) in a K-major operand tile in wgmma's canonical
// no-swizzle layout: core matrices of 8 rows x EPR elements (16 bytes),
// the kc = K / EPR of one 8-row group side by side.
template <int EPR>
__host__ __device__ constexpr int cm_index(int r, int k, int kc) {
  return ((r >> 3) * kc + k / EPR) * (8 * EPR) + (r & 7) * EPR + k % EPR;
}

// ------------------------------------------------------------- layouts --
// Query heads per block (a warpgroup each): the largest divisor of the GQA
// group up to this.
template <typename T, int DP>
struct MaxHeads {
  static constexpr int value = DP <= 64 ? 3 : (sizeof(T) == 4 ? 1 : 2);
};

// Dynamic shared memory, in elements of T: two raw stages of K and V rows
// (BK x DP each), the K and V^T operand tiles (big and small for float32),
// and each head's Q operand tile(s).
template <typename T, int DP>
struct Tile {
  static constexpr int EPR = 16 / sizeof(T);       // elements a 16-byte row
  static constexpr int PARTS = sizeof(T) == 4 ? 2 : 1;  // big, small
  static constexpr int BK = DP <= 64 ? 64 : 32;    // keys per tile
  static constexpr int RAW = BK * DP;              // one raw K or V tile
  static constexpr int OP = BK * DP;               // one K or V^T part
  static constexpr int QOP = BQ * DP;              // one head's Q part
  static constexpr int ELEMS =
      2 * 2 * RAW + 2 * PARTS * OP + PARTS * MaxHeads<T, DP>::value * QOP;
};

// ------------------------------------------------------------ TF32 split --
// x = big + small.  big is x rounded to nearest at 11 significant bits
// (Veltkamp's split: t = x (2^13 + 1), big = t - (t - x)), a TF32 value
// whose low 13 bits are zero, in three float32 operations; the _rn
// intrinsics keep the compiler from contracting them into an FMA, which
// would break the split.  small = x - big is exact in float32 (at most 13
// significant bits); the tensor core reads its top 11 (truncation: an error
// of at most 2^-11 |small| <= 2^-22 |x|).  Both are valid for |x| < 4e34.
// (cvt.rna.tf32.f32 would take the conversion unit, at a fraction of the
// float32 rate.)
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  const float t = __fmul_rn(x, 8193.f);
  const float b = __fsub_rn(t, __fsub_rn(t, x));
  big = __float_as_uint(b);
  small = __float_as_uint(__fsub_rn(x, b));
}

// ---------------------------------------------------------- PTX wrappers --
// wgmma m64nNk8 TF32 / m64nNk16 bf16, accumulating into d (N / 8 groups of
// 4 registers): A from shared memory (descriptor da) or registers (a), B
// from shared memory (descriptor db), both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[2][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[4][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[8][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// Matrix descriptor of a canonical no-swizzle K-major tile at p (16-byte
// aligned) with kc core matrices per 8-row group: leading byte offset 128
// (the next core matrix along K), stride byte offset 128 kc (the next
// 8-row group).  A k-step (two core matrices along K) adds 16.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int kc) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((128 * kc) >> 4) << 32);
}
// A descriptor plus a k-step (or pass) offset, computed where the product
// issues: the asm makes the base opaque, so the compiler cannot hoist
// base + offset out of the key loop and keep every (operand, k-step)
// descriptor of a tile in its own 64-bit register pair.
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint64_t off) {
  asm volatile("" : "+l"(base));
  return base + off;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that an in-flight wgmma reads or writes in place, so the
// compiler neither reads nor reuses them across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[i][e] = 0.f;
}
// o = o corr + t on the CUDA cores (one rounding, to nearest): a key tile's
// P V sum t joins the running output's column groups [off, off + M),
// rescaled by its row's softmax correction (accumulator register e is of
// row half e / 2).  off must be a constant after unrolling.
template <int N, int M>
__device__ __forceinline__ void promote(float (&o)[N][4],
                                        const float (&t)[M][4],
                                        const float (&corr)[2], int off = 0) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[off + i][e] = fmaf(o[off + i][e], corr[e >> 1], t[i][e]);
}
// A barrier of the 128 threads of warpgroup wg (named barrier wg + 1).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
// Makes this thread's shared-memory writes (stores and completed cp.async
// copies) visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------------- staging --
// Copy key rows [t0, t0 + BK) of k and v (head dims [0, DP)) into a raw
// stage (rows of DP elements): 16-byte cp.async where the rows allow it,
// else scalar loads; keys at or past kv_lim and dims at or past d are
// zeros.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(T* sk, T* sv, const T* kb,
                                           const T* vb, long long k_ss,
                                           long long v_ss, int t0, int kv_lim,
                                           int d, bool vec_k, bool vec_v,
                                           int tid, int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = Tile<T, DP>::BK * DP / VEC;
  for (int i = tid; i < 2 * CHUNKS; i += nthreads) {
    const bool is_v = i >= CHUNKS;
    const int c = is_v ? i - CHUNKS : i;
    const int r = c / (DP / VEC), col = (c - r * (DP / VEC)) * VEC;
    const int key = t0 + r;
    const T* src = is_v ? vb : kb;
    const long long ss = is_v ? v_ss : k_ss;
    T* dst = (is_v ? sv : sk) + r * DP + col;
    const bool in_rows = key < kv_lim;
    if (is_v ? vec_v : vec_k) {
      const bool ok = in_rows && col < d;
      cp_async16(dst, ok ? src + key * ss + col : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int dim = col + e;
        dst[e] = (in_rows && dim < d) ? src[key * ss + dim] : T(0.f);
      }
    }
  }
}

// Raw stage -> the K and V^T operand tiles (ko / vo, the small parts one
// tile further for float32).  float32 is split into TF32 (big, small) and
// V^T lists each 8-key group's keys in tf32_vt_k order; bf16 is copied.
template <typename T, int DP>
__device__ __forceinline__ void operand_tile(const T* sk, const T* sv, T* ko,
                                             T* vo, int tid, int nthreads) {
  using TL = Tile<T, DP>;
  constexpr int BK = TL::BK, EPR = TL::EPR;
  for (int i = tid; i < BK * DP / EPR; i += nthreads) {  // K: 16-byte rows
    const int key = i / (DP / EPR), col = (i - key * (DP / EPR)) * EPR;
    const int w = cm_index<EPR>(key, col, DP / EPR);
    const uint4 x = *reinterpret_cast<const uint4*>(sk + key * DP + col);
    if constexpr (sizeof(T) == 4) {
      uint32_t b[4], s[4];
      tf32_split(__uint_as_float(x.x), b[0], s[0]);
      tf32_split(__uint_as_float(x.y), b[1], s[1]);
      tf32_split(__uint_as_float(x.z), b[2], s[2]);
      tf32_split(__uint_as_float(x.w), b[3], s[3]);
      *reinterpret_cast<uint4*>(ko + w) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(ko + TL::OP + w) =
          make_uint4(s[0], s[1], s[2], s[3]);
    } else {
      *reinterpret_cast<uint4*>(ko + w) = x;
    }
  }
  // V^T: (dim, EPR logical keys) -> 16 bytes.  float32: the even or the odd
  // keys of an 8-key group; bf16: 8 keys in order.
  for (int i = tid; i < DP * BK / EPR; i += nthreads) {
    const int jr = i / DP, dim = i - jr * DP;
    if constexpr (sizeof(T) == 4) {
      const int key0 = (jr >> 1) * 8 + (jr & 1);
      uint32_t b[4], s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32_split(sv[(key0 + 2 * e) * DP + dim], b[e], s[e]);
      const int w = cm_index<4>(dim, tf32_vt_k(key0), BK / 4);
      *reinterpret_cast<uint4*>(vo + w) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(vo + TL::OP + w) =
          make_uint4(s[0], s[1], s[2], s[3]);
    } else {
      const int key0 = jr * 8;
      const T* col = sv + key0 * DP + dim;
      *reinterpret_cast<uint4*>(vo + cm_index<8>(dim, key0, BK / 8)) =
          make_uint4(pack_bf16(col[0], col[DP]),
                     pack_bf16(col[2 * DP], col[3 * DP]),
                     pack_bf16(col[4 * DP], col[5 * DP]),
                     pack_bf16(col[6 * DP], col[7 * DP]));
    }
  }
}

// ---------------------------------------------------------------- kernel --
template <typename T, int DP>
__global__ void __launch_bounds__(128 * MaxHeads<T, DP>::value, 1)
    flash_attention_fwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
        int hq, int hkv, int gb, int sq, int skv, int d, long long q_sb,
        long long q_sh, long long q_ss, long long k_sb, long long k_sh,
        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
        int causal, int has_window, int window, int q_offset, int kv_len,
        float scale, int vec_k, int vec_v) {
  using TL = Tile<T, DP>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = TL::BK, EPR = TL::EPR;
  constexpr int NT = BK / 8;       // 8-key column groups of S
  constexpr int ND = DP / 8;       // 8-dim column groups of O
  constexpr int KSTEP = 2 * EPR;   // depth of one wgmma: 8 (TF32), 16 (bf16)
  constexpr int KS = DP / KSTEP;   // k-steps of Q K^T
  constexpr int KK = BK / KSTEP;   // k-steps of P V
  extern __shared__ __align__(128) uint32_t smem[];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int group = hq / hkv, blocks_per_kv = group / gb;
  const int bx = blockIdx.x;
  const int b = bx / (hkv * blocks_per_kv);
  const int rest = bx - b * hkv * blocks_per_kv;
  const int hk = rest / blocks_per_kv;
  const int hl = warp >> 2;  // this warpgroup's head within the block
  const int h = hk * group + (rest - hk * blocks_per_kv) * gb + hl;
  // Late query tiles see the most keys under a causal mask: start them first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int wrow = 16 * (warp & 3);  // the warp's first row in the tile
  const float scale2 = scale * LOG2E;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const T* qh = q + b * q_sb + h * q_sh;

  // Shared memory (elements of T): two raw K/V stages, the K and V^T
  // operand tiles, then each head's Q operand tile.
  T* const raw = reinterpret_cast<T*>(smem);
  T* const ko = raw + 4 * TL::RAW;
  T* const vo = ko + TL::PARTS * TL::OP;
  T* const qo = vo + TL::PARTS * TL::OP + hl * TL::PARTS * TL::QOP;

  // q, split (float32) into this head's Q operand tile(s), once.
  for (int i = tid & 127; i < BQ * DP / EPR; i += 128) {
    const int row = i / (DP / EPR), col = (i - row * (DP / EPR)) * EPR;
    alignas(16) T x[EPR];
#pragma unroll
    for (int e = 0; e < EPR; ++e)
      x[e] = (q0 + row < sq && col + e < d) ? qh[(q0 + row) * q_ss + col + e]
                                             : T(0.f);
    const int w = cm_index<EPR>(row, col, DP / EPR);
    if constexpr (F32) {
      uint32_t bg[4], sm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(x[e], bg[e], sm[e]);
      *reinterpret_cast<uint4*>(qo + w) = make_uint4(bg[0], bg[1], bg[2],
                                                     bg[3]);
      *reinterpret_cast<uint4*>(qo + TL::QOP + w) =
          make_uint4(sm[0], sm[1], sm[2], sm[3]);
    } else {
      *reinterpret_cast<uint4*>(qo + w) = *reinterpret_cast<const uint4*>(x);
    }
  }

  float oacc[ND][4];
  zero_regs(oacc);
  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};

  // The keys any row of this block can see: [k_begin, k_end).
  const int kv_lim = kv_len < skv ? kv_len : skv;
  const int q_hi = q0 + BQ < sq ? q0 + BQ : sq;
  int k_end = kv_lim;
  if (causal && q_offset + q_hi < k_end) k_end = q_offset + q_hi;
  int k_begin = 0;
  if (has_window && q_offset + q0 - window + 1 > 0)
    k_begin = (q_offset + q0 - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // Descriptors of the operand tiles (a k-step adds 16).
  const uint64_t dq = smem_desc(qo, DP / EPR);
  const uint64_t dk = smem_desc(ko, DP / EPR);
  const uint64_t dv = smem_desc(vo, BK / EPR);
  // float32: the small parts, one operand tile further.
  const uint64_t dq_s = smem_desc(qo + TL::QOP, DP / EPR);
  const uint64_t dk_s = smem_desc(ko + TL::OP, DP / EPR);
  const uint64_t dv_s = smem_desc(vo + TL::OP, BK / EPR);

  // Stage s of the raw ring: K at raw + 2 s RAW, V right after it.
  if (n_tiles > 0) {
    stage_tile<T, DP>(raw, raw + TL::RAW, kb, vb, k_ss, v_ss, k_begin,
                      kv_lim, d, vec_k, vec_v, tid, nthreads);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = k_begin + j * BK;
    cp_async_wait_all();
    __syncthreads();  // tile j staged; every warpgroup done with tile j - 1
    if (j + 1 < n_tiles) {
      T* const next = raw + 2 * TL::RAW * ((j + 1) & 1);
      stage_tile<T, DP>(next, next + TL::RAW, kb, vb, k_ss, v_ss, t0 + BK,
                        kv_lim, d, vec_k, vec_v, tid, nthreads);
      cp_async_commit();
    }
    const T* const cur = raw + 2 * TL::RAW * (j & 1);
    operand_tile<T, DP>(cur, cur + TL::RAW, ko, vo, tid, nthreads);
    fence_proxy_async();  // the operand tiles (and Q) are wgmma's to read
    __syncthreads();

    // ---- S = Q K^T: this warpgroup's 64 rows against BK keys (S, and
    // below P V's tile sum, live within one tile: a tile's P V runs while
    // S is dead, so the two take no more registers than one)
    float sacc[NT][4];
    zero_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t s = 16 * ks;
      if constexpr (F32) {  // small terms first; the first overwrites S
        wgmma_tf32_ss(sacc, desc_at(dq_s, s), desc_at(dk, s), ks > 0);
        wgmma_tf32_ss(sacc, desc_at(dq, s), desc_at(dk_s, s), 1);
        wgmma_tf32_ss(sacc, desc_at(dq, s), desc_at(dk, s), 1);
      } else {
        wgmma_bf16_ss(sacc, desc_at(dq, s), desc_at(dk, s), ks > 0);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(sacc);

    // ---- online softmax on the fragments (log2 units)
    const bool full =
        t0 + BK <= kv_lim && (!causal || t0 + BK - 1 <= q_offset + q0) &&
        (!has_window || t0 > q_offset + q_hi - 1 - window);
    uint32_t dead = 0;  // bit 4 n + e: that score is masked
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] *= scale2;
        if (!full) {
          const int kpos = t0 + 8 * n + acc_col(lane, e);
          const int qpos = q_offset + q0 + wrow + acc_row(lane, e);
          const bool ok = kpos < kv_lim && (!causal || kpos <= qpos) &&
                          (!has_window || kpos > qpos - window);
          if (!ok) {
            sacc[n][e] = NEG_INF;
            dead |= 1u << (4 * n + e);
          }
        }
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sacc[n][2 * hr], sacc[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[hr], mx);
      corr[hr] = exp2f(m_row[hr] - m_new);
      m_row[hr] = m_new;
      l_row[hr] *= corr[hr];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Explicit re-mask: a fully masked row would get exp2(0) = 1.
        const float p = (dead >> (4 * n + e)) & 1u
                            ? 0.f
                            : exp2f(sacc[n][e] - m_row[e >> 1]);
        l_row[e >> 1] += p;
        sacc[n][e] = p;
      }

    // ---- O = O corr + P V, P from the S registers.  The tile's P V goes
    // into its own zeroed accumulator and joins O by an FFMA (round to
    // nearest): the tensor core's float32 accumulate truncates, and
    // adding every tile into O itself would truncate once for each of the
    // 3 BK / 8 products of every tile against O's full magnitude.
    uint32_t pa[KK][4], ps[F32 ? KK : 1][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (F32) {
          tf32_split(sacc[kk][tf32_p_from_acc(i)], pa[kk][i], ps[kk][i]);
        } else {  // p.astype(v.dtype): p rounded to bfloat16 here
          const float* c = sacc[2 * kk + bf16_p_group(i)] + bf16_p_first(i);
          pa[kk][i] = pack_bf16(c[0], c[1]);
        }
      }
    float tacc[ND][4];
    zero_regs(tacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t s = 16 * kk;
      if constexpr (F32) {
        wgmma_tf32_rs(tacc, ps[kk], desc_at(dv, s), 1);
        wgmma_tf32_rs(tacc, pa[kk], desc_at(dv_s, s), 1);
        wgmma_tf32_rs(tacc, pa[kk], desc_at(dv, s), 1);
      } else {
        wgmma_bf16_rs(tacc, pa[kk], desc_at(dv, s), 1);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(tacc);
    fence_regs(pa);
    if constexpr (F32) fence_regs(ps);
    promote(oacc, tacc, corr);
  }

  // ---- epilogue: the row sums across the quad, then o / l and lse
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_row[hr] += __shfl_xor_sync(0xffffffffu, l_row[hr], 1);
    l_row[hr] += __shfl_xor_sync(0xffffffffu, l_row[hr], 2);
  }
  const long long row_base = ((long long)b * hq + h) * sq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wrow + acc_row(lane, 2 * hr);
    if (row >= sq) continue;
    // Rows with no visible key have l == 0 (and acc == 0): zeros, not NaNs.
    const float l = l_row[hr];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    T* op = o + (row_base + row) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dim = 8 * n + acc_col(lane, e);
        if (dim < d) store(op + dim, oacc[n][2 * hr + e] * inv);
      }
    if (lane_t(lane) == 0)
      lse[row_base + row] =
          l == 0.f ? NEG_INF : m_row[hr] * LN2 + logf(l);
  }
}

// -------------------------------------------------- head_dim 129..256 route --
// Head dims 129..256 (recurrentgemma-2b's local attention: 10 query heads on
// 1 KV head of 256), padded to DP = 256, on the same tensor-core products as
// the kernel above (3xTF32 for float32, one bf16 product for bfloat16), with
// its masks, lse, empty-row zeros, strides, scalar staging for unaligned
// rows, key-tile skipping and heavy-tiles-first order.  The layout above does
// not fit at DP = 256 (its raw stages, split operand tiles and a head's split
// Q come to 393 KB against 227 KB a block, and a 64 x 256 float32 output tile
// is 128 accumulators a thread of one warpgroup), so this kernel:
//   * Splits the head dim between two consumer warpgroups.  Warpgroup hf
//     owns output dims [128 hf, 128 hf + 128): 64 accumulators a thread,
//     P V as m64n128.  (One warpgroup holding the whole 64 x 256 output
//     would need 128 accumulators a thread beside S, P's split and the
//     prefetch, and would leave 4 warps on the SM.)  Each warpgroup
//     computes a partial S over its 128 dims of Q and K (m64nBK); the two
//     partials meet through shared memory and each warpgroup adds the
//     other's to its own.  IEEE addition commutes, so both hold the same S
//     bit for bit and run the same softmax (the same m, l and P) with no
//     further exchange.
//   * Stages K and V through registers instead of a raw shared stage: right
//     after tile j is written into the operand tiles, every thread issues
//     its global loads of tile j + 1 (16-byte loads of K rows, scalar loads
//     of V columns, zeros past kv_len and d), which fly during tile j's
//     products and softmax; the next tile splits (float32) and stores them.
//     K lands straight in the canonical K-major layout (its rows already
//     are K-major), V transposed (V^T, keys in tf32_vt_k order for float32).
//   * Shared memory at float32 (BK = 16 keys a tile, one query head a
//     block), of the 232,448 bytes a block may have:
//       Q split, 2 halves x (big + small) x 64 x 128 x 4 B    131,072
//       K split, 2 halves x 2 parts x 16 x 128 x 4 B           32,768
//       V^T split, 2 halves x 2 parts x 128 x 16 x 4 B         32,768
//                                                     total   196,608
//     Each warpgroup's partial S (64 x 16 float32) goes into its own K
//     half, which no other warpgroup reads, after a barrier of its 128
//     threads (a warp passes its wgmma wait before the other warps of the
//     warpgroup are done reading K).  The S products at N = 16 re-read
//     the 64-row Q operand from shared memory for every 8-deep step, and
//     24-key tiles ran 7-8 % faster; but a tile's P V sum needs its own
//     64 accumulators a thread (float32 accuracy: see the kernel above),
//     and at 24 keys S, P's split and the next tile's K and V do not fit
//     beside them in 255 registers (ptxas spilled 32 bytes).
//   * bfloat16 (BK = 32): Q 32 KB a head, K and V^T 16 KB each, partial S
//     16 KB a head in its own buffer: a block takes G = 2 query heads of
//     one KV head when the GQA group is even (4 warpgroups, 512 threads,
//     131,072 bytes), so each K / V tile is loaded and stored once for
//     both (one head a block ran 54 % slower at chunk 1).
//   * Registers (ptxas, sm_90a): 254 a thread at float32 (64 output
//     accumulators, 64 of the tile's P V, 8 of S, 16 of P's split, 32 of
//     the next tile's K and V), 127 at bfloat16 with two heads (the
//     512-thread cap), 209 with one; no spills (chip_smoke.py phase 2
//     prints them).
//   * Block barriers a tile: the last tile's readers are done; the operand
//     tiles are written; the partial S are written.
namespace wide {
constexpr int DP = 256;    // head dims (padded)
constexpr int HALF = 128;  // head dims of one consumer warpgroup
}  // namespace wide

template <typename T>
struct Wide {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int EPR = 16 / sizeof(T);       // elements a 16-byte row
  static constexpr int PARTS = F32 ? 2 : 1;        // big, small
  static constexpr int BK = F32 ? 16 : 32;         // keys a tile
  static constexpr int HEADS = F32 ? 1 : 2;        // query heads a block, at most
  static constexpr int QT = BQ * wide::HALF;       // a head's Q half, one part
  static constexpr int KT = BK * wide::HALF;       // a K half, one part
  static constexpr int VT = wide::HALF * BK;       // a V^T half, one part
  static constexpr int XS = BQ * BK;               // one warpgroup's partial S
  // Bytes of dynamic shared memory of a block of g query heads.
  static constexpr int bytes(int g) {
    return (int)sizeof(T) * (g * 2 * PARTS * QT + 2 * PARTS * KT +
                             2 * PARTS * VT) +
           (F32 ? 0 : 4 * g * 2 * XS);
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(256 * G, 1)
    flash_attention_fwd_wide_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
        int hq, int hkv, int sq, int skv, int d, long long q_sb,
        long long q_sh, long long q_ss, long long k_sb, long long k_sh,
        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
        int causal, int has_window, int window, int q_offset, int kv_len,
        float scale, int vec_k) {
  using W = Wide<T>;
  using wide::DP;
  using wide::HALF;
  constexpr bool F32 = W::F32;
  constexpr int BK = W::BK, EPR = W::EPR, PARTS = W::PARTS;
  constexpr int NTH = 256 * G;       // threads a block
  constexpr int NT = BK / 8;         // 8-key column groups of S
  constexpr int ND = HALF / 8;       // 8-dim column groups of a half of O
  constexpr int KSTEP = 2 * EPR;     // depth of one wgmma: 8 (TF32), 16 (bf16)
  constexpr int KS = HALF / KSTEP;   // k-steps of a half's Q K^T
  constexpr int KK = BK / KSTEP;     // k-steps of P V
  constexpr int CPR = DP / EPR;      // 16-byte chunks a K row
  constexpr int KCH = BK * CPR / NTH;        // K chunks a thread
  constexpr int VCH = DP * (BK / EPR) / NTH; // V^T chunks a thread
  static_assert(KCH * NTH == BK * CPR && VCH * NTH == DP * (BK / EPR),
                "the tile's chunks must spread evenly over the threads");
  extern __shared__ __align__(128) uint32_t smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;          // consumer warpgroup
  const int hl = wg >> 1;            // its query head within the block
  const int hf = wg & 1;             // its half of the head dims
  const int wtid = tid & 127;
  const int group = hq / hkv, blocks_per_kv = group / G;
  const int bx = blockIdx.x;
  const int b = bx / (hkv * blocks_per_kv);
  const int rest = bx - b * hkv * blocks_per_kv;
  const int hk = rest / blocks_per_kv;
  const int h = hk * group + (rest - hk * blocks_per_kv) * G + hl;
  // Late query tiles see the most keys under a causal mask: start them first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int wrow = 16 * (warp & 3);  // the warp's first row in the tile
  const float scale2 = scale * LOG2E;

  const T* const kb = k + b * k_sb + hk * k_sh;
  const T* const vb = v + b * v_sb + hk * v_sh;
  const T* const qh = q + b * q_sb + h * q_sh;

  // Shared memory (elements of T): each head's Q halves (big, small), the K
  // halves, the V^T halves, then each warpgroup's partial S (float32).
  T* const qt = reinterpret_cast<T*>(smem);
  T* const kt = qt + G * 2 * PARTS * W::QT;
  T* const vt = kt + 2 * PARTS * W::KT;
  float* const xs = reinterpret_cast<float*>(vt + 2 * PARTS * W::VT);

  // Chunk i of an R-row tile of CPR 16-byte chunks a row: 8 consecutive
  // threads take one chunk of 8 consecutive rows (one core matrix: no bank
  // conflict), 4 such groups of a warp the next chunks of those rows.
  const auto chunk_rc = [](int i, int& row, int& col) {
    const int r8 = i & 7, rest8 = i >> 3;
    const int c = rest8 % CPR;
    row = (rest8 / CPR) * 8 + r8;
    col = c * EPR;
  };

  // q, split (float32) into this head's two Q halves, once.
  for (int i = tid & 255; i < BQ * CPR; i += 256) {
    int row, col;
    chunk_rc(i, row, col);
    alignas(16) T x[EPR];
#pragma unroll
    for (int e = 0; e < EPR; ++e)
      x[e] = (q0 + row < sq && col + e < d) ? qh[(q0 + row) * q_ss + col + e]
                                             : T(0.f);
    T* const dst = qt + (hl * 2 + col / HALF) * PARTS * W::QT;
    const int w = cm_index<EPR>(row, col % HALF, HALF / EPR);
    if constexpr (F32) {
      uint32_t bg[4], sm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(x[e], bg[e], sm[e]);
      *reinterpret_cast<uint4*>(dst + w) = make_uint4(bg[0], bg[1], bg[2],
                                                      bg[3]);
      *reinterpret_cast<uint4*>(dst + W::QT + w) =
          make_uint4(sm[0], sm[1], sm[2], sm[3]);
    } else {
      *reinterpret_cast<uint4*>(dst + w) = *reinterpret_cast<const uint4*>(x);
    }
  }

  // The keys any row of this block can see: [k_begin, k_end).
  const int kv_lim = kv_len < skv ? kv_len : skv;
  const int q_hi = q0 + BQ < sq ? q0 + BQ : sq;
  int k_end = kv_lim;
  if (causal && q_offset + q_hi < k_end) k_end = q_offset + q_hi;
  int k_begin = 0;
  if (has_window && q_offset + q0 - window + 1 > 0)
    k_begin = (q_offset + q0 - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // The next tile in registers: K chunks (16 bytes of one key row) and V^T
  // chunks (EPR keys of one dim), zeros past kv_lim and d.
  uint4 kreg[KCH], vreg[VCH];
  const auto load_tile = [&](int t0) {
#pragma unroll
    for (int c = 0; c < KCH; ++c) {
      int key, col;
      chunk_rc(tid + c * NTH, key, col);
      const int kpos = t0 + key;
      const T* const src = kb + kpos * k_ss + col;
      if (vec_k) {
        kreg[c] = kpos < kv_lim && col < d
                      ? *reinterpret_cast<const uint4*>(src)
                      : make_uint4(0u, 0u, 0u, 0u);
      } else {
        alignas(16) T x[EPR];
#pragma unroll
        for (int e = 0; e < EPR; ++e)
          x[e] = kpos < kv_lim && col + e < d ? src[e] : T(0.f);
        kreg[c] = *reinterpret_cast<const uint4*>(x);
      }
    }
#pragma unroll
    for (int c = 0; c < VCH; ++c) {
      const int i = tid + c * NTH;
      const int dim = i % DP, jr = i / DP;
      const int key0 = F32 ? (jr >> 1) * 8 + (jr & 1) : jr * 8;
      alignas(16) T x[EPR];
#pragma unroll
      for (int e = 0; e < EPR; ++e) {
        const int kpos = t0 + key0 + (F32 ? 2 * e : e);
        x[e] = kpos < kv_lim && dim < d ? vb[kpos * v_ss + dim] : T(0.f);
      }
      vreg[c] = *reinterpret_cast<const uint4*>(x);
    }
  };
  // The registers -> the K and V^T operand halves (split for float32).
  const auto store_tile = [&]() {
#pragma unroll
    for (int c = 0; c < KCH; ++c) {
      int key, col;
      chunk_rc(tid + c * NTH, key, col);
      T* const dst = kt + (col / HALF) * PARTS * W::KT +
                     cm_index<EPR>(key, col % HALF, HALF / EPR);
      if constexpr (F32) {
        uint32_t bg[4], sm[4];
        tf32_split(__uint_as_float(kreg[c].x), bg[0], sm[0]);
        tf32_split(__uint_as_float(kreg[c].y), bg[1], sm[1]);
        tf32_split(__uint_as_float(kreg[c].z), bg[2], sm[2]);
        tf32_split(__uint_as_float(kreg[c].w), bg[3], sm[3]);
        *reinterpret_cast<uint4*>(dst) = make_uint4(bg[0], bg[1], bg[2],
                                                    bg[3]);
        *reinterpret_cast<uint4*>(dst + W::KT) =
            make_uint4(sm[0], sm[1], sm[2], sm[3]);
      } else {
        *reinterpret_cast<uint4*>(dst) = kreg[c];
      }
    }
#pragma unroll
    for (int c = 0; c < VCH; ++c) {
      const int i = tid + c * NTH;
      const int dim = i % DP, jr = i / DP;
      T* const base = vt + (dim / HALF) * PARTS * W::VT;
      if constexpr (F32) {
        const int key0 = (jr >> 1) * 8 + (jr & 1);
        T* const dst = base + cm_index<4>(dim % HALF, tf32_vt_k(key0), BK / 4);
        uint32_t bg[4], sm[4];
        tf32_split(__uint_as_float(vreg[c].x), bg[0], sm[0]);
        tf32_split(__uint_as_float(vreg[c].y), bg[1], sm[1]);
        tf32_split(__uint_as_float(vreg[c].z), bg[2], sm[2]);
        tf32_split(__uint_as_float(vreg[c].w), bg[3], sm[3]);
        *reinterpret_cast<uint4*>(dst) = make_uint4(bg[0], bg[1], bg[2],
                                                    bg[3]);
        *reinterpret_cast<uint4*>(dst + W::VT) =
            make_uint4(sm[0], sm[1], sm[2], sm[3]);
      } else {
        *reinterpret_cast<uint4*>(base + cm_index<8>(dim % HALF, jr * 8,
                                                     BK / 8)) = vreg[c];
      }
    }
  };

  float oacc[ND][4], sacc[NT][4];
  zero_regs(oacc);
  zero_regs(sacc);
  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};

  // Descriptors of this warpgroup's operand halves (a k-step adds 16); the
  // small parts (float32) one part further.
  T* const qmine = qt + (hl * 2 + hf) * PARTS * W::QT;
  T* const kmine = kt + hf * PARTS * W::KT;
  T* const vmine = vt + hf * PARTS * W::VT;
  const uint64_t dq = smem_desc(qmine, HALF / EPR);
  const uint64_t dk = smem_desc(kmine, HALF / EPR);
  const uint64_t dv = smem_desc(vmine, BK / EPR);
  const uint64_t dq_s = smem_desc(qmine + W::QT, HALF / EPR);
  const uint64_t dk_s = smem_desc(kmine + W::KT, HALF / EPR);
  const uint64_t dv_s = smem_desc(vmine + W::VT, BK / EPR);
  // float32: each warpgroup's partial S in its own K half (read by no
  // other warpgroup, and done with once its S products are).
  float* const xmine = F32 ? reinterpret_cast<float*>(kt + hf * PARTS * W::KT)
                           : xs + (hl * 2 + hf) * W::XS;
  const float* const xother =
      F32 ? reinterpret_cast<const float*>(kt + (hf ^ 1) * PARTS * W::KT)
          : xs + (hl * 2 + (hf ^ 1)) * W::XS;

  if (n_tiles > 0) load_tile(k_begin);
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = k_begin + j * BK;
    __syncthreads();  // every warpgroup is done with tile j - 1 (and Q is in)
    store_tile();
    fence_proxy_async();  // the operand tiles (and Q) are wgmma's to read
    __syncthreads();
    if (j + 1 < n_tiles) load_tile(t0 + BK);  // in flight during tile j

    // ---- partial S = Q K^T over this warpgroup's 128 dims
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t s = 16 * ks;
      if constexpr (F32) {  // small terms first; the first overwrites S
        wgmma_tf32_ss(sacc, desc_at(dq_s, s), desc_at(dk, s), ks > 0);
        wgmma_tf32_ss(sacc, desc_at(dq, s), desc_at(dk_s, s), 1);
        wgmma_tf32_ss(sacc, desc_at(dq, s), desc_at(dk, s), 1);
      } else {
        wgmma_bf16_ss(sacc, desc_at(dq, s), desc_at(dk, s), ks > 0);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(sacc);

    // ---- S = the two halves' partials, the same sum in both warpgroups
    // (float32: the partial overwrites this half's K once every warp of the
    // warpgroup is done reading it)
    if constexpr (F32) warpgroup_sync(wg);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xmine[(4 * n + e) * 128 + wtid] = sacc[n][e];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[n][e] += xother[(4 * n + e) * 128 + wtid];

    // ---- online softmax on the fragments (log2 units)
    const bool full =
        t0 + BK <= kv_lim && (!causal || t0 + BK - 1 <= q_offset + q0) &&
        (!has_window || t0 > q_offset + q_hi - 1 - window);
    uint32_t dead = 0;  // bit 4 n + e: that score is masked
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] *= scale2;
        if (!full) {
          const int kpos = t0 + 8 * n + acc_col(lane, e);
          const int qpos = q_offset + q0 + wrow + acc_row(lane, e);
          const bool ok = kpos < kv_lim && (!causal || kpos <= qpos) &&
                          (!has_window || kpos > qpos - window);
          if (!ok) {
            sacc[n][e] = NEG_INF;
            dead |= 1u << (4 * n + e);
          }
        }
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sacc[n][2 * hr], sacc[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[hr], mx);
      corr[hr] = exp2f(m_row[hr] - m_new);
      m_row[hr] = m_new;
      l_row[hr] *= corr[hr];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Explicit re-mask: a fully masked row would get exp2(0) = 1.
        const float p = (dead >> (4 * n + e)) & 1u
                            ? 0.f
                            : exp2f(sacc[n][e] - m_row[e >> 1]);
        l_row[e >> 1] += p;
        sacc[n][e] = p;
      }

    // ---- O[:, this half] = O corr + P V[:, this half], P from the S
    // registers
    if constexpr (F32) {
      // As the kernel above: the tile's P V in a zeroed accumulator (64
      // registers beside O's 64), joined to O by an FFMA.
      uint32_t pa[KK][4], ps[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tf32_split(sacc[kk][tf32_p_from_acc(i)], pa[kk][i], ps[kk][i]);
      float tacc[ND][4];
      zero_regs(tacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint64_t s = 16 * kk;
        wgmma_tf32_rs(tacc, ps[kk], desc_at(dv, s), 1);
        wgmma_tf32_rs(tacc, pa[kk], desc_at(dv_s, s), 1);
        wgmma_tf32_rs(tacc, pa[kk], desc_at(dv, s), 1);
      }
      wgmma_commit_and_wait();
      fence_regs(tacc);
      fence_regs(pa);
      fence_regs(ps);
      promote(oacc, tacc, corr);
    } else {
      // bfloat16 (tolerance 5e-2) keeps one accumulator: two heads a block
      // hold 128 registers a thread, the 512-thread cap, with no room for
      // a tile accumulator.
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= corr[e >> 1];
      uint32_t pa[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // p.astype(v.dtype): p rounded to bfloat16 here
          const float* c = sacc[2 * kk + bf16_p_group(i)] + bf16_p_first(i);
          pa[kk][i] = pack_bf16(c[0], c[1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_bf16_rs(oacc, pa[kk], desc_at(dv, 16 * kk), 1);
      wgmma_commit_and_wait();
      fence_regs(oacc);
      fence_regs(pa);
    }
  }

  // ---- epilogue: the row sums across the quad, then o / l and lse (both
  // warpgroups hold the same m and l; the first half writes lse)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_row[hr] += __shfl_xor_sync(0xffffffffu, l_row[hr], 1);
    l_row[hr] += __shfl_xor_sync(0xffffffffu, l_row[hr], 2);
  }
  const long long row_base = ((long long)b * hq + h) * sq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wrow + acc_row(lane, 2 * hr);
    if (row >= sq) continue;
    // Rows with no visible key have l == 0 (and acc == 0): zeros, not NaNs.
    const float l = l_row[hr];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    T* op = o + (row_base + row) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dim = HALF * hf + 8 * n + acc_col(lane, e);
        if (dim < d) store(op + dim, oacc[n][2 * hr + e] * inv);
      }
    if (hf == 0 && lane_t(lane) == 0)
      lse[row_base + row] =
          l == 0.f ? NEG_INF : m_row[hr] * LN2 + logf(l);
  }
}

template <typename T, int G>
int launch_wide_g(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int hq, int hkv, int sq, int skv, int d,
                  long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss,
                  long long v_sb, long long v_sh, long long v_ss, int causal,
                  int has_window, int window, int q_offset, int kv_len,
                  float scale, int vec_k, cudaStream_t stream) {
  constexpr int SMEM = Wide<T>::bytes(G);
  auto kernel = flash_attention_fwd_wide_kernel<T, G>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(b * hkv * (hq / hkv / G), (sq + BQ - 1) / BQ);
  kernel<<<grid, 256 * G, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, sq, skv, d, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, causal, has_window, window, q_offset, kv_len, scale, vec_k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int hq, int hkv, int sq, int skv, int d,
                long long q_sb, long long q_sh, long long q_ss,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss, int causal,
                int has_window, int window, int q_offset, int kv_len,
                float scale, cudaStream_t stream) {
  // 16-byte K loads need 16-byte aligned rows, heads and batches.
  constexpr long long ES = sizeof(T);
  const int vec_k = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    (d * ES) % 16 == 0 && (k_sb * ES) % 16 == 0 &&
                    (k_sh * ES) % 16 == 0 && (k_ss * ES) % 16 == 0;
  // Two query heads a block where the GQA group allows it (bfloat16).
  if (Wide<T>::HEADS == 2 && (hq / hkv) % 2 == 0)
    return launch_wide_g<T, Wide<T>::HEADS>(
        q, k, v, o, lse, b, hq, hkv, sq, skv, d, q_sb, q_sh, q_ss, k_sb, k_sh,
        k_ss, v_sb, v_sh, v_ss, causal, has_window, window, q_offset, kv_len,
        scale, vec_k, stream);
  return launch_wide_g<T, 1>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, q_sb,
                             q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                             causal, has_window, window, q_offset, kv_len,
                             scale, vec_k, stream);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int skv, int d, long long q_sb,
           long long q_sh, long long q_ss, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           int causal, int has_window, int window, int q_offset, int kv_len,
           float scale, cudaStream_t stream) {
  using TL = Tile<T, DP>;
  constexpr size_t SMEM = TL::ELEMS * sizeof(T);
  auto kernel = flash_attention_fwd_kernel<T, DP>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // Query heads per block: the largest divisor of the GQA group that fits.
  const int group = hq / hkv;
  int gb = MaxHeads<T, DP>::value;
  while (group % gb) --gb;
  // 16-byte copies need 16-byte aligned rows, heads and batches.
  constexpr long long ES = sizeof(T);
  const auto aligned = [&](const void* p, long long sb, long long sh,
                           long long ss) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (d * ES) % 16 == 0 && (sb * ES) % 16 == 0 &&
           (sh * ES) % 16 == 0 && (ss * ES) % 16 == 0;
  };
  const int vec_k = aligned(k, k_sb, k_sh, k_ss);
  const int vec_v = aligned(v, v_sb, v_sh, v_ss);
  const dim3 grid(b * hkv * (group / gb), (sq + BQ - 1) / BQ);
  kernel<<<grid, 128 * gb, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, gb, sq, skv, d, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, causal, has_window, window, q_offset, kv_len, scale, vec_k,
      vec_v);
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
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128)
    return launch_wide<T>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, q_sb,
                          q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                          causal, has_window, window, q_offset, kv_len, scale,
                          s);
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

// Dynamic shared memory of one block at head dim d (ptxas reports only the
// static kind), for the build report.
int flash_attention_smem_bytes(int bf16, int d) {
  if (d > 128)
    return bf16 ? Wide<__nv_bfloat16>::bytes(Wide<__nv_bfloat16>::HEADS)
                : Wide<float>::bytes(Wide<float>::HEADS);
  const int dp = d <= 32 ? 32 : d <= 64 ? 64 : 128;
#define FA_SMEM(T)                                                   \
  (int)sizeof(T) * (dp == 32   ? Tile<T, 32>::ELEMS                 \
                    : dp == 64 ? Tile<T, 64>::ELEMS : Tile<T, 128>::ELEMS)
  return bf16 ? FA_SMEM(__nv_bfloat16) : FA_SMEM(float);
#undef FA_SMEM
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
