// Flash attention for Hopper (sm_90a): the forward and its backward, as
// four kernels (K1-K4) over [B, T, heads, D] tensors addressed by strides,
// and the forward's tile loop with the softmax deleted (K6), the roofline's
// ceiling for K1.
//
// K1 fa_fwd       replaces _fa_kernel        (kungfu_tpu/ops/flash_attention.py:133)
// K2 fa_delta     replaces _fa_delta_kernel  (kungfu_tpu/ops/flash_attention.py:279)
// K3 fa_bwd_dq    replaces _fa_bwd_dq_kernel (kungfu_tpu/ops/flash_attention.py:317,
//                 with _block_p_ds :288)
// K4 fa_bwd_dkv   replaces _fa_bwd_dkv_kernel (kungfu_tpu/ops/flash_attention.py:344)
// K6 fa_nosoftmax replaces _nosoftmax_kernel (kungfu_tpu/benchmarks/roofline.py:123)
//
// Numerics are the TPU kernels':
//   * softmax in base 2: scores s = (q . k) * scale * log2(e), p = exp2(s - m);
//   * the causal mask is qpos >= kpos, both counted from 0 (also when
//     Tq != Tk); masked scores are -1e30, not -inf;
//   * products take the input dtype and accumulate in f32 (bf16 on the
//     tensor cores through wgmma m64nNk16; f32 with scalar f32 FMAs, so
//     there is no TF32 anywhere);
//   * p is rounded to the input dtype before P.V and before dv += P^T dO;
//     ds is rounded before dq += ds K and dk += ds^T q;
//   * each output is written once, in the input dtype; lse is emitted in
//     natural log, m / log2(e) + log(max(l, 1e-30)), as [B, H, Tq] f32;
//   * GQA: query head h reads KV head h / (H / KVH); K4 sums the g query
//     heads of a KV head in f32 and writes compact dk/dv once (what
//     _compact_kv_grad computes after the TPU kernel), with no atomics.
// The bf16 kernels take exp2 from ex2.approx.ftz (a p below 2^-126 is 0
// where exp2f gives a denormal).
//
// Tiles: 64 query rows by 64 keys, 4 warps of 16 rows each (the bf16 K4
// takes its queries QN at a time, BwdCfg below; the bf16 K1 and K6 take
// 64 rows per warpgroup and FwdCfg's warpgroups per block).  Rows past T
// are zero-filled on the way into shared memory and masked, so any T
// works (the TPU's fit_block multiple-of-8 rule does not apply).  The
// causal classifier causal_tile_class (the TPU's _causal_tile_classes)
// skips tiles above the diagonal, runs tiles below it unmasked and masks
// the tiles that straddle it or the ragged edge.
//
// What bounds them (the 470m training shapes, B=2, T=2048, H=16, KVH=4,
// D=64, causal, bf16): K1, K3 and K4 are bound by tensor-core operations
// (17-34 GFLOP against tens of MB), K2 by bytes (it reads O and dO once).
// K6 at the roofline's shapes (B=4, T=2048, 12 heads of 64 or 8 of 128,
// bf16) is bound by operations too (27-69 GFLOP against 50 MB).  At D=64
// K1 also meets the special-function unit: one exp2 per score against 256
// tensor-core flops per score, the two rates' ratio on this card.
//
// K2, redesigned for Hopper: 16-byte loads, a lane group per row and
// several rows a thread, every load in flight before the first FMA (its
// note at fa_delta below).
//
// The f32 K1/K3/K4 (the first version): the f32 products are scalar FMAs
// from synchronously staged shared-memory tiles; the online-softmax state
// and the accumulators stay in registers, and nothing of size [T, T] ever
// reaches device memory.
//
// The bf16 K1, K3, K4 and K6, redesigned for Hopper: each warpgroup
// issues its products as wgmma (s and dp with both operands in shared
// memory; P.V, dq, dk, dv with p / ds as the A operand straight from the
// accumulator registers); tiles arrive through cp.async rings, in the
// 128-byte-swizzled layout that wgmma reads, while earlier tiles are
// computed.  K1 and K6 share one tile loop (fwd_tile_loop): a block's
// warpgroups share its K/V ring, s = q K^T for the next k-tile and P.V for
// the last one go out as two wgmma groups together, and K1 folds the
// score scale into the exp2 argument's FMA.  K4 runs one block per
// (k-tile, query head), k-tile 0 first, and sums a KV head's query heads
// in a thread-block cluster through distributed shared memory, in a fixed
// order and without atomics.  What still bounds them: inside a warpgroup
// the chain s -> p -> products is serial (K1 overlaps its softmax with
// the in-flight P.V only at D=128, where registers allow; K3 only p with
// dp), so the tensor cores wait on exp2 and the element-wise work, which
// only the other warpgroups on the SM hide; the products with both
// operands in shared memory at N=64 read as many shared-memory bytes as
// the tensor cores can take; K3 and K4 both recompute s and dp (7
// products where one fused kernel would do 5).  Left for later: TMA loads
// and warp specialisation (a producer warp, consumer warpgroups taking
// turns through named barriers), and a persistent grid that walks the
// (q-tile, head) items longest first, so one item's epilogue overlaps the
// next one's loads.
//
// Built by kungfu_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLog2e = 0.6931471805599453f;
constexpr int kBQ = 64;       // query rows per tile (4 warps x 16)
constexpr int kBK = 64;       // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// cp.async ring depth of the bf16 K3/K4: 2, 3 and 4 stages measured the
// same, so the next tile's copy overlaps the current tile's products
constexpr int kStages = 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Row padding of a shared tile, in elements: 16 bytes keeps every row
// 16-byte aligned and shifts consecutive rows by four banks.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *out, *dq, *dk, *dv;
  float* lse;             // K1 output [B, H, Tq] (may be null)
  const float* lse_in;    // K3/K4 input [B, H, Tq]
  const float* delta;     // K3/K4 input [B, H, Tq]
  const float* dlse;      // K2 input [B, H, Tq] (may be null)
  float* delta_out;       // K2 output [B, H, Tq]
  long long qs[3], ks[3], vs[3], os[3], dos[3];  // strides (b, t, head)
  int B, H, KVH, Tq, Tk, causal;
  float scale;            // 1 / sqrt(D)
};

// The TPU's _causal_tile_classes, once for all kernels: `below` = every
// key of the tile visible to every query of it, `on_diag` = the tile
// straddles the diagonal, `visible` = any pair visible.
struct TileClass {
  bool visible, below, on_diag;
};

__device__ __forceinline__ TileClass causal_tile_class(int iq, int ik) {
  const int q_lo = iq * kBQ, q_hi = q_lo + kBQ - 1;
  const int k_lo = ik * kBK, k_hi = k_lo + kBK - 1;
  TileClass c;
  c.visible = k_lo <= q_hi;
  c.below = k_hi <= q_lo;
  c.on_diag = c.visible && (k_hi > q_lo);
  return c;
}

// Whether a tile needs the elementwise mask: it straddles the causal
// diagonal, or it reaches past the end of the queries or the keys.
__device__ __forceinline__ bool tile_masked(const Params& p, int iq, int ik) {
  return (p.causal && causal_tile_class(iq, ik).on_diag) ||
         (iq + 1) * kBQ > p.Tq || (ik + 1) * kBK > p.Tk;
}

__device__ __forceinline__ bool pair_visible(const Params& p, int qpos,
                                             int kpos) {
  return qpos < p.Tq && kpos < p.Tk && (!p.causal || qpos >= kpos);
}

// Stage 64 rows [t0, t0 + 64) of one head into shared memory (row stride
// D + pad), zero-filling rows at or past `T`; 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long st,
                                          int t0, int T_len) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int LD = D + pad<T>();
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T_len)
      val = reinterpret_cast<const uint4*>(g + (t0 + r) * st)[c];
    reinterpret_cast<uint4*>(s + r * LD)[c] = val;
  }
}

// A shared-memory matrix seen as X(m, k) = p[m * SM + k * SK].
template <typename T, int SM, int SK>
struct Mat {
  const T* p;
  __device__ __forceinline__ float at(int m, int k) const {
    return to_f(p[m * SM + k * SK]);
  }
};

// One warp: C[16, 8 * NT] += A[16, K] . B[K, 8 * NT] in f32, with A
// given as A(m, k) and B as B(n, k), by scalar FMAs (the f32 kernels; every
// bf16 product is a wgmma).  C lives in registers in the mma.sync m16n8
// accumulator layout, which is also wgmma's: lane (g = lane / 4, t = lane
// % 4) holds, for n-tile j, rows g and g + 8 at columns 8j + 2t and
// 8j + 2t + 1 as c[j] = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
template <typename T, int NT, int K, class MA, class MB>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const MA& a,
                                          const MB& b) {
  static_assert(std::is_same<T, float>::value, "f32 only");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a.at(g, k), x1 = a.at(g + 8, k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float y0 = b.at(8 * j + 2 * t, k);
      const float y1 = b.at(8 * j + 2 * t + 1, k);
      c[j][0] = fmaf(x0, y0, c[j][0]);
      c[j][1] = fmaf(x0, y1, c[j][1]);
      c[j][2] = fmaf(x1, y0, c[j][2]);
      c[j][3] = fmaf(x1, y1, c[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Reduce over the 4 lanes that share a row of the accumulator layout.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write a warp's [16, 8 * NT] accumulator into shared memory rows of
// stride LDS, rounded to T.
template <typename T, int NT, int LDS>
__device__ __forceinline__ void store_frag(T* s, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[(g + (e >> 1) * 8) * LDS + 8 * j + 2 * t + (e & 1)] =
          from_f<T>(c[j][e]);
}

// Write a warp's [16, D] accumulator rows [row0, row0 + 16) to a
// contiguous-D output row by row (row stride `st`), rows < T_len only.
template <typename T, int NT>
__device__ __forceinline__ void write_rows(T* out, long long st, int row0,
                                           int T_len, const float (&c)[NT][4],
                                           float mul0, float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= T_len) continue;
    const float mul = half ? mul1 : mul0;
    T* dst = out + row * st;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float lo = c[j][2 * half] * mul, hi = c[j][2 * half + 1] * mul;
      if constexpr (std::is_same<T, bf16>::value) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) = v;
      } else {
        dst[8 * j + 2 * t] = lo;
        dst[8 * j + 2 * t + 1] = hi;
      }
    }
  }
}

// ------------------------------------------- Hopper primitives (bf16 only)
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// cp.async, 16 bytes (cache-global) or 4 bytes; a source that is not
// `in` reads nothing and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Columns [16 kk, 16 kk + 16) of a warp's [16, 8 NT] accumulator, rounded
// to bf16, as the A fragment of the next product: the m16n8 accumulator
// layout of n-tiles 2kk and 2kk + 1 is the m16n8k16 A layout.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Whether the (query span, key span) block needs the elementwise mask;
// only called for spans with a visible pair.
__device__ __forceinline__ bool span_masked(const Params& p, int q_lo, int nq,
                                            int k_lo, int nk) {
  return (p.causal && k_lo + nk - 1 > q_lo) || q_lo + nq > p.Tq ||
         k_lo + nk > p.Tk;
}

// ------------------------------------- wgmma (bf16 K1, K3, K4 and K6)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// what cp.async wrote (the generic proxy) becomes visible to wgmma's
// reads of shared memory (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accesses to d across a wgmma's window
template <int NT>
__device__ __forceinline__ void reg_fence(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// wgmma.mma_async m64nNk16: bf16 in, f32 accumulators d[N / 8][4] in the
// m16n8 layout of each warp's 16 rows (warp w of the warpgroup holds rows
// 16w to 16w + 15).  ss: A and B from shared memory by descriptor, both
// K-major (s and dp: N = 64 or K4's q-tile width 32); rs: A from
// registers (each warp's m16n8k16 A fragment) and B from shared memory,
// MN-major, imm-trans-b = 1 (P.V, dq, dk, dv: N = D).  acc = 0 overwrites
// d.
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[4][4], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// A wgmma tile of ROWS rows by D bf16 columns: D / 64 blocks of ROWS rows
// of 128 bytes; 16-byte chunk c of a row (c < 8 within its block) is
// stored at chunk c ^ (row % 8): the 128-byte swizzle, each block 1024-byte
// aligned.  The same tile is a K-major operand (rows = M or N, columns =
// k) and an MN-major one (rows = k, columns = N).  The block's NT threads
// share the copies.
template <int D, int ROWS, int NT = kThreads>
__device__ __forceinline__ void load_tile_sw128(bf16* s, const bf16* g,
                                                long long st, int t0,
                                                int T_len) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = t0 + r < T_len;
    cp_async16(s + (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3),
               g + (in ? (t0 + r) * st : 0) + c * 8, in);
  }
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* ptr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(ptr) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1)
                                                     << 62;
}
// K-major operand: columns [k0, k0 + 16) of every row (8-row groups 1024
// bytes apart).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const bf16* s, int k0) {
  return sw128_desc(s + (k0 >> 6) * ROWS * 64 + (k0 & 63), 16, 1024);
}
// MN-major operand: rows [r0, r0 + 16) as k, every column as n (64-column
// blocks ROWS * 128 bytes apart).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const bf16* s, int r0) {
  return sw128_desc(s + r0 * 64, ROWS * 128, 1024);
}

// desc_k<ROWS>(s, k0) - desc_k<ROWS>(s, 0) and desc_mn<ROWS>(s, r0) -
// desc_mn<ROWS>(s, 0): the start address moves in 16-byte units
template <int ROWS>
__host__ __device__ constexpr uint32_t desc_k_off(int k0) {
  return (k0 >> 6) * ROWS * 8 + ((k0 & 63) >> 3);
}
__host__ __device__ constexpr uint32_t desc_mn_off(int r0) { return r0 * 8; }
// base + off, with base opaque to the compiler at this point: a loop then
// keeps one descriptor live, not one per k-step and ring slot
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t off) {
  asm volatile("" : "+l"(base));
  return base + off;
}

// 2^x by the special-function unit (ex2.approx.ftz: results below 2^-126
// flush to 0, where exp2f returns a denormal)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* ptr) {
  return ptr + ((1024 - (smem_addr(ptr) & 1023)) & 1023);
}

// ------------------------------------------------------------ K1 (f32)
// The first version's K1, kept for f32 (the correctness cases): one
// thread block per (q-tile, b * H + h); loops over the visible k-tiles
// with the online-softmax state (m, l) and the output accumulator in
// registers.  Tiles are visited from k = 0 up, so a row's running max is
// finite after the first tile (key 0 is visible to every query).
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_f32(const Params p, float scale_log2) {
  using T = float;
  constexpr int LD = D + pad<T>(), LP = kBK + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBQ * LD;
  T* sV = sK + kBK * LD;
  T* sP = sV + kBK * LD;

  const int n_q = (p.Tq + kBQ - 1) / kBQ;
  const int iq = n_q - 1 - blockIdx.x;       // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];

  load_tile<T, D>(sQ, qg, p.qs[1], iq * kBQ, p.Tq);

  float acc[D / 8][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int n_k = (p.Tk + kBK - 1) / kBK;
  int k_end = n_k;
  if (p.causal) {
    const int last = (iq * kBQ + kBQ - 1) / kBK;   // last visible tile
    k_end = last + 1 < n_k ? last + 1 : n_k;
  }
  const int row_base = iq * kBQ + warp * 16 + g;
  for (int ik = 0; ik < k_end; ++ik) {
    __syncthreads();                 // the previous tile is consumed
    load_tile<T, D>(sK, kg, p.ks[1], ik * kBK, p.Tk);
    load_tile<T, D>(sV, vg, p.vs[1], ik * kBK, p.Tk);
    __syncthreads();
    float s[kBK / 8][4];
    zero(s);
    warp_gemm<T, kBK / 8, D>(s, Mat<T, LD, 1>{sQ + warp * 16 * LD},
                             Mat<T, LD, 1>{sK});
    const bool masked = tile_masked(p, iq, ik);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked &&
            !pair_visible(p, row_base + (e >> 1) * 8,
                          ik * kBK + 8 * j + 2 * t + (e & 1)))
          x = kNegInf;
        s[j][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = corr * l[r] + quad_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
    // p, rounded to T, through this warp's rows of sP into the PV product
    store_frag<T, kBK / 8, LP>(sP + warp * 16 * LP, s);
    __syncwarp();
    warp_gemm<T, D / 8, kBK>(acc, Mat<T, LP, 1>{sP + warp * 16 * LP},
                             Mat<T, 1, LD>{sV});
    __syncwarp();
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  T* og = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[2];
  write_rows<T, D / 8>(og, p.os[1], iq * kBQ + warp * 16, p.Tq, acc,
                       1.f / l0, 1.f / l1);
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Tq;
    if (row_base < p.Tq) lse[row_base] = m[0] * kInvLog2e + logf(l0);
    if (row_base + 8 < p.Tq) lse[row_base + 8] = m[1] * kInvLog2e + logf(l1);
  }
}

// ------------------------------------------------------------------ K2
// delta[b, h, t] = sum_d dO * O in f32, minus dlse when given.  Bound by
// bytes: O and dO are read once (17 MB at the 470m shapes), nothing is
// reused.  So the loads are 16 bytes wide and many are in flight: a row
// is read by a group of D / VEC lanes (8 at D64 bf16, 16 at D128), one
// load of O and one of dO a lane, and the group sums by shuffles (3-4
// steps); consecutive groups take consecutive rows of one head, so a
// warp's delta stores are one contiguous run.  Measured slower: 2, 4 or 8
// rows a thread with all their loads issued first (fewer warps to hide
// the loads' latency), and rows in the inputs' memory order (h fastest).
// The order of the sums is fixed: the same bits on every call.
constexpr int kDeltaThreads = 256;

template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, bf16>::value) {
      const float2 u = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + i));
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(y + i));
      s = fmaf(u.x, v.x, s);
      s = fmaf(u.y, v.y, s);
    } else {
      s = fmaf(__uint_as_float(x[i]), __uint_as_float(y[i]), s);
    }
  }
  return s;
}

// Grid: one lane group per row, kDeltaThreads threads a block.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads) fa_delta(const Params p) {
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int LPR = D / VEC;           // lanes per row
  static_assert(LPR <= 32 && 32 % LPR == 0, "a row within one warp");
  const int rows = p.B * p.H * p.Tq;
  const int sub = threadIdx.x % LPR;
  const int row = (blockIdx.x * kDeltaThreads + threadIdx.x) / LPR;
  float s = 0.f;
  if (row < rows) {
    const int bh = row / p.Tq, t = row - bh * p.Tq;
    const int b = bh / p.H, h = bh - b * p.H;
    const T* op = static_cast<const T*>(p.o) + b * p.os[0] + t * p.os[1] +
                  h * p.os[2] + sub * VEC;
    const T* dp = static_cast<const T*>(p.dout) + b * p.dos[0] +
                  t * p.dos[1] + h * p.dos[2] + sub * VEC;
    s = dot16<T>(__ldg(reinterpret_cast<const uint4*>(op)),
                 __ldg(reinterpret_cast<const uint4*>(dp)));
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (sub == 0 && row < rows)
    p.delta_out[row] = p.dlse != nullptr ? s - p.dlse[row] : s;
}

// Recompute one (q-tile, k-tile) pair for this warp's 16 query rows:
// s = q k^T, dp = dO v^T; then p = exp2(s * scale * log2e - lse * log2e)
// (0 where masked) into `s`, and ds = p (dp - delta) scale into `dp`.
template <typename T, int D>
__device__ __forceinline__ void block_p_ds(
    const Params& p, float (&s)[kBK / 8][4], float (&dp)[kBK / 8][4],
    const T* sQw, const T* sdOw, const T* sK, const T* sV, int iq, int ik,
    int row_base, const float (&lse2)[2], const float (&dl)[2],
    float scale_log2) {
  constexpr int LD = D + pad<T>();
  const int t = (threadIdx.x & 31) & 3;
  zero(s);
  zero(dp);
  warp_gemm<T, kBK / 8, D>(s, Mat<T, LD, 1>{sQw}, Mat<T, LD, 1>{sK});
  warp_gemm<T, kBK / 8, D>(dp, Mat<T, LD, 1>{sdOw}, Mat<T, LD, 1>{sV});
  const bool masked = tile_masked(p, iq, ik);
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s[j][e] * scale_log2;
      if (masked && !pair_visible(p, row_base + 8 * r,
                                  ik * kBK + 8 * j + 2 * t + (e & 1)))
        x = kNegInf;
      const float pr = exp2f(x - lse2[r]);
      s[j][e] = pr;
      dp[j][e] = pr * (dp[j][e] - dl[r]) * p.scale;
    }
}

// ------------------------------------------------------------ K3 (f32)
// The first version's K3, kept for f32 (the correctness cases): one
// thread block per (q-tile, b * H + h); loops over the visible k-tiles;
// dq stays in f32 registers and is written once.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_f32(const Params p, float scale_log2) {
  using T = float;
  constexpr int LD = D + pad<T>(), LP = kBK + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kBQ * LD;
  T* sK = sdO + kBQ * LD;
  T* sV = sK + kBK * LD;
  T* sdS = sV + kBK * LD;

  const int n_q = (p.Tq + kBQ - 1) / kBQ;
  const int iq = n_q - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* dog = static_cast<const T*>(p.dout) + b * p.dos[0] +
                 h * p.dos[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  load_tile<T, D>(sQ, qg, p.qs[1], iq * kBQ, p.Tq);
  load_tile<T, D>(sdO, dog, p.dos[1], iq * kBQ, p.Tq);

  const int row_base = iq * kBQ + warp * 16 + g;
  const long long rs = (static_cast<long long>(b) * p.H + h) * p.Tq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + 8 * r;
    lse2[r] = row < p.Tq ? p.lse_in[rs + row] * kLog2e : 0.f;
    dl[r] = row < p.Tq ? p.delta[rs + row] : 0.f;
  }

  float dq[D / 8][4];
  zero(dq);
  const int n_k = (p.Tk + kBK - 1) / kBK;
  int k_end = n_k;
  if (p.causal) {
    const int last = (iq * kBQ + kBQ - 1) / kBK;
    k_end = last + 1 < n_k ? last + 1 : n_k;
  }
  for (int ik = 0; ik < k_end; ++ik) {
    __syncthreads();
    load_tile<T, D>(sK, kg, p.ks[1], ik * kBK, p.Tk);
    load_tile<T, D>(sV, vg, p.vs[1], ik * kBK, p.Tk);
    __syncthreads();
    float s[kBK / 8][4], ds[kBK / 8][4];
    block_p_ds<T, D>(p, s, ds, sQ + warp * 16 * LD, sdO + warp * 16 * LD,
                     sK, sV, iq, ik, row_base, lse2, dl, scale_log2);
    store_frag<T, kBK / 8, LP>(sdS + warp * 16 * LP, ds);
    __syncwarp();
    warp_gemm<T, D / 8, kBK>(dq, Mat<T, LP, 1>{sdS + warp * 16 * LP},
                             Mat<T, 1, LD>{sK});
    __syncwarp();
  }
  T* dqg = static_cast<T*>(p.dq) +
           static_cast<long long>(b) * p.Tq * p.H * D + h * D;
  write_rows<T, D / 8>(dqg, static_cast<long long>(p.H) * D,
                       iq * kBQ + warp * 16, p.Tq, dq, 1.f, 1.f);
}

// ------------------------------------------------------------ K4 (f32)
// The first version's K4, kept for f32 (the correctness cases).  One
// thread block per (k-tile, b * KVH + kv head); loops over the g
// query heads of the KV head and their visible q-tiles.  Per pair: the
// warps first own 16 query rows each and write p and ds (rounded to T) to
// shared memory; then they own 16 keys each and accumulate dv += p^T dO,
// dk += ds^T q in f32 registers.  Compact dk/dv are written once.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_f32(const Params p, float scale_log2) {
  using T = float;
  constexpr int LD = D + pad<T>(), LP = kBK + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBK * LD;
  T* sQ = sV + kBK * LD;
  T* sdO = sQ + kBQ * LD;
  T* sP = sdO + kBQ * LD;
  T* sdS = sP + kBQ * LP;

  const int n_k = (p.Tk + kBK - 1) / kBK;
  const int ik = n_k - 1 - blockIdx.x;
  const int b = blockIdx.y / p.KVH, kvh = blockIdx.y % p.KVH;
  const int G = p.H / p.KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  load_tile<T, D>(sK, kg, p.ks[1], ik * kBK, p.Tk);
  load_tile<T, D>(sV, vg, p.vs[1], ik * kBK, p.Tk);

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const int n_q = (p.Tq + kBQ - 1) / kBQ;
  // first q-tile whose last row reaches this tile's first key
  const int q_start = p.causal ? (ik * kBK) / kBQ : 0;
  for (int hj = 0; hj < G; ++hj) {
    const int h = kvh * G + hj;
    const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
    const T* dog = static_cast<const T*>(p.dout) + b * p.dos[0] +
                   h * p.dos[2];
    const long long rs = (static_cast<long long>(b) * p.H + h) * p.Tq;
    for (int iq = q_start; iq < n_q; ++iq) {
      __syncthreads();               // sQ/sdO/sP/sdS are consumed
      load_tile<T, D>(sQ, qg, p.qs[1], iq * kBQ, p.Tq);
      load_tile<T, D>(sdO, dog, p.dos[1], iq * kBQ, p.Tq);
      __syncthreads();
      const int row_base = iq * kBQ + warp * 16 + g;
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + 8 * r;
        lse2[r] = row < p.Tq ? p.lse_in[rs + row] * kLog2e : 0.f;
        dl[r] = row < p.Tq ? p.delta[rs + row] : 0.f;
      }
      {
        float s[kBK / 8][4], ds[kBK / 8][4];
        block_p_ds<T, D>(p, s, ds, sQ + warp * 16 * LD, sdO + warp * 16 * LD,
                         sK, sV, iq, ik, row_base, lse2, dl, scale_log2);
        store_frag<T, kBK / 8, LP>(sP + warp * 16 * LP, s);
        store_frag<T, kBK / 8, LP>(sdS + warp * 16 * LP, ds);
      }
      __syncthreads();               // every warp's rows of sP/sdS
      // rows of the products are keys: A(key, q) = sP[q][key]
      warp_gemm<T, D / 8, kBQ>(dv, Mat<T, 1, LP>{sP + warp * 16},
                               Mat<T, 1, LD>{sdO});
      warp_gemm<T, D / 8, kBQ>(dk, Mat<T, 1, LP>{sdS + warp * 16},
                               Mat<T, 1, LD>{sQ});
    }
  }
  const long long ob = static_cast<long long>(b) * p.Tk * p.KVH * D +
                       static_cast<long long>(kvh) * D;
  const long long ost = static_cast<long long>(p.KVH) * D;
  write_rows<T, D / 8>(static_cast<T*>(p.dk) + ob, ost,
                       ik * kBK + warp * 16, p.Tk, dk, 1.f, 1.f);
  write_rows<T, D / 8>(static_cast<T*>(p.dv) + ob, ost,
                       ik * kBK + warp * 16, p.Tk, dv, 1.f, 1.f);
}

// The end of K4 (bf16): each block of a cluster holds its query heads'
// dk and dv partials for one k-tile in registers.  They go to its shared
// memory (f32 [2][64][D + 8]), the cluster meets, and rank r sums rows
// [r R, r R + R) over the ranks in rank order through distributed shared
// memory, rounds once and writes them; a second meeting keeps every
// block's shared memory alive until the others have read it.  The order
// of the sums is fixed, so the result is the same bits on every run.
template <int D>
__device__ __forceinline__ void cluster_sum_write(
    const float (&dk)[D / 8][4], const float (&dv)[D / 8][4],
    unsigned char* smem, const Params& p, int b, int kvh, int ik) {
  namespace cg = cooperative_groups;
  constexpr int LDP = D + 8;          // f32 row padding: no bank conflicts
  float* sP = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();                    // the staged tiles are consumed
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (warp * 16 + g + 8 * h) * LDP + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(sP + off) =
          make_float2(dk[j][2 * h], dk[j][2 * h + 1]);
      *reinterpret_cast<float2*>(sP + kBK * LDP + off) =
          make_float2(dv[j][2 * h], dv[j][2 * h + 1]);
    }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int C = static_cast<int>(cl.num_blocks());
  const int r = static_cast<int>(cl.block_rank());
  const int R = (kBK + C - 1) / C;
  constexpr int Q4 = D / 4;
  for (int i = threadIdx.x; i < 2 * R * Q4; i += kThreads) {
    const int which = i / (R * Q4), rem = i % (R * Q4);
    const int row = r * R + rem / Q4, c = (rem % Q4) * 4;
    const int key = ik * kBK + row;
    if (row >= kBK || key >= p.Tk) continue;
    const int off = which * kBK * LDP + row * LDP + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < C; ++src) {
      const float4 x =
          *reinterpret_cast<const float4*>(cl.map_shared_rank(sP, src) + off);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    bf16* out = static_cast<bf16*>(which ? p.dv : p.dk) +
                ((static_cast<long long>(b) * p.Tk + key) * p.KVH + kvh) * D +
                c;
    *reinterpret_cast<uint2*>(out) = u;
  }
  cl.sync();
}


// ------------------------------------------------------ K3 (bf16, wgmma)
// One block (one warpgroup: warp w owns query rows 16w to 16w + 15) per
// (q-tile, b * H + h), over the visible k-tiles; grid x = b * H + h, y =
// q-tiles from the last (the longest under the causal mask) down.  q and
// dO are staged once; K and V of the next k-tile stream in through a
// cp.async ring.  Per k-tile: s = q k^T and dp = dO v^T by
// wgmma from shared memory, as two groups so that p is computed while dp
// is in flight; ds = p (dp - delta) scale; dq += ds K with ds, rounded to
// bf16, as the A operand from registers and K MN-major.  dq stays in f32
// registers and is written once.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq(const Params p, float scale_log2) {
  constexpr int KS = D / 16, NK = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* sdO = sQ + kBQ * D;
  bf16* sKV = sdO + kBQ * D;   // stage s: K at s * 2 * kBK * D, V after

  const int n_q = (p.Tq + kBQ - 1) / kBQ;
  const int iq = n_q - 1 - blockIdx.y;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] +
                   kvh * p.ks[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] +
                   kvh * p.vs[2];
  const int n_k = (p.Tk + kBK - 1) / kBK;
  int k_end = n_k;
  if (p.causal) {
    const int last = (iq * kBQ + kBQ - 1) / kBK;
    k_end = last + 1 < n_k ? last + 1 : n_k;
  }
  auto stage_kv = [&](int ik) {   // K and V of k-tile ik into its stage
    bf16* sK = sKV + (ik % kStages) * 2 * kBK * D;
    load_tile_sw128<D, kBK>(sK, kg, p.ks[1], ik * kBK, p.Tk);
    load_tile_sw128<D, kBK>(sK + kBK * D, vg, p.vs[1], ik * kBK, p.Tk);
  };
  load_tile_sw128<D, kBQ>(sQ, static_cast<const bf16*>(p.q) + b * p.qs[0] +
                                  h * p.qs[2],
                          p.qs[1], iq * kBQ, p.Tq);
  load_tile_sw128<D, kBQ>(sdO, static_cast<const bf16*>(p.dout) +
                                   b * p.dos[0] + h * p.dos[2],
                          p.dos[1], iq * kBQ, p.Tq);
  for (int i = 0; i < kStages - 1; ++i) {   // the first k-tiles in flight
    if (i < k_end) stage_kv(i);
    cp_async_commit();
  }

  const int row_base = iq * kBQ + warp * 16 + g;
  const long long rs = (static_cast<long long>(b) * p.H + h) * p.Tq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + 8 * r;
    lse2[r] = row < p.Tq ? p.lse_in[rs + row] * kLog2e : 0.f;
    dl[r] = row < p.Tq ? p.delta[rs + row] : 0.f;
  }
  float dq[D / 8][4], s[NK][4], dp[NK][4];
  zero(dq);
  zero(s);
  zero(dp);
  for (int ik = 0; ik < k_end; ++ik) {
    // k-tile ik has landed, and every warp is done with k-tile ik - 1,
    // whose stage now takes k-tile ik + kStages - 1
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    if (ik + kStages - 1 < k_end) stage_kv(ik + kStages - 1);
    cp_async_commit();
    const bf16* sK = sKV + (ik % kStages) * 2 * kBK * D;
    const bf16* sV = sK + kBK * D;
    // s = q k^T and dp = dO v^T as two groups: p is computed while dp
    // is still in flight
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<kBK>::ss(s, desc_k<kBQ>(sQ, 16 * kk), desc_k<kBK>(sK, 16 * kk),
                     kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<kBK>::ss(dp, desc_k<kBQ>(sdO, 16 * kk),
                     desc_k<kBK>(sV, 16 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);
    const bool masked = tile_masked(p, iq, ik);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked && !pair_visible(p, row_base + 8 * (e >> 1),
                                    ik * kBK + 8 * j + 2 * t + (e & 1)))
          x = kNegInf;
        s[j][e] = fast_exp2(x - lse2[e >> 1]);
      }
    wgmma_wait<0>();
    reg_fence(dp);
    uint32_t a[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]) * p.scale;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a<NK>(a[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<D>::rs(dq, a[kk], desc_mn<kBK>(sK, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
  }
  cp_async_wait<0>();
  bf16* dqg = static_cast<bf16*>(p.dq) +
              static_cast<long long>(b) * p.Tq * p.H * D + h * D;
  write_rows<bf16, D / 8>(dqg, static_cast<long long>(p.H) * D,
                          iq * kBQ + warp * 16, p.Tq, dq, 1.f, 1.f);
}

// ------------------------------------------------------ K4 (bf16, wgmma)
// One block (one warpgroup: warp w owns keys 16w to 16w + 15) per
// (k-tile, query head).  The blocks of one KV head's g query heads form a
// thread-block cluster (at most 8; each rank takes g / C heads when g >
// 8) and sum their dk/dv through distributed shared memory at the end
// (cluster_sum_write).  Grid x = (b * KVH + kvh) * C + rank, y = k-tile:
// k-tile 0, which sees every q-tile under the causal mask, launches
// first.  K and V are staged once; q, dO, lse and delta of the next
// (query head, q-tile) item stream in through a cp.async ring.  The
// products are transposed, keys as rows: per item of QN queries s^T and
// dp^T, then p^T and ds^T in registers (lse and delta belong to the
// columns and are read from shared memory), then dv and dk.
template <int D, int QN, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    fa_bwd_dkv(const Params p, float scale_log2) {
  constexpr int KS = D / 16, NQ = QN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  // kStages stages of [q | dO] (QN rows each), then K, V, then kStages
  // stages of [lse | delta] (QN each)
  bf16* sQdO = reinterpret_cast<bf16*>(base);
  bf16* sK = sQdO + kStages * 2 * QN * D;
  bf16* sV = sK + kBK * D;
  float* sLD = reinterpret_cast<float*>(sV + kBK * D);

  const int ik = blockIdx.y;
  const int C = static_cast<int>(cooperative_groups::this_cluster()
                                     .num_blocks());
  const int rank = blockIdx.x % C, bk = blockIdx.x / C;
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const int G = p.H / p.KVH, per = G / C;   // query heads of this block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_q = (p.Tq + QN - 1) / QN;
  const int q_start = p.causal ? (ik * kBK) / QN : 0;
  const int n_vis = n_q > q_start ? n_q - q_start : 0;
  const int n_items = per * n_vis;     // (query head, q-tile) pairs
  // q, dO, lse and delta of item `it` (head rank * per + it / n_vis,
  // q-tile q_start + it % n_vis) into stage it % kStages
  auto stage_item = [&](int it) {
    const int h = kvh * G + rank * per + it / n_vis;
    const int iq = q_start + it % n_vis;
    bf16* sQ = sQdO + (it % kStages) * 2 * QN * D;
    float* sL = sLD + (it % kStages) * 2 * QN;
    load_tile_sw128<D, QN>(sQ, static_cast<const bf16*>(p.q) + b * p.qs[0] +
                                   h * p.qs[2],
                           p.qs[1], iq * QN, p.Tq);
    load_tile_sw128<D, QN>(sQ + QN * D,
                           static_cast<const bf16*>(p.dout) + b * p.dos[0] +
                               h * p.dos[2],
                           p.dos[1], iq * QN, p.Tq);
    const long long rs = (static_cast<long long>(b) * p.H + h) * p.Tq;
    for (int i = threadIdx.x; i < QN; i += kThreads) {
      const int row = iq * QN + i;
      const bool in = row < p.Tq;
      cp_async4(sL + i, p.lse_in + rs + (in ? row : 0), in);
      cp_async4(sL + QN + i, p.delta + rs + (in ? row : 0), in);
    }
  };
  load_tile_sw128<D, kBK>(sK, static_cast<const bf16*>(p.k) + b * p.ks[0] +
                                  kvh * p.ks[2],
                          p.ks[1], ik * kBK, p.Tk);
  load_tile_sw128<D, kBK>(sV, static_cast<const bf16*>(p.v) + b * p.vs[0] +
                                  kvh * p.vs[2],
                          p.vs[1], ik * kBK, p.Tk);
  for (int i = 0; i < kStages - 1; ++i) {   // the first items in flight
    if (i < n_items) stage_item(i);
    cp_async_commit();
  }

  float dk[D / 8][4], dv[D / 8][4], st[NQ][4], dpt[NQ][4];
  zero(dk);
  zero(dv);
  zero(st);
  zero(dpt);
  const int key0 = ik * kBK + warp * 16 + g;   // this lane's keys: +0, +8
  for (int it = 0; it < n_items; ++it) {
    // item it has landed, and every warp is done with item it - 1, whose
    // stage now takes item it + kStages - 1
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    if (it + kStages - 1 < n_items) stage_item(it + kStages - 1);
    cp_async_commit();
    const int iq = q_start + it % n_vis;
    const bf16* sQ = sQdO + (it % kStages) * 2 * QN * D;
    const bf16* sdO = sQ + QN * D;
    const float* sL = sLD + (it % kStages) * 2 * QN;   // lse, then delta
    const float* sDl = sL + QN;
    // s^T = K q^T and dp^T = V dO^T (keys are the rows) as two groups:
    // p^T is computed while dp^T is in flight.  Then dv += p^T dO and
    // dk += ds^T q, with p^T and ds^T rounded to bf16 as the A operand
    // from registers and dO, q MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<QN>::ss(st, desc_k<kBK>(sK, 16 * kk), desc_k<QN>(sQ, 16 * kk),
                    kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<QN>::ss(dpt, desc_k<kBK>(sV, 16 * kk), desc_k<QN>(sdO, 16 * kk),
                    kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(st);
    const bool masked = span_masked(p, iq * QN, QN, ik * kBK, kBK);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = st[j][e] * scale_log2;
        if (masked && !pair_visible(p, iq * QN + 8 * j + 2 * t + (e & 1),
                                    key0 + 8 * (e >> 1)))
          x = kNegInf;
        st[j][e] = fast_exp2(x - ((e & 1) ? l2.y : l2.x) * kLog2e);
      }
    }
    wgmma_wait<0>();
    reg_fence(dpt);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(sDl + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[j][e] =
            st[j][e] * (dpt[j][e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
    }
    uint32_t ap[QN / 16][4], as[QN / 16][4];
#pragma unroll
    for (int kq = 0; kq < QN / 16; ++kq) {
      acc_to_a<NQ>(ap[kq], st, kq);
      acc_to_a<NQ>(as[kq], dpt, kq);
    }
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < QN / 16; ++kq)
      Wgmma<D>::rs(dv, ap[kq], desc_mn<QN>(sdO, 16 * kq));
#pragma unroll
    for (int kq = 0; kq < QN / 16; ++kq)
      Wgmma<D>::rs(dk, as[kq], desc_mn<QN>(sQ, 16 * kq));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
  }
  cp_async_wait<0>();
  cluster_sum_write<D>(dk, dv, base, p, b, kvh, ik);
}

// --------------------------------------------- K1 and K6 (bf16, wgmma)
// The online softmax of one k-tile for this thread's two query rows (g and
// g + 8 of its warp's 16, row_base + 8 r), in base 2: x = s * scale *
// log2(e), -1e30 where `masked` and the pair is not visible; m_new = max(m,
// max x); s becomes p = exp2(x - m_new) in place; m and l move on, and
// corr[r] = exp2(m - m_new) is the factor the row's output accumulator
// must take.  Unmasked tiles fold the scale into one FMA per score (the
// row max of s * c is c times the row max of s, c > 0).
__device__ __forceinline__ void online_softmax(const Params& p,
                                               float (&s)[kBK / 8][4],
                                               int row_base, int k0,
                                               bool masked, float scale_log2,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
  const int t = threadIdx.x & 3;
  float c = scale_log2;
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = pair_visible(p, row_base + 8 * (e >> 1),
                               k0 + 8 * j + 2 * t + (e & 1))
                      ? s[j][e] * scale_log2
                      : kNegInf;
    c = 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx) * c);
    corr[r] = fast_exp2(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][2 * r] = fast_exp2(fmaf(s[j][2 * r], c, -m_new));
      s[j][2 * r + 1] = fast_exp2(fmaf(s[j][2 * r + 1], c, -m_new));
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = corr[r] * l[r] + quad_sum(sum);
    m[r] = m_new;
  }
}

// keep the compiler from reusing A-fragment registers that an issued
// wgmma may still be reading
template <int N>
__device__ __forceinline__ void reg_fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The forward's tile loop for bf16, K1 (SOFTMAX) and K6 (without).  One
// block per (q-tile of 64 WG rows, b * H + h) holds WG warpgroups;
// warpgroup w owns the tile's rows 64w to 64w + 63 (its warp v rows 16v
// to 16v + 15).  Grid x = b * H + h, y = q-tiles from the last (the
// longest under the causal mask) down.  q is staged once; K and V stream
// through rings of two slots each, in the 128-byte-swizzled layout wgmma
// reads, shared by the warpgroups: at the top of k-tile ik the copies of
// K[ik + 1] and V[ik] start, and they have the whole of k-tile ik's work
// to land.  Per k-tile each warpgroup issues two wgmma groups together:
// s = q K[ik]^T (q and K K-major from shared memory) and acc += p[ik - 1]
// V[ik - 1] (p, rounded to bf16, as the register A operand straight from
// the accumulator layout; V MN-major).  With OVERLAP the softmax of s runs
// while the PV product is in flight (without, after it); then acc takes
// its rows' correction factors (only rows whose max rose) and p[ik] is
// packed for the next k-tile.  K6 packs
// s itself: no scale, no mask, no softmax.  Under causal each warpgroup
// stops after its own last visible 64-key block (my_end), so K6 skips
// whole 64 x 64 blocks and computes the diagonal ones whole (the JAX
// kernel's result at 64 x 64 blocks), whatever WG is; K1 computes a
// warpgroup's block past its last one, all masked, as p = 0.  Only tiles
// that straddle the diagonal or the ragged edge are masked (span_masked);
// rows past T are zero-filled on the way in.
template <int D, bool SOFTMAX, int WG, bool OVERLAP>
__device__ __forceinline__ void fwd_tile_loop(const Params& p,
                                              float scale_log2) {
  constexpr int KS = D / 16, NK = kBK / 8, KP = kBK / 16;
  constexpr int NT = WG * kThreads, ROWS = WG * kBQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* sK = sQ + ROWS * D;           // two slots of kBK x D
  bf16* sV = sK + 2 * kBK * D;        // two slots of kBK x D

  const int n_q = (p.Tq + ROWS - 1) / ROWS;
  const int iq = n_q - 1 - blockIdx.y;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] +
                   kvh * p.ks[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] +
                   kvh * p.vs[2];
  const bf16* sQw = sQ + wg * kBQ * D;   // this warpgroup's 64 rows
  const int q_lo = iq * ROWS + wg * kBQ;
  // the k-tiles of the block, and of this warpgroup's rows
  const int n_k = (p.Tk + kBK - 1) / kBK;
  int k_end = n_k, my_end = n_k;
  // K1 needs no skip (its mask zeroes p past a warpgroup's last block),
  // and one warpgroup's last block is the block's
  constexpr bool all_on = SOFTMAX || WG == 1;
  if (p.causal) {
    const int last = (iq * ROWS + ROWS - 1) / kBK;
    const int my_last = (q_lo + kBQ - 1) / kBK;
    k_end = last + 1 < n_k ? last + 1 : n_k;
    my_end = my_last + 1 < n_k ? my_last + 1 : n_k;
  }
  auto slot = [](bf16* ring, int ik) { return ring + (ik & 1) * kBK * D; };
  // wgmma descriptors of q, and of the first K and V slots; a slot is
  // kBK * D * 2 bytes on
  const uint64_t q_desc = desc_k<kBQ>(sQw, 0), k_desc = desc_k<kBK>(sK, 0),
                 v_desc = desc_mn<kBK>(sV, 0);
  constexpr uint32_t kSlotDesc = kBK * D * 2 / 16;
  auto load_k = [&](int ik) {
    load_tile_sw128<D, kBK, NT>(slot(sK, ik), kg, p.ks[1], ik * kBK, p.Tk);
  };
  auto load_v = [&](int ik) {
    load_tile_sw128<D, kBK, NT>(slot(sV, ik), vg, p.vs[1], ik * kBK, p.Tk);
  };
  const int row_base = q_lo + warp * 16 + g;
  float acc[D / 8][4], s[NK][4], m[2] = {kNegInf, kNegInf},
                                 l[2] = {0.f, 0.f}, corr[2];
  uint32_t a[KP][4];
  zero(acc);
  // s = q K[ik]^T, issued as one wgmma group
  auto issue_s = [&](int ik) {
    const uint32_t slot_off = (ik & 1) * kSlotDesc;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<kBK>::ss(s, desc_at(q_desc, desc_k_off<kBQ>(16 * kk)),
                     desc_at(k_desc, slot_off + desc_k_off<kBK>(16 * kk)),
                     kk);
    wgmma_commit();
  };
  // acc += a V[ik], issued as one wgmma group
  auto issue_pv = [&](int ik) {
    const uint32_t slot_off = (ik & 1) * kSlotDesc;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      Wgmma<D>::rs(acc, a[kk],
                   desc_at(v_desc, slot_off + desc_mn_off(16 * kk)));
    wgmma_commit();
  };
  auto softmax = [&](int ik) {
    if constexpr (SOFTMAX)
      online_softmax(p, s, row_base, ik * kBK,
                     span_masked(p, q_lo, kBQ, ik * kBK, kBK), scale_log2, m,
                     l, corr);
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) acc_to_a<NK>(a[kk], s, kk);
  };

  if (k_end > 0) {
    for (int w = 0; w < WG; ++w)
      load_tile_sw128<D, kBQ, NT>(
          sQ + w * kBQ * D,
          static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[2], p.qs[1],
          iq * ROWS + w * kBQ, p.Tq);
    load_k(0);
    cp_async_commit();
    if (k_end > 1) load_k(1);
    load_v(0);
    cp_async_commit();
    cp_async_wait<1>();               // q and K[0] have landed
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    reg_fence(s);
    softmax(0);                       // acc is 0: nothing to rescale
    pack();
    for (int ik = 1; ik < k_end; ++ik) {
      // K[ik] and V[ik - 1] have landed, and every warp is done with
      // K[ik - 1] and V[ik - 2], whose slots take K[ik + 1] and V[ik]
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();
      if (ik + 1 < k_end) load_k(ik + 1);
      load_v(ik);
      cp_async_commit();
      const bool on = all_on || ik < my_end;
      reg_fence(acc);
      wgmma_fence();
      if (on) issue_s(ik);
      issue_pv(ik - 1);
      if (on) {
        // s is ready; with OVERLAP p[ik - 1] V is still in flight
        wgmma_wait<OVERLAP ? 1 : 0>();
        reg_fence(s);
        softmax(ik);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence_a(a);
      if (on) {
        if constexpr (SOFTMAX) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (corr[r] != 1.f) {     // the row max rose
#pragma unroll
              for (int j = 0; j < D / 8; ++j) {
                acc[j][2 * r] *= corr[r];
                acc[j][2 * r + 1] *= corr[r];
              }
            }
          }
        }
        pack();
      }
    }
    cp_async_wait<0>();               // V[k_end - 1] has landed
    fence_async_smem();
    __syncthreads();
    if (all_on || k_end <= my_end) {
      reg_fence(acc);
      wgmma_fence();
      issue_pv(k_end - 1);
      wgmma_wait<0>();
      reg_fence(acc);
    }
  }

  bf16* og = static_cast<bf16*>(p.out) + b * p.os[0] + h * p.os[2];
  if constexpr (SOFTMAX) {
    const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
    write_rows<bf16, D / 8>(og, p.os[1], q_lo + warp * 16, p.Tq, acc,
                            1.f / l0, 1.f / l1);
    if (p.lse != nullptr && t == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Tq;
      if (row_base < p.Tq) lse[row_base] = m[0] * kInvLog2e + logf(l0);
      if (row_base + 8 < p.Tq)
        lse[row_base + 8] = m[1] * kInvLog2e + logf(l1);
    }
  } else {
    write_rows<bf16, D / 8>(og, p.os[1], q_lo + warp * 16, p.Tq, acc, 1.f,
                            1.f);
  }
}

// The bf16 K1 and K6 choices per head_dim: warpgroups per block (each
// owns 64 query rows and shares the block's K/V ring), the blocks per SM
// that __launch_bounds__ holds registers to, and whether K1's softmax
// overlaps the in-flight PV product (which keeps p[ik - 1] live beside s).
// At D = 64 two warpgroups a block halve the K/V staging per query row and
// fit 2 blocks per SM in 128 registers only without the overlap (with it
// ptxas spills 28 bytes; it bought 1% there, since 4 warpgroups per SM
// already overlap each other).  At D = 128 shared memory (81 KB a block)
// allows 2 one-warpgroup blocks, registers allow the overlap, and a
// second warpgroup did not pay.
template <int D>
struct FwdCfg;
template <>
struct FwdCfg<64> {
  static constexpr int kWG = 2, kMinB = 2;
  static constexpr bool kOverlap = false;
};
template <>
struct FwdCfg<128> {
  static constexpr int kWG = 1, kMinB = 2;
  static constexpr bool kOverlap = true;
};

// ------------------------------------------------------- K1 (bf16, wgmma)
template <int D, int WG, int MINB>
__global__ void __launch_bounds__(WG * kThreads, MINB)
    fa_fwd(const Params p, float scale_log2) {
  fwd_tile_loop<D, true, WG, FwdCfg<D>::kOverlap>(p, scale_log2);
}

// ------------------------------------------------------------------ K6
// K1's tile loop with the online softmax deleted (fwd_tile_loop): per
// visible 64 x 64 block pair s = q k^T in f32, rounded to bf16 as the A
// operand, then acc += s v in f32; out is acc rounded to bf16.  K1 and K6
// differ only by the softmax, so their times' ratio is the softmax's cost
// in this kernel structure.  q, k, v and out are [B, T, H, D] by strides
// (the roofline passes [B, H, T, D] tensors with their time and head
// strides swapped).
template <int D, int WG, int MINB>
__global__ void __launch_bounds__(WG * kThreads, MINB)
    fa_nosoftmax(const Params p) {
  fwd_tile_loop<D, false, WG, false>(p, 0.f);
}

// ------------------------------------------------------------- launches
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_fwd_f32(const Params& p, cudaStream_t st) {
  constexpr size_t LD = D + pad<float>(), LP = kBK + pad<float>();
  const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * LD + kBQ * LP);
  auto kern = fa_fwd_f32<D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.B * p.H);
  kern<<<grid, kThreads, smem, st>>>(p, p.scale * kLog2e);
  return cudaGetLastError();
}

// The bf16 K1 and K6 launch: q (64 rows a warpgroup), then the two K and
// the two V slots in shared memory (+ 1024: the alignment).
template <int D, class K, class... A>
cudaError_t launch_fwd_loop(K kern, const Params& p, cudaStream_t st,
                            A... args) {
  constexpr int WG = FwdCfg<D>::kWG;
  const size_t smem = sizeof(bf16) * (WG * kBQ + 4 * kBK) * D + 1024;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.Tq + WG * kBQ - 1) / (WG * kBQ));
  kern<<<grid, WG * kThreads, smem, st>>>(p, args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_bf16(const Params& p, cudaStream_t st) {
  return launch_fwd_loop<D>(
      fa_fwd<D, FwdCfg<D>::kWG, FwdCfg<D>::kMinB>, p, st, p.scale * kLog2e);
}

// The bf16 K4's choices per head_dim: the q-tile width and the blocks per
// SM that __launch_bounds__ holds registers to.  At D = 64 a fourth block
// per SM pays, and 32-query items keep K4 within its 128 registers
// without spilling (the build log's ptxas lines); at D = 128 registers
// allow two blocks whatever the width, and 64-query items halve the
// items' fixed costs.
template <int D>
struct BwdCfg;
template <>
struct BwdCfg<64> {
  static constexpr int kDkvQN = 32, kDkvMinB = 4;
};
template <>
struct BwdCfg<128> {
  static constexpr int kDkvQN = 64, kDkvMinB = 1;
};

template <int D>
cudaError_t launch_dq_f32(const Params& p, cudaStream_t st) {
  constexpr size_t LD = D + pad<float>(), LP = kBK + pad<float>();
  const size_t smem = sizeof(float) * ((2 * kBQ + 2 * kBK) * LD + kBQ * LP);
  auto kern = fa_bwd_dq_f32<D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.B * p.H);
  kern<<<grid, kThreads, smem, st>>>(p, p.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (2 * kBQ + 2 * kStages * kBK) * D +
                      1024;                       // + 1024: the alignment
  auto kern = fa_bwd_dq<D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.Tq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, st>>>(p, p.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Params& p, cudaStream_t st) {
  constexpr size_t LD = D + pad<float>(), LP = kBK + pad<float>();
  const size_t smem =
      sizeof(float) * ((2 * kBQ + 2 * kBK) * LD + 2 * kBQ * LP);
  auto kern = fa_bwd_dkv_f32<D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tk + kBK - 1) / kBK, p.B * p.KVH);
  kern<<<grid, kThreads, smem, st>>>(p, p.scale * kLog2e);
  return cudaGetLastError();
}

// The cluster size of K4 (bf16): the largest divisor of g = H / KVH that
// is at most 8, the portable limit.
int dkv_cluster(const Params& p) {
  const int G = p.H / p.KVH;
  int c = G < 8 ? G : 8;
  while (G % c) --c;
  return c;
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t st) {
  constexpr int QN = BwdCfg<D>::kDkvQN;
  // the staged tiles, and the f32 dk/dv partials that reuse them at the end
  const size_t stage = sizeof(bf16) * (2 * kStages * QN + 2 * kBK) * D +
                       sizeof(float) * 2 * kStages * QN;
  const size_t part = sizeof(float) * 2 * kBK * (D + 8);
  const size_t smem = (stage > part ? stage : part) + 1024;
  auto kern = fa_bwd_dkv<D, QN, BwdCfg<D>::kDkvMinB>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int C = dkv_cluster(p);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.KVH * C, (p.Tk + kBK - 1) / kBK);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster whose blocks cannot be resident together never launches
  static int fits[9] = {};
  if (fits[C] == 0) {
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    fits[C] = n;
  }
  return cudaLaunchKernelEx(&cfg, kern, p, p.scale * kLog2e);
}

template <int D>
cudaError_t launch_nosoftmax(const Params& p, cudaStream_t st) {
  return launch_fwd_loop<D>(
      fa_nosoftmax<D, FwdCfg<D>::kWG, FwdCfg<D>::kMinB>, p, st);
}

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  f32 keeps the first
// version's kernels (the correctness cases), bf16 runs the Hopper ones.
#define KFT_DISPATCH(fn)                                                 \
  cudaError_t fn##_any(const Params& p, int D, int dtype,                  \
                       cudaStream_t st) {                                  \
    if (dtype == 0 && D == 64) return fn##_f32<64>(p, st);                 \
    if (dtype == 0 && D == 128) return fn##_f32<128>(p, st);               \
    if (dtype == 1 && D == 64) return fn##_bf16<64>(p, st);                \
    if (dtype == 1 && D == 128) return fn##_bf16<128>(p, st);              \
    return cudaErrorInvalidValue;                                          \
  }
KFT_DISPATCH(launch_fwd)
KFT_DISPATCH(launch_dq)
KFT_DISPATCH(launch_dkv)
#undef KFT_DISPATCH

Params make_params(int B, int H, int KVH, int Tq, int Tk, int causal,
                   float scale) {
  Params p = {};
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

void set3(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace

// Every function below launches on `stream` without synchronising and
// returns the CUDA error code of its launch (0 = success).  Strides are
// in elements, (batch, time, head) for [B, T, heads, D] tensors whose last
// dimension is contiguous and whose rows are 16-byte aligned.  Outputs
// are contiguous: out/dq [B, Tq, H, D], dk/dv [B, Tk, KVH, D], lse and
// delta [B, H, Tq] f32.

// K1: out (and lse unless null) from q, k, v.
extern "C" int kft_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, const long long* qs,
                             const long long* ks, const long long* vs,
                             int B, int H, int KVH, int Tq, int Tk, int D,
                             int dtype, int causal, float scale,
                             void* stream) {
  if (B == 0 || Tq == 0) return 0;
  Params p = make_params(B, H, KVH, Tq, Tk, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  set3(p.qs, qs);
  set3(p.ks, ks);
  set3(p.vs, vs);
  p.os[0] = static_cast<long long>(Tq) * H * D;
  p.os[1] = static_cast<long long>(H) * D;
  p.os[2] = D;
  return static_cast<int>(
      launch_fwd_any(p, D, dtype, static_cast<cudaStream_t>(stream)));
}

// K2: delta = rowsum(dO * O) - dlse (dlse may be null).
extern "C" int kft_flash_delta(const void* o, const void* dout,
                               const float* dlse, float* delta,
                               const long long* os, const long long* dos,
                               int B, int H, int T, int D, int dtype,
                               void* stream) {
  const long long rows = static_cast<long long>(B) * H * T;
  if (rows == 0) return 0;
  Params p = make_params(B, H, H, T, T, 0, 0.f);
  p.o = o;
  p.dout = dout;
  p.dlse = dlse;
  p.delta_out = delta;
  set3(p.os, os);
  set3(p.dos, dos);
  // thread indices (up to 32 lanes a row) stay within int
  if (rows * 32 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one lane group of D * sizeof(T) / 16 lanes per row
  auto grid = [&](int lanes_per_row) {
    return dim3(static_cast<unsigned>(
        (rows * lanes_per_row + kDeltaThreads - 1) / kDeltaThreads));
  };
#define KFT_DELTA(T, DD)                                                     \
  fa_delta<T, DD><<<grid(DD * sizeof(T) / 16), kDeltaThreads, 0, st>>>(p)
  if (dtype == 0 && D == 64)
    KFT_DELTA(float, 64);
  else if (dtype == 0 && D == 128)
    KFT_DELTA(float, 128);
  else if (dtype == 1 && D == 64)
    KFT_DELTA(bf16, 64);
  else if (dtype == 1 && D == 128)
    KFT_DELTA(bf16, 128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef KFT_DELTA
  return static_cast<int>(cudaGetLastError());
}

// K3: dq from q, k, v, dO, lse, delta.
extern "C" int kft_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq,
                                const long long* qs, const long long* ks,
                                const long long* vs, const long long* dos,
                                int B, int H, int KVH, int Tq, int Tk, int D,
                                int dtype, int causal, float scale,
                                void* stream) {
  if (B == 0 || Tq == 0) return 0;
  Params p = make_params(B, H, KVH, Tq, Tk, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dq = dq;
  set3(p.qs, qs);
  set3(p.ks, ks);
  set3(p.vs, vs);
  set3(p.dos, dos);
  return static_cast<int>(
      launch_dq_any(p, D, dtype, static_cast<cudaStream_t>(stream)));
}

// K4: compact dk, dv from q, k, v, dO, lse, delta.
extern "C" int kft_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dk, void* dv, const long long* qs,
                                 const long long* ks, const long long* vs,
                                 const long long* dos, int B, int H, int KVH,
                                 int Tq, int Tk, int D, int dtype,
                                 int causal, float scale, void* stream) {
  if (B == 0 || Tk == 0) return 0;
  Params p = make_params(B, H, KVH, Tq, Tk, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  set3(p.qs, qs);
  set3(p.ks, ks);
  set3(p.vs, vs);
  set3(p.dos, dos);
  return static_cast<int>(
      launch_dkv_any(p, D, dtype, static_cast<cudaStream_t>(stream)));
}

// K6: out = (bf16(q k^T) v) from bf16 q, k, v, all four [B, T, H, D] by
// (batch, time, head) strides; causal skips the k-tiles wholly above the
// diagonal and nothing else.
extern "C" int kft_nosoftmax_fwd(const void* q, const void* k, const void* v,
                                 void* out, const long long* qs,
                                 const long long* ks, const long long* vs,
                                 const long long* os, int B, int H, int T,
                                 int D, int causal, void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  Params p = make_params(B, H, H, T, T, causal, 0.f);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  set3(p.qs, qs);
  set3(p.ks, ks);
  set3(p.vs, vs);
  set3(p.os, os);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch_nosoftmax<64>(p, st));
  if (D == 128) return static_cast<int>(launch_nosoftmax<128>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
