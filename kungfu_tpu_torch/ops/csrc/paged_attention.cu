// Paged-decode attention for Hopper (sm_90a), straight off the paged KV pool.
//
// Replaces the Pallas TPU kernel _pa_kernel of
// kungfu_tpu/ops/paged_attention.py (launched by _run_kernel there, through
// paged_attention and paged_attention_queries).  It computes what that
// kernel computes:
//
//   * rows per KV head R = Q * G, ordered r = j * G + g (query j, query
//     head h * G + g), so the G query heads of a group read their KV head
//     compactly -- no GQA expansion is ever materialised;
//   * s = (q . k) / sqrt(Dh), masked to -1e30 where kpos > pos[s] + r / G
//     (the multi-query speculative-verify offset);
//   * softmax over the slot's visible keys with the max, the sum and the
//     PV accumulator in f32, out = acc / max(l, 1e-30) cast to q's dtype;
//   * bf16: products of bf16 values accumulated in f32, p rounded to bf16
//     before the PV product; f32: full f32 on the SIMT units (no TF32);
//   * int8 pools: k = (int8 * scale_f32) rounded to q's dtype before the
//     product, the same for v.
//
// Precondition: pos[s] >= 0, so block 0 holds a visible key for every row
// and the merged max is finite.
//
// What bounds it: bytes.  Decode attention does ~4 flops per K/V element
// read; the least traffic is each visited K and V block (plus its scales)
// once, plus q and out -- ~5 MB at the 470m serving shapes (8 slots, 4 KV
// heads of 64, blocks of 32, up to 32 blocks a slot), 1.6 us at 3.35 TB/s.
// That is less than one launch's fixed cost, so the design aims at one
// launch that has every byte in flight at once.
//
// The TPU kernel's grid walks a slot's blocks in order and carries the
// online-softmax state across grid steps in VMEM.  A GPU has no order
// between thread blocks, and one block walking a slot serially leaves most
// SMs idle (8 slots x 4 KV heads = 32 walks on 132 SMs).  So:
//
//   * One thread-block cluster of C blocks (C <= 8, the portable limit,
//     from the table width MB) per (slot, KV head, 16-row tile); grid
//     (C, KVH x row tiles, S).  Block b of a slot goes to rank b % C and,
//     within it, to warp (b / C) % 4; a warp walks its blocks with the
//     online softmax in registers.  Blocks past ceil((pos[s] + Q) / bs)
//     are never read.
//   * K and V rows of the head arrive as bf16 (or the pool's int8, then
//     dequantised into a bf16 tile in shared memory) through 16-byte
//     cp.async copies; where a warp walks more than one block, a two-slot
//     ring keeps the next block's copy in flight during this one's
//     products.
//   * bf16 at head_dim 64 and 128 (compile-time): both products are
//     mma.sync m16n8k16 on the tensor cores -- q as A fragments loaded
//     once, K by ldmatrix, V by ldmatrix.trans, p rounded to bf16 and
//     passed from the accumulator registers as the A operand of P.V, 32
//     keys (two m16n8k16 k-steps) per softmax step.  The R rows (4 at 470m decode, 16 for a Q = 4 verify)
//     are padded to the 16 of one m16 tile; R > 16 takes more row tiles
//     in the grid.  wgmma needs 64 rows, decode has 4-16, so mma.sync is
//     the instruction here.
//   * Any other head_dim, and f32 (the correctness path): the same walk,
//     ring and merge, with per-lane f32 arithmetic from shared memory.
//   * The merge: each warp's (m, l, acc) goes to shared memory, the block
//     merges its warps, then rank c of the cluster merges columns of every
//     rank's state through distributed shared memory and writes them.  The
//     orders are fixed and there are no atomics, so a call gives the same
//     bits every time; a rank with nothing to read contributes m = -1e30.
//     No workspace, no second kernel.
//
// Built by kungfu_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;          // warps per block, each walking its blocks
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;          // query rows per cluster: one m16 tile
constexpr int kHalves = 2;         // 16-key halves (the k of m16n8k16) a step
constexpr int kKeys = 16 * kHalves;   // keys per softmax step
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxSmem = 232448;   // shared memory a block can have

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// Round an f32 value to the model dtype T (and back to f32): the kernel
// works in f32 registers but must see the values the reference sees after
// its casts.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int slot_blocks(int p_slot, int Q,
                                                    int bs, int MB) {
  // the deepest query (j = Q - 1) reaches p_slot + Q - 1
  const int nb = (p_slot + Q - 1) / bs + 1;
  return nb < MB ? nb : MB;
}

__host__ __device__ __forceinline__ int up16(int bytes) {
  return (bytes + 15) & ~15;
}

// --------------------------------------------------- Hopper primitives
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// cp.async of 16 or 4 bytes; a source that is not `in` reads nothing and
// the destination is zero-filled.
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulators in the m16n8 layout:
// lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 at columns 2t
// and 2t + 1 as d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ----------------------------------------------------------- the layout
// q: [S, Q, H, Dh] (T); pools: [N, bs, KVH, Dh] (KV); scales: [N, bs, KVH]
// f32 (QUANT only); tables: [S, MB] int32; pos: [S] int32; out like q.
struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* pos;
  void* out;
  int Q, H, KVH, Dh, bs, MB;
  int ns;        // ring slots per warp: 2 where a warp walks > 1 block
  float scale;   // 1 / sqrt(Dh)
};

// Shared memory, in bytes, every region 16-byte aligned.  The block's own
// region: q in f32 (SIMT path only), the merged state, and the cluster
// merge's gathered m and l and weights.  Then one region
// per warp: its ring of `ns` slots (K rows, V rows, in the pool's type,
// rows padded by 16 bytes so ldmatrix's eight rows hit distinct banks;
// int8 pools add the rows' scales), the dequantised K and V tile (QUANT),
// its softmax state, and the p rows (SIMT path).  A state is m[16], l[16]
// and acc[16][Dh], f32.
template <typename T, typename KV, bool QUANT, bool MMA>
struct Layout {
  int bsp;       // keys per block rounded up to kKeys (zero-filled)
  int ldr;       // ring row stride, KV elements
  int ldt;       // tile row stride, T elements (== ldr unless QUANT)
  int slot;      // bytes of one ring slot
  int ring, tile, state, pbuf;   // per-warp region offsets
  int warp;      // bytes per warp
  int q_sh, cta_state, merge, cta;   // block region offsets and size
  __host__ __device__ Layout(int Dh, int bs, int ns) {
    bsp = (bs + kKeys - 1) / kKeys * kKeys;
    ldr = Dh + 16 / static_cast<int>(sizeof(KV));
    ldt = Dh + 16 / static_cast<int>(sizeof(T));
    const int rows = up16(bsp * ldr * static_cast<int>(sizeof(KV)));
    slot = 2 * rows + (QUANT ? up16(2 * bsp * 4) : 0);
    const int state_bytes = up16((2 * kRows + kRows * Dh) * 4);
    q_sh = 0;
    cta_state = MMA ? 0 : up16(kRows * Dh * 4);
    merge = cta_state + state_bytes;
    cta = merge + up16((3 * kMaxCluster + 1) * kRows * 4);
    ring = 0;
    tile = ring + ns * slot;
    state = tile + (QUANT ? 2 * up16(bsp * ldt * static_cast<int>(
                                sizeof(T))) : 0);
    pbuf = state + state_bytes;
    warp = pbuf + (MMA ? 0 : up16(kRows * bsp * 4));
  }
  __host__ __device__ int bytes() const { return cta + kWarps * warp; }
};

// Issue the cp.async copies of pool block `blk`'s K and V rows of head h
// (and their scales) into a ring slot, zero-filling keys [bs, bsp).
template <typename KV, bool QUANT, int DH>
__device__ __forceinline__ void stage_block(const Params& p, int Dh,
                                            size_t blk, int h, int bsp,
                                            int ldr, unsigned char* slot,
                                            int rows_bytes, int lane) {
  constexpr int VEC = 16 / sizeof(KV);
  const int cpr = (DH > 0 ? DH : Dh) / VEC;  // 16-byte chunks per row
  const KV* kp = static_cast<const KV*>(p.k_pool);
  const KV* vp = static_cast<const KV*>(p.v_pool);
  KV* ks = reinterpret_cast<KV*>(slot);
  KV* vs = reinterpret_cast<KV*>(slot + rows_bytes);
  for (int c = lane; c < bsp * cpr; c += 32) {
    const int t = c / cpr, e = (c - t * cpr) * VEC;
    const bool in = t < p.bs;
    const size_t off =
        in ? ((blk * p.bs + t) * p.KVH + h) * static_cast<size_t>(Dh) + e
           : 0;
    cp_async16(ks + t * ldr + e, kp + off, in);
    cp_async16(vs + t * ldr + e, vp + off, in);
  }
  if (QUANT) {
    float* ksc = reinterpret_cast<float*>(slot + 2 * rows_bytes);
    for (int t = lane; t < bsp; t += 32) {
      const bool in = t < p.bs;
      const size_t off = in ? (blk * p.bs + t) * p.KVH + h : 0;
      cp_async4(ksc + t, p.k_scale + off, in);
      cp_async4(ksc + bsp + t, p.v_scale + off, in);
    }
  }
}

// int8 rows and their scales -> the T tile: round_to_T(int8 * scale), the
// reference's cast (kungfu_tpu/ops/paged_attention.py:101-104).
template <typename T>
__device__ __forceinline__ void dequant_block(const unsigned char* slot,
                                              int rows_bytes, int Dh,
                                              int bsp, int ldr, int ldt,
                                              T* kt, T* vt, int lane) {
  const float* ksc = reinterpret_cast<const float*>(slot + 2 * rows_bytes);
  const int cpr = Dh / 16;
  for (int c = lane; c < 2 * bsp * cpr; c += 32) {
    const int which = c / (bsp * cpr), rem = c - which * bsp * cpr;
    const int t = rem / cpr, e = (rem - t * cpr) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        slot + which * rows_bytes + t * ldr + e);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    const float sc = ksc[which * bsp + t];
    T* dst = (which ? vt : kt) + t * ldt + e;
#pragma unroll
    for (int u = 0; u < 16; ++u) dst[u] = from_f<T>(to_f(x[u]) * sc);
  }
}

// ------------------------------------------------- per-block arithmetic
// bf16 tensor-core step: one pool block's keys against this warp's 16
// rows, online softmax in registers (rows g and g + 8 of the lane).
template <int DH>
struct MmaState {
  uint32_t qa[DH / 16][4];   // q as m16n8k16 A fragments
  float acc[DH / 8][4];      // P.V accumulator, m16n8 layout
  float m[2], l[2];          // running max; this lane's partial sum
  int reach[2];              // last visible key position of rows g, g + 8
};

template <int DH>
__device__ __forceinline__ void mma_block(MmaState<DH>& st, const bf16* kt,
                                          const bf16* vt, int ldt, int bs,
                                          int bsp, int kpos0, float scale,
                                          int lane) {
  const int t = lane & 3;
  const int mi = lane >> 3, row = lane & 7;
  for (int c0 = 0; c0 < bsp; c0 += kKeys) {
    float sc[2 * kHalves][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (c0 + 16 * hf + (mi >> 1) * 8 + row) * ldt +
                           kk * 16 + (mi & 1) * 8);
        mma_bf16(sc[2 * hf], st.qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * hf + 1], st.qa[kk], b[2], b[3]);
      }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2 * kHalves; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * j + 2 * t + (e & 1);
        const bool vis = key < bs && kpos0 + key <= st.reach[e >> 1];
        sc[j][e] = vis ? sc[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(st.m[hh], mx[hh]);
      corr[hh] = __expf(st.m[hh] - mn);
      st.m[hh] = mn;
      st.l[hh] *= corr[hh];
    }
#pragma unroll
    for (int j = 0; j < 2 * kHalves; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e];
        const float pv = x <= kNegInf ? 0.f : __expf(x - st.m[e >> 1]);
        st.l[e >> 1] += pv;
        sc[j][e] = pv;
      }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      st.acc[n][0] *= corr[0];
      st.acc[n][1] *= corr[0];
      st.acc[n][2] *= corr[1];
      st.acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      // p rounded to bf16: n-tiles 2 hf and 2 hf + 1 of the m16n8
      // accumulator are the m16n8k16 A fragment of these 16 keys
      const uint32_t pa[4] = {pack_bf16(sc[2 * hf][0], sc[2 * hf][1]),
                              pack_bf16(sc[2 * hf][2], sc[2 * hf][3]),
                              pack_bf16(sc[2 * hf + 1][0], sc[2 * hf + 1][1]),
                              pack_bf16(sc[2 * hf + 1][2], sc[2 * hf + 1][3])};
#pragma unroll
      for (int n = 0; n < DH / 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (c0 + 16 * hf + (mi & 1) * 8 + row) * ldt +
                                 (n + (mi >> 1)) * 8);
        mma_bf16(st.acc[n], pa, b[0], b[1]);
        mma_bf16(st.acc[n + 1], pa, b[2], b[3]);
      }
    }
  }
}

// Per-lane f32 step (f32, or bf16 at a head_dim without an MMA form): the
// state lives in the warp's shared memory.
template <typename T>
__device__ __forceinline__ void simt_block(const float* q_sh, const T* kt,
                                           const T* vt, int ldt, float* wm,
                                           float* wl, float* wacc,
                                           float* p_sh, int nr, int Dh,
                                           int bs, int bsp, int kpos0,
                                           int reach0, int r0, int G,
                                           float scale, int lane) {
  for (int r = 0; r < nr; ++r) {
    const float* qr = q_sh + r * Dh;
    float* pr = p_sh + r * bsp;
    const int reach = reach0 + (r0 + r) / G;
    float mx = kNegInf;
    for (int t = lane; t < bs; t += 32) {
      const T* kr = kt + t * ldt;
      float a = 0.f;
      for (int d = 0; d < Dh; ++d) a = fmaf(qr[d], to_f(kr[d]), a);
      const float sc = kpos0 + t <= reach ? a * scale : kNegInf;
      pr[t] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = warp_max(mx);
    const float m_old = wm[r];
    const float mn = fmaxf(m_old, mx);
    const float corr = expf(m_old - mn);
    float sum = 0.f;
    for (int t = lane; t < bs; t += 32) {
      const float x = pr[t];
      const float pv = x <= kNegInf ? 0.f : expf(x - mn);
      sum += pv;
      pr[t] = round_to<T>(pv);   // p is cast to v's dtype for PV
    }
    sum = warp_sum(sum);
    for (int d = lane; d < Dh; d += 32) wacc[r * Dh + d] *= corr;
    __syncwarp();
    if (lane == 0) {
      wm[r] = mn;
      wl[r] = wl[r] * corr + sum;
    }
  }
  __syncwarp();
  for (int i = lane; i < nr * Dh; i += 32) {
    const int r = i / Dh, d = i - r * Dh;
    const float* pr = p_sh + r * bsp;
    float a = wacc[i];
    for (int t = 0; t < bs; ++t) a = fmaf(pr[t], to_f(vt[t * ldt + d]), a);
    wacc[i] = a;
  }
  __syncwarp();
}

// ------------------------------------------------------------ the kernel
// Grid (C, KVH x row tiles, S), cluster (C, 1, 1), block kThreads.  DH:
// the head_dim of the bf16 tensor-core form (64, 128), or 0 for the
// per-lane form at the runtime head_dim.
template <typename T, typename KV, bool QUANT, int DH>
__global__ void __launch_bounds__(kThreads) paged_attention_cluster(
    const Params p) {
  constexpr bool MMA = DH > 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y % p.KVH;
  const int r0 = blockIdx.y / p.KVH * kRows;
  const int s = blockIdx.z;
  const int Dh = MMA ? DH : p.Dh;
  const int G = p.H / p.KVH;
  const int R = p.Q * G;
  const int nr = min(kRows, R - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Layout<T, KV, QUANT, MMA> lay(Dh, p.bs, p.ns);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wbase = smem + lay.cta + warp * lay.warp;
  float* wm = reinterpret_cast<float*>(wbase + lay.state);
  float* wl = wm + kRows;
  float* wacc = wl + kRows;
  const int rows_bytes = up16(lay.bsp * lay.ldr * sizeof(KV));

  const T* q = static_cast<const T*>(p.q);
  // q row r of this tile: query j = r / G, head h * G + r % G
  auto q_row = [&](int r) {
    const int j = r / G, g = r - j * G;
    return q + ((static_cast<size_t>(s) * p.Q + j) * p.H + h * G + g) * Dh;
  };
  float* q_sh = reinterpret_cast<float*>(smem + lay.q_sh);
  if (!MMA) {
    for (int i = threadIdx.x; i < kRows * Dh; i += kThreads) {
      const int r = i / Dh;
      q_sh[i] = r < nr ? to_f(q_row(r0 + r)[i - r * Dh]) : 0.f;
    }
    for (int i = lane; i < kRows * Dh; i += 32) wacc[i] = 0.f;
    if (lane < kRows) {
      wm[lane] = kNegInf;
      wl[lane] = 0.f;
    }
    __syncthreads();
  }

  const int stride = C * kWarps;
  const int first = warp * C + rank;   // block b = first + it * stride
  const int* table = p.tables + static_cast<size_t>(s) * p.MB;
  // the warp's first table entry is loaded beside pos (the two loads
  // overlap) and used only if that block is within the slot's reach
  const int blk0 = first < p.MB ? table[first] : 0;
  const int p_slot = p.pos[s];
  const int nb = slot_blocks(p_slot, p.Q, p.bs, p.MB);
  const int n_it = first < nb ? (nb - 1 - first) / stride + 1 : 0;

  MmaState<MMA ? DH : 16> st;
  if constexpr (MMA) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      st.reach[hh] = p_slot + (r < R ? r / G : 0);
      st.m[hh] = kNegInf;
      st.l[hh] = 0.f;
    }
    const bf16* qa = q_row(min(r0 + g, R - 1));
    const bf16* qb = q_row(min(r0 + g + 8, R - 1));
    const bool ina = g < nr, inb = g + 8 < nr;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bf16* src = (u & 1 ? qb : qa) + kk * 16 + (u >> 1) * 8 + 2 * t;
        st.qa[kk][u] = (u & 1 ? inb : ina)
                           ? *reinterpret_cast<const uint32_t*>(src)
                           : 0u;
      }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
  }

  // the walk: slot it % ns holds block it; copies run ns - 1 blocks ahead
  for (int i = 0; i < p.ns; ++i) {
    if (i < n_it)
      stage_block<KV, QUANT, DH>(
          p, Dh, static_cast<size_t>(i ? table[first + i * stride] : blk0),
          h, lay.bsp, lay.ldr, wbase + lay.ring + i * lay.slot, rows_bytes,
          lane);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    if (p.ns > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncwarp();
    unsigned char* slot = wbase + lay.ring + (it % p.ns) * lay.slot;
    const T* kt = reinterpret_cast<const T*>(slot);
    const T* vt = reinterpret_cast<const T*>(slot + rows_bytes);
    if (QUANT) {
      T* kq = reinterpret_cast<T*>(wbase + lay.tile);
      T* vq = reinterpret_cast<T*>(
          wbase + lay.tile + up16(lay.bsp * lay.ldt * sizeof(T)));
      dequant_block<T>(slot, rows_bytes, Dh, lay.bsp, lay.ldr, lay.ldt, kq,
                       vq, lane);
      __syncwarp();
      kt = kq;
      vt = vq;
    }
    const int kpos0 = (first + it * stride) * p.bs;
    if constexpr (MMA)
      mma_block<DH>(st, kt, vt, lay.ldt, p.bs, lay.bsp, kpos0, p.scale,
                    lane);
    else
      simt_block<T>(q_sh, kt, vt, lay.ldt, wm, wl, wacc,
                    reinterpret_cast<float*>(wbase + lay.pbuf), nr, Dh, p.bs,
                    lay.bsp, kpos0, p_slot, r0, G, p.scale, lane);
    __syncwarp();
    if (it + p.ns < n_it)
      stage_block<KV, QUANT, DH>(
          p, Dh, static_cast<size_t>(table[first + (it + p.ns) * stride]), h,
          lay.bsp, lay.ldr, slot, rows_bytes, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if constexpr (MMA) {
    // the warp's state to shared memory (a warp with no block writes
    // m = -1e30, l = 0, acc = 0)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = st.l[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t == 0) {
        wm[g + 8 * hh] = st.m[hh];
        wl[g + 8 * hh] = l;
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(wacc + (g + 8 * hh) * DH + 8 * n +
                                   2 * t) =
            make_float2(st.acc[n][2 * hh], st.acc[n][2 * hh + 1]);
    }
  }
  __syncthreads();

  // merge the warps, in warp order, into the block's state
  float* cm = reinterpret_cast<float*>(smem + lay.cta_state);
  float* cl = cm + kRows;
  float* cacc = cl + kRows;
  auto warp_state = [&](int w) {
    return reinterpret_cast<const float*>(smem + lay.cta + w * lay.warp +
                                          lay.state);
  };
  for (int i = threadIdx.x; i < nr * Dh; i += kThreads) {
    const int r = i / Dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, warp_state(w)[r]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ws = warp_state(w);
      const float wt = expf(ws[r] - M);
      A = fmaf(ws[2 * kRows + i], wt, A);
      L = fmaf(ws[kRows + r], wt, L);
    }
    cacc[i] = A;
    if (i - r * Dh == 0) {
      cm[r] = M;
      cl[r] = L;
    }
  }
  cluster.sync();

  // rank c merges its share of the columns over every rank, in rank order,
  // through distributed shared memory, and writes them: first every
  // rank's m and l in one round of remote loads, then the weights, then
  // each column's C partial sums, loaded together
  float* gm = reinterpret_cast<float*>(smem + lay.merge);   // [C][kRows]
  float* gl = gm + kMaxCluster * kRows;                     // [C][kRows]
  float* gw = gl + kMaxCluster * kRows;                     // [C][kRows]
  float* gL = gw + kMaxCluster * kRows;                     // [kRows]
  if (threadIdx.x < C * kRows) {
    const int c = threadIdx.x / kRows, r = threadIdx.x - c * kRows;
    gm[threadIdx.x] = cluster.map_shared_rank(cm, c)[r];
    gl[threadIdx.x] = cluster.map_shared_rank(cl, c)[r];
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    float M = kNegInf;
    for (int c = 0; c < C; ++c) M = fmaxf(M, gm[c * kRows + r]);
    float L = 0.f;
    for (int c = 0; c < C; ++c) {
      const float wt = expf(gm[c * kRows + r] - M);
      gw[c * kRows + r] = wt;
      L = fmaf(gl[c * kRows + r], wt, L);
    }
    gL[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int n = nr * Dh, share = (n + C - 1) / C;
  T* out = static_cast<T*>(p.out);
  for (int i = rank * share + threadIdx.x; i < min(n, (rank + 1) * share);
       i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    float x[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      x[c] = c < C ? cluster.map_shared_rank(cacc, c)[i] : 0.f;
    float A = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C) A = fmaf(x[c], gw[c * kRows + r], A);
    const int row = r0 + r, j = row / G, g = row - j * G;
    out[((static_cast<size_t>(s) * p.Q + j) * p.H + h * G + g) * Dh + d] =
        from_f<T>(A / gL[r]);
  }
  cluster.sync();   // keep this block's state alive for the other ranks
}

// Cluster size from the table width: enough ranks that each warp walks
// about one block, at most kMaxCluster.
int cluster_size(int MB) {
  const int c = (MB + kWarps - 1) / kWarps;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

template <typename T, typename KV, bool QUANT, int DH>
cudaError_t launch(Params p, int S, cudaStream_t st) {
  const int C = cluster_size(p.MB);
  const int per_warp = (p.MB + C * kWarps - 1) / (C * kWarps);
  using L = Layout<T, KV, QUANT, (DH > 0)>;
  // a second ring slot where a warp walks more than one block and the
  // block's shared memory allows it
  p.ns = per_warp > 1 && L(p.Dh, p.bs, 2).bytes() <= kMaxSmem ? 2 : 1;
  const int G = p.H / p.KVH;
  const int row_tiles = (p.Q * G + kRows - 1) / kRows;
  const size_t smem = L(p.Dh, p.bs, p.ns).bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_attention_cluster<T, KV, QUANT, DH>;
  // the attribute and the residency check once per instantiation, size
  // and cluster width (host time counts on the decode path)
  static size_t allowed = 48 * 1024;
  static size_t fits[kMaxCluster + 1] = {};
  cudaError_t e;
  if (smem > allowed) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.KVH * row_tiles, S);
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
  if (smem > fits[C]) {
    int nc = 0;
    e = cudaOccupancyMaxActiveClusters(&nc, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (nc < 1) return cudaErrorInvalidConfiguration;
    fits[C] = smem;
  }
  return cudaLaunchKernelEx(&cfg, kern, p);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and the pools unless quant);
// quant: 1 = int8 pools with f32 scales.  Pools 16-byte aligned with
// Dh * itemsize a multiple of 16 bytes.  One launch, asynchronous on
// `stream`; returns its CUDA error code (0 = success).
extern "C" int kft_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* pos, void* out, int S, int Q,
                                   int H, int KVH, int Dh, int bs, int MB,
                                   int dtype, int quant, float scale,
                                   void* stream) {
  if (S == 0) return 0;
  Params p = {};
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.out = out;
  p.Q = Q;
  p.H = H;
  p.KVH = KVH;
  p.Dh = Dh;
  p.bs = bs;
  p.MB = MB;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0 && !quant)
    e = launch<float, float, false, 0>(p, S, st);
  else if (dtype == 0)
    e = launch<float, int8_t, true, 0>(p, S, st);
  else if (dtype == 1 && !quant && Dh == 64)
    e = launch<bf16, bf16, false, 64>(p, S, st);
  else if (dtype == 1 && !quant && Dh == 128)
    e = launch<bf16, bf16, false, 128>(p, S, st);
  else if (dtype == 1 && !quant)
    e = launch<bf16, bf16, false, 0>(p, S, st);
  else if (dtype == 1 && Dh == 64)
    e = launch<bf16, int8_t, true, 64>(p, S, st);
  else if (dtype == 1 && Dh == 128)
    e = launch<bf16, int8_t, true, 128>(p, S, st);
  else if (dtype == 1)
    e = launch<bf16, int8_t, true, 0>(p, S, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
