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
//     before the PV product; f32: full f32 (no TF32);
//   * int8 pools: k = (int8 * scale_f32) rounded to q's dtype before the
//     product, the same for v.
//
// Precondition: pos[s] >= 0, so block 0 holds a visible key for every row
// and the merged max is finite.
//
// What bounds it: bytes.  Decode attention does ~4 flops per K/V element
// read; the least traffic is each visited K and V block (plus its scales)
// once, plus q and out.  The TPU kernel's grid walks a slot's blocks in
// order and carries the online-softmax state across grid steps in VMEM.
// A GPU has no order between thread blocks, and one block walking a slot
// serially leaves most SMs idle (8 slots x 4 KV heads = 32 walks on 132
// SMs).  So the work is split two ways:
//
//   1. paged_attention_partial: one warp per visited (slot, KV head, pool
//      block) -- ~500 independent warps at the 470m serving shapes.  The
//      warp loads its own table entry, stages the block's K/V rows for its
//      head with 16-byte loads (all of a lane's loads in flight at once,
//      int8 dequantised on the way into shared memory), computes the
//      block's scores (one lane per key, float4 shared-memory reads, four
//      accumulators), its row max and sum (warp shuffles), and its PV
//      product (one lane per four output columns), and writes the block's
//      (m, l, acc) to a workspace.  Blocks past ceil((pos[s] + Q) / bs)
//      are never read (the TPU grid predicates them instead).
//   2. paged_attention_merge: one thread block per (slot, KV head) rescales
//      the slot's partials to their common max and divides -- the online
//      softmax's correction, done once at the end.
//
// wgmma/mma for the multi-query verify, TMA staging and a one-pass merge
// are later work.
//
// Built by kungfu_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;  // pool blocks per thread block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 8;  // 16-byte loads a lane keeps in flight per tensor
constexpr int kMergeThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// Round an f32 value to the model dtype T (and back to f32 for the
// arithmetic): the kernel works in f32 registers but must see the values
// the reference sees after its casts.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
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

// A warp's shared memory, in floats; a multiple of 4 so every region
// stays 16-byte aligned.  K rows are padded to Dh + 4: lanes reading
// float4s of consecutive rows then hit distinct banks.
__host__ __device__ __forceinline__ int warp_floats(int R, int Dh, int bs) {
  return (bs * (Dh + 4) + bs * Dh + R * bs + 3) & ~3;
}

// Stage pool block `blk`'s K/V rows of head h into shared memory as f32
// (dequantised and rounded to T for int8 pools).  Requires Dh * sizeof(KV)
// to be a multiple of 16 bytes and 16-byte-aligned pools.
template <typename T, typename KV, bool QUANT>
__device__ __forceinline__ void stage_block(
    const KV* __restrict__ k_pool, const KV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    size_t blk, int h, int KVH, int Dh, int bs, float* k_sh, float* v_sh,
    int lane) {
  constexpr int VEC = 16 / sizeof(KV);
  const int cpr = Dh / VEC;  // 16-byte chunks per row
  const int n = bs * cpr;
  for (int base = 0; base < n; base += 32 * kBatch) {
    uint4 kr[kBatch], vr[kBatch];
    float ks[kBatch], vs[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = base + j * 32 + lane;
      if (c < n) {
        const int t = c / cpr;
        const size_t row = (blk * bs + t) * KVH + h;
        const size_t off = row * Dh + (c - t * cpr) * VEC;
        kr[j] = *reinterpret_cast<const uint4*>(k_pool + off);
        vr[j] = *reinterpret_cast<const uint4*>(v_pool + off);
        if (QUANT) {
          ks[j] = k_scale[row];
          vs[j] = v_scale[row];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = base + j * 32 + lane;
      if (c < n) {
        const int t = c / cpr;
        const int e = (c - t * cpr) * VEC;
        const KV* kx = reinterpret_cast<const KV*>(&kr[j]);
        const KV* vx = reinterpret_cast<const KV*>(&vr[j]);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          float kf = to_f(kx[u]);
          float vf = to_f(vx[u]);
          if (QUANT) {
            kf = round_to<T>(kf * ks[j]);
            vf = round_to<T>(vf * vs[j]);
          }
          k_sh[t * (Dh + 4) + e + u] = kf;
          v_sh[t * Dh + e + u] = vf;
        }
      }
    }
  }
}

// q: [S, Q, H, Dh] (T); pools: [N, bs, KVH, Dh] (KV); scales: [N, bs, KVH]
// f32 (QUANT only); tables: [S, MB] int32; pos: [S] int32.  Partials, f32:
// acc [S, KVH, MB, R, Dh], m and l [S, KVH, MB, R].
// Grid (KVH, S, ceil(MB / kWarps)); block kThreads.
template <typename T, typename KV, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_attention_partial(
    const T* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int Q, int H,
    int KVH, int Dh, int bs, int MB, float scale) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int p_slot = pos[s];
  const int nb = slot_blocks(p_slot, Q, bs, MB);
  if (blockIdx.z * kWarps >= nb) return;  // the whole block is past reach

  const int G = H / KVH;
  const int R = Q * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);  // [R][Dh]
  for (int i = threadIdx.x; i < R * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    const int j = r / G, g = r - j * G;
    q_sh[i] = to_f(q[((static_cast<size_t>(s) * Q + j) * H + h * G + g) * Dh
                     + d]);
  }
  __syncthreads();
  const int b = blockIdx.z * kWarps + warp;
  if (b >= nb) return;  // no block-wide barrier follows

  float* k_sh = q_sh + R * Dh + warp * warp_floats(R, Dh, bs);
  float* v_sh = k_sh + bs * (Dh + 4);
  float* p_sh = v_sh + bs * Dh;
  stage_block<T, KV, QUANT>(
      k_pool, v_pool, k_scale, v_scale,
      static_cast<size_t>(tables[static_cast<size_t>(s) * MB + b]), h, KVH,
      Dh, bs, k_sh, v_sh, lane);
  __syncwarp();

  const size_t part = (static_cast<size_t>(s) * KVH + h) * MB + b;
  const int D4 = Dh / 4;
  for (int r = 0; r < R; ++r) {
    const float4* q4 = reinterpret_cast<const float4*>(q_sh + r * Dh);
    float* pr = p_sh + r * bs;
    const int reach = p_slot + r / G;
    float mx = kNegInf;
    for (int t = lane; t < bs; t += 32) {
      const float4* k4 = reinterpret_cast<const float4*>(k_sh + t * (Dh + 4));
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int d = 0; d < D4; ++d) {
        const float4 x = q4[d], y = k4[d];
        a0 = fmaf(x.x, y.x, a0);
        a1 = fmaf(x.y, y.y, a1);
        a2 = fmaf(x.z, y.z, a2);
        a3 = fmaf(x.w, y.w, a3);
      }
      const float sc =
          (b * bs + t <= reach) ? ((a0 + a1) + (a2 + a3)) * scale : kNegInf;
      pr[t] = sc;
      mx = fmaxf(mx, sc);
    }
    // a row with no visible key in this block gets m = -1e30; the merge
    // weighs it by exp(-1e30 - max) = 0
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < bs; t += 32) {
      const float pv = expf(pr[t] - mx);
      sum += pv;
      pr[t] = round_to<T>(pv);  // p is cast to v's dtype for PV
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[part * R + r] = mx;
      part_l[part * R + r] = sum;
    }
  }
  __syncwarp();

  float4* acc4 = reinterpret_cast<float4*>(part_acc + part * R * Dh);
  for (int i = lane; i < R * D4; i += 32) {
    const int r = i / D4, d = i - r * D4;
    const float* pr = p_sh + r * bs;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < bs; ++t) {
      const float pv = pr[t];
      const float4 v = reinterpret_cast<const float4*>(v_sh + t * Dh)[d];
      a.x = fmaf(pv, v.x, a.x);
      a.y = fmaf(pv, v.y, a.y);
      a.z = fmaf(pv, v.z, a.z);
      a.w = fmaf(pv, v.w, a.w);
    }
    acc4[i] = a;
  }
}

// out: [S, Q, H, Dh] (T).  Grid (KVH, S); block kMergeThreads; shared
// memory: MB * R weights + R sums.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) paged_attention_merge(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int* __restrict__ pos,
    T* __restrict__ out, int Q, int H, int KVH, int Dh, int bs, int MB) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int G = H / KVH;
  const int R = Q * G;
  const int nb = slot_blocks(pos[s], Q, bs, MB);
  const size_t first = (static_cast<size_t>(s) * KVH + h) * MB;
  extern __shared__ float msmem[];
  float* w_sh = msmem;          // [nb][R] weight exp(m_b - max)
  float* l_sh = w_sh + MB * R;  // [R] max(sum_b l_b * w_b, 1e-30)
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float mx = kNegInf;
    for (int b = 0; b < nb; ++b) mx = fmaxf(mx, part_m[(first + b) * R + r]);
    float l = 0.f;
    for (int b = 0; b < nb; ++b) {
      const float w = expf(part_m[(first + b) * R + r] - mx);
      w_sh[b * R + r] = w;
      l += part_l[(first + b) * R + r] * w;
    }
    l_sh[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    float a = 0.f;
    for (int b = 0; b < nb; ++b)
      a += part_acc[(first + b) * R * Dh + i] * w_sh[b * R + r];
    const int j = r / G, g = r - j * G;
    out[((static_cast<size_t>(s) * Q + j) * H + h * G + g) * Dh + d] =
        from_f<T>(a / l_sh[r]);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, typename KV, bool QUANT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* pos, void* out,
                   void* workspace, int S, int Q, int H, int KVH, int Dh,
                   int bs, int MB, float scale, cudaStream_t stream) {
  const int R = Q * (H / KVH);
  const size_t n_part = static_cast<size_t>(S) * KVH * MB * R;
  float* part_acc = static_cast<float*>(workspace);
  float* part_m = part_acc + n_part * Dh;
  float* part_l = part_m + n_part;

  const size_t smem =
      sizeof(float) * (static_cast<size_t>(R) * Dh +
                       static_cast<size_t>(kWarps) * warp_floats(R, Dh, bs));
  auto partial = paged_attention_partial<T, KV, QUANT>;
  cudaError_t e = allow_smem(partial, smem);
  if (e != cudaSuccess) return e;
  partial<<<dim3(KVH, S, (MB + kWarps - 1) / kWarps), kThreads, smem,
            stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), part_acc, part_m, part_l, Q, H, KVH, Dh,
      bs, MB, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t msmem = sizeof(float) * (static_cast<size_t>(MB) * R + R);
  auto merge = paged_attention_merge<T>;
  e = allow_smem(merge, msmem);
  if (e != cudaSuccess) return e;
  merge<<<dim3(KVH, S), kMergeThreads, msmem, stream>>>(
      part_acc, part_m, part_l, static_cast<const int*>(pos),
      static_cast<T*>(out), Q, H, KVH, Dh, bs, MB);
  return cudaGetLastError();
}

}  // namespace

// Floats of f32 workspace a call needs (the partials of every block).
extern "C" long long kft_paged_attention_workspace(int S, int Q, int H,
                                                   int KVH, int Dh, int MB) {
  const long long n_part = static_cast<long long>(S) * KVH * MB * Q *
                           (H / KVH);
  return n_part * (Dh + 2);
}

// dtype: 0 = float32, 1 = bfloat16 (q, out, and the pools unless quant);
// quant: 1 = int8 pools with f32 scales; workspace: 16-byte-aligned f32
// buffer of kft_paged_attention_workspace(...) floats.  Returns the
// launches' CUDA error code (0 = success); they are asynchronous on
// `stream`.
extern "C" int kft_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* pos, void* out,
                                   void* workspace, int S, int Q, int H,
                                   int KVH, int Dh, int bs, int MB,
                                   int dtype, int quant, float scale,
                                   void* stream) {
  if (S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0 && !quant)
    e = launch<float, float, false>(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, pos, out, workspace, S, Q, H,
                                    KVH, Dh, bs, MB, scale, st);
  else if (dtype == 0)
    e = launch<float, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, pos, out, workspace, S, Q, H,
                                    KVH, Dh, bs, MB, scale, st);
  else if (dtype == 1 && !quant)
    e = launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, workspace, S,
        Q, H, KVH, Dh, bs, MB, scale, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, int8_t, true>(
        q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, workspace, S,
        Q, H, KVH, Dh, bs, MB, scale, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
