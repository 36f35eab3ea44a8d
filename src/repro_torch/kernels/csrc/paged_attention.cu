// Paged attention over a block-table page pool, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (Pallas; scalar-prefetched block table driving the K/V index maps, one grid
// step per (slot, page), running max / denominator / accumulator in VMEM
// scratch across a slot's page sweep).
//
// What bounds it here: bytes. Every page that a row's block table names
// holds page_size entries of K and V for each kv head; a row reads them once
// and does two multiply-adds per element read, far below the ~300
// operations per byte where the tensor cores would start to matter. So the
// design keeps the traffic to the pages a row can see and does the rest on
// the CUDA cores:
//   * one block per (row, kv head); the block reads its own block-table row
//     (no scalar prefetch on this card) and walks the pages in order;
//   * for each page it first loads the page's ids and skips the page when no
//     entry is visible to the row (the null page, the unallocated tail of a
//     short row, a row disabled with pos = -1), so K and V of such pages are
//     never read;
//   * a visible page's K and V slices for the block's kv head go to shared
//     memory (K rows padded by one float against bank conflicts);
//   * one warp per query head of the group (G = H / Hkv <= 32): lane t scores
//     key t of the page, the warp reduces the running max and denominator
//     with shuffles, and each lane keeps D / 32 accumulator entries;
//   * float32 throughout with NEG_INF = -1e30; p is multiplied by the
//     visibility (p = 0 for a hidden entry), so a row that sees nothing
//     finalises to exact zeros, and the output is acc / max(l, 1e-30).
// Block-table entries outside [0, P) name no page and are skipped.
//
// Plain C interface (ctypes): paged_attention_launch returns the CUDA error
// code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)
#define MAX_D_PER_LANE 4  // head_dim <= 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ ids_pool,
    const int* __restrict__ block_table, const int* __restrict__ pos,
    T* __restrict__ out, int H, int Hkv, int D, int P, int ps, int n_pages,
    int window, float sqrt_d) {
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* ks = smem;                       // ps x (D + 1)
  float* vs = ks + ps * (D + 1);          // ps x D
  float* qs = vs + ps * D;                // G x D
  int* ids = reinterpret_cast<int*>(qs + G * D);  // ps

  const int p_r = pos[r];
  const long long q_off = ((long long)r * H + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += nthreads) qs[i] = to_f32(q[q_off + i]);

  float m = NEG_INF, l = 0.f;
  float acc[MAX_D_PER_LANE];
#pragma unroll
  for (int i = 0; i < MAX_D_PER_LANE; ++i) acc[i] = 0.f;

  const int* bt = block_table + (long long)r * n_pages;
  for (int j = 0; j < n_pages; ++j) {
    const int page = bt[j];
    __syncthreads();  // the previous page's tiles are no longer read
    int mine = 0;
    if (page >= 0 && page < P && p_r >= 0) {
      for (int t = tid; t < ps; t += nthreads) {
        const int id = ids_pool[(long long)page * ps + t];
        ids[t] = id;
        mine |= (id >= 0 && id <= p_r && (window <= 0 || id > p_r - window));
      }
    }
    if (!__syncthreads_or(mine)) continue;  // nothing visible on this page
    for (int i = tid; i < ps * D; i += nthreads) {
      const int t = i / D, d = i - t * D;
      const long long src = (((long long)page * ps + t) * Hkv + h) * D + d;
      ks[t * (D + 1) + d] = to_f32(k_pool[src]);
      vs[t * D + d] = to_f32(v_pool[src]);
    }
    __syncthreads();
    const float* qg = qs + g * D;
    for (int c = 0; c < ps; c += 32) {
      const int t = c + lane;
      bool valid = false;
      float s = NEG_INF;
      if (t < ps) {
        const int id = ids[t];
        valid = id >= 0 && id <= p_r && (window <= 0 || id > p_r - window);
        if (valid) {
          float dot = 0.f;
          const float* kt = ks + t * (D + 1);
          for (int d = 0; d < D; ++d) dot += qg[d] * kt[d];
          s = dot / sqrt_d;
        }
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < MAX_D_PER_LANE; ++i) acc[i] *= corr;
      const int nt = min(32, ps - c);
      for (int tt = 0; tt < nt; ++tt) {
        const float pt = __shfl_sync(0xffffffffu, p, tt);
        const float* vt = vs + (c + tt) * D;
#pragma unroll
        for (int i = 0; i < MAX_D_PER_LANE; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] += pt * vt[d];
        }
      }
      m = m_new;
    }
  }
  const float denom = fmaxf(l, 1e-30f);
  T* o = out + q_off + (long long)g * D;
#pragma unroll
  for (int i = 0; i < MAX_D_PER_LANE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store(o + d, acc[i] / denom);
  }
}

extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ids_pool, const void* block_table, const void* pos,
    void* out, int R, int H, int Hkv, int D, int P, int ps, int n_pages,
    int window, int dtype, void* stream) {
  const int G = H / Hkv;
  const dim3 grid(R, Hkv);
  const dim3 block(32 * G);
  const size_t smem =
      sizeof(float) * ((size_t)ps * (D + 1) + (size_t)ps * D + (size_t)G * D)
      + sizeof(int) * (size_t)ps;
  const float sqrt_d = sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_attention_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(ids_pool),
        static_cast<const int*>(block_table), static_cast<const int*>(pos),
        static_cast<float*>(out), H, Hkv, D, P, ps, n_pages, window, sqrt_d);
  } else {
    paged_attention_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(ids_pool),
        static_cast<const int*>(block_table), static_cast<const int*>(pos),
        static_cast<__nv_bfloat16*>(out), H, Hkv, D, P, ps, n_pages, window,
        sqrt_d);
  }
  return (int)cudaGetLastError();
}
