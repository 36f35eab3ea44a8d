// Blockwise online-softmax attention (FlashAttention), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas; single head, grid (q blocks, kv blocks) with the kv axis
// sequential, m / l / acc in VMEM scratch across the kv sweep), batched over
// (B, H) as ops.flash_attention_bh batches it, with GQA inside the kernel.
//
// What bounds it here: operations, 4 * S * T * D per head (half when
// causal) against S * D + 2 * T * D + S * D elements moved. The score matrix
// never reaches device memory. This first version computes on the CUDA
// cores in float32, so it stays well above the bound the tensor cores would
// give (wgmma tiles and TMA loads are later work):
//   * one block of 64 threads per (b, h, tile of 64 query rows); each thread
//     owns one query row, holding q and its accumulator in registers;
//   * the block walks the key tiles (64 keys, 32 for head_dim 128) up to the
//     diagonal when causal: the tile's K and V for kv head h / (H / Hkv) are
//     loaded into shared memory by all threads, then every thread reads them
//     as broadcasts;
//   * keys are taken 16 at a time: 16 scores, their max, one rescale of the
//     row's running denominator and accumulator, then the 16 weighted rows of
//     V; a hidden key (past T, or above the diagonal) has weight exactly 0;
//   * the output is acc / max(l, 1e-30) in the inputs' dtype.
// Rows past S and keys past T are masked here, so any S and T are taken.
//
// Plain C interface (ctypes): flash_attention_launch returns the CUDA error
// code of the launch (0 on success), or -1 for a head_dim it has no
// instance for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)

namespace {

constexpr int BLOCK_Q = 64;
constexpr int CHUNK = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_Q)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Tk, int H, int Hkv, int causal, float sqrt_d) {
  constexpr int BK = D <= 64 ? 64 : 32;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool row_ok = qi < S;

  float qr[D], acc[D];
  const long long q_off = (((long long)b * S + qi) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_f32(q[q_off + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int k_end = causal ? min(Tk, q0 + BLOCK_Q) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += BLOCK_Q) {
      const int t = i / D, d = i - t * D;
      const int kt = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (kt < Tk) {
        const long long src = (((long long)b * Tk + kt) * Hkv + kh) * D + d;
        kv = to_f32(k[src]);
        vv = to_f32(v[src]);
      }
      ks[t][d] = kv;
      vs[t][d] = vv;
    }
    __syncthreads();
    for (int c = 0; c < BK; c += CHUNK) {
      float s[CHUNK];
      unsigned visible = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int kt = k0 + c + j;
        const bool ok = kt < Tk && (!causal || kt <= qi);
        float dot = 0.f;
        const float4* kr = reinterpret_cast<const float4*>(ks[c + j]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kk = kr[d4];
          dot += qr[4 * d4] * kk.x;
          dot += qr[4 * d4 + 1] * kk.y;
          dot += qr[4 * d4 + 2] * kk.z;
          dot += qr[4 * d4 + 3] * kk.w;
        }
        s[j] = ok ? dot / sqrt_d : NEG_INF;
        visible |= (ok ? 1u : 0u) << j;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        s[j] = ((visible >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = s[j];
        const float4* vr = reinterpret_cast<const float4*>(vs[c + j]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += p * vv.x;
          acc[4 * d4 + 1] += p * vv.y;
          acc[4 * d4 + 2] += p * vv.z;
          acc[4 * d4 + 3] += p * vv.w;
        }
      }
      m = m_new;
    }
  }
  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) store(out + q_off + d, acc[d] / denom);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int Hkv, int causal, cudaStream_t stream) {
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  flash_attention_kernel<T, D><<<grid, BLOCK_Q, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, Hkv, causal,
      sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Tk, int H, int Hkv, int D, int causal,
                 cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, Hkv, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, Hkv, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, Hkv, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, Hkv, causal, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Tk, int H, int Hkv, int D,
                                      int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, out, B, S, Tk, H, Hkv, D, causal, s);
  return launch_dtype<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, Hkv, D,
                                     causal, s);
}
