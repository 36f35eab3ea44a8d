// Blockwise online-softmax attention (FlashAttention), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas; single head, grid (q blocks, kv blocks) with the kv axis
// sequential, m / l / acc in VMEM scratch across the kv sweep), batched over
// (B, H) as ops.flash_attention_bh batches it, with GQA inside the kernel.
//
// What bounds it here: operations, 4 * S * T * D per head (half when
// causal) against S * D + 2 * T * D + S * D elements moved; the score matrix
// never reaches device memory. Two instances per head_dim (16, 32, 64, 128):
//
// bfloat16 (the serving path's type) is FlashAttention-2 on the tensor
// cores (mma_attention.cuh): one block of 4 warps per (b, h, tile of 64
// query rows), 16 rows per warp, heavy causal tiles scheduled first. The Q
// tile is copied to shared memory once and held as A fragments; K and V
// tiles of 64 keys of kv head h / (H / Hkv) go through a 3-stage cp.async
// ring (rows padded against bank conflicts), the next tiles' copies in
// flight while the current one computes; tiles wholly above the diagonal
// are never loaded. S = Q K^T and P V on mma.sync m16n8k16 with f32
// accumulators, the mask and the online softmax in registers (exp2f with
// log2(e) / sqrt(D) folded into the scale), P kept in registers as two
// bf16 halves (see the header), the output acc / max(l, 1e-30) rounded to
// bf16 once. It stays above its bound by what mma.sync leaves on the table
// against wgmma with TMA (later work), and by the second P V product.
//
// float32 stays on the CUDA cores, bit for bit the plain version's
// arithmetic (TF32 would lose the float32 token gates):
//   * one block of 64 threads per (b, h, tile of 64 query rows); each thread
//     owns one query row, holding q and its accumulator in registers;
//   * the block walks the key tiles (64 keys, 32 for head_dim 128) up to the
//     diagonal when causal: the tile's K and V for kv head h / (H / Hkv) are
//     loaded into shared memory by all threads, then every thread reads them
//     as broadcasts;
//   * keys are taken 16 at a time: 16 scores, their max, one rescale of the
//     row's running denominator and accumulator, then the 16 weighted rows of
//     V; a hidden key (past T, or above the diagonal) has weight exactly 0;
//   * the output is acc / max(l, 1e-30).
// Rows past S and keys past T are masked here, so any S and T are taken.
//
// Plain C interface (ctypes): flash_attention_launch returns the CUDA error
// code of the launch (0 on success), or -1 for a head_dim it has no
// instance for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_attention.cuh"

#define NEG_INF (-1e30f)

namespace {

constexpr int BLOCK_Q = 64;
constexpr int CHUNK = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// --- bfloat16: FlashAttention-2 on the tensor cores -------------------------

constexpr int STAGES = 3;  // K/V ring depth

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_att::Dims<D>::LD
         * (mma_att::ROWS + 2 * STAGES * mma_att::KT);
}

template <int D>
__global__ void __launch_bounds__(32 * mma_att::WARPS, 2)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int S, int Tk,
                            int H, int Hkv, int causal, float scale_log2) {
  using namespace mma_att;
  constexpr int LD = Dims<D>::LD;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + ROWS * LD;      // STAGES x KT x LD
  __nv_bfloat16* vs = ks + STAGES * KT * LD;

  // the longest causal tiles first: they bound the kernel's tail
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long long)b * S * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Tk * Hkv + kh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Tk * Hkv + kh) * D;

  for (int c = tid; c < ROWS * CH; c += 32 * WARPS) {
    const int row = c / CH, ch = c - row * CH;
    const bool ok = q0 + row < S;
    cp_async16(qs + row * LD + 8 * ch,
               ok ? qb + (q0 + row) * q_stride + 8 * ch : qb, ok);
  }
  cp_async_commit();
  const int k_end = causal ? min(Tk, q0 + ROWS) : Tk;
  const int n_tiles = (k_end + KT - 1) / KT;
  auto load_tile = [&](int i) {
    const int st = i % STAGES, k0 = i * KT;
    for (int c = tid; c < KT * CH; c += 32 * WARPS) {
      const int row = c / CH, ch = c - row * CH;
      const bool ok = k0 + row < Tk;
      const long long off = ok ? (k0 + row) * kv_stride + 8 * ch : 0;
      cp_async16(ks + (st * KT + row) * LD + 8 * ch, kb + off, ok);
      cp_async16(vs + (st * KT + row) * LD + 8 * ch, vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  uint32_t qa[D / 16][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // the thread's rows: +0, +8

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed; tile i - 1's stage is free
    if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1);
    cp_async_commit();
    if (i == 0) load_q<D>(qa, qs, 16 * warp);
    const int k0 = i * KT, st = i % STAGES;
    tile_step<D>(
        qa, ks + st * KT * LD, vs + st * KT * LD,
        [&](int half, int key) {
          const int kt = k0 + key;
          return kt < Tk && (!causal || kt <= row0 + 8 * half);
        },
        scale_log2, m, l, acc);
  }
  cp_async_wait<0>();  // (the Q copy, when there was no key tile)
  store_rows<D>(acc, l,
                row0 < S ? out + ((long long)b * S + row0) * q_stride
                               + (long long)h * D : nullptr,
                row0 + 8 < S ? out + ((long long)b * S + row0 + 8) * q_stride
                                   + (long long)h * D : nullptr);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Tk, int H, int Hkv, int causal,
               cudaStream_t stream) {
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  flash_attention_kernel<float, D><<<grid, BLOCK_Q, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Tk, H, Hkv,
      causal, sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int Tk, int H, int Hkv, int causal,
                float scale_log2, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + mma_att::ROWS - 1) / mma_att::ROWS, H, B);
  flash_attention_bf16_kernel<D><<<grid, 32 * mma_att::WARPS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, Tk, H, Hkv, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Tk, int H, int Hkv, int D,
                                      int causal, int dtype, float scale_log2,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(q, k, v, out, B, S, Tk, H, Hkv, causal, s);
      case 32: return launch_f32<32>(q, k, v, out, B, S, Tk, H, Hkv, causal, s);
      case 64: return launch_f32<64>(q, k, v, out, B, S, Tk, H, Hkv, causal, s);
      case 128: return launch_f32<128>(q, k, v, out, B, S, Tk, H, Hkv, causal, s);
      default: return -1;
    }
  }
  switch (D) {
    case 16: return launch_bf16<16>(q, k, v, out, B, S, Tk, H, Hkv, causal, scale_log2, s);
    case 32: return launch_bf16<32>(q, k, v, out, B, S, Tk, H, Hkv, causal, scale_log2, s);
    case 64: return launch_bf16<64>(q, k, v, out, B, S, Tk, H, Hkv, causal, scale_log2, s);
    case 128: return launch_bf16<128>(q, k, v, out, B, S, Tk, H, Hkv, causal, scale_log2, s);
    default: return -1;
  }
}
