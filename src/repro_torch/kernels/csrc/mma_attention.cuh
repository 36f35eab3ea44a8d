// Shared pieces of the bf16 tensor-core attention kernels (flash attention
// and the paged extend), for sm_90a.
//
// One warp owns 16 query rows (an m16 tile) and takes the keys 64 at a time
// (one tile of the block's shared-memory ring):
//   * S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulators): Q as A
//     fragments in registers (ldmatrix, loaded once), K as B fragments
//     (ldmatrix) from the tile's rows;
//   * the mask and the online softmax in registers: s2 = S * scale_log2
//     (log2(e) / sqrt(D) folded into one product), a hidden key scores
//     NEG_INF and weighs exactly 0, p = exp2f(s2 - m_new), the row's max and
//     sum over the quad of lanes that holds it (xor 1, then xor 2);
//   * P V on mma.sync: the accumulator layout of S is the A-fragment layout
//     of m16n8k16, so P stays in registers; V as B fragments (ldmatrix
//     .trans). P goes in as two bf16 halves, hi = bf16(p) and
//     lo = bf16(p - hi), two products into one accumulator: p keeps ~16
//     bits, as close to the float32 weights of the TPU kernel as two bf16
//     products come (one rounding of p to bf16 moves the reduced llama's
//     bf16 logits past the reference's 0.06 bound). A weight or rescale
//     factor below 2^-100 (exp2 of less than -100) counts as 0, so every
//     half that reaches the tensor cores is 0 or a normal number.
// The tensor cores sum each m16n8k16 step in their own way (the 16
// products and the accumulator aligned to the largest operand-exponent
// sum, cut to 25 bits below it, the sum cut to float32);
// flash_attention.py's tensor_core_mma repeats that step, so the plain
// versions follow these kernels bit for bit.
// Tile rows are padded by 8 elements (16 bytes), so the 8 row addresses of
// an ldmatrix and the 16-byte cp.async stores fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_att {

constexpr int KT = 64;          // keys per tile
constexpr int WARPS = 4;        // warps per block, 16 query rows each
constexpr int ROWS = 16 * WARPS;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Dims {
  static constexpr int LD = D + 8;  // padded row, in elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with ok false the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16) b (16x8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 x0, __nv_bfloat16 x1) {
  return (uint32_t)__bfloat16_as_ushort(x0)
         | ((uint32_t)__bfloat16_as_ushort(x1) << 16);
}

// (hi, lo) fragments of the weights x0, x1: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in float32)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
            __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// The warp's 16 rows of Q (rows row0.. of a tile with LD-element rows) as A
// fragments, one per 16 columns of D.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* qs, int row0) {
  constexpr int LD = Dims<D>::LD;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], qs + (row0 + 8 * (mi & 1) + r) * LD + 16 * kk
                            + 8 * (mi >> 1));
}

// One 64-key tile for the warp's 16 rows. visible(half, key) says whether
// key (0..63 in the tile) is visible to the thread's row g (half 0) or
// g + 8 (half 1), g = lane / 4. m, l: the running max (in log2 units) and
// denominator of those two rows; acc: their D accumulator columns, 2 per
// 8-column tile.
template <int D, typename Visible>
__device__ __forceinline__ void tile_step(const uint32_t (&qa)[D / 16][4],
                                          const __nv_bfloat16* ks,
                                          const __nv_bfloat16* vs,
                                          Visible visible, float scale_log2,
                                          float (&m)[2], float (&l)[2],
                                          float (&acc)[D / 8][4]) {
  constexpr int LD = Dims<D>::LD;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const int tig = lane & 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + (16 * np + 8 * (mi >> 1) + r) * LD + 16 * kk
                         + 8 * (mi & 1));
      mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
  // element (nt, e): row half e >> 1, key 8 nt + 2 tig + (e & 1)
  uint32_t vis = 0u;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = visible(e >> 1, 8 * nt + 2 * tig + (e & 1));
      vis |= (ok ? 1u : 0u) << (4 * nt + e);
      s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]), x = m[h] - m_new;
    corr[h] = x >= -100.f ? exp2f(x) : 0.f;
    m[h] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e] - m[e >> 1];
      s[nt][e] = ((vis >> (4 * nt + e)) & 1u) && x >= -100.f ? exp2f(x) : 0.f;
      sum[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * corr[h] + sum[h];
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] *= corr[0];
    acc[dn][1] *= corr[0];
    acc[dn][2] *= corr[1];
    acc[dn][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ah[4], al[4];
    split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
    split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
    split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
    split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (16 * kk + 8 * (mi & 1) + r) * LD + 16 * dp
                               + 8 * (mi >> 1));
      mma_bf16(acc[2 * dp], ah, b[0], b[1]);
      mma_bf16(acc[2 * dp], al, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], ah, b[2], b[3]);
      mma_bf16(acc[2 * dp + 1], al, b[2], b[3]);
    }
  }
}

// acc / max(l, 1e-30) of the thread's two rows, rounded to bf16 once: the
// row g + 8 * half's columns 8 dn + 2 tig, + 1 go to row_out[half].
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           const float (&l)[2],
                                           __nv_bfloat16* row_out0,
                                           __nv_bfloat16* row_out1) {
  const int tig = threadIdx.x & 3;
  __nv_bfloat16* outs[2] = {row_out0, row_out1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (outs[h] == nullptr) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[dn][2 * h] / denom, acc[dn][2 * h + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(outs[h] + 8 * dn + 2 * tig) = v;
    }
  }
}

}  // namespace mma_att
