// Error-injecting int8 matmul for Hopper (sm_90a) on the s8 tensor cores,
// with optional fused row/column checksums.
//
// Replaces two TPU kernels of the JAX package, which share one body:
//   repro/kernels/overscale_matmul.py::overscale_matmul (pallas_call :78)
//   repro/kernels/abft_matmul.py::abft_matmul           (pallas_call :98)
//
//   acc[i, j] = sum_k a[i, k] * b[k, j]            int8 x int8 -> int32, mod 2^32
//   u   = f32(u_gate[i, j]) * 2^-32                 (round to nearest)
//   u2  = (f32(u_bit[i, j]) * 2^-32) * p_total      (p_total = cdf[32])
//   bit = min(#{k in 1..32 : u2 >= cdf[k]}, 31)
//   c[i, j] = u < p_total ? acc ^ (1u << bit) : acc
//
// and, for the ABFT entry, rowsum[i] = sum_j c[i, j] and colsum[j] =
// sum_i c[i, j], both mod 2^32. An optional second output ``clean`` holds
// acc before the flips (the callers' requantisation limit and SDC ledger).
//
// What bounds it on the H100 (1,979 int8 TOPS, 3.35 TB/s): the two random
// planes and the int32 output are 12 bytes per output element, so most
// calls are bound by bytes, and the epilogue moves most of them. At
// llama3.2-1b's MLP widths and M = 4096 the up product (K = 2048, N = 8192)
// is bound by its 4.3e8 bytes (0.128 ms), the down product (K = 8192,
// N = 2048) by its 1.4e11 operations (0.069 ms); at M = 48 both are bound by
// the 16 MB weight (~0.006 ms). LeNet's products (K = 9..256, N = 8..16)
// move a few MB each and do almost no arithmetic.
//
// Design:
// * The product runs on mma.sync m16n8k32 .s32.s8.s8.s32 WITHOUT
//   .satfinite: the int32 accumulators wrap, and integer sums are exact in
//   any order, so the kernel equals its plain version bit for bit however
//   the tiles, the tensor cores or the split-K partials add up.
// * Operands, 64 values of K per tile, through a cp.async ring of 3 to 6
//   stages (one group per tile). A (M, K) is K-major, as the A operand
//   wants it: 16-byte copies (8 where K is a multiple of 8 only, as LeNet's
//   K = 72; byte loads where K is odd) into rows padded to 80 bytes, so the
//   8 row addresses of an ldmatrix fall in distinct banks. B (K, N) is
//   N-major, but the .col B operand wants K contiguous per column: B lands
//   as it lies (16-byte chunks XOR-swizzled by row, so a quarter-warp's
//   16-byte reads of 8 rows hit 8 distinct chunks), then each tile is
//   transposed once into a K-major tile with the same 80-byte rows (4 rows
//   x 16 columns per thread: 4 loads, 32 __byte_perm, 16 stores), between
//   two __syncthreads, and read with ldmatrix like A.
// * Tiles (the host's plan() in overscale_matmul.py picks one):
//     wide  128 x 128, 4 warps of 64 x 64   llama's products;
//     short  64 x 128, 4 warps of 64 x 32   M <= 64 (48 tokens);
//     n16   256 x  16, 8 warps of 32 x 16   LeNet, 8 < N <= 16;
//     n8    256 x   8, 8 warps of 32 x  8   LeNet, N <= 8.
//   Where the output tiles are fewer than the SMs, K is split across CTAs:
//   each split writes its partial sums to a scratch plane, and the last CTA
//   of a tile to arrive (a ticket per tile, reset by that CTA) adds the
//   others' to its own and runs the epilogue, so flips and checksums see
//   the whole sum.
// * Epilogue: the accumulators go through shared memory (the ring is free
//   by then), and a thread takes 4 neighbouring columns of a row, so a
//   warp reads both planes and writes c (and clean) as 512 contiguous
//   bytes, 16 bytes a lane where N is a multiple of 4. Eight rows are in
//   flight at once: both planes of all of them are loaded together, and
//   the bits of their flips found together (a 6-step search of the cdf
//   where it does not decrease, the searches in lockstep), so a thread
//   waits on one round trip to memory per 8 rows. Row sums: a shuffle
//   across the lanes of a row, one global atomic per row per CTA; column
//   sums: per thread, then shared-memory atomics, one global atomic per
//   column per CTA.
// * Edges are masked in the kernel (zero-filled loads, no store outside
//   (M, N)); the TPU kernel padded instead.
// Flip decisions round as the reference does (-fmad=false, __fmul_rn).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // int8 values of K per tile
constexpr int PITCH = BK + 16;  // bytes per shared-memory row
constexpr float TWO_POW_M32 = 1.0f / 4294967296.0f;  // exact: a power of two

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;  // depth of the cp.async ring
  static constexpr int MINB = MINB_;      // CTAs an SM must hold
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // one warp's outputs
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // m16 and n8 tiles
  static constexpr int A_STAGE = BM * PITCH;          // A, K-major
  static constexpr int B_STAGE = BK * BN;             // B as it lies
  static constexpr int BT = BN * PITCH;               // B, K-major
  // the transpose's unit: 4 rows of K x 16 columns (8 where BN = 8)
  static constexpr int UNIT_N = BN < 16 ? BN : 16;
  static constexpr int UNITS = (BK / 4) * (BN / UNIT_N);
  static constexpr int UNITS_PER_THREAD = (UNITS + THREADS - 1) / THREADS;
  // 16-byte chunks of a staged B row are XOR-swizzled by bits 2..4 of the
  // row, so the 8 rows a quarter-warp of the transpose reads fall in 8
  // distinct chunks
  static constexpr int SWIZZLE = BN >= 128 ? 7 : 0;
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) + BT;
  // the epilogue's tile of accumulators, rows padded by 4 words
  static constexpr int TP = BN + 4;
  static_assert(BM * TP * 4 <= SMEM, "the epilogue's tile fits the ring");
  static_assert(THREADS % (BN / 4) == 0 && BM % (THREADS / (BN / 4)) == 0,
                "every warp takes whole rows, the same count of them");
};
using Wide = Tile<128, 128, 2, 2, 4, 2>;
using Short = Tile<64, 128, 1, 4, 6, 2>;
using N16 = Tile<256, 16, 8, 1, 3, 2>;
using N8 = Tile<256, 8, 8, 1, 3, 2>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies; with ok false nothing is read and the destination
// is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if (W == 16) cp_async16(dst, src, ok);
  else if (W == 8) cp_async8(dst, src, ok);
  else cp_async4(dst, src, ok);
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
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c (16x8 s32) += a (16x32 s8, row) b (32x8 s8, col), wrapping mod 2^32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A tile (BM rows x 64 values of K from k0) into one stage of the ring,
// W bytes per copy; a thread's rows and columns are fixed across tiles
template <class T, int W>
__device__ __forceinline__ void load_a_w(int8_t* as, const int8_t* a,
                                         long long m0, int k0, int M, int K) {
  constexpr int CPR = BK / W;  // copies per row
  for (int e = threadIdx.x; e < T::BM * CPR; e += T::THREADS) {
    const int r = e / CPR, k = (e % CPR) * W;
    const long long gr = m0 + r;
    const bool ok = gr < M && k0 + k < K;
    cp_async<W>(as + r * PITCH + k, ok ? a + gr * K + k0 + k : a, ok);
  }
}

// ``aw`` bytes per copy: 16, 8, or 1 (plain byte loads, where K is odd)
template <class T>
__device__ __forceinline__ void load_a(int8_t* as, const int8_t* a,
                                       long long m0, int k0, int M, int K,
                                       int aw) {
  if (aw == 16) {
    load_a_w<T, 16>(as, a, m0, k0, M, K);
  } else if (aw == 8) {
    load_a_w<T, 8>(as, a, m0, k0, M, K);
  } else {
    for (int e = threadIdx.x; e < T::BM * (BK / 4); e += T::THREADS) {
      const int r = e / (BK / 4), w = e % (BK / 4);
      const long long gr = m0 + r;
      uint32_t v = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + 4 * w + j;
        if (gr < M && gk < K) v |= (uint32_t)(uint8_t)a[gr * K + gk] << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(as + r * PITCH + 4 * w) = v;
    }
  }
}

// byte offset of (row k, column n) in a staged B tile
template <class T>
__device__ __forceinline__ int bs_off(int k, int n) {
  return k * T::BN + ((((n >> 4) ^ ((k >> 2) & T::SWIZZLE)) << 4) | (n & 15));
}

// B tile (64 values of K from k0 x BN columns) into one stage of the ring
// as it lies (N-major), W bytes per copy
template <class T, int W>
__device__ __forceinline__ void load_b_w(int8_t* bs, const int8_t* b, int k0,
                                         long long n0, int K, int N) {
  constexpr int CPR = T::BN / W;  // copies per row
  for (int e = threadIdx.x; e < BK * CPR; e += T::THREADS) {
    const int r = e / CPR, n = (e % CPR) * W;
    const long long gn = n0 + n;
    const bool ok = k0 + r < K && gn < N;
    cp_async<W>(bs + bs_off<T>(r, n),
                ok ? b + (long long)(k0 + r) * N + gn : b, ok);
  }
}

// ``bw`` bytes per copy: 16, 8, 4, or 1 (plain byte loads, where N is not
// a multiple of 4)
template <class T>
__device__ __forceinline__ void load_b(int8_t* bs, const int8_t* b, int k0,
                                       long long n0, int K, int N, int bw) {
  if (bw == 16) {
    if constexpr (T::BN >= 16) load_b_w<T, 16>(bs, b, k0, n0, K, N);
  } else if (bw == 8) {
    load_b_w<T, 8>(bs, b, k0, n0, K, N);
  } else if (bw == 4) {
    load_b_w<T, 4>(bs, b, k0, n0, K, N);
  } else {
    for (int e = threadIdx.x; e < BK * (T::BN / 4); e += T::THREADS) {
      const int r = e / (T::BN / 4), n = (e % (T::BN / 4)) * 4;
      const int gk = k0 + r;
      uint32_t v = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long gn = n0 + n + j;
        if (gk < K && gn < N)
          v |= (uint32_t)(uint8_t)b[(long long)gk * N + gn] << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(bs + bs_off<T>(r, n)) = v;
    }
  }
}

// 4 words of 4 rows of K (byte e: column e) -> 4 words of 4 columns (byte
// j: row j), by 8 __byte_perm
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t* dst) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  dst[0] = __byte_perm(t0, t1, 0x5410);
  dst[PITCH / 4] = __byte_perm(t0, t1, 0x7632);
  dst[2 * PITCH / 4] = __byte_perm(t2, t3, 0x5410);
  dst[3 * PITCH / 4] = __byte_perm(t2, t3, 0x7632);
}

// A staged B tile transposed into the K-major tile, a unit at a time: 4
// rows of K (kb) x UNIT_N columns (nq), read as one 16- (or 8-) byte load
// per row (the swizzle puts the 8 rows of a quarter-warp in 8 distinct
// chunks), written as one word per column.
template <class T>
__device__ __forceinline__ void transpose_b(int8_t* bt, const int8_t* bs) {
#pragma unroll
  for (int i = 0; i < T::UNITS_PER_THREAD; ++i) {
    const int u = threadIdx.x + i * T::THREADS;
    if (u >= T::UNITS) continue;
    const int kb = u % (BK / 4), nq = u / (BK / 4);
    uint32_t w[4][T::UNIT_N / 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* src = bs + bs_off<T>(4 * kb + j, T::UNIT_N * nq);
      if constexpr (T::UNIT_N == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        w[j][0] = v.x;
        w[j][1] = v.y;
        w[j][2] = v.z;
        w[j][3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[j][0] = v.x;
        w[j][1] = v.y;
      }
    }
#pragma unroll
    for (int q = 0; q < T::UNIT_N / 4; ++q)
      transpose4(w[0][q], w[1][q], w[2][q], w[3][q],
                 reinterpret_cast<uint32_t*>(
                     bt + (T::UNIT_N * nq + 4 * q) * PITCH + 4 * kb));
  }
}

// One 64-deep tile of the warp's (MT x 16) x (NT x 8) outputs.
template <class T>
__device__ __forceinline__ void compute(int (&acc)[T::MT][T::NT][4],
                                        const int8_t* as, const int8_t* bt,
                                        int wm, int wn) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    uint32_t af[T::MT][4], bf[T::NT][2];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
      ldmatrix_x4(af[mt], as + (wm * T::WTM + 16 * mt + r + 8 * (mi & 1)) * PITCH
                              + 32 * ks + 16 * (mi >> 1));
#pragma unroll
    for (int np = 0; np < T::NT / 2; ++np) {
      uint32_t x[4];
      ldmatrix_x4(x, bt + (wn * T::WTN + 16 * np + r + 8 * (mi >> 1)) * PITCH
                         + 32 * ks + 16 * (mi & 1));
      bf[2 * np][0] = x[0];
      bf[2 * np][1] = x[1];
      bf[2 * np + 1][0] = x[2];
      bf[2 * np + 1][1] = x[3];
    }
    if (T::NT & 1) {
      uint32_t x[2];
      ldmatrix_x2(x, bt + (wn * T::WTN + 8 * (T::NT - 1) + r) * PITCH
                         + 32 * ks + 16 * (mi & 1));
      bf[T::NT - 1][0] = x[0];
      bf[T::NT - 1][1] = x[1];
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
  }
}

// whether an element flips, in the reference's order of rounding
__device__ __forceinline__ bool gate(unsigned ug, float p_total) {
  return __fmul_rn(__uint2float_rn(ug), TWO_POW_M32) < p_total;
}
// u2 = (f32(u_bit) * 2^-32) * p_total, rounded as the reference rounds it
__device__ __forceinline__ float bit_draw(unsigned ub, float p_total) {
  return __fmul_rn(__fmul_rn(__uint2float_rn(ub), TWO_POW_M32), p_total);
}
// 4 neighbouring elements of a plane from ``p`` (column ``col`` of N): one
// 16-byte access when ``vec``, else one per element inside N; ``l2``
// reads through L2 only (another CTA's partial sums)
__device__ __forceinline__ uint4 ld4(const unsigned* p, long long col, int N,
                                     bool vec, bool l2) {
  if (vec)
    return l2 ? __ldcg(reinterpret_cast<const uint4*>(p))
              : *reinterpret_cast<const uint4*>(p);
  unsigned x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < N) x[e] = l2 ? __ldcg(p + e) : p[e];
  return make_uint4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st4(unsigned* p, uint4 v, long long col,
                                    int N, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < N) p[e] = x[e];
}
__device__ __forceinline__ uint4 ld4s(const unsigned* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <class T, bool SUMS>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
int8_error_mma_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ b,
                      const unsigned* __restrict__ u_gate,
                      const unsigned* __restrict__ u_bit,
                      const float* __restrict__ cdf, unsigned* __restrict__ c,
                      unsigned* __restrict__ clean,
                      unsigned* __restrict__ rowsum,
                      unsigned* __restrict__ colsum,
                      unsigned* __restrict__ partial, int* __restrict__ tickets,
                      int M, int K, int N, int kt_per_split, int aw, int bw,
                      int vec) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* as = smem;                               // STAGES x A_STAGE
  int8_t* bs = as + T::STAGES * T::A_STAGE;        // STAGES x B_STAGE
  int8_t* bts = bs + T::STAGES * T::B_STAGE;       // BT
  __shared__ float cdf_s[33];
  __shared__ unsigned col_part[T::BN];
  __shared__ int last, sorted;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * T::BM;
  const long long n0 = (long long)blockIdx.y * T::BN;
  const int kt_all = K > 0 ? (K + BK - 1) / BK : 1;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nk = min(kt_all, kt0 + kt_per_split) - kt0;  // >= 1 (host plan)

  if (tid < 33) cdf_s[tid] = cdf[tid];
  if (tid < 32) {  // does cdf[1..32] never decrease? (NaN: no)
    const float lo = cdf[tid + 1];
    const float hi = cdf[tid < 31 ? tid + 2 : 32];
    const bool up = __all_sync(0xffffffffu, lo <= hi);
    if (tid == 0) sorted = up;
  }
  if (SUMS)
    for (int i = tid; i < T::BN; i += T::THREADS) col_part[i] = 0u;

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // the pipeline: A and B STAGES - 1 tiles ahead (one cp.async group per
  // tile); each tile's B transposed once it has landed, between two
  // __syncthreads
  constexpr int S = T::STAGES;
  auto load = [&](int i) {
    if (i < nk) {
      load_a<T>(as + (i % S) * T::A_STAGE, a, m0, (kt0 + i) * BK, M, K, aw);
      load_b<T>(bs + (i % S) * T::B_STAGE, b, (kt0 + i) * BK, n0, K, N, bw);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load(i);
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<S - 2>();  // tile i has landed
    __syncthreads();         // ... for every thread; tile i - 1 is consumed
    load(i + S - 1);
    transpose_b<T>(bts, bs + (i % S) * T::B_STAGE);
    __syncthreads();
    compute<T>(acc, as + (i % S) * T::A_STAGE, bts, wm, wn);
  }

  // the epilogue streams whole rows: the accumulators go through shared
  // memory (the ring is free now), then a thread takes 4 neighbouring
  // columns (16 bytes) of a row, a warp 512 contiguous bytes of the planes
  // and of c
  cp_async_wait<0>();
  __syncthreads();
  unsigned* tile = reinterpret_cast<unsigned*>(smem);  // BM x TP
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint2*>(
            tile + (wm * T::WTM + 16 * mt + g + 8 * h) * T::TP + wn * T::WTN
            + 8 * nt + 2 * t) =
            make_uint2((unsigned)acc[mt][nt][2 * h],
                       (unsigned)acc[mt][nt][2 * h + 1]);
  __syncthreads();

  constexpr int GPR = T::BN / 4;           // 4-column groups per row
  constexpr int RPP = T::THREADS / GPR;    // rows per pass
  constexpr int ITERS = T::BM / RPP;       // rows a thread takes
  constexpr int U = ITERS < 8 ? ITERS : 8;  // of them in flight at once
  static_assert(ITERS % U == 0, "whole batches of rows");
  const int cg = tid % GPR, r0 = tid / GPR;
  const long long col = n0 + 4 * cg;
  const bool vec4 = vec != 0;  // N % 4 == 0 and every plane 16-byte aligned
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  if (gridDim.z > 1) {
    // split-K: leave the partial sums; the last split of the tile to
    // arrive adds them all (integer sums: exact in any order)
    unsigned* mine = partial + (long long)blockIdx.z * M * N;
    for (int r = r0; r < T::BM; r += RPP) {
      const long long row = m0 + r;
      if (row < M && col < N)
        st4(mine + row * N + col, ld4s(tile + r * T::TP + 4 * cg), col, N,
            vec4);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(&tickets[tile_id], 1) == (int)gridDim.z - 1;
      if (last) tickets[tile_id] = 0;  // ready for the next call
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int rb = 0; rb < ITERS; rb += U)
      for (int z = 0; z < (int)gridDim.z; ++z) {
        if (z == (int)blockIdx.z) continue;
        const unsigned* other = partial + (long long)z * M * N;
        uint4 o[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long row = m0 + r0 + (rb + u) * RPP;
          o[u] = row < M && col < N
                     ? ld4(other + row * N + col, col, N, vec4, true)
                     : zero4;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          unsigned* x = tile + (r0 + (rb + u) * RPP) * T::TP + 4 * cg;
          x[0] += o[u].x;
          x[1] += o[u].y;
          x[2] += o[u].z;
          x[3] += o[u].w;
        }
      }
  }

  // U rows at a time, both planes of all of them read together: a thread
  // waits on one round trip to memory per batch, not two per row. The bit
  // of every flip is bit = min(#{k in 1..32 : u2 >= cdf[k]}, 31). Where
  // cdf[1..32] does not decrease (a cumulative sum of probabilities) the k
  // counted are a prefix, found in 6 halving steps, the batch's 4 U
  // searches in lockstep so that their shared-memory reads overlap;
  // otherwise all 32 are counted, as the plain version does.
  const float p_total = cdf_s[32];
  const bool cdf_sorted = sorted != 0;
  unsigned cs[4] = {0u, 0u, 0u, 0u};
  for (int rb = 0; rb < ITERS; rb += U) {
    uint4 ug[U], ub[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = m0 + r0 + (rb + u) * RPP;
      ok[u] = row < M && col < N;
      ug[u] = ok[u] ? ld4(u_gate + row * N + col, col, N, vec4, false)
                    : zero4;
      ub[u] = ok[u] ? ld4(u_bit + row * N + col, col, N, vec4, false)
                    : zero4;
    }
    unsigned mask[U][4];  // the bit each element flips, or 0
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned g4[4] = {ug[u].x, ug[u].y, ug[u].z, ug[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mask[u][e] = ok[u] && col + e < N && gate(g4[e], p_total) ? 1u : 0u;
        any |= mask[u][e] != 0u;
      }
    }
    if (__any_sync(0xffffffffu, any)) {
      float u2[U][4];
      int bit[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned b4[4] = {ub[u].x, ub[u].y, ub[u].z, ub[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          u2[u][e] = bit_draw(b4[e], p_total);
          bit[u][e] = 0;
        }
      }
      if (cdf_sorted) {
#pragma unroll
        for (int step = 32; step >= 1; step >>= 1)
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = bit[u][e] + step;
              bit[u][e] +=
                  (j <= 32 && u2[u][e] >= cdf_s[j <= 32 ? j : 0]) ? step : 0;
            }
      } else {
        for (int k = 1; k <= 32; ++k)
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              bit[u][e] += (u2[u][e] >= cdf_s[k]) ? 1 : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mask[u][e] = mask[u][e] ? 1u << (bit[u][e] > 31 ? 31 : bit[u][e])
                                  : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + (rb + u) * RPP;
      const long long row = m0 + r;
      const long long idx = row * N + col;
      unsigned rsum = 0u;
      if (ok[u]) {
        const uint4 v = ld4s(tile + r * T::TP + 4 * cg);
        if (clean != nullptr) st4(clean + idx, v, col, N, vec4);
        const unsigned x[4] = {v.x ^ mask[u][0], v.y ^ mask[u][1],
                               v.z ^ mask[u][2], v.w ^ mask[u][3]};
        st4(c + idx, make_uint4(x[0], x[1], x[2], x[3]), col, N, vec4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) {
            rsum += x[e];
            cs[e] += x[e];
          }
      }
      if (SUMS) {
        // the row's GPR groups are neighbouring lanes of one warp
#pragma unroll
        for (int off = GPR / 2; off >= 1; off >>= 1)
          rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        if (cg == 0 && row < M) atomicAdd(&rowsum[row], rsum);
      }
    }
  }
  if (!SUMS) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) atomicAdd(&col_part[4 * cg + e], cs[e]);
  __syncthreads();
  for (int i = tid; i < T::BN; i += T::THREADS)
    if (n0 + i < N) atomicAdd(&colsum[n0 + i], col_part[i]);
}

struct Args {
  const void *a, *b, *u_gate, *u_bit, *cdf;
  void *c, *clean, *rowsum, *colsum, *partial, *tickets;
  int M, K, N, per, aw, bw, vec;  // per: 64-deep K tiles per split
};

template <class T, bool SUMS>
int run(const Args& x, cudaStream_t stream) {
  const int kt_all = x.K > 0 ? (x.K + BK - 1) / BK : 1;
  const int per = x.per < 1 ? kt_all : x.per;
  const dim3 grid((x.M + T::BM - 1) / T::BM, (x.N + T::BN - 1) / T::BN,
                  (kt_all + per - 1) / per);
  auto kernel = int8_error_mma_kernel<T, SUMS>;
  static int ready = -1;  // the device the shared-memory limit was set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != ready) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err == cudaSuccess) ready = dev;
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      (const int8_t*)x.a, (const int8_t*)x.b, (const unsigned*)x.u_gate,
      (const unsigned*)x.u_bit, (const float*)x.cdf, (unsigned*)x.c,
      (unsigned*)x.clean, (unsigned*)x.rowsum, (unsigned*)x.colsum,
      (unsigned*)x.partial, (int*)x.tickets, x.M, x.K, x.N, per, x.aw, x.bw,
      x.vec);
  return (int)cudaGetLastError();
}

template <bool SUMS>
int dispatch(int tile, const Args& x, void* stream) {
  if (x.M <= 0 || x.N <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return run<Wide, SUMS>(x, s);
    case 1: return run<Short, SUMS>(x, s);
    case 2: return run<N16, SUMS>(x, s);
    case 3: return run<N8, SUMS>(x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a (M, K) int8, b (K, N) int8, u_gate/u_bit (M, N) 32-bit, cdf (33,) f32,
// all contiguous -> c (M, N) int32 and, unless null, clean (M, N) int32.
// ``tile`` (0 wide, 1 short, 2 n16, 3 n8), ``per`` (64-deep K tiles per
// split: ceil(K / 64) / per splits, rounded up), the load widths ``aw``
// (16, 8, 1) and ``bw`` (16, 8, 4, 1) and ``vec`` (N a multiple of 4 and
// every plane 16-byte aligned) come from the host's plan. With more than one split,
// ``partial`` holds splits x M x N int32 and ``tickets`` one zeroed int per
// output tile (left zeroed). Launches on ``stream``; returns the CUDA error
// code of the launch.
extern "C" int overscale_matmul_launch(const void* a, const void* b,
                                       const void* u_gate, const void* u_bit,
                                       const void* cdf, void* c, void* clean,
                                       void* partial, void* tickets, int M,
                                       int K, int N, int tile, int per,
                                       int aw, int bw, int vec,
                                       void* stream) {
  const Args x{a, b, u_gate, u_bit, cdf, c, clean, nullptr, nullptr,
               partial, tickets, M, K, N, per, aw, bw, vec};
  return dispatch<false>(tile, x, stream);
}

// As above, plus rowsum (M,) and colsum (N,) int32 of the corrupted c,
// accumulated with atomics: both must be zeroed before the launch.
extern "C" int abft_matmul_launch(const void* a, const void* b,
                                  const void* u_gate, const void* u_bit,
                                  const void* cdf, void* c, void* clean,
                                  void* rowsum, void* colsum, void* partial,
                                  void* tickets, int M, int K, int N,
                                  int tile, int per, int aw, int bw,
                                  int vec, void* stream) {
  const Args x{a, b, u_gate, u_bit, cdf, c, clean, rowsum, colsum,
               partial, tickets, M, K, N, per, aw, bw, vec};
  return dispatch<true>(tile, x, stream);
}
