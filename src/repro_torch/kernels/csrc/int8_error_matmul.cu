// Error-injecting int8 matmul for Hopper (sm_90a), with optional fused
// row/column checksums.
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
// acc before the flips (the callers need the clean product for their
// requantisation limit and their SDC ledger; it costs one store per
// element instead of a second product).
//
// What bounds it on the H100 (1,979 int8 TOPS, 3.35 TB/s): the two random
// planes and the int32 output are 12 bytes per output element, so most
// calls are bound by bytes. At llama3.2-1b's MLP widths and M = 4096, the
// down product (K = 8192, N = 2048) does 1.4e11 operations (69 us) on
// 1.5e8 bytes (45 us) and is bound by operations; the up product
// (K = 2048, N = 8192) does as many on 4.3e8 bytes (127 us). LeNet's
// products (K = 9..256, N = 8..16) move a few MB each.
//
// Design (a simple kernel that is right first; wgmma s8 and TMA are later
// work): one 256-thread CTA per 64 x 64 output tile, a K loop over 32-byte
// slices staged through shared memory, and __dp4a for four int8 MACs per
// instruction. A is staged as it lies (K contiguous); B is transposed into
// shared memory so that four K values of one column pack into one word. The
// odd pitch (9 words per row) keeps both the transposed stores and the
// per-thread reads free of bank conflicts. Each thread owns a 4 x 4 grid of
// outputs strided by 16, so a warp's B reads fall in 16 different banks and
// its A reads are broadcasts.
//
// Wrapping: __dp4a adds in 32-bit two's complement without saturation, and
// the epilogue works in ``unsigned``, so every sum is mod 2^32 and defined.
// Edges: every load and store is bounds-checked (the TPU kernel padded
// instead); a lane outside (M, N) neither stores nor adds to a checksum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;            // int8 values of K per stage
constexpr int KW = BK / 4;        // packed 32-bit words per tile row
constexpr int PITCH = KW + 1;     // words per row in shared memory
constexpr int THREADS = 256;      // a 16 x 16 grid of threads
constexpr int TM = BM / 16;       // outputs per thread along M
constexpr int TN = BN / 16;       // outputs per thread along N
constexpr float TWO_POW_M32 = 1.0f / 4294967296.0f;  // exact: a power of two

__global__ void __launch_bounds__(THREADS)
int8_error_matmul_kernel(const int8_t* __restrict__ a,
                         const int8_t* __restrict__ b,
                         const unsigned* __restrict__ u_gate,
                         const unsigned* __restrict__ u_bit,
                         const float* __restrict__ cdf,
                         unsigned* __restrict__ c,
                         unsigned* __restrict__ clean,
                         unsigned* __restrict__ rowsum,
                         unsigned* __restrict__ colsum,
                         int M, int K, int N) {
  __shared__ int a_s[BM * PITCH];
  __shared__ int b_s[BN * PITCH];
  __shared__ float cdf_s[33];
  __shared__ unsigned row_part[BM];
  __shared__ unsigned col_part[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;
  const bool sums = rowsum != nullptr;

  if (tid < 33) cdf_s[tid] = cdf[tid];
  if (tid < BM) row_part[tid] = 0u;
  if (tid < BN) col_part[tid] = 0u;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  int8_t* a_b = reinterpret_cast<int8_t*>(a_s);
  int8_t* b_b = reinterpret_cast<int8_t*>(b_s);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: row r's K values k0..k0+31 at bytes [r * PITCH * 4, +32)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const long long gr = m0 + r;
      const int gk = k0 + k;
      a_b[r * PITCH * 4 + k] = (gr < M && gk < K) ? a[gr * K + gk] : 0;
    }
    // B tile, transposed: column n's K values at bytes [n * PITCH * 4, +32)
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k;
      const long long gn = n0 + n;
      b_b[n * PITCH * 4 + k] =
          (gk < K && gn < N) ? b[(long long)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[(ty + 16 * i) * PITCH + w];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[(tx + 16 * j) * PITCH + w];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one flip decision per output element, in the reference's
  // order of rounding (-fmad=false keeps every product rounded on its own)
  const float p_total = cdf_s[32];
  unsigned rs[TM], cs[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) rs[i] = 0u;
#pragma unroll
  for (int j = 0; j < TN; ++j) cs[j] = 0u;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (r >= M || n >= N) continue;
      const long long idx = r * N + n;
      unsigned v = (unsigned)acc[i][j];
      if (clean != nullptr) clean[idx] = v;
      const float u = __fmul_rn(__uint2float_rn(u_gate[idx]), TWO_POW_M32);
      if (u < p_total) {
        const float u2 = __fmul_rn(
            __fmul_rn(__uint2float_rn(u_bit[idx]), TWO_POW_M32), p_total);
        int bit = 0;
#pragma unroll
        for (int k = 1; k <= 32; ++k) bit += (u2 >= cdf_s[k]) ? 1 : 0;
        v ^= 1u << (bit > 31 ? 31 : bit);
      }
      c[idx] = v;
      rs[i] += v;
      cs[j] += v;
    }
  }
  if (!sums) return;  // uniform across the CTA
#pragma unroll
  for (int i = 0; i < TM; ++i) atomicAdd(&row_part[ty + 16 * i], rs[i]);
#pragma unroll
  for (int j = 0; j < TN; ++j) atomicAdd(&col_part[tx + 16 * j], cs[j]);
  __syncthreads();
  if (tid < BM && m0 + tid < M) atomicAdd(&rowsum[m0 + tid], row_part[tid]);
  if (tid < BN && n0 + tid < N) atomicAdd(&colsum[n0 + tid], col_part[tid]);
}

int launch(const void* a, const void* b, const void* u_gate,
           const void* u_bit, const void* cdf, void* c, void* clean,
           void* rowsum, void* colsum, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_error_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const unsigned*)u_gate,
      (const unsigned*)u_bit, (const float*)cdf, (unsigned*)c,
      (unsigned*)clean, (unsigned*)rowsum, (unsigned*)colsum, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, K) int8, b (K, N) int8, u_gate/u_bit (M, N) 32-bit, cdf (33,) f32,
// all contiguous -> c (M, N) int32 and, unless null, clean (M, N) int32.
// Launches on ``stream``; returns the CUDA error code of the launch.
extern "C" int overscale_matmul_launch(const void* a, const void* b,
                                       const void* u_gate, const void* u_bit,
                                       const void* cdf, void* c, void* clean,
                                       int M, int K, int N, void* stream) {
  return launch(a, b, u_gate, u_bit, cdf, c, clean, nullptr, nullptr, M, K,
                N, stream);
}

// As above, plus rowsum (M,) and colsum (N,) int32 of the corrupted c,
// accumulated with atomics: both must be zeroed before the launch.
extern "C" int abft_matmul_launch(const void* a, const void* b,
                                  const void* u_gate, const void* u_bit,
                                  const void* cdf, void* c, void* clean,
                                  void* rowsum, void* colsum, int M, int K,
                                  int N, void* stream) {
  return launch(a, b, u_gate, u_bit, cdf, c, clean, rowsum, colsum, M, K, N,
                stream);
}
