// Fused multi-sweep thermal stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/thermal_stencil.py::thermal_stencil
// (the pallas_call at :82): K sweeps of
//     T <- ((P + g_v_tamb) + g_lat * (((up + dn) + lf) + rt)) / diag
// on B float32 grids of m x n cells with zero-padded borders. phase < 0 runs
// Jacobi sweeps; phase 0|1 runs red-black Gauss-Seidel sweeps starting on the
// colour (row + col) % 2 == phase, each colour reading the freshly written
// other colour.
//
// What bounds it: bytes. A call must read T, P and diag once and write T
// once, 16 B per cell (a diag shared across the batch is read once); the
// arithmetic (5 adds, 1 mul, 1 div per cell and sweep) is negligible. At
// B = 1 and 92 x 92 that is 135 KB, about 0.04 us at 3.35 TB/s, so a launch
// (a few us) dominates every call of the smoother.
//
// Two launch shapes:
//  - resident: one CTA per grid. The grid's T lives in dynamic shared memory
//    (one buffer for red-black, two ping-pong buffers for Jacobi) and all K
//    sweeps run inside one launch, with __syncthreads() between colours; P
//    and diag are read from global memory (L2-resident after the first
//    sweep). This is what the TPU kernel does in VMEM, and it covers every
//    grid of the FPGA path (up to 152 x 152 = 92 KB).
//  - global: grids whose T does not fit shared memory (256 x 256). One
//    launch per colour half-sweep, in place (cells of one colour read only
//    the other colour), or one launch per Jacobi sweep between two buffers;
//    32 x 8 tiles over (n, m) and the batch on the grid's z axis.
//
// Every operation is rounded on its own (__fadd_rn, __fmul_rn, __fdiv_rn;
// the build also passes -fmad=false), in the plain version's order, so the
// kernel equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float relaxed(const float* T, int k,
                                         int i, int j, int m, int n, float p,
                                         float d, float g_lat,
                                         float g_v_tamb) {
  const float up = (i + 1 < m) ? T[k + n] : 0.0f;
  const float dn = (i > 0) ? T[k - n] : 0.0f;
  const float lf = (j + 1 < n) ? T[k + 1] : 0.0f;
  const float rt = (j > 0) ? T[k - 1] : 0.0f;
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt);
  return __fdiv_rn(__fadd_rn(__fadd_rn(p, g_v_tamb), __fmul_rn(g_lat, s)), d);
}

__global__ void resident_rb(float* __restrict__ T, const float* __restrict__ P,
                            const float* __restrict__ diag, int m, int n,
                            long long p_stride, long long d_stride,
                            float g_lat, float g_v_tamb, int iters,
                            int phase) {
  extern __shared__ float sT[];
  const int cells = m * n;
  float* Tg = T + (long long)blockIdx.x * cells;
  const float* Pg = P + (long long)blockIdx.x * p_stride;
  const float* Dg = diag + (long long)blockIdx.x * d_stride;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) sT[k] = Tg[k];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int h = 0; h < 2; ++h) {
      const int colour = h == 0 ? phase : 1 - phase;
      for (int k = threadIdx.x; k < cells; k += blockDim.x) {
        const int i = k / n;
        const int j = k - i * n;
        if (((i + j) & 1) == colour)
          sT[k] = relaxed(sT, k, i, j, m, n, Pg[k], Dg[k], g_lat, g_v_tamb);
      }
      __syncthreads();
    }
  }
  for (int k = threadIdx.x; k < cells; k += blockDim.x) Tg[k] = sT[k];
}

__global__ void resident_jacobi(float* __restrict__ T,
                                const float* __restrict__ P,
                                const float* __restrict__ diag, int m, int n,
                                long long p_stride, long long d_stride,
                                float g_lat, float g_v_tamb, int iters) {
  extern __shared__ float sT[];
  const int cells = m * n;
  float* Tg = T + (long long)blockIdx.x * cells;
  const float* Pg = P + (long long)blockIdx.x * p_stride;
  const float* Dg = diag + (long long)blockIdx.x * d_stride;
  float* src = sT;
  float* dst = sT + cells;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) src[k] = Tg[k];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int k = threadIdx.x; k < cells; k += blockDim.x) {
      const int i = k / n;
      const int j = k - i * n;
      dst[k] = relaxed(src, k, i, j, m, n, Pg[k], Dg[k], g_lat, g_v_tamb);
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  for (int k = threadIdx.x; k < cells; k += blockDim.x) Tg[k] = src[k];
}

__global__ void global_rb(float* __restrict__ T, const float* __restrict__ P,
                          const float* __restrict__ diag, int m, int n,
                          long long p_stride, long long d_stride, float g_lat,
                          float g_v_tamb, int colour) {
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  if (i >= m || j >= n || ((i + j) & 1) != colour) return;
  const long long b = blockIdx.z;
  float* Tb = T + b * m * n;
  const int k = i * n + j;
  Tb[k] = relaxed(Tb, k, i, j, m, n, P[b * p_stride + k], diag[b * d_stride + k],
                  g_lat, g_v_tamb);
}

__global__ void global_jacobi(const float* __restrict__ src,
                              float* __restrict__ dst,
                              const float* __restrict__ P,
                              const float* __restrict__ diag, int m, int n,
                              long long p_stride, long long d_stride,
                              float g_lat, float g_v_tamb) {
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  if (i >= m || j >= n) return;
  const long long b = blockIdx.z;
  const int k = i * n + j;
  dst[b * m * n + k] = relaxed(src + b * m * n, k, i, j, m, n,
                               P[b * p_stride + k], diag[b * d_stride + k],
                               g_lat, g_v_tamb);
}

}  // namespace

// Largest dynamic shared memory one block may opt into on the current device
// (bytes), or -(CUDA error code).
extern "C" int thermal_stencil_smem_optin(void) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return bytes;
}

// `iters` sweeps on T (B x m x n, contiguous, updated in place). P and diag
// are read at P + b * p_stride and diag + b * d_stride (a stride of 0 shares
// one grid across the batch). `scratch` (B x m x n) is used only by the
// global Jacobi shape. Returns the CUDA error code (0 on success).
extern "C" int thermal_stencil_launch(float* T, const float* P,
                                      const float* diag, float* scratch,
                                      int B, int m, int n, long long p_stride,
                                      long long d_stride, float g_lat,
                                      float g_v_tamb, int iters, int phase,
                                      int resident, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int cells = m * n;
  if (B <= 0 || cells <= 0 || iters <= 0) return 0;
  const bool jacobi = phase < 0;
  if (resident) {
    const size_t smem = sizeof(float) * cells * (jacobi ? 2 : 1);
    int threads = ((cells + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    if (jacobi) {
      if (smem > kDefaultSmem) {
        cudaError_t err = cudaFuncSetAttribute(
            resident_jacobi, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      resident_jacobi<<<B, threads, smem, stream>>>(
          T, P, diag, m, n, p_stride, d_stride, g_lat, g_v_tamb, iters);
    } else {
      if (smem > kDefaultSmem) {
        cudaError_t err = cudaFuncSetAttribute(
            resident_rb, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      resident_rb<<<B, threads, smem, stream>>>(
          T, P, diag, m, n, p_stride, d_stride, g_lat, g_v_tamb, iters, phase);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((n + kTileX - 1) / kTileX, (m + kTileY - 1) / kTileY, B);
  if (!jacobi) {
    for (int it = 0; it < iters; ++it) {
      for (int h = 0; h < 2; ++h) {
        global_rb<<<grid, block, 0, stream>>>(T, P, diag, m, n, p_stride,
                                              d_stride, g_lat, g_v_tamb,
                                              h == 0 ? phase : 1 - phase);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    return 0;
  }
  float* src = T;
  float* dst = scratch;
  for (int it = 0; it < iters; ++it) {
    global_jacobi<<<grid, block, 0, stream>>>(src, dst, P, diag, m, n,
                                              p_stride, d_stride, g_lat,
                                              g_v_tamb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* t = src;
    src = dst;
    dst = t;
  }
  if (src != T) {
    cudaError_t err = cudaMemcpyAsync(T, src, sizeof(float) * B * cells,
                                      cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
