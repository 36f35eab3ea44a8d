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
//
// The second entry point, thermal_mg_solve_launch, runs a whole multigrid
// solve (V-cycles with these sweeps as smoother, the coarse solve and the
// stop test) in one launch; its notes are above its kernel, mg_solve.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kDefaultSmem = 48 * 1024;

// ((up + dn) + lf) + rt around cell k = (i, j), zero-padded borders.
__device__ __forceinline__ float nbr_sum(const float* T, int k, int i, int j,
                                         int m, int n) {
  const float up = (i + 1 < m) ? T[k + n] : 0.0f;
  const float dn = (i > 0) ? T[k - n] : 0.0f;
  const float lf = (j + 1 < n) ? T[k + 1] : 0.0f;
  const float rt = (j > 0) ? T[k - 1] : 0.0f;
  return __fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt);
}

__device__ __forceinline__ float relaxed(const float* T, int k,
                                         int i, int j, int m, int n, float p,
                                         float d, float g_lat,
                                         float g_v_tamb) {
  const float s = nbr_sum(T, k, i, j, m, n);
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

// --- One launch per multigrid solve (thermal_mg_solve_launch) ---------------
//
// Replaces, on the card, the reference's jitted multigrid solve
// (repro/core/thermal.py:201-266): V-cycles with the TPU stencil kernel
// (repro/kernels/thermal_stencil.py, the pallas_call at :82) as their
// smoother, the coarse direct solve, and the stop test inside
// jax.lax.while_loop. One CTA solves one batch element from start to stop:
// the full-multigrid cold start (or the warm start T0), then V-cycles until
// (s > tol) & (s < 0.9 s_prev) & (cycles < max_cycles) fails, with
// s = max |r| / diag. It writes T and the cycle count; the host reads
// nothing during the solve.
//
// What bounds it: neither bytes nor operations but the chain of dependent
// steps. A solve must read b, diag and T0 once and write T once (tens of
// KB), and its float operations take a few us at the float32 rate spread
// over the card, but one CTA runs them one level after another with a
// __syncthreads() between every half-sweep, restriction, coarse product and
// prolongation, on one SM. The design removes what bound the per-step form
// (a launch per step, ~18 stencil launches and ~4 host reads per solve);
// one SM per grid at B = 1 is its known limit.
//
// Layout: every level's T and the coarse levels' right-hand sides live in
// dynamic shared memory (the host's plan, thermal_mg.make_plan; 56 KB at
// 92 x 92, 150 KB at 152 x 152); the fine level's b, every level's diagonal,
// the prolongation's (index, weight) tables and the direct tier's inverse
// are read from global memory and stay in L2 across cycles. The residual is
// never stored: each coarse cell sums its four fine residuals as it
// restricts them. The prolongation recomputes each row interpolation where
// a fine cell needs it (the same rounded values the plain version keeps).
//
// Order of operations, each rounded on its own as in the plain version
// (thermal_mg.thermal_mg_solve_ref): the sweeps are relaxed() above; the
// residual b - (d * T - g_lat * nbr_sum); the restriction
// ((r00 + r01) + r10) + r11; the prolongation rows first, then columns,
// each w0 * e0 + w1 * e1; the coarse product A_inv[r, c] * b[c] summed by a
// halving tree over the row padded to a power of two (per lane, then warp
// shuffles); the maxima are exact in any order.

constexpr int kMaxLevels = 16;   // thermal_mg.MAX_LEVELS
constexpr int kLaneValues = 16;  // thermal_mg.LANE_VALUES

// The host's plan (thermal_mg.make_plan builds it as int32, field by field).
struct MgPlan {
  int levels;        // L; level L - 1 is the direct tier
  int coarse_lane;   // the coarse product's row width / 32
  int smem_floats;   // every T, the coarse levels' b, one float per warp
  int m[kMaxLevels];
  int n[kMaxLevels];
  int diag_off[kMaxLevels];  // level l's diagonal in diag
  int row_off[kMaxLevels];   // its row table (m[l] pairs) in idx and w
  int col_off[kMaxLevels];   // its column table (n[l] pairs)
  int t_off[kMaxLevels];     // level l's T in shared memory
  int b_off[kMaxLevels];     // level l's right-hand side (l >= 1)
};

__device__ __forceinline__ float residual(const float* T, int k, int i,
                                          int j, int m, int n, float b,
                                          float d, float g_lat) {
  const float s = nbr_sum(T, k, i, j, m, n);
  return __fsub_rn(b, __fsub_rn(__fmul_rn(d, T[k]), __fmul_rn(g_lat, s)));
}

// `sweeps` red-black sweeps, red ((i + j) even) first, in place.
__device__ void mg_smooth(float* T, const float* b, const float* d, int m,
                          int n, float g_lat, int sweeps) {
  const int cells = m * n;
  for (int it = 0; it < sweeps; ++it) {
    for (int colour = 0; colour < 2; ++colour) {
      for (int k = threadIdx.x; k < cells; k += blockDim.x) {
        const int i = k / n;
        const int j = k - i * n;
        if (((i + j) & 1) == colour)
          T[k] = relaxed(T, k, i, j, m, n, b[k], d[k], g_lat, 0.0f);
      }
      __syncthreads();
    }
  }
}

// out (mc x nc) = 2x2 block sums of at(i, j) over an m x n level, zero past
// its odd trailing edges.
template <class At>
__device__ void mg_restrict(float* out, int mc, int nc, int m, int n,
                            At at) {
  for (int kc = threadIdx.x; kc < mc * nc; kc += blockDim.x) {
    const int i = 2 * (kc / nc);
    const int j = 2 * (kc % nc);
    const float r00 = at(i, j);
    const float r01 = (j + 1 < n) ? at(i, j + 1) : 0.0f;
    const float r10 = (i + 1 < m) ? at(i + 1, j) : 0.0f;
    const float r11 = (i + 1 < m && j + 1 < n) ? at(i + 1, j + 1) : 0.0f;
    out[kc] = __fadd_rn(__fadd_rn(__fadd_rn(r00, r01), r10), r11);
  }
  __syncthreads();
}

// T (m x n) = [T +] the bilinear prolongation of e (. x nc).
__device__ void mg_prolong(float* T, const float* e, int m, int n, int nc,
                           const int* ri, const float* rw, const int* ci,
                           const float* cw, bool add) {
  for (int k = threadIdx.x; k < m * n; k += blockDim.x) {
    const int i = k / n;
    const int j = k - i * n;
    const float* e0 = e + ri[2 * i] * nc;
    const float* e1 = e + ri[2 * i + 1] * nc;
    const float w0 = rw[2 * i], w1 = rw[2 * i + 1];
    const int c0 = ci[2 * j], c1 = ci[2 * j + 1];
    const float t0 = __fadd_rn(__fmul_rn(w0, e0[c0]), __fmul_rn(w1, e1[c0]));
    const float t1 = __fadd_rn(__fmul_rn(w0, e0[c1]), __fmul_rn(w1, e1[c1]));
    const float p = __fadd_rn(__fmul_rn(cw[2 * j], t0),
                              __fmul_rn(cw[2 * j + 1], t1));
    T[k] = add ? __fadd_rn(T[k], p) : p;
  }
  __syncthreads();
}

// x = A_inv b on the direct tier (N cells): a warp per row; lane l holds
// the products at columns l + 32 q (zero past N), the halving tree runs in
// registers down to 32 values, then over the warp's shuffles.
__device__ void mg_coarse(float* x, const float* bc,
                          const float* __restrict__ a_inv, int N,
                          int per_lane) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < N; r += warps) {
    const float* a = a_inv + (long long)r * N;
    float v[kLaneValues];
#pragma unroll
    for (int q = 0; q < kLaneValues; ++q) {
      const int c = lane + 32 * q;
      v[q] = (q < per_lane && c < N) ? __fmul_rn(a[c], bc[c]) : 0.0f;
    }
#pragma unroll
    for (int h = kLaneValues / 2; h >= 1; h >>= 1) {
      if (h < per_lane) {
#pragma unroll
        for (int q = 0; q < h; ++q) v[q] = __fadd_rn(v[q], v[q + h]);
      }
    }
    float s = v[0];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) x[r] = s;
  }
  __syncthreads();
}

// max |r| / diag over the fine level, the same value in every thread.
__device__ float mg_scaled_residual(const float* T, const float* b,
                                    const float* d, int m, int n, float g_lat,
                                    float* red) {
  float s = 0.0f;
  for (int k = threadIdx.x; k < m * n; k += blockDim.x) {
    const int i = k / n;
    const int j = k - i * n;
    s = fmaxf(s, __fdiv_rn(fabsf(residual(T, k, i, j, m, n, b[k], d[k],
                                          g_lat)), d[k]));
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float all = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) all = fmaxf(all, red[w]);
  __syncthreads();  // red is free again
  return all;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    mg_solve(float* __restrict__ out, const float* __restrict__ b,
             const float* __restrict__ T0, const float* __restrict__ diag,
             const float* __restrict__ a_inv, const int* __restrict__ idx,
             const float* __restrict__ w, int* __restrict__ cycles,
             const MgPlan p, float g_lat, float tol, int max_cycles,
             int n_smooth) {
  extern __shared__ float smem[];
  const int top = p.levels - 1;
  const int cells = p.m[0] * p.n[0];
  const float* bg = b + (long long)blockIdx.x * cells;
  float* red = smem + p.smem_floats - 32;
  float* T = smem + p.t_off[0];
  auto level_b = [&](int l) -> const float* {
    return l == 0 ? bg : smem + p.b_off[l];
  };

  // level `from`'s T holds the cycle's start; down to the direct tier and
  // back up
  auto vcycle = [&](int from) {
    for (int l = from; l < top; ++l) {
      float* Tl = smem + p.t_off[l];
      const float* bl = level_b(l);
      const float* dl = diag + p.diag_off[l];
      const int m = p.m[l], n = p.n[l];
      if (l > from) {
        for (int k = threadIdx.x; k < m * n; k += blockDim.x) Tl[k] = 0.0f;
        __syncthreads();
      }
      mg_smooth(Tl, bl, dl, m, n, g_lat, n_smooth);
      mg_restrict(smem + p.b_off[l + 1], p.m[l + 1], p.n[l + 1], m, n,
                  [&](int i, int j) {
                    const int k = i * n + j;
                    return residual(Tl, k, i, j, m, n, bl[k], dl[k], g_lat);
                  });
    }
    mg_coarse(smem + p.t_off[top], smem + p.b_off[top], a_inv,
              p.m[top] * p.n[top], p.coarse_lane);
    for (int l = top - 1; l >= from; --l) {
      float* Tl = smem + p.t_off[l];
      mg_prolong(Tl, smem + p.t_off[l + 1], p.m[l], p.n[l], p.n[l + 1],
                 idx + p.row_off[l], w + p.row_off[l], idx + p.col_off[l],
                 w + p.col_off[l], true);
      mg_smooth(Tl, level_b(l), diag + p.diag_off[l], p.m[l], p.n[l], g_lat,
                n_smooth);
    }
  };

  if (T0 == nullptr) {
    // full-multigrid cold start: b restricted to every level, the direct
    // solve, then up one level at a time with one V-cycle each
    for (int l = 1; l <= top; ++l) {
      const float* src = level_b(l - 1);
      const int n = p.n[l - 1];
      mg_restrict(smem + p.b_off[l], p.m[l], p.n[l], p.m[l - 1], n,
                  [&](int i, int j) { return src[i * n + j]; });
    }
    mg_coarse(smem + p.t_off[top], smem + p.b_off[top], a_inv,
              p.m[top] * p.n[top], p.coarse_lane);
    for (int l = top - 1; l >= 0; --l) {
      mg_prolong(smem + p.t_off[l], smem + p.t_off[l + 1], p.m[l], p.n[l],
                 p.n[l + 1], idx + p.row_off[l], w + p.row_off[l],
                 idx + p.col_off[l], w + p.col_off[l], false);
      vcycle(l);
    }
  } else {
    const float* Tg = T0 + (long long)blockIdx.x * cells;
    for (int k = threadIdx.x; k < cells; k += blockDim.x) T[k] = Tg[k];
    __syncthreads();
  }

  const float* d0 = diag + p.diag_off[0];
  float s = mg_scaled_residual(T, bg, d0, p.m[0], p.n[0], g_lat, red);
  float s_prev = __int_as_float(0x7f800000);  // +inf
  int it = 0;
  while (s > tol && s < __fmul_rn(0.9f, s_prev) && it < max_cycles) {
    vcycle(0);
    s_prev = s;
    s = mg_scaled_residual(T, bg, d0, p.m[0], p.n[0], g_lat, red);
    ++it;
  }
  float* Tout = out + (long long)blockIdx.x * cells;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) Tout[k] = T[k];
  if (threadIdx.x == 0) cycles[blockIdx.x] = it;
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

// One multigrid solve per batch element in one launch (B CTAs). b, T0 and
// out are B x m[0] x n[0] (T0 may be null: the full-multigrid cold start);
// diag, idx, w and a_inv are the plan's flat tables on the device; `meta`
// is the host's MgPlan as `meta_len` ints. Writes out and cycles (B ints).
// Returns the CUDA error code (0 on success).
extern "C" int thermal_mg_solve_launch(float* out, const float* b,
                                       const float* T0, const float* diag,
                                       const float* a_inv, const int* idx,
                                       const float* w, int* cycles,
                                       const int* meta, int meta_len, int B,
                                       float g_lat, float tol, int max_cycles,
                                       int n_smooth, void* stream_ptr) {
  MgPlan p;
  if (static_cast<size_t>(meta_len) * sizeof(int) != sizeof(MgPlan))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&p, meta, sizeof(MgPlan));
  if (p.levels < 2 || p.levels > kMaxLevels || p.coarse_lane < 1 ||
      p.coarse_lane > kLaneValues)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const int cells = p.m[0] * p.n[0];
  int threads = ((cells + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  // opt in to the card's whole per-block shared memory once per device,
  // so that no attribute is set while a CUDA graph is being captured
  static int ready = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != ready) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          mg_solve, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess) ready = dev;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * p.smem_floats;
  mg_solve<<<B, threads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      out, b, T0, diag, a_inv, idx, w, cycles, p, g_lat, tol, max_cycles,
      n_smooth);
  return static_cast<int>(cudaGetLastError());
}
