// Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan (Pallas;
// grid over the chunks in sequence, the carried (H, P, N) state in VMEM
// scratch, which it drops at the end), batched over b as ops.mamba_scan_b
// batches it. Per chunk of Q steps and head h, with cum the running sum of
// dt * A[h] inside the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) (C_i . state)
//   state = state exp(cum_{Q-1}) + sum_q exp(cum_{Q-1} - cum_q) dt_q x_q B_q
// in float32. The final state is a second output of the same launch.
//
// What bounds it here: operations, Q(Q+1)/2 (N + P) + 2 Q P N multiply-adds
// per chunk and head against a few bytes per element moved; the (Q, Q) term
// never reaches device memory. This first version computes on the CUDA
// cores (wgmma tiles and TMA loads are later work):
//   * one block of 256 threads per (b, h, 16 columns of P): at batch 1 the
//     models' 48 or 64 heads give 192 or 256 blocks for the 132 SMs, where
//     one block per head would leave most of them idle;
//   * the chunks run in sequence inside the block; the (16, N) state, the
//     chunk's dt, running sums and decay weights stay in shared memory;
//   * the (Q, Q) term is taken in 32 x 32 tiles of rows i and columns
//     j <= i (at Q = 256 the whole term would be 256 KB in float32, more
//     than a block's shared memory): per tile, C_i . B_j by 2 x 2 register
//     blocks, then exp(cum_i - cum_j) only where j <= i (the masked
//     differences are positive and would overflow to inf, and inf * 0 is
//     NaN), then each thread's two outputs take the tile's 32 weighted rows
//     of x in order;
//   * B and C are read through the head's group (h / (H / G)), so the
//     model's (b, S, G, N) projections need no repeat over heads;
//   * every sum runs in one fixed order and the build has no fused
//     multiply-adds, so the plain version repeats it bit for bit.
// Rows past Q and columns past P are masked here.
//
// Plain C interface (ctypes): mamba_scan_launch returns the CUDA error code
// of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PT = 16;      // columns of P per block
constexpr int TILE = 32;    // chunk rows per tile, of i and of j
constexpr int MAX_N = 128;  // largest state size
constexpr int SU = PT * MAX_N / THREADS;  // state entries per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, T* __restrict__ y,
                  float* __restrict__ state, int S, int H, int P, int G,
                  int N, int Q) {
  extern __shared__ float smem[];
  const int ld = N + 1;  // padded rows: column walks hit distinct banks
  float* cum = smem;               // [Q] running sum of dt * A
  float* dts = cum + Q;            // [Q] dt
  float* coef = dts + Q;           // [Q] exp(cum[Q-1] - cum[q]) * dt[q]
  float* ct = coef + Q;            // [TILE][ld] C rows of the output tile
  float* bt = ct + TILE * ld;      // [TILE][ld] B rows of the input tile
  float* st = bt + TILE * ld;      // [PT][ld] the carried state
  float* xt = st + PT * ld;        // [TILE][PT] x rows of the input tile
  float* mt = xt + TILE * PT;      // [TILE][TILE + 1] the tile's weights

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h];

  // rows [r0, r0 + TILE) of a chunk of B or C (this head's group), zeros
  // past Q
  auto load_bc = [&](const T* src, float* dst, int s0, int r0) {
    for (int e = tid; e < TILE * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      float v = 0.f;
      if (r0 + r < Q)
        v = to_f32(src[(((long long)b * S + s0 + r0 + r) * G + g) * N + n]);
      dst[r * ld + n] = v;
    }
  };
  // the same rows of x, this block's columns, zeros past Q and P
  auto load_x = [&](int s0, int r0) {
    for (int e = tid; e < TILE * PT; e += THREADS) {
      const int r = e / PT, p = e - r * PT;
      float v = 0.f;
      if (r0 + r < Q && p0 + p < P)
        v = to_f32(x[(((long long)b * S + s0 + r0 + r) * H + h) * P + p0 + p]);
      xt[r * PT + p] = v;
    }
  };

  for (int e = tid; e < PT * ld; e += THREADS) st[e] = 0.f;

  // outputs: row i_own of the tile, columns p_own and p_own + 1
  const int i_own = tid >> 3;
  const int p_own = (tid & 7) * 2;
  // tile weights: rows gi, gi + 1 and columns gj, gj + 1
  const int gi = (tid >> 4) * 2;
  const int gj = (tid & 15) * 2;
  // state entries: e = tid + k * THREADS, (p, n) = (e / N, e % N)
  int sp[SU], sn[SU];
#pragma unroll
  for (int k = 0; k < SU; ++k) {
    const int e = tid + k * THREADS;
    sp[k] = e / N;
    sn[k] = e - sp[k] * N;
  }

  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int q = tid; q < Q; q += THREADS) {
      const float d = to_f32(dt[((long long)b * S + s0 + q) * H + h]);
      dts[q] = d;
      cum[q] = d * a;
    }
    __syncthreads();
    if (tid == 0) {
      float run = cum[0];
      for (int q = 1; q < Q; ++q) {
        run = run + cum[q];
        cum[q] = run;
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int q = tid; q < Q; q += THREADS)
      coef[q] = expf(last - cum[q]) * dts[q];

    for (int i0 = 0; i0 < Q; i0 += TILE) {
      __syncthreads();  // ct is no longer read
      load_bc(Cm, ct, s0, i0);
      const int i = i0 + i_own;
      float acc0 = 0.f, acc1 = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        __syncthreads();  // bt, xt and mt are no longer read
        load_bc(Bm, bt, s0, j0);
        load_x(s0, j0);
        __syncthreads();
        const float* c0 = ct + gi * ld;
        const float* c1 = c0 + ld;
        const float* b0 = bt + gj * ld;
        const float* b1 = b0 + ld;
        float g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f;
        for (int n = 0; n < N; ++n) {
          const float cv0 = c0[n], cv1 = c1[n], bv0 = b0[n], bv1 = b1[n];
          g00 += cv0 * bv0;
          g01 += cv0 * bv1;
          g10 += cv1 * bv0;
          g11 += cv1 * bv1;
        }
        // m[i][j] = ((C_i . B_j) * exp(cum_i - cum_j)) * dt_j where j <= i
        auto weight = [&](int di, int dj, float gij) {
          const int ii = i0 + gi + di, jj = j0 + gj + dj;
          float m = 0.f;
          if (ii < Q && jj <= ii)
            m = (gij * expf(cum[ii] - cum[jj])) * dts[jj];
          mt[(gi + di) * (TILE + 1) + gj + dj] = m;
        };
        weight(0, 0, g00);
        weight(0, 1, g01);
        weight(1, 0, g10);
        weight(1, 1, g11);
        __syncthreads();
        if (i < Q) {
          const int jn = min(TILE, i - j0 + 1);  // columns j <= i
          const float* mrow = mt + i_own * (TILE + 1);
          for (int jl = 0; jl < jn; ++jl) {
            const float m = mrow[jl];
            acc0 += m * xt[jl * PT + p_own];
            acc1 += m * xt[jl * PT + p_own + 1];
          }
        }
      }
      // the read-out from the state entering the chunk, then y
      if (i < Q) {
        const float* crow = ct + i_own * ld;
        const float* s0r = st + p_own * ld;
        const float* s1r = s0r + ld;
        float d0 = 0.f, d1 = 0.f;
        for (int n = 0; n < N; ++n) {
          d0 += crow[n] * s0r[n];
          d1 += crow[n] * s1r[n];
        }
        const float e_in = expf(cum[i]);
        const long long o =
            (((long long)b * S + s0 + i) * H + h) * P + p0 + p_own;
        if (p0 + p_own < P) store(y + o, acc0 + d0 * e_in);
        if (p0 + p_own + 1 < P) store(y + o + 1, acc1 + d1 * e_in);
      }
    }

    // the state at the chunk's end
    float su[SU];
#pragma unroll
    for (int k = 0; k < SU; ++k) su[k] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += TILE) {
      __syncthreads();  // bt and xt are no longer read
      load_bc(Bm, bt, s0, j0);
      load_x(s0, j0);
      __syncthreads();
      const int jn = min(TILE, Q - j0);
      for (int jl = 0; jl < jn; ++jl) {
        const float cq = coef[j0 + jl];
        const float* brow = bt + jl * ld;
        const float* xrow = xt + jl * PT;
#pragma unroll
        for (int k = 0; k < SU; ++k)
          if (sp[k] < PT) su[k] += (cq * xrow[sp[k]]) * brow[sn[k]];
      }
    }
    const float tot = expf(last);
#pragma unroll
    for (int k = 0; k < SU; ++k)
      if (sp[k] < PT) {
        float* s = st + sp[k] * ld + sn[k];
        *s = *s * tot + su[k];
      }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SU; ++k)
    if (sp[k] < PT && p0 + sp[k] < P)
      state[(((long long)b * H + h) * P + p0 + sp[k]) * N + sn[k]] =
          st[sp[k] * ld + sn[k]];
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* B,
           const void* C, void* y, float* state, int b, int S, int H, int P,
           int G, int N, int Q, cudaStream_t stream) {
  const int ld = N + 1;
  const size_t smem = sizeof(float) * (3 * Q + 2 * TILE * ld + PT * ld +
                                       TILE * PT + TILE * (TILE + 1));
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + PT - 1) / PT, H, b);
  mamba_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      state, S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, void* y,
                                 void* state, int b, int S, int H, int P,
                                 int G, int N, int Q, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  float* st = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dt, a, B, C, y, st, b, S, H, P, G, N, Q, s);
  return launch<__nv_bfloat16>(x, dt, a, B, C, y, st, b, S, H, P, G, N, Q,
                               s);
}
