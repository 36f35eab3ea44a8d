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
// in float32. The final state is a second output.
//
// What bounds it here: operations. C_i . B_j depends on (b, group, chunk)
// alone, not on the head or the column of P: Q(Q+1)/2 N multiply-adds per
// chunk and group. The rest is per head: Q(Q+1)/2 P multiply-adds for the
// weighted sum and 2 Q P N for the read-out and the state update, against a
// few bytes per element moved. A call enqueues two launches on the caller's
// stream:
//   1. gram_kernel, one block of 256 threads per (32 x 32 tile of the lower
//      triangle, chunk, b * G): C_i . B_j once per (b, group, chunk), a 2 x 2
//      register block a thread, into a float32 scratch (b, G, chunks, Q, Q)
//      laid out [j][i], so that the scan reads it along i; tiles above the
//      diagonal are never formed. At Q = 256 a chunk's triangle is 256 KB and
//      stays in L2 for the second launch.
//   2. scan_kernel, one block of 256 threads per (b, h, 32 columns of P):
//      the chunks run in sequence inside the block, with the (N, 32) state
//      and the chunk's dt, running sums and decay weights in shared memory.
//      Per tile of 128 output rows, 64 input rows at a time: the pair's
//      C B^T comes from L2 by asynchronous copies while the rows of x load,
//      then the weights m_ij = ((C_i . B_j) exp(cum_i - cum_j)) dt_j are
//      formed in place, the exponential only where j <= i (the masked
//      differences are positive and would overflow to inf, and inf * 0 is
//      NaN), and each thread sums a 4 x 4 block of outputs (two 16-byte
//      shared loads per 16 multiply-adds). The read-out C_i . state and the state
//      update take 4 x 4 blocks the same way (4 x 2 at N <= 64). The P tile
//      is 32, not 16: every block of a head forms that head's weights, so a
//      narrower tile repeats the exponentials. At batch 1 the models' 48 or
//      64 heads give 96 or 128 blocks, one a SM, each with up to 128
//      registers a thread (two blocks a SM at most).
// B, C and x are read with 16-byte vector loads where the row allows, bf16
// widened to float32 on load; B and C through the head's group
// (h / (H / G)), so the model's (b, S, G, N) projections need no repeat over
// heads. Every sum runs in one fixed order and the build has no fused
// multiply-adds, so the plain version repeats it bit for bit: C_i . B_j and
// C_i . state over n ascending; y_i over j ascending (a thread's four rows
// run to the last one's diagonal: the weights past a row's own are 0 and add
// nothing, as in the plain version), then acc + dot * exp(cum_i); the state
// update over q ascending, then state * exp(cum_{Q-1}) + su. Rows past Q and
// columns past P are masked.
//
// Plain C interface (ctypes): mamba_scan_launch returns the CUDA error code
// of the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;     // scan block
constexpr int PT = 32;           // columns of P per scan block
constexpr int ROWS = 128;        // output rows per tile: 32 groups of 4
constexpr int IN = 64;           // input rows (or n) per tile
constexpr int GT = 32;           // C B^T tile, of i and of j
constexpr int GRAM_THREADS = 256;  // 16 x 16 register blocks of 2 x 2

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T, widened to float
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int W = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the lower address in the low half
      o[2 * k] = __uint_as_float(w[k] << 16);
      o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

// Rows [0, R) x columns [0, CN) of a row-major source (row r at src + r *
// ld), widened to float into dst[r * ldd + c], or dst[c * ldd + r] when
// TRANS; zeros at rows >= rows and columns >= cols. CN is a multiple of 8.
// With vec (cols and ld multiples of the vector, src 16-byte aligned) whole
// 16-byte vectors; consecutive threads take consecutive vectors of a row,
// or, when TRANS, the same vector of consecutive rows, so that the shared
// stores hit distinct banks.
template <bool TRANS, int NT, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const T* src,
                                          long long ld, int R, int CN,
                                          int rows, int cols, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int W = Vec<T>::W;
    const int vr = CN / W;
#pragma unroll 4
    for (int e = tid; e < R * vr; e += NT) {
      const int r = TRANS ? e % R : e / vr;
      const int c = (TRANS ? e / R : e % vr) * W;
      float v[W];
      if (r < rows && c < cols) {
        Vec<T>::load(src + r * ld + c, v);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (TRANS)
          dst[(c + k) * ldd + r] = v[k];
        else
          dst[r * ldd + c + k] = v[k];
      }
    }
  } else {
    for (int e = tid; e < R * CN; e += NT) {
      const int r = TRANS ? e % R : e / CN;
      const int c = TRANS ? e / R : e % CN;
      const float v = (r < rows && c < cols) ? to_f32(src[r * ld + c]) : 0.f;
      if (TRANS)
        dst[c * ldd + r] = v;
      else
        dst[r * ldd + c] = v;
    }
  }
}

// asynchronous 16- and 4-byte copies from global to shared memory, and the
// wait for all of a thread's copies
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// acc[r][k] += a[r] * b[k]: a product, then a sum (no fused multiply-add)
template <int R, int K>
__device__ __forceinline__ void mac(float (&acc)[R][K], const float* a,
                                    const float* b) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[r][k] += a[r] * b[k];
}

// v[0 .. min(n, 4)) to p; one vector store with vec when all four are in
__device__ __forceinline__ void store4(float* p, const float* v, int n,
                                       bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && k < n; ++k) p[k] = v[k];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v,
                                       int n, bool vec) {
  if (vec && n >= 4) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    q[0] = __floats2bfloat162_rn(v[0], v[1]);
    q[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && k < n; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

__host__ __device__ __forceinline__ int round8(int n) {
  return (n + 7) / 8 * 8;
}

// launch 1: the lower triangle of C B^T per (b, group, chunk), stored
// gram[((b G + g) chunks + c) Q Q + j Q + i] = sum_n C_i,n B_j,n, n in order
template <typename T>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
            float* __restrict__ gram, int S, int G, int N, int Q, bool vbc) {
  extern __shared__ __align__(16) float smem[];
  const int np = round8(N);
  float* cs = smem;          // [np][GT] the C rows of tile ti, n-major
  float* bs = cs + np * GT;  // [np][GT] the B rows of tile tj
  // blockIdx.x walks the lower triangle: tile (ti, tj), tj <= ti
  const int k = blockIdx.x;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  const int tj = k - ti * (ti + 1) / 2;
  const int c = blockIdx.y;
  const int bg = blockIdx.z;
  const int b = bg / G, g = bg - b * G;
  const int tid = threadIdx.x;
  const int nc = S / Q;
  const long long ld = (long long)G * N;
  const long long row0 = (long long)b * S + (long long)c * Q;
  load_tile<true, GRAM_THREADS>(cs, GT, Cm + (row0 + ti * GT) * ld + g * N,
                                ld, GT, np, Q - ti * GT, N, vbc, tid);
  load_tile<true, GRAM_THREADS>(bs, GT, Bm + (row0 + tj * GT) * ld + g * N,
                                ld, GT, np, Q - tj * GT, N, vbc, tid);
  __syncthreads();
  // rows i 2 ri, 2 ri + 1 and columns j 2 rj, 2 rj + 1 of the tile: a warp
  // stores 32 consecutive i of two rows j of gram
  const int ri = tid & 15, rj = tid >> 4;
  float acc[2][2] = {};
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float2 cv2 = *reinterpret_cast<const float2*>(cs + n * GT + 2 * ri);
    const float2 bv2 = *reinterpret_cast<const float2*>(bs + n * GT + 2 * rj);
    const float cv[2] = {cv2.x, cv2.y}, bv[2] = {bv2.x, bv2.y};
    mac(acc, cv, bv);
  }
  float* out = gram + ((long long)bg * nc + c) * Q * Q;
  const int i = ti * GT + 2 * ri;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int j = tj * GT + 2 * rj + kk;
    if (j < Q && i < Q) {
      out[(long long)j * Q + i] = acc[0][kk];
      if (i + 1 < Q) out[(long long)j * Q + i + 1] = acc[1][kk];
    }
  }
}

// launch 2: the scan of one (b, h, 32 columns of P), reading C B^T from gram
template <typename T, int NPT>
__global__ void __launch_bounds__(THREADS, 2)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ gram,
            T* __restrict__ y, float* __restrict__ state, int S, int H,
            int P, int G, int N, int Q, bool vx, bool vbc, bool vy,
            bool vg) {
  extern __shared__ __align__(16) float smem[];
  const int np = round8(N);
  // buf: the weights m[j][i] of an (input, output) tile pair [IN][ROWS],
  // or the C rows of an output tile n-major [IN][ROWS], or B rows [IN][np]
  float* buf = smem;
  float* xs = buf + IN * ROWS;  // [IN][PT] x rows
  float* st = xs + IN * PT;     // [np][PT] the carried state, n-major
  float* cum = st + np * PT;    // [Q] running sum of dt * A
  float* dts = cum + Q;         // [Q] dt
  float* coef = dts + Q;        // [Q] exp(cum[Q-1] - cum[q]) * dt[q]

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // rows 4 tr .. 4 tr + 3; state: n NPT tr ..
  const int tc = tid & 7;   // columns 4 tc .. 4 tc + 3 of the P tile
  const float a = A[h];
  const long long ldx = (long long)H * P;
  const long long ldbc = (long long)G * N;
  const int nc = S / Q;
  const bool n_live = tr * NPT < N;

  for (int e = tid; e < np * PT; e += THREADS) st[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long row0 = (long long)b * S + (long long)c * Q;
    const T* xc = x + row0 * ldx + (long long)h * P + p0;
    const T* bc = Bm + row0 * ldbc + (long long)g * N;
    const T* cc = Cm + row0 * ldbc + (long long)g * N;
    const float* gc = gram + (((long long)b * G + g) * nc + c) * Q * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int q = tid; q < Q; q += THREADS) {
      const float d = to_f32(dt[(row0 + q) * H + h]);
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

    for (int i0 = 0; i0 < Q; i0 += ROWS) {
      const int i_first = i0 + 4 * tr;
      const int i_last = min(i_first + 3, Q - 1);
      const bool live = i_first < Q;
      float acc[4][4] = {};
      const int j_end = min(i0 + ROWS, Q);
      for (int j0 = 0; j0 < j_end; j0 += IN) {
        __syncthreads();  // buf and xs are no longer read
        // the pair's C B^T, in flight while x loads: buf[jl][il] =
        // gram[j0 + jl][i0 + il] where j <= i < Q, four i a thread
#pragma unroll
        for (int e = 4 * tid; e < IN * ROWS; e += 4 * THREADS) {
          const int i = i0 + e % ROWS, j = j0 + e / ROWS;
          const float* src = gc + (long long)j * Q + i;
          if (vg && i + 3 < Q && j <= i + 3) {
            cp_async16(buf + e, src);
          } else {
            for (int k = 0; k < 4; ++k)
              if (i + k < Q && j <= i + k) cp_async4(buf + e + k, src + k);
          }
        }
        load_tile<false, THREADS>(xs, PT, xc + j0 * ldx, ldx, IN, PT, Q - j0,
                                  P - p0, vx, tid);
        cp_async_wait_all();
        // the weights m[i][j], each thread on the entries it copied (the
        // others, never copied, are masked)
#pragma unroll
        for (int e = 4 * tid; e < IN * ROWS; e += 4 * THREADS) {
          const int i = i0 + e % ROWS, j = j0 + e / ROWS;
          const float cj = j < Q ? cum[j] : 0.f, dj = j < Q ? dts[j] : 0.f;
          float v[4];
          ld4(buf + e, v);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = (i + k < Q && j <= i + k)
                       ? (v[k] * expf(cum[i + k] - cj)) * dj
                       : 0.f;
          *reinterpret_cast<float4*>(buf + e) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();
        if (live) {
          const int jn = min(IN, i_last - j0 + 1);
#pragma unroll 4
          for (int jl = 0; jl < jn; ++jl) {
            float mv[4], xv[4];
            ld4(buf + jl * ROWS + 4 * tr, mv);
            ld4(xs + jl * PT + 4 * tc, xv);
            mac(acc, mv, xv);
          }
        }
      }
      // the read-out from the state entering the chunk
      float dot[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += IN) {
        __syncthreads();  // buf is no longer read
        load_tile<true, THREADS>(buf, ROWS, cc + i0 * ldbc + n0, ldbc, ROWS,
                                 IN, Q - i0, N - n0, vbc, tid);
        __syncthreads();
        if (live) {
          const int nn = min(IN, N - n0);
#pragma unroll 4
          for (int n = 0; n < nn; ++n) {
            float cv[4], sv[4];
            ld4(buf + n * ROWS + 4 * tr, cv);
            ld4(st + (n0 + n) * PT + 4 * tc, sv);
            mac(dot, cv, sv);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i_first + r;
          if (i < Q) {
            const float e_in = expf(cum[i]);
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = acc[r][k] + dot[r][k] * e_in;
            store4(y + (row0 + i) * ldx + (long long)h * P + p0 + 4 * tc, v,
                   P - p0 - 4 * tc, vy);
          }
        }
      }
    }

    // the state at the chunk's end
    float su[4][NPT] = {};
    for (int q0 = 0; q0 < Q; q0 += IN) {
      __syncthreads();  // buf and xs are no longer read
      load_tile<false, THREADS>(xs, PT, xc + q0 * ldx, ldx, IN, PT, Q - q0,
                                P - p0, vx, tid);
      load_tile<false, THREADS>(buf, np, bc + q0 * ldbc, ldbc, IN, np,
                                Q - q0, N, vbc, tid);
      __syncthreads();
      if (n_live) {
        const int qn = min(IN, Q - q0);
#pragma unroll 4
        for (int q = 0; q < qn; ++q) {
          const float cq = coef[q0 + q];
          float xv[4], u[4], bv[NPT];
          ld4(xs + q * PT + 4 * tc, xv);
#pragma unroll
          for (int k = 0; k < 4; ++k) u[k] = cq * xv[k];
#pragma unroll
          for (int k = 0; k < NPT; ++k) bv[k] = buf[q * np + NPT * tr + k];
          mac(su, u, bv);
        }
      }
    }
    // every read of the state entering the chunk is behind a barrier, and
    // each thread updates only the entries it summed
    const float tot = expf(last);
    if (n_live) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          float* s = st + (NPT * tr + k) * PT + 4 * tc + r;
          *s = *s * tot + su[r][k];
        }
    }
  }
  // the final state: each thread its own entries
  if (n_live) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        const int p = p0 + 4 * tc + r, n = NPT * tr + k;
        if (p < P && n < N)
          state[(((long long)b * H + h) * P + p) * N + n] =
              st[n * PT + 4 * tc + r];
      }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* B,
           const void* C, void* y, float* state, float* gram, int b, int S,
           int H, int P, int G, int N, int Q, cudaStream_t stream) {
  constexpr int W = Vec<T>::W;
  const int np = round8(N);
  const int nc = S / Q;
  const int t = (Q + GT - 1) / GT;
  const bool vbc = N % W == 0 && aligned(B) && aligned(C);
  const bool vx = P % W == 0 && aligned(x);
  const bool vy = P % 4 == 0 && aligned(y);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(B);
  const T* ct = static_cast<const T*>(C);

  // at most 2 x 128 x 32 floats: within the 48 KB a launch may take
  // without raising the kernel's limit
  const size_t gram_smem = sizeof(float) * 2 * np * GT;
  gram_kernel<T><<<dim3(t * (t + 1) / 2, nc, b * G), GRAM_THREADS, gram_smem,
                   stream>>>(bt, ct, gram, S, G, N, Q, vbc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t scan_smem =
      sizeof(float) * (IN * ROWS + IN * PT + np * PT + 3 * Q);
  const dim3 grid((P + PT - 1) / PT, H, b);
  auto kernel = N > 64 ? scan_kernel<T, 4> : scan_kernel<T, 2>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, scan_smem, stream>>>(
      xt, static_cast<const T*>(dt), A, bt, ct, gram, static_cast<T*>(y),
      state, S, H, P, G, N, Q, vx, vbc, vy, Q % 4 == 0 && aligned(gram));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, void* y,
                                 void* state, void* gram, int b, int S, int H,
                                 int P, int G, int N, int Q, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  float* st = static_cast<float*>(state);
  float* gm = static_cast<float*>(gram);
  if (dtype == 0)
    return launch<float>(x, dt, a, B, C, y, st, gm, b, S, H, P, G, N, Q, s);
  return launch<__nv_bfloat16>(x, dt, a, B, C, y, st, gm, b, S, H, P, G, N,
                               Q, s);
}
