// Paged attention over a block-table page pool, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (Pallas; scalar-prefetched block table driving the K/V index maps, one grid
// step per (slot, page), running max / denominator / accumulator in VMEM
// scratch across a slot's page sweep).
//
// The queries come as chunks: S rows per slot b that share the slot's
// block-table row, each row at its own position pos[b, s]. Entry t of a page
// is visible to a row iff 0 <= ids <= pos (and ids > pos - window when
// window > 0). A block holds a tile of the slot's rows x the G = H / Hkv
// query heads of one kv head, at most 64 (row, head) pairs, each masked by
// its own row's position (nothing assumes a slot's positions are
// consecutive), and reads each page some row of the tile may see once for
// the whole tile, never once per row; a page none of them can see (the null
// page, the unallocated tail, rows disabled with pos = -1) is never read.
// The table and the entries' ids are read a window at a time (16 entries on
// the CUDA cores, 1024 positions on the tensor cores), with all threads, so
// no step waits on a dependent load and shared memory does not grow with
// the table.
//
// The CUDA-core kernel (paged_rows_kernel) walks pages through a
// double-buffered cp.async pair of page buffers, one warp per (row, head)
// pair at a time (lane t scores key t of the page, shuffles reduce the max
// and the denominator, lane d keeps accumulator columns d, d + 32, ...), in
// splits of SPLIT table entries. It has two modes:
//   * split-K, for decode (S = 1) and chunks of at most 16 rows (a
//     speculative verify): bound by bytes (every visible page read once
//     against two multiply-adds per element, G = 4 rows per kv head leave
//     the tensor cores nothing to do), so one block per (tile, kv head,
//     slot, split) to put enough blocks on the card, each writing its
//     partial (m, l, acc) to float32 scratch; then a second, small kernel
//     folds the partials in split order: M' = max(M, m),
//     L = L exp(M - M') + l exp(m - M'), the same for the accumulator. A
//     split that saw nothing has l = 0 and m = NEG_INF, so a row that sees
//     nothing ends in exact zeros;
//   * folding, for float32 chunks of more rows: one block per (tile, kv
//     head, slot) walks every split and folds each split's partial into its
//     running total by the combine kernel's formula.
// Both give every pair exactly the arithmetic of its row's decode, in
// either dtype, so a chunk equals the decode of its rows bit for bit and a
// speculative verify scores drafts as greedy decoding would.
//
// bfloat16 chunks of more than 16 rows (prefill chunks; bound by operations
// at 256 rows) take the tensor cores (paged_extend_bf16_kernel): the keys
// in tiles of 64 table positions, a window of 16 tiles at a time, through a
// 3-stage cp.async ring (entries no row can see zero-filled, never read),
// tiles without such an entry skipped, S and P V on mma.sync m16n8k16
// (mma_attention.cuh, as flash attention).
// Block-table entries outside [0, P) name no page and are skipped.
//
// Plain C interface (ctypes): paged_rows_launch and paged_extend_launch
// return the CUDA error code of their launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_attention.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SPLIT = 16;          // table entries per split
constexpr int MAX_D_PER_LANE = 4;  // head_dim <= 128
constexpr int PAIRS = 64;          // (row, head) pairs per block, at most
constexpr int MAX_WARPS = 16;      // CUDA-core blocks: warps, at most
constexpr int PPW = PAIRS / MAX_WARPS;  // pairs per warp, at most
constexpr int STAGES = 3;          // bf16 extend: K/V ring depth
constexpr int WIN = 1024;          // bf16 extend: table positions a window
constexpr int WIN_TILES = WIN / mma_att::KT;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 consecutive elements from 16-byte-aligned shared memory, widened
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

__device__ __forceinline__ bool visible(int id, int p, int window) {
  return id >= 0 && id <= p && (window <= 0 || id > p - window);
}

// elements per padded page row: one 16-byte chunk more than D
template <typename T>
__host__ __device__ constexpr int row_ld(int D) {
  return D + 16 / (int)sizeof(T);
}

// Copy a page's K and V rows for kv head h into the buffers (cp.async).
template <typename T>
__device__ __forceinline__ void load_page(T* ks, T* vs, const T* k_pool,
                                          const T* v_pool, int page, int ps,
                                          int Hkv, int h, int D) {
  constexpr int E = 16 / sizeof(T);
  const int ch = D / E, ld = row_ld<T>(D);
  for (int c = threadIdx.x; c < ps * ch; c += blockDim.x) {
    const int t = c / ch, e = (c - t * ch) * E;
    const long long src = (((long long)page * ps + t) * Hkv + h) * D + e;
    mma_att::cp_async16(ks + t * ld + e, k_pool + src, true);
    mma_att::cp_async16(vs + t * ld + e, v_pool + src, true);
  }
}

// One warp, one (row, head) pair, one page in shared memory: up to 32 keys
// at a time, lane t on key c + t; the dot product summed over d in order,
// divided by sqrt(D); the running max and the butterfly sum of the weights
// over the warp; the accumulator rescaled, then the keys' weighted rows of V
// one after another.
template <typename T>
__device__ __forceinline__ void page_step(const float* qg, const T* ks,
                                          const T* vs, const int* ids,
                                          int ps, int D, int p_r, int window,
                                          float sqrt_d, float& m, float& l,
                                          float (&acc)[MAX_D_PER_LANE]) {
  const int lane = threadIdx.x & 31, ld = row_ld<T>(D);
  for (int c = 0; c < ps; c += 32) {
    const int t = c + lane;
    bool valid = false;
    float s = NEG_INF;
    if (t < ps) {
      valid = visible(ids[t], p_r, window);
      if (valid) {
        float dot = 0.f;
        const T* kt = ks + t * ld;
        for (int d = 0; d < D; d += 8) {
          float x[8];
          load8(kt + d, x);
#pragma unroll
          for (int j = 0; j < 8; ++j) dot += qg[d + j] * x[j];
        }
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
      const T* vt = vs + (c + tt) * ld;
#pragma unroll
      for (int i = 0; i < MAX_D_PER_LANE; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pt * to_f32(vt[d]);
      }
    }
    m = m_new;
  }
}

// Fold a split's partial (m, l, acc) into the running (M, L, A), as the
// combine kernel does.
__device__ __forceinline__ void fold(float& M, float& L,
                                     float (&A)[MAX_D_PER_LANE], float m,
                                     float l, const float (&acc)[MAX_D_PER_LANE]) {
  const float Mn = fmaxf(M, m);
  const float a = expf(M - Mn), b = expf(m - Mn);
  L = L * a + l * b;
#pragma unroll
  for (int i = 0; i < MAX_D_PER_LANE; ++i) A[i] = A[i] * a + acc[i] * b;
  M = Mn;
}

__device__ __forceinline__ int next_flag(const int* flg, int j, int n) {
  while (j < n && !flg[j]) ++j;
  return j;
}

// --- the CUDA-core kernel: decode, short chunks, float32 chunks -------------

template <typename T>
size_t rows_smem(int M, int D, int ps) {
  return sizeof(T) * 4 * (size_t)ps * row_ld<T>(D)
         + sizeof(float) * (size_t)M * D
         + sizeof(int) * ((size_t)M + 2 * SPLIT + (size_t)SPLIT * ps);
}

// Block (tile x part, kv head h, slot b): the pairs of rows
// [s0, s0 + TR) x the group's G heads. Split-K (split != 0): the block
// takes split `part` of the table and writes its partial to
// m_part, l_part (B S H, parts) and acc_part (B S H, parts, D). Folding:
// parts == 1, the block takes every split and writes out.
template <typename T>
__global__ void paged_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ ids_pool,
    const int* __restrict__ block_table, const int* __restrict__ pos,
    T* __restrict__ out, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int S, int H,
    int Hkv, int D, int P, int ps, int n, int window, int TR, int parts,
    int split, float sqrt_d) {
  const int tile = blockIdx.x / parts, part = blockIdx.x - tile * parts;
  const int h = blockIdx.y, b = blockIdx.z, s0 = tile * TR;
  const int G = H / Hkv, M = TR * G, M_pairs = min(TR, S - s0) * G;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ld = row_ld<T>(D), buf = ps * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // 2 pages
  T* vs = ks + 2 * buf;                    // 2 pages
  float* qs = reinterpret_cast<float*>(vs + 2 * buf);  // M x D
  int* pos_s = reinterpret_cast<int*>(qs + M * D);     // M
  int* tbl = pos_s + M;                                // SPLIT
  int* flg = tbl + SPLIT;                              // SPLIT
  int* ids = flg + SPLIT;                              // SPLIT x ps

  for (int i = tid; i < M_pairs * D; i += nthreads) {
    const int r = i / D, row = s0 + r / G;
    qs[i] = to_f32(
        q[(((long long)b * S + row) * H + h * G + r % G) * D + (i - r * D)]);
  }
  for (int r = tid; r < M; r += nthreads)
    pos_s[r] = r < M_pairs ? pos[(long long)b * S + s0 + r / G] : -1;
  __syncthreads();
  int pmax = -1, pmin = 0x7fffffff;  // over the tile's live rows
  for (int r = 0; r < M_pairs; r += G) {
    const int p = pos_s[r];
    pmax = max(pmax, p);
    if (p >= 0) pmin = min(pmin, p);
  }

  float m[PPW], l[PPW], acc[PPW][MAX_D_PER_LANE];
  float Mr[PPW], Lr[PPW], Ar[PPW][MAX_D_PER_LANE];
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    Mr[i] = NEG_INF;
    Lr[i] = 0.f;
#pragma unroll
    for (int e = 0; e < MAX_D_PER_LANE; ++e) Ar[i][e] = 0.f;
  }
  const int n_splits = (n + SPLIT - 1) / SPLIT;
  const int sp0 = split ? part : 0, sp1 = split ? part + 1 : n_splits;
  for (int sp = sp0; sp < sp1; ++sp) {
    const int j0 = sp * SPLIT, nj = min(SPLIT, n - j0);
    if (tid < nj) {
      tbl[tid] = block_table[(long long)b * n + j0 + tid];
      flg[tid] = 0;
    }
    __syncthreads();
    for (int i = tid; i < nj * ps; i += nthreads) {
      const int j = i / ps, page = tbl[j];
      const int id = (page >= 0 && page < P && pmax >= 0)
                         ? ids_pool[(long long)page * ps + (i - j * ps)]
                         : -1;
      ids[i] = id;
      if (id >= 0 && id <= pmax && (window <= 0 || id > pmin - window))
        flg[j] = 1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < MAX_D_PER_LANE; ++e) acc[i][e] = 0.f;
    }
    int cur = next_flag(flg, 0, nj), bsel = 0;
    if (cur < nj) {
      load_page(ks, vs, k_pool, v_pool, tbl[cur], ps, Hkv, h, D);
      mma_att::cp_async_commit();
    }
    while (cur < nj) {
      const int nxt = next_flag(flg, cur + 1, nj);
      if (nxt < nj) {
        load_page(ks + (bsel ^ 1) * buf, vs + (bsel ^ 1) * buf, k_pool,
                  v_pool, tbl[nxt], ps, Hkv, h, D);
        mma_att::cp_async_commit();
        mma_att::cp_async_wait<1>();
      } else {
        mma_att::cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int r = warp + W * i;
        if (r < M_pairs)
          page_step(qs + r * D, ks + bsel * buf, vs + bsel * buf,
                    ids + cur * ps, ps, D, pos_s[r], window, sqrt_d, m[i],
                    l[i], acc[i]);
      }
      __syncthreads();  // this buffer is refilled two pages on
      cur = nxt;
      bsel ^= 1;
    }
    if (!split) {
#pragma unroll
      for (int i = 0; i < PPW; ++i)
        fold(Mr[i], Lr[i], Ar[i], m[i], l[i], acc[i]);
    }
    __syncthreads();  // the next split's set-up overwrites tbl, flg, ids
  }
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int r = warp + W * i;
    if (r >= M_pairs) continue;
    const long long rh =
        ((long long)b * S + s0 + r / G) * H + h * G + r % G;
    if (split) {  // a single split: its partial is (m, l, acc) as it stands
      const long long pt = rh * parts + part;
      if (lane == 0) {
        m_part[pt] = m[i];
        l_part[pt] = l[i];
      }
#pragma unroll
      for (int e = 0; e < MAX_D_PER_LANE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc_part[pt * D + d] = acc[i][e];
      }
    } else {
      const float denom = fmaxf(Lr[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < MAX_D_PER_LANE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) store(out + rh * D + d, Ar[i][e] / denom);
      }
    }
  }
}

template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     const float* __restrict__ acc_part,
                                     T* __restrict__ out, int D,
                                     int n_splits) {
  const long long rh = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= D) return;
  float M = NEG_INF, L = 0.f, A[MAX_D_PER_LANE] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_splits; ++s) {
    const long long part = rh * n_splits + s;
    const float acc[MAX_D_PER_LANE] = {acc_part[part * D + d], 0.f, 0.f, 0.f};
    fold(M, L, A, m_part[part], l_part[part], acc);
  }
  store(out + rh * D + d, A[0] / fmaxf(L, 1e-30f));
}

// --- extend, bfloat16: tensor-core tiles of 64 table positions ---------------

template <int D>
size_t extend_bf16_smem() {
  return sizeof(__nv_bfloat16) * (size_t)mma_att::Dims<D>::LD
             * (mma_att::ROWS + 2 * STAGES * mma_att::KT)
         + sizeof(int) * ((size_t)PAIRS + 2 * WIN + 2 * WIN_TILES + 1);
}

template <int D>
__global__ void __launch_bounds__(32 * mma_att::WARPS, 2)
paged_extend_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pool,
                         const __nv_bfloat16* __restrict__ v_pool,
                         const int* __restrict__ ids_pool,
                         const int* __restrict__ block_table,
                         const int* __restrict__ pos,
                         __nv_bfloat16* __restrict__ out, int S, int H,
                         int Hkv, int P, int ps, int n, int window, int TR,
                         float scale_log2) {
  using mma_att::KT;
  using mma_att::ROWS;
  constexpr int LD = mma_att::Dims<D>::LD;
  constexpr int CH = D / 8;
  const int h = blockIdx.y, b = blockIdx.z, s0 = blockIdx.x * TR;
  const int G = H / Hkv, M_pairs = TR * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = 32 * mma_att::WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + ROWS * LD;  // STAGES x KT x LD
  __nv_bfloat16* vs = ks + STAGES * KT * LD;
  int* pos_s = reinterpret_cast<int*>(vs + STAGES * KT * LD);  // PAIRS
  int* ids_w = pos_s + PAIRS;   // the window's entries' ids
  int* src_w = ids_w + WIN;     // their pages, -1 where nothing is read
  int* tl = src_w + WIN;        // WIN_TILES flags: some entry is read
  int* tiles = tl + WIN_TILES;  // the window's tiles to walk
  int* n_live = tiles + WIN_TILES;

  for (int c = tid; c < ROWS * CH; c += nthreads) {
    const int r = c / CH, ch = c - r * CH, row = s0 + r / G;
    const bool ok = r < M_pairs && row < S;
    const long long src =
        ok ? (((long long)b * S + row) * H + h * G + r % G) * D + 8 * ch : 0;
    mma_att::cp_async16(qs + r * LD + 8 * ch, q + src, ok);
  }
  mma_att::cp_async_commit();
  for (int r = tid; r < PAIRS; r += nthreads) {
    const int row = s0 + r / G;
    pos_s[r] = (r < M_pairs && row < S) ? pos[(long long)b * S + row] : -1;
  }
  mma_att::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  mma_att::load_q<D>(qa, qs, 16 * warp);
  int pmax = -1, pmin = 0x7fffffff;  // over the tile's live rows
  for (int r = 0; r < M_pairs; r += G) {
    const int p = pos_s[r];
    pmax = max(pmax, p);
    if (p >= 0) pmin = min(pmin, p);
  }
  const int r0 = 16 * warp + (lane >> 2);  // the thread's pairs: r0, r0 + 8
  const int prow[2] = {pos_s[r0], pos_s[r0 + 8]};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int n_keys = n * ps;
  for (int k0 = 0; pmax >= 0 && k0 < n_keys; k0 += WIN) {
    if (tid < WIN_TILES) tl[tid] = 0;
    __syncthreads();  // (and the last window's tiles are done)
    for (int i = tid; i < WIN; i += nthreads) {
      const int key = k0 + i;
      int id = -1, src = -1;
      if (key < n_keys) {
        const int j = key / ps, page = block_table[(long long)b * n + j];
        if (page >= 0 && page < P) {
          id = ids_pool[(long long)page * ps + key - j * ps];
          if (id >= 0 && id <= pmax && (window <= 0 || id > pmin - window)) {
            src = page;
            tl[i / KT] = 1;
          }
        }
      }
      ids_w[i] = id;
      src_w[i] = src;
    }
    __syncthreads();
    if (tid == 0) {
      int c = 0;
      for (int i = 0; i < WIN_TILES; ++i)
        if (tl[i]) tiles[c++] = i;
      *n_live = c;
    }
    __syncthreads();
    const int live = *n_live;
    auto load_tile = [&](int idx) {
      const int st = idx % STAGES, i0 = KT * tiles[idx];
      for (int c = tid; c < KT * CH; c += nthreads) {
        const int row = c / CH, ch = c - row * CH, i = i0 + row;
        const int src = src_w[i], key = k0 + i;
        const bool ok = src >= 0;
        const long long off =
            ok ? (((long long)src * ps + key % ps) * Hkv + h) * D + 8 * ch
               : 0;
        mma_att::cp_async16(ks + (st * KT + row) * LD + 8 * ch, k_pool + off,
                            ok);
        mma_att::cp_async16(vs + (st * KT + row) * LD + 8 * ch, v_pool + off,
                            ok);
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < live) load_tile(i);
      mma_att::cp_async_commit();
    }
    for (int idx = 0; idx < live; ++idx) {
      mma_att::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (idx + STAGES - 1 < live) load_tile(idx + STAGES - 1);
      mma_att::cp_async_commit();
      const int st = idx % STAGES, i0 = KT * tiles[idx];
      mma_att::tile_step<D>(
          qa, ks + st * KT * LD, vs + st * KT * LD,
          [&](int half, int key) {
            return visible(ids_w[i0 + key], prow[half], window);
          },
          scale_log2, m, l, acc);
    }
    mma_att::cp_async_wait<0>();
  }
  __nv_bfloat16* rows[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half, row = s0 + r / G;
    rows[half] = (r < M_pairs && row < S)
                     ? out + (((long long)b * S + row) * H + h * G + r % G) * D
                     : nullptr;
  }
  mma_att::store_rows<D>(acc, l, rows[0], rows[1]);
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int rows(const void* q, const void* k, const void* v, const void* ids,
         const void* bt, const void* pos, void* out, float* m_part,
         float* l_part, float* acc_part, int B, int S, int H, int Hkv, int D,
         int P, int ps, int n, int window, int TR, int split,
         cudaStream_t s) {
  const int G = H / Hkv, M = TR * G, tiles = (S + TR - 1) / TR;
  const int n_splits = (n + SPLIT - 1) / SPLIT;
  const int parts = split ? n_splits : 1;
  if (parts > 0) {
    const size_t smem = rows_smem<T>(M, D, ps);
    int err = set_smem((const void*)paged_rows_kernel<T>, smem);
    if (err) return err;
    paged_rows_kernel<T><<<dim3(tiles * parts, Hkv, B),
                           32 * min(MAX_WARPS, M), smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(ids),
        static_cast<const int*>(bt), static_cast<const int*>(pos),
        static_cast<T*>(out), m_part, l_part, acc_part, S, H, Hkv, D, P, ps,
        n, window, TR, parts, split, sqrtf((float)D));
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (split) {
    paged_combine_kernel<T><<<B * S * H, 128, 0, s>>>(
        m_part, l_part, acc_part, static_cast<T*>(out), D, n_splits);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <int D>
int extend_bf16(const void* q, const void* k, const void* v, const void* ids,
                const void* bt, const void* pos, void* out, int B, int S,
                int H, int Hkv, int P, int ps, int n, int window, int TR,
                float scale_log2, cudaStream_t s) {
  const size_t smem = extend_bf16_smem<D>();
  const int err = set_smem((const void*)paged_extend_bf16_kernel<D>, smem);
  if (err) return err;
  const dim3 grid((S + TR - 1) / TR, Hkv, B);
  paged_extend_bf16_kernel<D><<<grid, 32 * mma_att::WARPS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(ids),
      static_cast<const int*>(bt), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, P, ps, n, window, TR,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), block_table (B, n), pos (B, S); TR rows per tile. With
// split != 0, scratch m_part, l_part (B, S, H, n_splits) and acc_part
// (B, S, H, n_splits, D) float32, and a second launch that combines them.
extern "C" int paged_rows_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ids_pool, const void* block_table, const void* pos,
    void* out, void* m_part, void* l_part, void* acc_part, int B, int S,
    int H, int Hkv, int D, int P, int ps, int n, int window, int TR,
    int split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (dtype == 0)
    return rows<float>(q, k_pool, v_pool, ids_pool, block_table, pos, out,
                       mp, lp, ap, B, S, H, Hkv, D, P, ps, n, window, TR,
                       split, s);
  return rows<__nv_bfloat16>(q, k_pool, v_pool, ids_pool, block_table, pos,
                             out, mp, lp, ap, B, S, H, Hkv, D, P, ps, n,
                             window, TR, split, s);
}

// bfloat16 q (B, S, H, D), block_table (B, n), pos (B, S); TR = 64 / G
// chunk rows per block.
extern "C" int paged_extend_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ids_pool, const void* block_table, const void* pos,
    void* out, int B, int S, int H, int Hkv, int D, int P, int ps, int n,
    int window, int TR, float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return extend_bf16<16>(q, k_pool, v_pool, ids_pool, block_table, pos, out, B, S, H, Hkv, P, ps, n, window, TR, scale_log2, s);
    case 32: return extend_bf16<32>(q, k_pool, v_pool, ids_pool, block_table, pos, out, B, S, H, Hkv, P, ps, n, window, TR, scale_log2, s);
    case 64: return extend_bf16<64>(q, k_pool, v_pool, ids_pool, block_table, pos, out, B, S, H, Hkv, P, ps, n, window, TR, scale_log2, s);
    case 128: return extend_bf16<128>(q, k_pool, v_pool, ids_pool, block_table, pos, out, B, S, H, Hkv, P, ps, n, window, TR, scale_log2, s);
    default: return -1;
  }
}
