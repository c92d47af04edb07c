// Fused paged attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces repro/kernels/paged/kernel.py:paged_attention_4d (_paged_kernel),
// the Pallas TPU block-table kernel behind attention_decode_paged.
//
// Contract (the same as the Pallas kernel and ref.paged_attention_ref):
//   q/out (B, H, SQ, D); k_pool/v_pool (KH, n_pages, page, D), the whole pool;
//   tables (B, P) int32 page ids; kv_len (B,) int32 on the device. All
//   contiguous. Query head h reads KV head h / (H / KH); the group*SQ query
//   rows of one KV head are contiguous in q, row r = g*SQ + s. Span row r sits
//   at absolute position kv_len - SQ + r % SQ and sees the keys at positions
//   <= that one; a row that sees no key (kv_len == 0, or a span row before the
//   first key) outputs exactly 0. Softmax statistics and the accumulator are
//   f32; the output has q's dtype.
//
// What bounds it on the H100: decode does 4*D flops per (query row, key) on
// 2*D*bytes of K/V per key, about 1 flop per byte for bf16 with group 1, far
// under the card's ~295 flop/byte ridge: the floor is the touched pages
// (2*KH*cdiv(kv_len, page)*page*D elements per sequence) at 3.35 TB/s, a few
// microseconds on the serving path. At that size what bounds a kernel is
// latency: the chain of dependent loads (kv_len, the table, the pages) and of
// arithmetic each block walks, and how many blocks share it out.
//
// What the design does about it:
//   * split over pages in one launch (flash-decoding): the grid is (KH, B, S)
//     and block (kh, b, s) walks only table entries [s*pps, (s+1)*pps) of
//     sequence b, clipped to the cdiv(kv_len, page) entries it covers; a split
//     that starts past them reads no table entry and no page and contributes
//     l = 0. S and pps come from the host's plan (kernel.py), from the table
//     width and the SM count, never from kv_len (that lives on the device).
//     With S = 1 the block writes the output itself. Otherwise each block
//     writes its float32 (m, l, acc[R][D]) to a workspace, and the last block
//     of its (sequence, KV head), found by an atomic ticket taken after
//     __threadfence(), merges the S states in an order fixed by the split
//     index (never by arrival, so a call's output is the same bit for bit
//     every time) and resets the ticket for the next call. One launch per call: the serving
//     step is host-bound, and a second launch would cost the host more than
//     the merge costs the card;
//   * bf16 runs on the tensor cores: each 64-key tile of a split is gathered
//     row by row from its pages (a tile may span pages smaller than 64 rows)
//     by 16-byte cp.async into XOR-swizzled tiles, a ring of 2 stages (tile
//     t+1 in flight while tile t is computed). The R = group*SQ <= 64 query
//     rows are padded to 1, 2 or 4 m-tiles of 16; the 4 warps share the m-tiles
//     and split each tile's keys between the warps of one m-tile (KW of them),
//     so a decode row (R = 1) still keeps all 4 warps busy. S = Q K^T and
//     O += P V by mma.sync m16n8k16 through ldmatrix (the products of bf16
//     inputs are exact, the sums float32), the online softmax in registers
//     in log2 units. P goes into P V in two bf16 parts, its rounding and
//     the rounding of what that leaves (about 16 bits of P), as in the flash
//     forward (flash_mma.cuh's split_a).
//     The warps' states are merged in warp order through shared memory at
//     the end of the split;
//   * float32 is the exact oracle: scalar float32 inner products (tiles of
//     `tk` keys inside one page, loaded into registers ahead of use), through
//     the same split and merge, so a fault of the merge shows in both dtypes;
//   * every page id read is checked against the pool, and a kv_len past the
//     table's coverage trips an assert; no table entry or page past
//     cdiv(kv_len, page) is read.
// The building blocks (swizzled tiles, cp.async, ldmatrix, mma.sync) come
// from flash_attention/csrc/flash_mma.cuh.
//
// Head dims: 64, 128 and 112 (zamba2's shared attention block). At D 112 a
// bf16 tile row takes 16 chunks of 16 bytes for its 14 (flash_mma.cuh's
// row_chunks: the swizzle's XOR stays inside the row), so a tile takes D
// 128's 16 KB; the warps' float states after the key loop ([NW][16][D] over
// the Q tile and K stages, [R][D] over the V stages) fit as at D 128. The
// float32 path takes 32-key tiles (tile_rows), and its score loop walks
// every column (D / 32 is not whole at 112).

#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int NT = 128;                 // threads per block
constexpr int NW = NT / 32;             // warps per block
constexpr int MMA_MIN_BLOCKS = 2;       // bf16 path: resident blocks per SM (kernel.py's plan)
constexpr int MAX_ROWS = 64;            // group * SQ query rows one block holds
constexpr int MAX_SPLITS = 64;          // splits per (sequence, KV head)
constexpr int KEY_TILE = 64;            // keys per tile of the bf16 path
constexpr int TILE_BYTES = 16384;       // float32 path: K (and V) bytes per tile at most
constexpr int SMEM_LIMIT = 200 * 1024;  // dynamic shared memory a launch may ask for
constexpr float NEG = -1e30f;           // masked score of the float32 path (the refs' sentinel)

__device__ __forceinline__ float from_f32(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <bool LOG2>
__device__ __forceinline__ float ex(float x) { return LOG2 ? exp2f(x) : expf(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The table entries and keys split s of a sequence reads: entries [e0, e1)
// of the n_used that its kv_len keys cover, keys [k0, k1).
struct Split {
  int e0, e1, k0, k1;
};

__device__ __forceinline__ Split split_of(int s, int pps, int n_used, int page, int kvl) {
  Split sp;
  sp.e0 = s * pps;
  sp.e1 = min(sp.e0 + pps, n_used);
  sp.k0 = sp.e0 * page;
  sp.k1 = sp.e1 > sp.e0 ? min(sp.e1 * page, kvl) : sp.k0;
  return sp;
}

// Stage the split's page ids in shared memory, each checked against the pool.
__device__ __forceinline__ void stage_pids(int* pids, const int* __restrict__ tables, int b,
                                           int P, int n_pages, const Split& sp) {
  for (int e = sp.e0 + threadIdx.x; e < sp.e1; e += NT) {
    const int pid = tables[static_cast<size_t>(b) * P + e];
    assert(pid >= 0 && pid < n_pages);    // every page id read must be in the pool
    pids[e - sp.e0] = pid;
  }
}

// Floats of one split's state in the workspace: acc[R][D], m[R], l[R], padded
// so that every split's acc starts 16-byte aligned.
__device__ __forceinline__ size_t part_floats(int R, int D) {
  return static_cast<size_t>(R) * (D + 4);
}

// The merged float4 e4 of acc over splits j0, j0 + dj, ... < S (in that
// order), each weighted by wt[j][r].
__device__ __forceinline__ float4 merge4(const float* all, size_t part, const float* wt,
                                         int R, int D, int S, int e4, int j0, int dj) {
  const int r = 4 * e4 / D;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int j = j0; j < S; j += dj) {
    const float w = wt[j * R + r];
    const float4 x = __ldcg(reinterpret_cast<const float4*>(all + j * part) + e4);
    a.x = fmaf(w, x.x, a.x);
    a.y = fmaf(w, x.y, a.y);
    a.z = fmaf(w, x.z, a.z);
    a.w = fmaf(w, x.w, a.w);
  }
  return a;
}

template <typename T>
__device__ __forceinline__ void store4(T* out, int e4, float4 a, float inv) {
  out[4 * e4] = from_f32(a.x * inv, out);
  out[4 * e4 + 1] = from_f32(a.y * inv, out);
  out[4 * e4 + 2] = from_f32(a.z * inv, out);
  out[4 * e4 + 3] = from_f32(a.w * inv, out);
}

// The end of every split: st_m / st_l / st_acc hold the block's state for
// rows [0, R) (running max, in log2 units when LOG2; denominator; the
// unnormalised output, [R][D]). With one split the block writes out = acc / l
// (0 on a row that saw no key). Otherwise it writes its state to the
// workspace; the last block of its (sequence, KV head) to take the ticket
// merges all S states and resets the ticket. The merge's order is fixed by
// the split index, never by arrival: per row one warp takes the weights
// exp(m_j - M) (lane j mod 32 of split j, M the largest m among the splits
// with l > 0) and the denominator by a fixed shuffle tree; per float4 of the
// output the threads of group g add splits g, g + G, ... in index order, and
// the G groups (G > 1 only when the output has fewer float4 than the block
// has threads) are added in group order. wt: S * R floats and red: 4 * NT
// floats of shared memory; st_m is reused for the rows' 1 / l once the state
// is written.
template <typename T, bool LOG2>
__device__ __forceinline__ void finish_split(float* st_m, const float* st_l,
                                             const float* st_acc, int R, int D,
                                             T* __restrict__ out, float* __restrict__ ws,
                                             int* __restrict__ counters, int pair, int s, int S,
                                             float* wt, float* red) {
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (S == 1) {
    for (int e = tid; e < R * D; e += NT) {
      const float l = st_l[e / D];
      out[e] = from_f32(l > 0.f ? st_acc[e] / l : 0.f, out);
    }
    return;
  }
  const size_t part = part_floats(R, D);
  float* all = ws + static_cast<size_t>(pair) * S * part;
  float* mine = all + s * part;
  for (int e = tid; e < R * D; e += NT) mine[e] = st_acc[e];
  for (int r = tid; r < R; r += NT) {
    mine[R * D + r] = st_m[r];
    mine[R * D + R + r] = st_l[r];
  }
  __threadfence();                        // the state is visible before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + pair, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = warp; r < R; r += NW) {    // S <= 64: splits lane and lane + 32
    float l_j[2], m_j[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      l_j[i] = j < S ? __ldcg(all + j * part + R * D + R + r) : 0.f;
      m_j[i] = j < S ? __ldcg(all + j * part + R * D + r) : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (l_j[i] > 0.f) M = fmaxf(M, m_j[i]);
    M = warp_max(M);
    float L = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float w = l_j[i] > 0.f ? ex<LOG2>(m_j[i] - M) : 0.f;
      if (lane + 32 * i < S) wt[(lane + 32 * i) * R + r] = w;
      L = fmaf(w, l_j[i], L);
    }
    L = warp_sum(L);
    if (lane == 0) st_m[r] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  const int items = R * D / 4;            // float4 of the output
  if (items >= NT) {
    for (int e4 = tid; e4 < items; e4 += NT)
      store4(out, e4, merge4(all, part, wt, R, D, S, e4, 0, 1), st_m[4 * e4 / D]);
  } else {
    const int G = NT / items, g = tid / items, e4 = tid - g * items;
    float4* red4 = reinterpret_cast<float4*>(red);     // [G][items]
    if (g < G) red4[g * items + e4] = merge4(all, part, wt, R, D, S, e4, g, G);
    __syncthreads();
    if (tid < items) {
      float4 a = red4[tid];
      for (int k = 1; k < G; ++k) {
        const float4 b = red4[k * items + tid];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      store4(out, tid, a, st_m[4 * tid / D]);
    }
  }
  if (tid == 0) counters[pair] = 0;       // ready for the next call
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by cp.async
// ---------------------------------------------------------------------------

// Copy keys [key0, key0 + 64) of the split into stage tiles dK / dV (swizzled
// [64][D]), each row from its page; rows at or past the split's end k1 are
// zero-filled and not read.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t dK, uint32_t dV,
                                        const __nv_bfloat16* __restrict__ k_pool,
                                        const __nv_bfloat16* __restrict__ v_pool,
                                        const int* pids, const Split& sp, int kh, int n_pages,
                                        int page, int key0, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < KEY_TILE * CH / NT; ++j) {
    const int i = tid + j * NT, r = i / CH, c = i % CH, pos = key0 + r;
    const bool ok = pos < sp.k1;
    size_t off = 0;
    if (ok) {
      const int e = pos / page;
      off = ((static_cast<size_t>(kh) * n_pages + pids[e - sp.e0]) * page + (pos - e * page)) *
                D + c * 8;
    }
    cp_async16(dK + swz<D>(r, c), k_pool + off, ok);
    cp_async16(dV + swz<D>(r, c), v_pool + off, ok);
  }
}

// Shared memory of the bf16 kernel: Q, 2 K stages, 2 V stages, the block's
// m and l per row, the split's page ids.
template <int D>
__host__ __device__ constexpr int mma_smem_fixed() {
  return 5 * static_cast<int>(tile_bytes<D, KEY_TILE>()) +
         2 * MAX_ROWS * static_cast<int>(sizeof(float));
}

// KW: warps that share one 16-row m-tile (4 / m-tiles), each taking 64 / KW
// keys of every tile. MMA_MIN_BLOCKS in the launch bounds: the host's plan
// sizes the grid for 2 blocks per SM (kernel.py), and the stated minimum
// gives ptxas up to 255 registers a thread; with the maximum alone it held
// <64, 2> to 128 and spilled.
template <int D, int KW>
__global__ void __launch_bounds__(NT, MMA_MIN_BLOCKS)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                 const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ counters, int H, int KH, int SQ,
                 int n_pages, int page, int P, int pps, float scale) {
  constexpr int KS = D / 16;                   // k-steps of S = Q K^T
  constexpr int NK = KEY_TILE / KW;            // keys of a tile one warp takes
  constexpr int NS = NK / 8;                   // its 8-key column tiles of S
  constexpr int ND = D / 8;                    // 8-wide column tiles of O
  constexpr uint32_t TB = tile_bytes<D, KEY_TILE>();   // one bf16 tile, rows padded
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);         // [64][D], rows >= R zero
  const uint32_t sK = sQ + TB;                 // 2 stages
  const uint32_t sV = sK + 2 * TB;             // 2 stages
  float* st_m = reinterpret_cast<float*>(smem + 5 * TB);
  float* st_l = st_m + MAX_ROWS;
  int* pids = reinterpret_cast<int*>(st_l + MAX_ROWS);
  // after the key loop: the warps' states over Q and the K stages, the
  // block's merged output over the V stages; the merge's sums over the rest
  // of Q (4 * NT floats)
  float* w_m = reinterpret_cast<float*>(smem);              // [NW][16]
  float* w_l = w_m + NW * 16;                                // [NW][16]
  float* w_acc = reinterpret_cast<float*>(smem + TB);       // [NW][16][D]
  float* st_acc = reinterpret_cast<float*>(smem + 3 * TB);  // [R][D]

  const int kh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = H / KH;
  const int R = group * SQ;
  const int pair = b * KH + kh;
  // the R query rows of this KV head are contiguous in (B, H, SQ, D)
  const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * group) * SQ * D;

  const int kvl = kv_len[b];
  const int n_used = kvl > 0 ? (kvl + page - 1) / page : 0;
  assert(n_used <= P);                    // kv_len beyond the table's coverage
  const Split sp = split_of(s, pps, n_used, page, kvl);
  const int n_t = (sp.k1 - sp.k0 + KEY_TILE - 1) / KEY_TILE;
  load_tile<D>(sQ, q + q_base, 0, R, tid);
  stage_pids(pids, tables, b, P, n_pages, sp);
  __syncthreads();

  if (n_t > 0) load_kv<D>(sK, sV, k_pool, v_pool, pids, sp, kh, n_pages, page, sp.k0, tid);
  cp_async_commit();

  const int mt = warp / KW;                    // this warp's m-tile
  const int kc0 = (warp % KW) * NK;            // its keys within each tile
  const int row_a = mt * 16 + (lane >> 2);     // its rows row_a and row_a + 8
  int q_last[2];                               // last key position each row sees
#pragma unroll
  for (int r = 0; r < 2; ++r) q_last[r] = kvl - SQ + (row_a + 8 * r) % SQ;
  const float scale_log2 = scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};     // running max, log2 units
  float l_run[2] = {0.f, 0.f};                 // this thread's part of the denominator

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1's stage
    if (t + 1 < n_t) {
      const uint32_t nxt = ((t + 1) & 1) * TB;
      load_kv<D>(sK + nxt, sV + nxt, k_pool, v_pool, pids, sp, kh, n_pages, page,
                 sp.k0 + (t + 1) * KEY_TILE, tid);
      cp_async_commit();
    }
    const uint32_t sKt = sK + (t & 1) * TB;
    const uint32_t sVt = sV + (t & 1) * TB;
    const int key0 = sp.k0 + t * KEY_TILE + kc0;

    // S = Q K^T: 16 rows x NK keys per warp; Q's fragments are read from
    // its tile per k-step, not held across the loop (registers at D 128)
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldsm_a<D>(sQ, mt * 16, ks, lane, qa);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t b0, b1, b2, b3;
        ldsm_bt<D>(sKt, kc0 + n2 * 16, ks, lane, b0, b1, b2, b3);
        mma_bf16(sc[2 * n2], qa, b0, b1);
        mma_bf16(sc[2 * n2 + 1], qa, b2, b3);
      }
    }
    // log2 units; a key past the split or after the row's position weighs 0
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = key0 + n * 8 + (lane & 3) * 2 + (e & 1);
        sc[n][e] = kpos < sp.k1 && kpos <= q_last[e >> 1] ? sc[n][e] * scale_log2 : -INFINITY;
      }
    }

    // online softmax in registers; a row that has seen no key yet keeps
    // m = -inf and subtracts 0, so its masked entries weigh exp2(-inf) = 0
    float m_sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_run[r] - m_use);
      m_run[r] = m_new;
      m_sub[r] = m_use;
      l_run[r] *= corr;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m_sub[e >> 1]);
        l_run[e >> 1] += p;
        sc[n][e] = p;
      }
    }

    // O += P V, 16 keys per step: P split in registers into two bf16 parts,
    // both A operands against the same V fragments
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t a[4], a_lo[4];
      split_a(sc[2 * kk], sc[2 * kk + 1], a, a_lo);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t b0, b1, b2, b3;
        ldsm_b<D>(sVt, kc0 + kk * 16, d2, lane, b0, b1, b2, b3);
        mma_bf16(acc[2 * d2], a, b0, b1);
        mma_bf16(acc[2 * d2], a_lo, b0, b1);
        mma_bf16(acc[2 * d2 + 1], a, b2, b3);
        mma_bf16(acc[2 * d2 + 1], a_lo, b2, b3);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // every warp is done with Q and the stages; no copy in flight

  // each warp's state for its 16 rows
  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  float* wa = w_acc + warp * 16 * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(wa + g * D + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(wa + (g + 8) * D + col) = make_float2(acc[j][2], acc[j][3]);
  }
  if ((lane & 3) == 0) {
    w_m[warp * 16 + g] = m_run[0];
    w_m[warp * 16 + g + 8] = m_run[1];
    w_l[warp * 16 + g] = l_run[0];
    w_l[warp * 16 + g + 8] = l_run[1];
  }
  __syncthreads();
  // the block's state: row r's warps are (r / 16) * KW + j, merged in warp order
  for (int r = tid; r < R; r += NT) {
    const int w0 = (r >> 4) * KW * 16 + (r & 15);
    float M = -INFINITY;
    for (int j = 0; j < KW; ++j)
      if (w_l[w0 + j * 16] > 0.f) M = fmaxf(M, w_m[w0 + j * 16]);
    float L = 0.f;
    for (int j = 0; j < KW; ++j)
      if (w_l[w0 + j * 16] > 0.f) L = fmaf(exp2f(w_m[w0 + j * 16] - M), w_l[w0 + j * 16], L);
    st_m[r] = M;
    st_l[r] = L;
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const int w0 = (r >> 4) * KW * 16 + (r & 15);
    float a = 0.f;
    for (int j = 0; j < KW; ++j)
      if (w_l[w0 + j * 16] > 0.f)
        a = fmaf(exp2f(w_m[w0 + j * 16] - st_m[r]), w_acc[(w0 + j * 16) * D + d], a);
    st_acc[e] = a;
  }
  __syncthreads();
  finish_split<__nv_bfloat16, true>(st_m, st_l, st_acc, R, D, out + q_base, ws, counters,
                                    pair, s, gridDim.z, w_acc, w_l + NW * 16);
}

// ---------------------------------------------------------------------------
// float32: the exact scalar path
// ---------------------------------------------------------------------------

// Key rows per tile: 64, or the largest power of two whose tile of K stays
// within TILE_BYTES (D 128 -> 32, D 112 -> 32 where 36 rows would fit), so
// the register staging stays small and the tile divides every power-of-two
// page (the host takes gcd(block, tile_rows), kernel.py's tile_rows).
template <int D>
__host__ __device__ constexpr int tile_rows() {
  int rows = 64;
  while (rows * D * 4 > TILE_BYTES) rows /= 2;
  return rows;
}

// 16-byte vectors of one K (or V) tile each thread loads.
template <int D>
__host__ __device__ constexpr int vecs_per_thread() {
  return (tile_rows<D>() * D * 4 / 16 + NT - 1) / NT;
}

// Issue the loads of the tk keys from key0 (inside one page) into registers.
template <int D, int VPT>
__device__ __forceinline__ void load_tile_regs(uint4 (&kreg)[VPT], uint4 (&vreg)[VPT],
                                               const float* __restrict__ k_pool,
                                               const float* __restrict__ v_pool,
                                               const int* pids, const Split& sp, int kh,
                                               int n_pages, int page, int tk, int key0,
                                               int tid) {
  const int e = key0 / page;
  const size_t base =
      ((static_cast<size_t>(kh) * n_pages + pids[e - sp.e0]) * page + key0 - e * page) * D;
  const uint4* ks = reinterpret_cast<const uint4*>(k_pool + base);
  const uint4* vs = reinterpret_cast<const uint4*>(v_pool + base);
  const int nvec = tk * D / 4;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = tid + i * NT;
    if (idx < nvec) {
      kreg[i] = __ldg(ks + idx);
      vreg[i] = __ldg(vs + idx);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
paged_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                 const float* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ kv_len, float* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ counters, int H, int KH, int SQ,
                 int n_pages, int page, int P, int tk, int pps, float scale) {
  constexpr int TKT = tile_rows<D>();
  constexpr int VPT = vecs_per_thread<D>();

  const int kh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = H / KH;
  const int R = group * SQ;
  const int pair = b * KH + kh;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);          // [TKT][D]
  float* Vs = Ks + TKT * D;                                // [TKT][D]
  float* Qs = Vs + TKT * D;                                // [R][D]
  float* Acc = Qs + R * D;                                 // [R][D]
  float* S = Acc + R * D;                                  // [R][TKT] scores, then probs
  float* row_m = S + R * TKT;                              // running max per row
  float* row_l = row_m + R;                                // running denominator per row
  float* row_c = row_l + R;                                // this tile's rescale per row
  int* pids = reinterpret_cast<int*>(row_c + R);           // [pps] the split's page ids

  const int kvl = kv_len[b];
  const int n_used = kvl > 0 ? (kvl + page - 1) / page : 0;
  assert(n_used <= P);                    // kv_len beyond the table's coverage
  const Split sp = split_of(s, pps, n_used, page, kvl);
  const int n_tiles = (sp.k1 - sp.k0 + tk - 1) / tk;
  // the R query rows of this KV head are contiguous in (B, H, SQ, D)
  const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * group) * SQ * D;

  for (int i = tid; i < R * D; i += NT) {
    Qs[i] = q[q_base + i];
    Acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) {
    row_m[r] = NEG;
    row_l[r] = 0.f;
  }
  stage_pids(pids, tables, b, P, n_pages, sp);
  __syncthreads();

  uint4 kreg[VPT], vreg[VPT];
  if (n_tiles > 0)
    load_tile_regs<D, VPT>(kreg, vreg, k_pool, v_pool, pids, sp, kh, n_pages, page, tk, sp.k0,
                           tid);
  const int nvec = tk * D / 4;
  const int q_pos0 = kvl - SQ;            // absolute position of span row 0

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                      // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = tid + i * NT;
      if (idx < nvec) {
        reinterpret_cast<uint4*>(Ks)[idx] = kreg[i];
        reinterpret_cast<uint4*>(Vs)[idx] = vreg[i];
      }
    }
    __syncthreads();
    const int key0 = sp.k0 + t * tk;
    if (t + 1 < n_tiles)                  // in flight while this tile is computed
      load_tile_regs<D, VPT>(kreg, vreg, k_pool, v_pool, pids, sp, kh, n_pages, page, tk,
                             key0 + tk, tid);

    // scores: warps split the (row, key) pairs, lanes split D
    for (int p = warp; p < R * tk; p += NW) {
      const int r = p / tk;
      const int c = p - r * tk;
      const float* qr = Qs + r * D;
      const float* kc = Ks + c * D;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < (D + 31) / 32; ++j) {   // every column, also where 32 does not divide D
        const int d = lane + 32 * j;
        if (d < D) dot = fmaf(qr[d], kc[d], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) S[r * TKT + c] = key0 + c <= q_pos0 + r % SQ ? dot * scale : NEG;
    }
    __syncthreads();

    // online softmax, one warp per row; masked keys weigh exactly 0
    for (int r = warp; r < R; r += NW) {
      float* sr = S + r * TKT;
      float mx = NEG;
      for (int c = lane; c < tk; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < tk; c += 32) {
        const float sv = sr[c];
        const float pr = sv > 0.5f * NEG ? expf(sv - m_new) : 0.f;
        sr[c] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V
    for (int e = tid; e < R * D; e += NT) {
      const int r = e / D;
      const int d = e - r * D;
      const float* pr = S + r * TKT;
      float a = Acc[e] * row_c[r];
      for (int c = 0; c < tk; ++c) a = fmaf(pr[c], Vs[c * D + d], a);
      Acc[e] = a;
    }
  }
  __syncthreads();
  finish_split<float, false>(row_m, row_l, Acc, R, D, out + q_base, ws, counters, pair, s,
                             gridDim.z, Ks, Vs);
}

template <int D, int KW>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                       const int* kv_len, void* out, float* ws, int* counters, int B, int H,
                       int KH, int SQ, int n_pages, int page, int P, int splits, int pps,
                       float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_fixed<D>() + sizeof(int) * static_cast<size_t>(pps);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> done{0};
  auto kern = paged_mma_kernel<D, KW>;
  const cudaError_t err = allow_smem(kern, SMEM_LIMIT, done);   // once per card
  if (err != cudaSuccess) return err;
  kern<<<dim3(KH, B, splits), NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), tables, kv_len,
      static_cast<__nv_bfloat16*>(out), ws, counters, H, KH, SQ, n_pages, page, P, pps, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_rows(const void* q, const void* k_pool, const void* v_pool,
                            const int* tables, const int* kv_len, void* out, float* ws,
                            int* counters, int B, int H, int KH, int SQ, int n_pages, int page,
                            int P, int splits, int pps, float scale, cudaStream_t stream) {
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const int*,
                                 const int*, void*, float*, int*, int, int, int, int, int, int,
                                 int, int, int, float, cudaStream_t);
  const int R = (H / KH) * SQ;            // 1, 2 or 4 m-tiles: 4, 2 or 1 warps each
  const Launch fn =
      R <= 16 ? &launch_mma<D, 4> : R <= 32 ? &launch_mma<D, 2> : &launch_mma<D, 1>;
  return fn(q, k_pool, v_pool, tables, kv_len, out, ws, counters, B, H, KH, SQ, n_pages, page,
            P, splits, pps, scale, stream);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                       const int* kv_len, void* out, float* ws, int* counters, int B, int H,
                       int KH, int SQ, int n_pages, int page, int P, int tk, int splits,
                       int pps, float scale, cudaStream_t stream) {
  constexpr int TKT = tile_rows<D>();
  const int R = (H / KH) * SQ;
  if (tk < 1 || tk > TKT || page % tk != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(TKT) * D +
                                       2 * static_cast<size_t>(R) * D +
                                       static_cast<size_t>(R) * TKT + 3 * R) +
                      sizeof(int) * static_cast<size_t>(pps);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> done{0};
  auto kern = paged_f32_kernel<D>;
  const cudaError_t err = allow_smem(kern, SMEM_LIMIT, done);   // once per card
  if (err != cudaSuccess) return err;
  kern<<<dim3(KH, B, splits), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), tables, kv_len, static_cast<float*>(out), ws, counters,
      H, KH, SQ, n_pages, page, P, tk, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32 (the scalar path, tk
// keys per tile), 1 = bfloat16 (tensor cores; q, the pools and out 16-byte
// aligned; tk unused). splits * pps table entries cover the table (P), no
// split starts past it; with splits > 1, ws holds B*KH*splits*R*(D+4)
// floats (16-byte aligned) and counters B*KH zeroed ints (the kernel leaves them zeroed).
// Returns a cudaError_t (0 on success); the launch does not synchronise.
extern "C" int tsl_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* kv_len, void* out, void* ws,
                                   void* counters, int B, int H, int KH, int SQ, int D,
                                   int n_pages, int page, int P, int tk, int splits, int pps,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(tables);
  const int* kvl = static_cast<const int*>(kv_len);
  float* w = static_cast<float*>(ws);
  int* ct = static_cast<int*>(counters);
  if (B <= 0 || B > 65535 || H <= 0 || KH <= 0 || H % KH != 0 || SQ <= 0 || n_pages <= 0 ||
      page <= 0 || P <= 0 || (H / KH) * SQ > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > MAX_SPLITS || pps < 1 || (splits - 1) * pps >= P ||
      splits * pps < P || (splits > 1 && (w == nullptr || ct == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k_pool, v_pool, tab, kvl, out, w, ct, B, H, KH, SQ, n_pages, page,
                          P, tk, splits, pps, scale, st);
  if (dtype == 0 && D == 112)
    return launch_f32<112>(q, k_pool, v_pool, tab, kvl, out, w, ct, B, H, KH, SQ, n_pages,
                           page, P, tk, splits, pps, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k_pool, v_pool, tab, kvl, out, w, ct, B, H, KH, SQ, n_pages,
                           page, P, tk, splits, pps, scale, st);
  if (dtype != 1 || !(aligned16(q) && aligned16(k_pool) && aligned16(v_pool) && aligned16(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_mma_rows<64>(q, k_pool, v_pool, tab, kvl, out, w, ct, B, H, KH, SQ, n_pages,
                               page, P, splits, pps, scale, st);
  if (D == 112)
    return launch_mma_rows<112>(q, k_pool, v_pool, tab, kvl, out, w, ct, B, H, KH, SQ, n_pages,
                                page, P, splits, pps, scale, st);
  if (D == 128)
    return launch_mma_rows<128>(q, k_pool, v_pool, tab, kvl, out, w, ct, B, H, KH, SQ, n_pages,
                                page, P, splits, pps, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
