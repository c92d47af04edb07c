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
// (2*KH*cdiv(kv_len, page)*page*D elements per sequence) at 3.35 TB/s.
//
// What the design does about it: one block per (KV head, sequence) holds all
// group*SQ query rows in shared memory, so each page is read once per KV head
// whatever the GQA group or span. The block walks only the table entries
// 0 .. cdiv(kv_len, page) - 1, reading the page ids from the table at run
// time (they are staged in shared memory once, each checked against the
// pool); a page is never fetched past kv_len, so the entries beyond it are
// never read at all. K and V tiles of up to 64 rows (one page or a slice of
// one, never straddling two) are copied with 16-byte loads; the next tile's
// loads are issued into registers before the current tile is computed, so
// the copy overlaps the arithmetic. There are only B*KH blocks (128 on the
// serving path: batch 8, 16 KV heads, one query row each), so the
// parallelism inside a block comes from the keys: warps split the keys of a
// tile and lanes split D for the q.k dot products; the P.V update splits
// (row, d). Masked keys get exactly zero weight. Split-K across blocks
// (flash-decoding), TMA and wgmma are later work.

#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;                 // threads per block
constexpr int NW = NT / 32;             // warps per block
constexpr int MAX_ROWS = 64;            // group * SQ query rows one block holds
constexpr int TILE_BYTES = 16384;       // K (and V) bytes per tile at most
constexpr float NEG = -1e30f;           // masked score (same sentinel as the refs)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// Key rows per tile: 64, or fewer where a 64-row tile of K would pass
// TILE_BYTES (f32 with D = 128 -> 32), so the register staging stays small.
template <typename T, int D>
__host__ __device__ constexpr int tile_rows() {
  return TILE_BYTES / (D * static_cast<int>(sizeof(T))) < 64
             ? TILE_BYTES / (D * static_cast<int>(sizeof(T)))
             : 64;
}

// 16-byte vectors of one K (or V) tile each thread loads.
template <typename T, int D>
__host__ __device__ constexpr int vecs_per_thread() {
  return (tile_rows<T, D>() * D * static_cast<int>(sizeof(T)) / 16 + NT - 1) / NT;
}

// Issue the loads of tile `t` (keys [t*tk, (t+1)*tk), inside one page) into
// registers.
template <typename T, int D, int VPT>
__device__ __forceinline__ void load_tile(uint4 (&kreg)[VPT], uint4 (&vreg)[VPT],
                                          const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool, const int* pids,
                                          int kh, int n_pages, int page, int tk, int t,
                                          int tid) {
  const int key0 = t * tk;
  const size_t base =
      ((static_cast<size_t>(kh) * n_pages + pids[key0 / page]) * page + key0 % page) * D;
  const uint4* ks = reinterpret_cast<const uint4*>(k_pool + base);
  const uint4* vs = reinterpret_cast<const uint4*>(v_pool + base);
  const int nvec = tk * D * static_cast<int>(sizeof(T)) / 16;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = tid + i * NT;
    if (idx < nvec) {
      kreg[i] = __ldg(ks + idx);
      vreg[i] = __ldg(vs + idx);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ kv_len, T* __restrict__ out, int H, int KH,
                       int SQ, int n_pages, int page, int P, int tk, float scale) {
  constexpr int TKT = tile_rows<T, D>();
  constexpr int VPT = vecs_per_thread<T, D>();

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = H / KH;
  const int R = group * SQ;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                  // [TKT][D]
  T* Vs = Ks + TKT * D;                                    // [TKT][D]
  float* Qs = reinterpret_cast<float*>(Vs + TKT * D);      // [R][D]
  float* Acc = Qs + R * D;                                 // [R][D]
  float* S = Acc + R * D;                                  // [R][TKT] scores, then probs
  float* row_m = S + R * TKT;                              // running max per row
  float* row_l = row_m + R;                                // running denominator per row
  float* row_c = row_l + R;                                // this tile's rescale per row
  int* pids = reinterpret_cast<int*>(row_c + R);           // [P] page ids in use

  const int kvl = kv_len[b];
  const int n_used = kvl > 0 ? (kvl + page - 1) / page : 0;
  const int n_tiles = kvl > 0 ? (kvl + tk - 1) / tk : 0;
  // the R query rows of this KV head are contiguous in (B, H, SQ, D)
  const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * group) * SQ * D;

  for (int i = tid; i < R * D; i += NT) {
    Qs[i] = to_f32(q[q_base + i]);
    Acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) {
    row_m[r] = NEG;
    row_l[r] = 0.f;
  }
  for (int i = tid; i < n_used; i += NT) {
    assert(i < P);                        // kv_len beyond the table's coverage
    const int pid = tables[static_cast<size_t>(b) * P + i];
    assert(pid >= 0 && pid < n_pages);    // every page id read must be in the pool
    pids[i] = pid;
  }
  __syncthreads();

  uint4 kreg[VPT], vreg[VPT];
  if (n_tiles > 0)
    load_tile<T, D, VPT>(kreg, vreg, k_pool, v_pool, pids, kh, n_pages, page, tk, 0, tid);
  const int nvec = tk * D * static_cast<int>(sizeof(T)) / 16;
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
    if (t + 1 < n_tiles)                  // in flight while this tile is computed
      load_tile<T, D, VPT>(kreg, vreg, k_pool, v_pool, pids, kh, n_pages, page, tk, t + 1,
                           tid);
    const int key0 = t * tk;

    // scores: warps split the (row, key) pairs, lanes split D
    for (int p = warp; p < R * tk; p += NW) {
      const int r = p / tk;
      const int c = p - r * tk;
      const float* qr = Qs + r * D;
      const T* kc = Ks + c * D;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) dot = fmaf(qr[lane + 32 * j], to_f32(kc[lane + 32 * j]), dot);
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
        const float s = sr[c];
        const float pr = s > 0.5f * NEG ? expf(s - m_new) : 0.f;
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
      for (int c = 0; c < tk; ++c) a = fmaf(pr[c], to_f32(Vs[c * D + d]), a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < R * D; e += NT) {
    const float l = row_l[e / D];
    out[q_base + e] = from_f32<T>(l > 0.f ? Acc[e] / l : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* kv_len, void* out, int B, int H, int KH, int SQ, int n_pages,
                   int page, int P, int tk, float scale, cudaStream_t stream) {
  constexpr int TKT = tile_rows<T, D>();
  const int R = (H / KH) * SQ;
  if (tk < 1 || tk > TKT || page % tk != 0 || R < 1 || R > MAX_ROWS || P < 1)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(TKT) * D * sizeof(T) +
                      sizeof(float) * (2 * static_cast<size_t>(R) * D +
                                       static_cast<size_t>(R) * TKT + 3 * R) +
                      sizeof(int) * static_cast<size_t>(P);
  auto kern = paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(KH, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, kv_len, static_cast<T*>(out), H, KH, SQ, n_pages, page, P, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 on success); the launch does not synchronise.
extern "C" int tsl_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* kv_len, void* out, int B,
                                   int H, int KH, int SQ, int D, int n_pages, int page, int P,
                                   int tk, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(tables);
  const int* kvl = static_cast<const int*>(kv_len);
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || SQ <= 0 || n_pages <= 0 || page <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_pool, v_pool, tab, kvl, out, B, H, KH, SQ, n_pages, page, P,
                             tk, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_pool, v_pool, tab, kvl, out, B, H, KH, SQ, n_pages, page,
                              P, tk, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, tab, kvl, out, B, H, KH, SQ, n_pages,
                                     page, P, tk, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, tab, kvl, out, B, H, KH, SQ,
                                      n_pages, page, P, tk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
