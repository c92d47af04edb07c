// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++:
// two recomputation kernels, dq (q-tiled) and dk/dv (k-tiled).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_bwd_dq_4d
// (_flash_bwd_dq_kernel) and flash_attention_bwd_dkv_4d
// (_flash_bwd_dkv_kernel), the Pallas TPU kernels.
//
// Contract (the same as the Pallas kernels and ref.attention_bwd_dq /
// ref.attention_bwd_dkv):
//   q / do (B,H,Sq,D), k/v (B,KH,Sk,D) contiguous, one dtype; lse and
//   delta (B,H,Sq) float32: lse from the forward (0 on a row that sees no
//   key), delta = rowsum(dO * O) in float32, both computed by the caller.
//   Query head h reads KV head h / (H/KH) (GQA). Row i sees key j iff
//     j < min(kv_len, Sk)  and, when causal,  j <= i + q_offset
//   (runtime ints, as the forward). With s = scale * q.k:
//     p  = exp(s - lse)   (exactly 0 where masked)
//     ds = p * (dO.v - delta)
//     dq = scale * sum_j ds k_j          written in q's dtype
//     dv = sum_i p do_i,  dk = scale * sum_i ds q_i
//   dk/dv are written in float32 per QUERY head, (B,H,Sk,D); the caller
//   sums each group of H/KH heads onto its KV head in float32 and casts
//   (as the reference's ops.py does outside its kernel).
//
// What bounds it on the H100: at the training shape (B 8, 16 heads, S 512,
// D 64, causal, bf16) dq does three S x S x D products (S = QK^T, dP = dO V^T,
// dQ = dS K) on 42 MB and dk/dv four (S^T, dP^T, dV = P^T dO, dK = dS^T Q) on
// 68 MB, most of it dk/dv's float32 output; the datasheet floor is the bytes
// for both (0.013 and 0.020 ms against 0.007 and 0.009 ms of tensor-core
// operations). A kernel of this size is held in practice by how fast its
// products issue and by the latency of each tile's loads.
//
// What the design does about it (bf16, the main path; the forward's design,
// flash_attention.cu, and its building blocks, flash_mma.cuh):
//   * a block never writes what another block reads, so there are no atomics
//     and no second pass, and the gradients are the same run to run;
//   * dq: one block of 4 warps per (64-row q tile, head, batch), q tiles
//     launched last-first (under causality the heaviest first); each warp
//     owns 16 q rows. Q and dO are copied once into swizzled bf16 tiles and,
//     at D 64, their fragments kept in registers after one ldmatrix (at D 112
//     and 128 they are read again per k tile, to keep the dq accumulator, S
//     and dP in registers without spills). The K/V tiles the q tile can see (the
//     forward's causal tile skip) stream through a 2-stage cp.async ring with
//     one barrier per tile. S = Q K^T and dP = dO V^T take K and V by
//     ldmatrix; dS = P (dP - delta) stays in registers and is the A operand of
//     dQ += dS K, which takes K by ldmatrix.trans. The epilogue stages dq *
//     scale in bf16 through the warp's own rows of the Q tile and writes it
//     with 16-byte stores;
//   * dk/dv: one block of 4 warps per (64-row k tile, query head, batch), the
//     first k tiles (the heaviest under causality) launched first; each warp
//     owns 16 key rows. K and V are copied once (zero-filled past kv_len and
//     Sk), their fragments kept in registers at D 64 and read again per q
//     sub-tile at D 112 and 128. The q tiles that can see the k tile, from
//     the first row whose causal window reaches it, stream with their lse and
//     delta through a 2-stage cp.async ring. S^T = K Q^T and dP^T = V dO^T take
//     Q and dO by ldmatrix; P^T = exp(S^T scale - lse) (lse per column) and dS^T =
//     P^T (dP^T - delta) stay in registers as the A operands of dV += P^T dO
//     and dK += dS^T Q, which take dO and Q by ldmatrix.trans. The f32 dk and
//     dv accumulators stay in registers; at D 128 each q tile is taken in two
//     32-row halves, at D 112 in four 16-row quarters, so the S^T and dP^T
//     accumulators fit beside them without spills;
//   * P and dS are split in registers into their bf16 rounding and the bf16
//     rounding of the remainder, two products against the same B fragments,
//     as the forward splits P (rounded once, P failed card_bf16 there;
//     tools/flash_bwd_rounding.py measures both here);
//   * masking (causal diagonal, kv_len and Sq edges) only on the tiles that
//     cross it; masked entries weigh exactly 0, never NaN, so a row that sees
//     no key gets dq exactly 0.
// Shared memory: 6 bf16 tiles of 64 rows (flash_mma.cuh's tile_bytes; dq: Q,
// dO, 2 K and 2 V stages; dk/dv: K, V, 2 Q and 2 dO stages, plus 1 KB of lse
// and delta) = 48 KB at D 64, 96 KB at D 112 and D 128 (a D-112 row padded to
// 16 chunks, flash_mma.cuh's row_chunks; chunks 14-15 are never read or
// written). Built at D 64, 112 (zamba2's shared attention block, 32 heads
// of 112) and 128. At D 112 the loops divide evenly: 7 k-steps of 16, 14
// column tiles of 8 (7 ldmatrix pairs a 16-row step), 7 copies a thread per
// tile; Q / dO (dq) and K / V (dk/dv) are read again per tile, as at D 128,
// and dk/dv takes its q tiles in 16-row quarters; the dk/dv epilogue stores
// its 14 column tiles, 112 columns a row, straight from the accumulators.
// The float32 kernels at D 112: 28 dq / dk / dv elements a thread, 129 KB
// (dq) and 145.5 KB (dk/dv) of dynamic shared memory.
//
// float32 is the exact oracle path, not the main path: the card_f32 gates
// (rel 1e-5) cannot be met through TF32 or bf16 tensor cores, so the float32
// kernels (flash_bwd_dq_kernel / flash_bwd_dkv_kernel<float, D>) do their
// products with scalar f32 FMAs out of shared memory. K and V rows there are
// padded to D+1 and the 64x64 probability tiles to 65 columns, so the score
// loops (a warp on one row, 32 keys) and the product loops (a warp on one
// row, 32 columns) are free of bank conflicts. The C entry points pick the
// path by dtype; a bf16 input never reaches the scalar code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int TILE = 64;   // q rows and k rows per tile
constexpr int NT = 256;    // threads per block

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

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int kv_lim,
                                        int causal, int q_offset) {
  return qpos < Sq && kpos < kv_lim && (!causal || kpos <= qpos + q_offset);
}

// Stage rows [r0, r0 + TILE) of a (rows, D) matrix into shared memory with
// row pitch `pitch`, zero past `rows`.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src, int r0,
                                      int rows) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * pitch + d] = r0 + r < rows ? to_f32(src[static_cast<size_t>(r0 + r) * D + d])
                                       : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs [TILE][D]; Ks, Vs [TILE][D+1]; dSs [TILE][TILE+1]; lse, delta
  return sizeof(float) *
         (2 * TILE * D + 2 * TILE * (D + 1) + TILE * (TILE + 1) + 2 * TILE);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Qs, dOs [TILE][D]; Ks, Vs [TILE][D+1]; Ps, dSs [TILE][TILE+1]; lse, delta
  return sizeof(float) *
         (2 * TILE * D + 2 * TILE * (D + 1) + 2 * TILE * (TILE + 1) + 2 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int KH, int Sq, int Sk, int kv_len,
                    int q_offset, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [TILE][D]
  float* dOs = Qs + TILE * D;              // [TILE][D]
  float* Ks = dOs + TILE * D;              // [TILE][D + 1]
  float* Vs = Ks + TILE * (D + 1);         // [TILE][D + 1]
  float* dSs = Vs + TILE * (D + 1);        // [TILE][TILE + 1]
  float* row_lse = dSs + TILE * (TILE + 1);
  float* row_delta = row_lse + TILE;

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const size_t rows = (static_cast<size_t>(b) * H + h) * Sq;   // first row of (b, h)
  const T* kb = k + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * KH + kh) * Sk * D;

  stage<T, D>(Qs, D, q + rows * D, q0, Sq);
  stage<T, D>(dOs, D, dout + rows * D, q0, Sq);
  if (tid < TILE) {
    const bool in = q0 + tid < Sq;
    row_lse[tid] = in ? lse[rows + q0 + tid] : 0.f;
    row_delta[tid] = in ? delta[rows + q0 + tid] : 0.f;
  }

  // keys this q tile can see: [0, k_end), as in the forward
  const int kv_lim = min(kv_len, Sk);
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(q0 + TILE, Sq) - 1 + q_offset + 1);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  // this thread's slice of the (TILE x D) dq accumulator: element
  // e = tid + j*NT, row e / D, column e % D
  constexpr int PER = TILE * D / NT;
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();                       // previous tile's readers are done
    stage<T, D>(Ks, D + 1, kb, k0, Sk);
    stage<T, D>(Vs, D + 1, vb, k0, Sk);
    __syncthreads();

    // dS[r][c] = p * (dO_r . v_c - delta_r), 0 where masked
    for (int i = tid; i < TILE * TILE; i += NT) {
      const int r = i / TILE, c = i % TILE;
      float ds = 0.f;
      if (visible(q0 + r, k0 + c, Sq, kv_lim, causal, q_offset)) {
        const float* qr = Qs + r * D;
        const float* dor = dOs + r * D;
        const float* kc = Ks + c * (D + 1);
        const float* vc = Vs + c * (D + 1);
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kc[d], s);
          dp = fmaf(dor[d], vc[d], dp);
        }
        ds = expf(s * scale - row_lse[r]) * (dp - row_delta[r]);
      }
      dSs[r * (TILE + 1) + c] = ds;
    }
    __syncthreads();

    // dq += dS @ K
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * NT, r = e / D, d = e % D;
      const float* dsr = dSs + r * (TILE + 1);
      float a = acc[j];
#pragma unroll 8
      for (int c = 0; c < TILE; ++c) a = fmaf(dsr[c], Ks[c * (D + 1) + d], a);
      acc[j] = a;
    }
  }

  T* dqb = dq + rows * D;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * NT, qr = q0 + e / D;
    if (qr < Sq) dqb[static_cast<size_t>(qr) * D + e % D] = from_f32<T>(acc[j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int KH,
                     int Sq, int Sk, int kv_len, int q_offset, int causal,
                     float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [TILE][D]
  float* dOs = Qs + TILE * D;              // [TILE][D]
  float* Ks = dOs + TILE * D;              // [TILE][D + 1]
  float* Vs = Ks + TILE * (D + 1);         // [TILE][D + 1]
  float* Ps = Vs + TILE * (D + 1);         // [TILE][TILE + 1]
  float* dSs = Ps + TILE * (TILE + 1);     // [TILE][TILE + 1]
  float* row_lse = dSs + TILE * (TILE + 1);
  float* row_delta = row_lse + TILE;

  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const size_t rows = (static_cast<size_t>(b) * H + h) * Sq;   // first q row of (b, h)
  const T* qb = q + rows * D;
  const T* dob = dout + rows * D;

  stage<T, D>(Ks, D + 1, k + (static_cast<size_t>(b) * KH + kh) * Sk * D, k0, Sk);
  stage<T, D>(Vs, D + 1, v + (static_cast<size_t>(b) * KH + kh) * Sk * D, k0, Sk);

  // q tiles that can see a key of this tile: none if the tile lies past
  // kv_len; when causal, from the first row i with i + q_offset >= k0
  const int kv_lim = min(kv_len, Sk);
  const int q_begin = causal ? max(0, k0 - q_offset) : 0;
  const int qt_begin = q_begin / TILE;
  const int qt_end = k0 < kv_lim ? (Sq + TILE - 1) / TILE : 0;

  // this thread's slice of the (TILE x D) dk and dv accumulators: element
  // e = tid + j*NT, key row e / D, column e % D
  constexpr int PER = TILE * D / NT;
  float acc_k[PER], acc_v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();                       // previous tile's readers are done
    stage<T, D>(Qs, D, qb, q0, Sq);
    stage<T, D>(dOs, D, dob, q0, Sq);
    if (tid < TILE) {
      const bool in = q0 + tid < Sq;
      row_lse[tid] = in ? lse[rows + q0 + tid] : 0.f;
      row_delta[tid] = in ? delta[rows + q0 + tid] : 0.f;
    }
    __syncthreads();

    // P[r][c] = exp(s - lse_r), dS[r][c] = P (dO_r . v_c - delta_r); 0 where masked
    for (int i = tid; i < TILE * TILE; i += NT) {
      const int r = i / TILE, c = i % TILE;
      float p = 0.f, ds = 0.f;
      if (visible(q0 + r, k0 + c, Sq, kv_lim, causal, q_offset)) {
        const float* qr = Qs + r * D;
        const float* dor = dOs + r * D;
        const float* kc = Ks + c * (D + 1);
        const float* vc = Vs + c * (D + 1);
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kc[d], s);
          dp = fmaf(dor[d], vc[d], dp);
        }
        p = expf(s * scale - row_lse[r]);
        ds = p * (dp - row_delta[r]);
      }
      Ps[r * (TILE + 1) + c] = p;
      dSs[r * (TILE + 1) + c] = ds;
    }
    __syncthreads();

    // dv += P^T @ dO, dk += dS^T @ Q
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * NT, c = e / D, d = e % D;
      float av = acc_v[j], ak = acc_k[j];
#pragma unroll 8
      for (int r = 0; r < TILE; ++r) {
        av = fmaf(Ps[r * (TILE + 1) + c], dOs[r * D + d], av);
        ak = fmaf(dSs[r * (TILE + 1) + c], Qs[r * D + d], ak);
      }
      acc_v[j] = av;
      acc_k[j] = ak;
    }
  }

  const size_t out = (static_cast<size_t>(b) * H + h) * Sk * D;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * NT, kr = k0 + e / D;
    if (kr < Sk) {
      const size_t at = out + static_cast<size_t>(kr) * D + e % D;
      dk[at] = acc_k[j] * scale;
      dv[at] = acc_v[j];
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int H,
                      int KH, int Sq, int Sk, int kv_len, int q_offset, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, KH, Sq, Sk,
      kv_len, q_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dk, float* dv,
                       int B, int H, int KH, int Sq, int Sk, int kv_len, int q_offset,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + TILE - 1) / TILE, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dk, dv, H, KH, Sq, Sk, kv_len, q_offset,
      causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by cp.async
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;   // threads per block of the bf16 kernels (4 warps)
static_assert(MMA_NT == 128 && TILE == 64, "load_tile's defaults; one lse / delta row a thread");

// true where row qpos may not see key kpos (both global indices)
__device__ __forceinline__ bool masked(int qpos, int kpos, int Sq, int kv_lim, int causal,
                                       int q_offset) {
  return qpos >= Sq || kpos >= kv_lim || (causal && kpos > qpos + q_offset);
}

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int KH, int Sq, int Sk,
                        int kv_len, int q_offset, int causal, float scale) {
  constexpr int CH = D / 8;                    // 16-byte chunks per row
  constexpr int KS = D / 16;                   // k-steps of S and dP over D
  constexpr int NS = TILE / 8;                 // 8-key column tiles of S and dP
  constexpr int ND = D / 8;                    // 8-wide column tiles of dQ
  constexpr bool HOLD = D <= 64;               // Q and dO fragments kept in registers
  constexpr uint32_t TILE_BYTES = tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char smem_b[];   // (the f32 kernels' is smem)
  const uint32_t sQ = smem_addr(smem_b);       // [TILE][D], later dq's staging
  const uint32_t sdO = sQ + TILE_BYTES;        // [TILE][D]
  const uint32_t sK = sdO + TILE_BYTES;        // 2 stages
  const uint32_t sV = sK + 2 * TILE_BYTES;     // 2 stages

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rows = (static_cast<size_t>(b) * H + h) * Sq;   // first row of (b, h)
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * KH + kh) * Sk * D;

  // keys this q tile can see: [0, k_end), as in the forward
  const int kv_lim = min(kv_len, Sk);
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(q0 + TILE, Sq) + q_offset);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  load_tile<D>(sQ, q + rows * D, q0, Sq, tid);
  load_tile<D>(sdO, dout + rows * D, q0, Sq, tid);
  if (n_kt > 0) {
    load_tile<D>(sK, kb, 0, kv_lim, tid);
    load_tile<D>(sV, vb, 0, kv_lim, tid);
  }
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16 (accumulator rows 0, 1)
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  float lse_log2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row_a + r * 8;
    lse_log2[r] = qr < Sq ? lse[rows + qr] * kLog2e : 0.f;
    dlt[r] = qr < Sq ? delta[rows + qr] : 0.f;
  }
  uint32_t qf[KS][4], df[KS][4];
  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with tile kt - 1's stage
    if (HOLD && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldsm_a<D>(sQ, warp * 16, ks, lane, qf[ks]);
        ldsm_a<D>(sdO, warp * 16, ks, lane, df[ks]);
      }
    }
    if (kt + 1 < n_kt) {
      const uint32_t nxt = ((kt + 1) & 1) * TILE_BYTES;
      load_tile<D>(sK + nxt, kb, (kt + 1) * TILE, kv_lim, tid);
      load_tile<D>(sV + nxt, vb, (kt + 1) * TILE, kv_lim, tid);
      cp_async_commit();
    }
    const uint32_t sKt = sK + (kt & 1) * TILE_BYTES;
    const uint32_t sVt = sV + (kt & 1) * TILE_BYTES;
    const int k0 = kt * TILE;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ad[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i] = qf[ks][i], ad[i] = df[ks][i];
      } else {
        ldsm_a<D>(sQ, warp * 16, ks, lane, aq);
        ldsm_a<D>(sdO, warp * 16, ks, lane, ad);
      }
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t b0, b1, b2, b3;
        ldsm_bt<D>(sKt, n2 * 16, ks, lane, b0, b1, b2, b3);
        mma_bf16(s[2 * n2], aq, b0, b1);
        mma_bf16(s[2 * n2 + 1], aq, b2, b3);
        ldsm_bt<D>(sVt, n2 * 16, ks, lane, b0, b1, b2, b3);
        mma_bf16(dp[2 * n2], ad, b0, b1);
        mma_bf16(dp[2 * n2 + 1], ad, b2, b3);
      }
    }

    // dS = P (dP - delta) with P = exp(S scale - lse), into s; masked only on
    // a tile that crosses the kv_len edge or the causal diagonal
    const bool edge = k0 + TILE > kv_lim || (causal && k0 + TILE - 1 > q0 + q_offset);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = exp2f(fmaf(s[n][e], scale_log2, -lse_log2[r])) * (dp[n][e] - dlt[r]);
        if (edge && masked(row_a + r * 8, k0 + n * 8 + (lane & 3) * 2 + (e & 1), Sq, kv_lim,
                           causal, q_offset))
          ds = 0.f;
        s[n][e] = ds;
      }
    }

    // dQ += dS K, 16 keys per step: dS split into its bf16 part and the bf16
    // remainder, both A operands against the same K fragments (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t ds_hi[4], ds_lo[4];
      split_a(s[2 * kk], s[2 * kk + 1], ds_hi, ds_lo);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t b0, b1, b2, b3;
        ldsm_b<D>(sKt, kk * 16, d2, lane, b0, b1, b2, b3);
        mma_bf16(dq_acc[2 * d2], ds_hi, b0, b1);
        mma_bf16(dq_acc[2 * d2], ds_lo, b0, b1);
        mma_bf16(dq_acc[2 * d2 + 1], ds_hi, b2, b3);
        mma_bf16(dq_acc[2 * d2 + 1], ds_lo, b2, b3);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // no copy into the Q tile is still in flight, no warp reads it

  // epilogue: dq = scale * dS K as bf16 through the warp's own 16 rows of the
  // Q tile, written with 16-byte stores
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] *= scale;
  unsigned char* stage = smem_b;
  const int wr = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const uint32_t col = (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(stage + swz<D>(wr, j) + col) =
        pack_bf16(dq_acc[j][0], dq_acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(wr + 8, j) + col) =
        pack_bf16(dq_acc[j][2], dq_acc[j][3]);
  }
  __syncwarp();
  __nv_bfloat16* dqb = dq + rows * D;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH, c = i % CH, qr = q0 + r;
    if (qr < Sq)
      *reinterpret_cast<uint4*>(dqb + static_cast<size_t>(qr) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(r, c));
  }
}

// QW: q rows per sub-tile of a q tile (64 at D 64; 32 at D 128, where the
// 2 x 64 f32 registers of the dk and dv accumulators leave room for S^T and
// dP^T of 32 rows only; 16 at D 112, see launch_dkv_mma)
template <int D, int QW>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int KH,
                         int Sq, int Sk, int kv_len, int q_offset, int causal,
                         float scale) {
  constexpr int KS = D / 16;                   // k-steps of S^T and dP^T over D
  constexpr int NS = QW / 8;                   // 8-row column tiles of S^T per sub-tile
  constexpr int ND = D / 8;                    // 8-wide column tiles of dK and dV
  constexpr bool HOLD = D <= 64;               // K and V fragments kept in registers
  constexpr uint32_t TILE_BYTES = tile_bytes<D>();
  static_assert(TILE % QW == 0 && QW % 16 == 0, "q sub-tiles of whole k-steps");
  extern __shared__ __align__(128) unsigned char smem_b[];   // (the f32 kernels' is smem)
  const uint32_t sK = smem_addr(smem_b);       // [TILE][D]
  const uint32_t sV = sK + TILE_BYTES;         // [TILE][D]
  const uint32_t sQ = sV + TILE_BYTES;         // 2 stages
  const uint32_t sdO = sQ + 2 * TILE_BYTES;    // 2 stages
  const uint32_t sLse = sdO + 2 * TILE_BYTES;  // 2 stages of TILE f32
  const uint32_t sDelta = sLse + 2 * TILE * 4; // 2 stages of TILE f32
  const float* lse_s = reinterpret_cast<const float*>(smem_b + 6 * TILE_BYTES);
  const float* delta_s = lse_s + 2 * TILE;

  const int k0 = blockIdx.x * TILE;            // heaviest causal tiles (the first) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rows = (static_cast<size_t>(b) * H + h) * Sq;   // first q row of (b, h)
  const __nv_bfloat16* qb = q + rows * D;
  const __nv_bfloat16* dob = dout + rows * D;

  // q tiles that can see a key of this tile: none if the tile lies past
  // kv_len; when causal, from the first row i with i + q_offset >= k0
  const int kv_lim = min(kv_len, Sk);
  const int q_first = causal ? max(0, k0 - q_offset) : 0;
  const int qt_first = q_first / TILE;
  const int qt_end = k0 < kv_lim ? (Sq + TILE - 1) / TILE : 0;

  // a q tile with its lse and delta (zero past Sq) into ring stage `slot`
  auto load_q_tile = [&](int qt, int slot) {
    load_tile<D>(sQ + slot * TILE_BYTES, qb, qt * TILE, Sq, tid);
    load_tile<D>(sdO + slot * TILE_BYTES, dob, qt * TILE, Sq, tid);
    const int i = tid & (TILE - 1), r = qt * TILE + i;
    const bool ok = r < Sq;
    const float* src = tid < TILE ? lse : delta;
    cp_async4((tid < TILE ? sLse : sDelta) + (slot * TILE + i) * 4, ok ? src + rows + r : src,
              ok);
  };
  load_tile<D>(sK, k + (static_cast<size_t>(b) * KH + kh) * Sk * D, k0, kv_lim, tid);
  load_tile<D>(sV, v + (static_cast<size_t>(b) * KH + kh) * Sk * D, k0, kv_lim, tid);
  if (qt_first < qt_end) load_q_tile(qt_first, 0);
  cp_async_commit();

  // this thread's key rows: g and g + 8 of the warp's 16 (accumulator rows 0, 1)
  const int key_a = k0 + warp * 16 + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  uint32_t kf[KS][4], vf[KS][4];
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qt = qt_first; qt < qt_end; ++qt) {
    const int slot = (qt - qt_first) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile qt landed; every warp is done with tile qt - 1's stage
    if (HOLD && qt == qt_first) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldsm_a<D>(sK, warp * 16, ks, lane, kf[ks]);
        ldsm_a<D>(sV, warp * 16, ks, lane, vf[ks]);
      }
    }
    if (qt + 1 < qt_end) {
      load_q_tile(qt + 1, slot ^ 1);
      cp_async_commit();
    }
    const uint32_t sQt = sQ + slot * TILE_BYTES;
    const uint32_t sdOt = sdO + slot * TILE_BYTES;
    const float* lse_t = lse_s + slot * TILE;
    const float* delta_t = delta_s + slot * TILE;
    const int q0 = qt * TILE;
    const bool edge = k0 + TILE > kv_lim || q0 + TILE > Sq ||
                      (causal && k0 + TILE - 1 > q0 + q_offset);

    // not unrolled: at D 128 the two 32-row halves unrolled together spill
    // registers, one at a time they fit (chip_smoke.py phase 1 prints ptxas's
    // registers and spills per instantiation)
#pragma unroll 1
    for (int sub = 0; sub < TILE / QW; ++sub) {
      const int c0 = sub * QW;                 // first row of the sub-tile in the q tile

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x QW q rows per warp
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ak[i] = kf[ks][i], av[i] = vf[ks][i];
        } else {
          ldsm_a<D>(sK, warp * 16, ks, lane, ak);
          ldsm_a<D>(sV, warp * 16, ks, lane, av);
        }
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          uint32_t b0, b1, b2, b3;
          ldsm_bt<D>(sQt, c0 + n2 * 16, ks, lane, b0, b1, b2, b3);
          mma_bf16(st[2 * n2], ak, b0, b1);
          mma_bf16(st[2 * n2 + 1], ak, b2, b3);
          ldsm_bt<D>(sdOt, c0 + n2 * 16, ks, lane, b0, b1, b2, b3);
          mma_bf16(dpt[2 * n2], av, b0, b1);
          mma_bf16(dpt[2 * n2 + 1], av, b2, b3);
        }
      }

      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta), lse and
      // delta per column (q row); masked only on an edge tile
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = c0 + n * 8 + (lane & 3) * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          float p = exp2f(st[n][e] * scale_log2 - l * kLog2e);
          if (edge && masked(q0 + c + (e & 1), key_a + (e >> 1) * 8, Sq, kv_lim, causal,
                             q_offset))
            p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl);
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 q rows per step: P^T and dS^T split
      // into bf16 part and remainder against the same dO / Q fragments
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
        split_a(st[2 * kk], st[2 * kk + 1], p_hi, p_lo);
        split_a(dpt[2 * kk], dpt[2 * kk + 1], ds_hi, ds_lo);
#pragma unroll
        for (int d2 = 0; d2 < ND / 2; ++d2) {
          uint32_t b0, b1, b2, b3;
          ldsm_b<D>(sdOt, c0 + kk * 16, d2, lane, b0, b1, b2, b3);
          mma_bf16(dv_acc[2 * d2], p_hi, b0, b1);
          mma_bf16(dv_acc[2 * d2], p_lo, b0, b1);
          mma_bf16(dv_acc[2 * d2 + 1], p_hi, b2, b3);
          mma_bf16(dv_acc[2 * d2 + 1], p_lo, b2, b3);
          ldsm_b<D>(sQt, c0 + kk * 16, d2, lane, b0, b1, b2, b3);
          mma_bf16(dk_acc[2 * d2], ds_hi, b0, b1);
          mma_bf16(dk_acc[2 * d2], ds_lo, b0, b1);
          mma_bf16(dk_acc[2 * d2 + 1], ds_hi, b2, b3);
          mma_bf16(dk_acc[2 * d2 + 1], ds_lo, b2, b3);
        }
      }
    }
  }
  cp_async_wait_all();   // nothing in flight when the block exits

  // epilogue: f32 dk = scale * dS^T Q and dv, 8 bytes a thread, 4 threads a
  // row's 32-byte sector; key rows past Sk are not written, rows past kv_len
  // get 0
  const float dk_scale = scale;
  const size_t out = (static_cast<size_t>(b) * H + h) * Sk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key_a + r * 8;
    if (kr >= Sk) continue;
    float* dkr = dk + out + static_cast<size_t>(kr) * D + (lane & 3) * 2;
    float* dvr = dv + out + static_cast<size_t>(kr) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<float2*>(dkr + j * 8) =
          make_float2(dk_acc[j][2 * r] * dk_scale, dk_acc[j][2 * r + 1] * dk_scale);
      *reinterpret_cast<float2*>(dvr + j * 8) = make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int B, int H,
                          int KH, int Sq, int Sk, int kv_len, int q_offset, int causal,
                          float scale, cudaStream_t stream) {
  constexpr int smem = 6 * tile_bytes<D>();   // Q + dO + 2 K stages + 2 V stages
  static std::atomic<uint32_t> done{0};
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  flash_bwd_dq_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dq), H, KH, Sq, Sk, kv_len, q_offset, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, float* dk, float* dv,
                           int B, int H, int KH, int Sq, int Sk, int kv_len, int q_offset,
                           int causal, float scale, cudaStream_t stream) {
  // at D 112 ptxas spilled 80 bytes at QW 32 (255 registers; D 128 fits
  // in 252 there): half-height sub-tiles leave 16 registers of S^T and dP^T
  constexpr int QW = D <= 64 ? 64 : D == 112 ? 16 : 32;
  // K + V + 2 Q stages + 2 dO stages + 2 stages of lse and delta
  constexpr int smem = 6 * tile_bytes<D>() + 4 * TILE * 4;
  static std::atomic<uint32_t> done{0};
  cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D, QW>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + TILE - 1) / TILE, H, B);
  flash_bwd_dkv_mma_kernel<D, QW><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, dk, dv, H, KH, Sq, Sk, kv_len, q_offset, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype (of q, k, v, do and dq): 0 =
// float32 (scalar path), 1 = bfloat16 (tensor cores; q, k, v, do and dq
// 16-byte aligned); lse, delta, dk and dv are float32. Each returns a
// cudaError_t (0 on success); the launches do not synchronise.
extern "C" int tsl_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dq, int B, int H,
                                          int KH, int Sq, int Sk, int D, int kv_len,
                                          int q_offset, int causal, float scale,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
#define TSL_DQ(T, DD)                                                                 \
  return launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Sk, kv_len,    \
                          q_offset, causal, scale, s)
  if (dtype == 0 && D == 64) TSL_DQ(float, 64);
  if (dtype == 0 && D == 112) TSL_DQ(float, 112);
  if (dtype == 0 && D == 128) TSL_DQ(float, 128);
#undef TSL_DQ
  if (dtype != 1 || !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                      aligned16(dq)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Sk, kv_len,
                             q_offset, causal, scale, s);
  if (D == 112)
    return launch_dq_mma<112>(q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Sk, kv_len,
                              q_offset, causal, scale, s);
  if (D == 128)
    return launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Sk, kv_len,
                              q_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tsl_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse,
                                           const float* delta, float* dk, float* dv,
                                           int B, int H, int KH, int Sq, int Sk, int D,
                                           int kv_len, int q_offset, int causal,
                                           float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
#define TSL_DKV(T, DD)                                                                \
  return launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, B, H, KH, Sq, Sk,       \
                           kv_len, q_offset, causal, scale, s)
  if (dtype == 0 && D == 64) TSL_DKV(float, 64);
  if (dtype == 0 && D == 112) TSL_DKV(float, 112);
  if (dtype == 0 && D == 128) TSL_DKV(float, 128);
#undef TSL_DKV
  if (dtype != 1 || !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KH, Sq, Sk, kv_len,
                              q_offset, causal, scale, s);
  if (D == 112)
    return launch_dkv_mma<112>(q, k, v, dout, lse, delta, dk, dv, B, H, KH, Sq, Sk, kv_len,
                               q_offset, causal, scale, s);
  if (D == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KH, Sq, Sk, kv_len,
                               q_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
