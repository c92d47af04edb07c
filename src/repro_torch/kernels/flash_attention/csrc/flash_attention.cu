// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_4d
// (_fa_call / _flash_kernel), the Pallas TPU online-softmax kernel, and,
// with a non-null lse, flash_attention_fwd_4d (the same kernel with
// emit_lse): the training forward that also writes the (B,H,Sq) f32
// logsumexp m + log(l) the backward kernels (flash_attention_bwd.cu)
// recompute the probabilities from, 0 on a row that sees no key (so the
// backward's p = exp(s - lse) is 0 there, never NaN). The lse store is a
// template flag (LSE): serving passes a null lse and runs the instantiation
// without it.
//
// Contract (the same as the Pallas kernel and ref.attention):
//   q (B,H,Sq,D), k/v (B,KH,Sk,D), contiguous; query head h reads KV head
//   h / (H/KH) (GQA). Row r (global index i) sees key j iff
//     j < min(kv_len, Sk)  and, when causal,  j <= i + q_offset
//   with q_offset = kv_len - Sq (ends-aligned causality: prefill
//   continuation against a padded cache). kv_len and q_offset are runtime
//   ints, not compile-time constants. A row that sees no key outputs exactly
//   0. Softmax statistics and the output accumulator are f32.
//
// What bounds it on the H100: at the model's shapes (D = 64, S = 512,
// causal, bf16) a head does 4*(S*(S+1)/2)*D flops on 4*S*D*2 bytes, ~128
// flop/byte, under the card's ~295 flop/byte ridge — so the datasheet floor
// is the bytes; from S ~ 1.2k on it is the tensor-core operations. In
// practice a kernel of this size is held by how fast its products issue
// and by the latency of each tile's loads.
//
// What the design does about it (bf16, the main path):
//   * one block of 4 warps per (64-row q tile, head, batch); each warp owns
//     16 query rows. The q tiles are launched last-first, so under causality
//     the blocks with the most key tiles start first;
//   * Q, K and V stay bf16 in shared memory, copied with 16-byte cp.async
//     (zero-filled past Sq, Sk and kv_len) into rows whose 16-byte chunks
//     are XOR-swizzled by row, so every ldmatrix is free of bank conflicts.
//     K/V tiles go through a ring of 2 stages: tile t+1's copy is in flight
//     while tile t is computed, one __syncthreads per tile;
//   * S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate): Q's fragments are loaded once by ldmatrix and kept in
//     registers, K's by ldmatrix, V's by ldmatrix.trans. P goes into the
//     A operand straight from the registers (the m16n8k16 accumulator
//     layout is the A layout), split into its bf16 rounding and the bf16
//     rounding of the remainder, two products against the same V
//     fragments: P rounded once to bf16 (2^-9), the usual flash design,
//     reads over the card_bf16 limit on a training case, P carried to
//     ~16 bits stays inside it (tools/flash_p_rounding.py measures both);
//   * the online softmax runs in registers: row max and row sum over the
//     four threads that share a row by __shfl_xor_sync, exp2f with
//     scale*log2(e) folded into the scores; masking (causal diagonal,
//     kv_len edge) only on the tiles that cross it, masked entries weigh
//     exactly 0; tiles wholly above the diagonal or past kv_len are never
//     loaded (causal tile skip);
//   * the epilogue stages O/l as bf16 through the warp's own rows of the Q
//     tile and writes it with coalesced 16-byte stores; the lse is stored by
//     the threads that own the row;
//   * the shared-memory limit is raised once per instantiation and card,
//     not on every launch.
// The building blocks (swizzled tiles, cp.async, ldmatrix, mma.sync, the
// split of P) are in flash_mma.cuh, shared with the backward.
// Shared memory: (1 + 2 + 2) tiles of 64 rows, each row D * 2 bytes padded
// to a whole number of 128-byte swizzle groups (flash_mma.cuh's row_chunks):
// 40 KB at D 64, 80 KB at D 112 and D 128.
//
// Head dims: 64, 128 and 112 (zamba2's shared attention block, 32 heads of
// 112). At D 112 a row holds 14 chunks of 16 bytes; the swizzle XORs a chunk
// with the row's low 3 bits, so a row takes 16 chunks in shared memory (the
// last 2 idle) and the XOR never leaves it. Its loops divide evenly: 7
// k-steps of 16, 14 column tiles of 8, 7 pairs of ldmatrix.trans, 7 copies a
// thread per tile, 56 accumulator elements a thread on the float32 path.
// D 112 is built for serving and for training (zamba2's hybrid training):
// the lse instantiation at D 112 is the one the backward
// (flash_attention_bwd.cu, D 64, 112 and 128) recomputes from.
//
// float32 is the exact oracle path, not the main path: the card_f32 gates
// (rel 1e-5) cannot be met through TF32 or bf16 tensor cores, so the
// float32 instantiations keep scalar f32 FMAs out of shared memory (rows
// padded to D+1 / 64+1 against bank conflicts). The C entry point picks the
// path by dtype; a bf16 input never reaches the scalar code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int TILE = 64;        // q rows per block, k rows per tile
constexpr int NT = 128;         // threads per block (4 warps)
constexpr float NEG = -1e30f;   // masked score of the float32 path (the refs' sentinel)

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by cp.async
// ---------------------------------------------------------------------------

template <int D, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int H, int KH, int Sq, int Sk, int kv_len,
                     int q_offset, int causal, float scale) {
  constexpr int CH = D / 8;                    // 16-byte chunks per row
  constexpr int KS = D / 16;                   // k-steps of S = Q K^T
  constexpr int NS = TILE / 8;                 // 8-key column tiles of S
  constexpr int ND = D / 8;                    // 8-wide column tiles of O
  constexpr uint32_t TILE_BYTES = tile_bytes<D>();   // rows padded to row_chunks<D>
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);         // [TILE][D], later O's staging
  const uint32_t sK = sQ + TILE_BYTES;         // 2 stages
  const uint32_t sV = sK + 2 * TILE_BYTES;     // 2 stages

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  __nv_bfloat16* ob = o + (static_cast<size_t>(b) * H + h) * Sq * D;

  // keys this q tile can see: [0, k_end)
  const int kv_lim = min(kv_len, Sk);
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(q0 + TILE, Sq) + q_offset);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  load_tile<D>(sQ, qb, q0, Sq, tid);
  if (n_kt > 0) {
    load_tile<D>(sK, kb, 0, kv_lim, tid);
    load_tile<D>(sV, vb, 0, kv_lim, tid);
  }
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16 (accumulator rows 0, 1)
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};     // running max, log2 units
  float l_run[2] = {0.f, 0.f};                 // this thread's part of the denominator

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with tile kt - 1's stage
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_a<D>(sQ, warp * 16, ks, lane, qf[ks]);
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

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t b0, b1, b2, b3;
        ldsm_bt<D>(sKt, n2 * 16, ks, lane, b0, b1, b2, b3);
        mma_bf16(s[2 * n2], qf[ks], b0, b1);
        mma_bf16(s[2 * n2 + 1], qf[ks], b2, b3);
      }
    }

    // scale into log2 units; mask only on a tile that crosses the kv_len
    // edge or the causal diagonal of the block's first row
    const bool edge = k0 + TILE > kv_lim || (causal && k0 + TILE - 1 > q0 + q_offset);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int qpos = row_a + (e >> 1) * 8;
          if (kpos >= kv_lim || (causal && kpos > qpos + q_offset)) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }

    // online softmax in registers; a row that has seen no key yet keeps
    // m = -inf and subtracts 0, so its masked entries weigh exp2(-inf) = 0
    float m_sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
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
        const float p = exp2f(s[n][e] - m_sub[e >> 1]);
        l_run[e >> 1] += p;
        s[n][e] = p;
      }
    }

    // O += P V, 16 keys per step: P split in registers into its bf16 part
    // and the bf16 remainder, both A operands against the same V fragments
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4], a_lo[4];
      split_a(s[2 * kk], s[2 * kk + 1], a, a_lo);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t b0, b1, b2, b3;
        ldsm_b<D>(sVt, kk * 16, d2, lane, b0, b1, b2, b3);
        mma_bf16(acc[2 * d2], a, b0, b1);
        mma_bf16(acc[2 * d2], a_lo, b0, b1);
        mma_bf16(acc[2 * d2 + 1], a, b2, b3);
        mma_bf16(acc[2 * d2 + 1], a_lo, b2, b3);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // no copy into the Q tile is still in flight (n_kt == 0 too)

  // epilogue: O / l as bf16 through the warp's own 16 rows of the Q tile
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
  unsigned char* stage = smem;
  const int wr = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const uint32_t col = (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(stage + swz<D>(wr, j) + col) =
        pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(wr + 8, j) + col) =
        pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH, c = i % CH, qr = q0 + r;
    if (qr < Sq)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(qr) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(r, c));
  }
  if (LSE && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row_a + r * 8;
      if (qr < Sq)
        lse[(static_cast<size_t>(b) * H + h) * Sq + qr] =
            l[r] > 0.f ? m_run[r] * kLn2 + logf(l[r]) : 0.f;
    }
  }
}

template <int D, bool LSE>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int KH, int Sq, int Sk, int kv_len, int q_offset,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = 5 * tile_bytes<D>();   // Q + 2 K stages + 2 V stages
  static std::atomic<uint32_t> done{0};
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D, LSE>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  flash_fwd_mma_kernel<D, LSE><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, KH, Sq,
      Sk, kv_len, q_offset, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the exact scalar path
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes_f32() {
  // Qs[TILE][D] + Ks[TILE][D+1] + Vs[TILE][D] + Ps[TILE][TILE+1] + m,l,corr
  return sizeof(float) *
         (TILE * D + TILE * (D + 1) + TILE * D + TILE * (TILE + 1) + 3 * TILE);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int KH, int Sq, int Sk,
                     int kv_len, int q_offset, int causal, float scale) {
  extern __shared__ float smem_f[];
  float* Qs = smem_f;                      // [TILE][D]
  float* Ks = Qs + TILE * D;               // [TILE][D + 1]
  float* Vs = Ks + TILE * (D + 1);         // [TILE][D]
  float* Ps = Vs + TILE * D;               // [TILE][TILE + 1] scores, then probs
  float* row_m = Ps + TILE * (TILE + 1);   // running max per row
  float* row_l = row_m + TILE;             // running denominator per row
  float* row_c = row_l + TILE;             // this step's rescale per row

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;

  const float* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const float* kb = k + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  const float* vb = v + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  float* ob = o + (static_cast<size_t>(b) * H + h) * Sq * D;

  for (int i = tid; i < TILE * D; i += NT) {
    const int r = i / D, qr = q0 + r;
    Qs[i] = qr < Sq ? qb[static_cast<size_t>(qr) * D + i % D] : 0.f;
  }
  if (tid < TILE) {
    row_m[tid] = NEG;
    row_l[tid] = 0.f;
  }

  // keys this q tile can see: [0, k_end)
  const int kv_lim = min(kv_len, Sk);
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(q0 + TILE, Sq) - 1 + q_offset + 1);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  // this thread's slice of the (TILE x D) output accumulator:
  // element e = tid + j*NT, row e / D, column e % D
  constexpr int PER = TILE * D / NT;
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    for (int i = tid; i < TILE * D; i += NT) {
      const int r = i / D, d = i % D, kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < Sk) {
        kx = kb[static_cast<size_t>(kr) * D + d];
        vx = vb[static_cast<size_t>(kr) * D + d];
      }
      Ks[r * (D + 1) + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    // scores: S[r][c] = q_r . k_c * scale, or NEG where masked
    for (int i = tid; i < TILE * TILE; i += NT) {
      const int r = i / TILE, c = i % TILE;
      const int kpos = k0 + c;
      float s = NEG;
      if (kpos < kv_lim && (!causal || kpos <= q0 + r + q_offset)) {
        const float* qr = Qs + r * D;
        const float* kc = Ks + c * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
        s = dot * scale;
      }
      Ps[r * (TILE + 1) + c] = s;
    }
    __syncthreads();

    // online softmax, one thread per row; masked entries weigh exactly 0
    if (tid < TILE) {
      float* pr = Ps + tid * (TILE + 1);
      const float m_prev = row_m[tid];
      float m_cur = NEG;
      for (int c = 0; c < TILE; ++c) m_cur = fmaxf(m_cur, pr[c]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int c = 0; c < TILE; ++c) {
        const float p = pr[c] > 0.5f * NEG ? expf(pr[c] - m_new) : 0.f;
        pr[c] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      row_l[tid] = row_l[tid] * corr + sum;
      row_m[tid] = m_new;
      row_c[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P @ V
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * NT, r = e / D, d = e % D;
      const float* pr = Ps + r * (TILE + 1);
      float a = acc[j] * row_c[r];
#pragma unroll 8
      for (int c = 0; c < TILE; ++c) a = fmaf(pr[c], Vs[c * D + d], a);
      acc[j] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * NT, r = e / D, qr = q0 + r;
    if (qr < Sq) {
      const float l = row_l[r];
      ob[static_cast<size_t>(qr) * D + e % D] = l > 0.f ? acc[j] / l : 0.f;
    }
  }
  if (LSE && tid < TILE && q0 + tid < Sq) {
    const float l = row_l[tid];
    lse[(static_cast<size_t>(b) * H + h) * Sq + q0 + tid] =
        l > 0.f ? row_m[tid] + logf(l) : 0.f;
  }
}

template <int D, bool LSE>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int KH, int Sq, int Sk, int kv_len, int q_offset,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(smem_bytes_f32<D>());
  static std::atomic<uint32_t> done{0};
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D, LSE>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  flash_fwd_f32_kernel<D, LSE><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, KH, Sq, Sk, kv_len, q_offset, causal, scale);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, float*, int, int,
                               int, int, int, int, int, int, float, cudaStream_t);

template <int D>
Launch pick(int dtype, bool with_lse) {
  if (dtype == 0) return with_lse ? launch_f32<D, true> : launch_f32<D, false>;
  return with_lse ? launch_mma<D, true> : launch_mma<D, false>;
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32 (scalar path), 1 =
// bfloat16 (tensor cores; q, k, v and o 16-byte aligned); lse is a (B,H,Sq)
// float32 output or null. Returns a cudaError_t (0 on success); the launch
// does not synchronise.
extern "C" int tsl_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, float* lse, int B, int H, int KH, int Sq,
                                       int Sk, int D, int kv_len, int q_offset,
                                       int causal, float scale, int dtype,
                                       void* stream) {
  if (H <= 0 || KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch fn = D == 64    ? pick<64>(dtype, lse != nullptr)
              : D == 112 ? pick<112>(dtype, lse != nullptr)
              : D == 128 ? pick<128>(dtype, lse != nullptr)
                         : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(q, k, v, o, lse, B, H, KH, Sq, Sk, kv_len, q_offset, causal,
                             scale, static_cast<cudaStream_t>(stream)));
}
