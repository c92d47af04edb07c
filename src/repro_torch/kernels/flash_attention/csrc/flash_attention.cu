// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_4d
// (_fa_call / _flash_kernel), the Pallas TPU online-softmax kernel.
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
// What bounds it on the H100: at the model's prefill shape (D = 64,
// S = 512, causal, bf16) a head does 4*(S*(S+1)/2)*D flops on 4*S*D*2
// bytes, ~128 flop/byte, under the card's ~295 flop/byte ridge — so the
// datasheet floor is the bytes; from S ~ 1.2k on it is the tensor-core
// operations. This first version does its products with scalar f32 FMAs out
// of shared memory, so in practice the FMA pipe and shared-memory bandwidth
// bound it, far above either floor; mma.sync / wgmma tiles fed by TMA are
// later work.
//
// What the design does about it: one block per (64-row q tile, head,
// batch); the q tile is staged in shared memory once and the block walks
// 64-row k/v tiles, each staged once and shared by all 64 query rows (and
// never replicated per query head in device memory: GQA is an index map).
// Tiles past min(kv_len, Sk) or wholly above the causal diagonal are never
// loaded (causal tile skip). Shared-memory rows are padded (D+1, 64+1) so
// the score and softmax loops are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;        // q rows per block, k rows per tile
constexpr int NT = 128;         // threads per block
constexpr float NEG = -1e30f;   // masked score (same sentinel as the refs)

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

template <int D>
constexpr size_t smem_bytes() {
  // Qs[TILE][D] + Ks[TILE][D+1] + Vs[TILE][D] + Ps[TILE][TILE+1] + m,l,corr
  return sizeof(float) *
         (TILE * D + TILE * (D + 1) + TILE * D + TILE * (TILE + 1) + 3 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int Sq, int Sk, int kv_len, int q_offset, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [TILE][D]
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

  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * KH + kh) * Sk * D;
  T* ob = o + (static_cast<size_t>(b) * H + h) * Sq * D;

  for (int i = tid; i < TILE * D; i += NT) {
    const int r = i / D, qr = q0 + r;
    Qs[i] = qr < Sq ? to_f32(qb[static_cast<size_t>(qr) * D + i % D]) : 0.f;
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
        kx = to_f32(kb[static_cast<size_t>(kr) * D + d]);
        vx = to_f32(vb[static_cast<size_t>(kr) * D + d]);
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
      ob[static_cast<size_t>(qr) * D + e % D] = from_f32<T>(l > 0.f ? acc[j] / l : 0.f);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KH, int Sq, int Sk, int kv_len, int q_offset,
                   int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KH, Sq, Sk, kv_len, q_offset, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 on success); the launch does not synchronise.
extern "C" int tsl_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, int B, int H, int KH, int Sq,
                                       int Sk, int D, int kv_len, int q_offset,
                                       int causal, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, q_offset, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, q_offset, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, q_offset, causal,
                                     scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, q_offset, causal,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
