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
// D 64, causal, bf16) the two kernels together do about 2.5x the forward's
// operations (five S x S x D products against two) on the same few MB, so
// the datasheet floor is the tensor-core operations. This first version
// does its products with scalar f32 FMAs out of shared memory, like the
// forward: the FMA pipe and shared-memory bandwidth bound it, far above
// that floor; mma.sync / wgmma tiles fed by TMA are later work.
//
// What the design does about it: a block never writes what another block
// reads, so there are no atomics and no second pass. dq: one block per
// (64-row q tile, head, batch) stages its q, dO, lse and delta once and
// walks the 64-row k/v tiles it can see (the forward's causal tile skip),
// accumulating dq in registers. dk/dv: one block per (64-row k tile, query
// head, batch) stages its k and v once and walks the q tiles that can see
// it (from the first row whose causal window reaches the tile), keeping dk
// and dv in registers. K and V rows in shared memory are padded to D+1 and
// the 64x64 probability tiles to 65 columns, so the score loops (a warp on
// one row, 32 keys) and the product loops (a warp on one row, 32 columns)
// are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// C interface, loaded with ctypes. dtype (of q, k, v, do and dq): 0 =
// float32, 1 = bfloat16; lse, delta, dk and dv are float32. Each returns a
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
  if (dtype == 0 && D == 128) TSL_DQ(float, 128);
  if (dtype == 1 && D == 64) TSL_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) TSL_DQ(__nv_bfloat16, 128);
#undef TSL_DQ
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
  if (dtype == 0 && D == 128) TSL_DKV(float, 128);
  if (dtype == 1 && D == 64) TSL_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) TSL_DKV(__nv_bfloat16, 128);
#undef TSL_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
