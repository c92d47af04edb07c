// Horizontal add for Hopper (sm_90a), written by hand in CUDA C++: the
// paper's Fig 9/11 adder tree, one sum per row of a (rows, n) array.
//
// Replaces repro/kernels/hadd/kernel.py:hadd_2d (_hadd_kernel), the Pallas
// TPU kernel that halves a padded (block_rows, block_cols) tile lane by lane
// and carries each row's sum over the column blocks of a sequential grid.
//
// Contract (the same as ref.hadd): x (rows, n) contiguous, n >= 1; out
// (rows,) in x's dtype. float32 sums in float32, bfloat16 in float32 and
// rounds back once; int32 sums in int32 and wraps modulo 2^32, as jnp.sum
// does (an integer sum is exact in any order, so the count the composed
// range-count app adds up equals the fused kernel's exactly).
//
// What bounds it on the H100: bytes. One add per element read:
// rows * n * itemsize bytes at 3.35 TB/s (a flat 2^30 int32: 1.28 ms).
//
// What the design does about it: no padding: the runtime n and a tail mask.
// Two regimes:
//  * many short rows (n <= 1024, as the (64, 512) bench shape): one warp per
//    row; each lane strides the row, then five __shfl_down_sync steps halve
//    the 32 partial sums to lane 0 (the Fig 11 tree, across lanes).
//  * few or long rows (the composed app's one row of 2^30): the row is split
//    over enough blocks to fill the card; each block strides its slice with
//    16-byte loads (four f32 / int32, eight bf16) where the row allows,
//    reduces by the warp tree and then across its 8 warps, and writes one
//    partial in the accumulator type; a second launch adds each row's
//    partials the same way and rounds to the output type. One block per row
//    would leave 131 of the 132 SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;             // warps per block

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int> { using type = unsigned; };     // wraps modulo 2^32

template <typename T> __device__ __forceinline__ typename Acc<T>::type widen(T v);
template <> __device__ __forceinline__ float widen<float>(float v) { return v; }
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ unsigned widen<int>(int v) {
  return static_cast<unsigned>(v);
}

template <typename T> __device__ __forceinline__ T narrow(typename Acc<T>::type v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ int narrow<int>(unsigned v) { return static_cast<int>(v); }

// Sum of the 16 bytes of one vector load, element by element.
template <typename T> __device__ __forceinline__ typename Acc<T>::type vec_sum(uint4 v);
template <> __device__ __forceinline__ float vec_sum<float>(uint4 v) {
  return __uint_as_float(v.x) + __uint_as_float(v.y) + __uint_as_float(v.z) +
         __uint_as_float(v.w);
}
template <> __device__ __forceinline__ unsigned vec_sum<int>(uint4 v) {
  return v.x + v.y + v.z + v.w;
}
template <> __device__ __forceinline__ float vec_sum<__nv_bfloat16>(uint4 v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    s += f.x + f.y;
  }
  return s;
}

template <typename A>
__device__ __forceinline__ A warp_tree(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;                             // the sum, on lane 0
}

// The block's sum, on thread 0: each warp's tree, then warp 0's over them.
template <typename A>
__device__ __forceinline__ A block_tree(A v) {
  __shared__ A warp_sums[NW];
  v = warp_tree(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < NW ? warp_sums[threadIdx.x] : A(0);
  if (threadIdx.x < 32) v = warp_tree(v);
  return v;
}

// Short rows: warp w of block b sums row b * NW + w.
template <typename T>
__global__ void __launch_bounds__(NT) hadd_rows(const T* __restrict__ x, long long rows, int n,
                                                T* __restrict__ out) {
  using A = typename Acc<T>::type;
  const long long row = static_cast<long long>(blockIdx.x) * NW + (threadIdx.x >> 5);
  if (row >= rows) return;              // whole warps leave together
  const T* r = x + row * n;
  A s = A(0);
  for (int c = threadIdx.x & 31; c < n; c += 32) s += widen<T>(r[c]);
  s = warp_tree(s);
  if ((threadIdx.x & 31) == 0) out[row] = narrow<T>(s);
}

// Long rows: block (row, s) sums elements [s * chunk, min(n, (s+1) * chunk))
// of its row (chunk is a multiple of the vector width) into partial[row *
// splits + s], or straight into out[row] when splits == 1. vec: the row
// start is 16-byte aligned and n a multiple of the vector width.
template <typename T>
__global__ void __launch_bounds__(NT) hadd_split(const T* __restrict__ x, long long n,
                                                 long long chunk, int splits, bool vec,
                                                 typename Acc<T>::type* __restrict__ partial,
                                                 T* __restrict__ out) {
  using A = typename Acc<T>::type;
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load
  const long long row = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long c1 = c0 + chunk < n ? c0 + chunk : n;
  const T* r = x + row * n;
  A s = A(0);
  long long c = c0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r + c0);
    const long long nv = (c1 - c0) / V;
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += NT) s += vec_sum<T>(__ldg(r4 + i));
    c = c0 + nv * V;
  }
  for (c += threadIdx.x; c < c1; c += NT) s += widen<T>(r[c]);
  s = block_tree(s);
  if (threadIdx.x == 0) {
    if (splits == 1) out[row] = narrow<T>(s);
    else partial[row * splits + blockIdx.y] = s;
  }
}

// Second pass: block row adds the splits partials of its row.
template <typename T>
__global__ void __launch_bounds__(NT) hadd_finish(const typename Acc<T>::type* __restrict__ partial,
                                                  int splits, T* __restrict__ out) {
  using A = typename Acc<T>::type;
  const long long row = blockIdx.x;
  A s = A(0);
  for (int i = threadIdx.x; i < splits; i += NT) s += partial[row * splits + i];
  s = block_tree(s);
  if (threadIdx.x == 0) out[row] = narrow<T>(s);
}

template <typename T>
cudaError_t launch(const void* x, long long rows, long long n, int splits, long long chunk,
                   void* partial, void* out, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (splits == 0) {                    // short rows: a warp per row
    const long long blocks = (rows + NW - 1) / NW;
    hadd_rows<T><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(xt, rows,
                                                                   static_cast<int>(n), ot);
    return cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<unsigned long long>(x) % 16 == 0 && n % V == 0;
  hadd_split<T><<<dim3(static_cast<unsigned>(rows), splits), NT, 0, stream>>>(
      xt, n, chunk, splits, vec, static_cast<A*>(partial), ot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  hadd_finish<T><<<static_cast<unsigned>(rows), NT, 0, stream>>>(static_cast<const A*>(partial),
                                                                  splits, ot);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = int32. splits: 0 = a warp per row (n <= 1024), else blocks per row,
// each summing `chunk` columns (a multiple of 8); partial: rows * splits
// accumulators (4 bytes each) when splits > 1, else unused. Returns a
// cudaError_t (0 on success); nothing synchronises.
extern "C" int tsl_hadd(const void* x, long long rows, long long n, int dtype, int splits,
                        long long chunk, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || splits < 0 || rows > 2147483647LL ||
      (splits == 0 && n > 1024) || (splits > 0 && (chunk <= 0 || chunk % 8 != 0 ||
                                                   (splits - 1) * chunk >= n || splits > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, rows, n, splits, chunk, partial, out, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, rows, n, splits, chunk, partial, out, s));
    case 2: return static_cast<int>(launch<int>(x, rows, n, splits, chunk, partial, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
