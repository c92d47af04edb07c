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
//  * few or long rows (the composed app's one row of 2^30): a grid that
//    persists: `splits` blocks per row, as many in all as the card holds at
//    once (4 of 256 threads per SM, which __launch_bounds__ guarantees), each
//    striding over its whole row in steps of splits * 256 * 8 vectors, so
//    every block has the same work and the one wave ends together. Each
//    thread keeps 8 independent 16-byte loads in flight (four f32 / int32,
//    eight bf16) into two accumulators; a row whose start or length does not
//    allow 16-byte loads strides element by element. The block reduces by
//    the warp tree and then across its 8 warps and writes one partial in the
//    accumulator type. The same launch finishes the row: the last block to
//    take the row's atomic ticket (after __threadfence) adds the partials in
//    index order, rounds to the output type and resets the ticket. Every
//    sum is taken in a fixed order, so float32 and bf16 results are the same
//    bit for bit from call to call; int32 wraps modulo 2^32 exactly.

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

constexpr int U = 8;                    // 16-byte loads in flight per thread
constexpr int MIN_BLOCKS = 4;           // resident blocks per SM the grid is sized for

// Long rows: block (row, s) of `splits` per row sums the 16-byte vectors
// s * NT * U + t + u * NT + k * splits * NT * U of its row (thread t, u < U,
// k = 0, 1, ...), then the elements past the last whole vector, into
// partial[row * splits + s], or straight into out[row] when splits == 1;
// the row's last block adds its partials. vec: the row start is 16-byte
// aligned and n a multiple of the vector width, else element by element.
template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
hadd_split(const T* __restrict__ x, long long n, int splits, bool vec,
           typename Acc<T>::type* __restrict__ partial, unsigned* __restrict__ tickets,
           T* __restrict__ out) {
  using A = typename Acc<T>::type;
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load
  __shared__ bool last;
  const long long row = blockIdx.x;
  const int s = blockIdx.y;
  const T* r = x + row * n;
  A s0 = A(0), s1 = A(0);
  long long c = 0;                      // elements the vector loop covered
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    const long long nv = n / V;
    const long long step = static_cast<long long>(splits) * NT * U;
    long long i = static_cast<long long>(s) * NT * U + threadIdx.x;
    for (; i + (U - 1) * NT < nv; i += step) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldg(r4 + i + u * NT);
#pragma unroll
      for (int u = 0; u < U; u += 2) {
        s0 += vec_sum<T>(v[u]);
        s1 += vec_sum<T>(v[u + 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * NT < nv) s0 += vec_sum<T>(__ldg(r4 + i + u * NT));
    c = nv * V;
  }
  for (c += static_cast<long long>(s) * NT + threadIdx.x; c < n;
       c += static_cast<long long>(splits) * NT)
    s0 += widen<T>(r[c]);
  A sum = block_tree(s0 + s1);
  if (splits == 1) {
    if (threadIdx.x == 0) out[row] = narrow<T>(sum);
    return;
  }
  if (threadIdx.x == 0) {
    partial[row * splits + s] = sum;
    __threadfence();                    // the partial is visible before the ticket
    last = atomicAdd(tickets + row, 1u) == static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the row's last block: its partials, each thread a fixed set in index order
  sum = A(0);
  for (int i = threadIdx.x; i < splits; i += NT) sum += __ldcg(partial + row * splits + i);
  sum = block_tree(sum);
  if (threadIdx.x == 0) {
    out[row] = narrow<T>(sum);
    tickets[row] = 0u;                  // ready for the next call
  }
}

template <typename T>
cudaError_t launch(const void* x, long long rows, long long n, int splits, void* partial,
                   void* tickets, void* out, cudaStream_t stream) {
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
      xt, n, splits, vec, static_cast<A*>(partial), static_cast<unsigned*>(tickets), ot);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = int32. splits: 0 = a warp per row (n <= 1024), else blocks per row;
// with splits > 1, partial holds rows * splits accumulators (4 bytes each)
// and tickets rows zeroed 4-byte counters (the kernel leaves them zeroed);
// else both are unused. One launch; returns a cudaError_t (0 on success);
// nothing synchronises.
extern "C" int tsl_hadd(const void* x, long long rows, long long n, int dtype, int splits,
                        void* partial, void* tickets, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || splits < 0 || rows > 2147483647LL ||
      (splits == 0 && n > 1024) || splits > 65535 ||
      (splits > 1 && (partial == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, rows, n, splits, partial, tickets, out, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, rows, n, splits, partial, tickets, out, s));
    case 2: return static_cast<int>(launch<int>(x, rows, n, splits, partial, tickets, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
