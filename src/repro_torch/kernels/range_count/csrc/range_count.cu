// Range count for Hopper (sm_90a), written by hand in CUDA C++: the paper's
// case-study app (Fig 8), fused.
//
// Replaces repro/kernels/range_count/kernel.py:range_count_2d
// (_range_count_kernel), the Pallas TPU kernel that counts a (rows, 128)
// padded tile view block by block into a sequential scratch accumulator.
//
// Contract (the same as ref.range_count and the reference's cpu_xla
// definition, NOT the Pallas wrapper, which casts the bounds to the data's
// dtype): count the x of a flat, contiguous array of n elements with
// lo <= x <= hi, into one int32 (wrapping past 2^31, as an int32 sum does).
// Each bound compares as torch and jnp promote it: on float32 data, in
// float32 (the bound rounded to float32); on int32 data, an integer bound
// exactly, a float bound in float32 (x converted to float32).
// NaN compares false, so it is never in range.
//
// What bounds it on the H100: bytes. Three compares and a count per
// element against 4 bytes read: n * 4 bytes at 3.35 TB/s (2^30 floats:
// 1.28 ms).
//
// What the design does about it: the data is read in place, with the
// runtime n and a tail mask (no padded copy, which at 4 GiB would double
// the traffic). A grid of a few blocks per SM strides over the array with
// 64-bit indices; each thread loads 16 bytes (four elements) at a time, four
// such loads in flight before their compares. Each warp turns its 32
// predicates per element slot into one word with __ballot_sync and counts
// it with __popc (the movemask + popcount the paper's Fig 8 spells out); the
// warp's counts meet in shared memory, and one atomicAdd per block adds the
// block's count into the int32. An integer count is exact in any order. The
// loop bound is uniform across a warp, so every lane reaches every ballot.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;             // warps per block
constexpr int UNROLL = 4;               // 16-byte loads in flight per thread

// MODE bits: 1 = int32 data, 2 = lo is a float bound, 4 = hi is a float
// bound (float32 data: 6). bits holds one element's 32 bits.
template <int MODE>
__device__ __forceinline__ bool in_range(unsigned bits, float flo, float fhi, long long ilo,
                                         long long ihi) {
  const int xi = static_cast<int>(bits);
  const float xf = (MODE & 1) ? static_cast<float>(xi) : __uint_as_float(bits);
  const bool ge = (MODE & 2) ? xf >= flo : static_cast<long long>(xi) >= ilo;
  const bool le = (MODE & 4) ? xf <= fhi : static_cast<long long>(xi) <= ihi;
  return ge && le;
}

// Count of the warp's lanes whose predicate holds, on every lane.
__device__ __forceinline__ unsigned warp_count(bool p) {
  return __popc(__ballot_sync(0xffffffffu, p));
}

template <int MODE>
__global__ void __launch_bounds__(NT) range_count_kernel(const unsigned* __restrict__ x,
                                                         long long n, int head, float flo,
                                                         float fhi, long long ilo, long long ihi,
                                                         unsigned* __restrict__ count) {
  __shared__ unsigned warp_sums[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned c = 0;                       // this warp's count, kept on lane 0

  // body: after the `head` elements before the first 16-byte boundary,
  // (n - head) / 4 groups of four elements, read as 16-byte words
  const long long n4 = (n - head) >> 2;
  const uint4* __restrict__ x4 = reinterpret_cast<const uint4*>(x + head);
  const long long tile = static_cast<long long>(NT) * UNROLL;   // groups per block step
  for (long long base = static_cast<long long>(blockIdx.x) * tile; base < n4;
       base += static_cast<long long>(gridDim.x) * tile) {
    uint4 v[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = base + static_cast<long long>(u) * NT + threadIdx.x;
      ok[u] = g < n4;
      if (ok[u]) v[u] = __ldg(x4 + g);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned w = warp_count(ok[u] && in_range<MODE>(v[u].x, flo, fhi, ilo, ihi)) +
                         warp_count(ok[u] && in_range<MODE>(v[u].y, flo, fhi, ilo, ihi)) +
                         warp_count(ok[u] && in_range<MODE>(v[u].z, flo, fhi, ilo, ihi)) +
                         warp_count(ok[u] && in_range<MODE>(v[u].w, flo, fhi, ilo, ihi));
      if (lane == 0) c += w;
    }
  }
  // edges: the head (< 4 elements) and the tail after the last group (< 4),
  // by the first warp of block 0
  if (blockIdx.x == 0 && warp == 0) {
    const long long i = lane < head ? lane : head + (n4 << 2) + (lane - head);
    const bool p = i < n && in_range<MODE>(__ldg(x + (i < n ? i : 0)), flo, fhi, ilo, ihi);
    const unsigned w = warp_count(p);
    if (lane == 0) c += w;
  }
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) total += warp_sums[w];
    if (total) atomicAdd(count, total);
  }
}

template <int MODE>
cudaError_t launch(const void* x, long long n, int head, float flo, float fhi, long long ilo,
                   long long ihi, void* count, int blocks, cudaStream_t stream) {
  range_count_kernel<MODE><<<blocks, NT, 0, stream>>>(static_cast<const unsigned*>(x), n, head,
                                                      flo, fhi, ilo, ihi,
                                                      static_cast<unsigned*>(count));
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. x: n float32 (mode 6) or int32 (modes 1,
// 3, 5, 7) elements, 4-byte aligned, mode as MODE above; count: one int32,
// zeroed here on the stream before the launch. blocks: grid size (>= 1).
// Returns a cudaError_t (0 on success); nothing synchronises.
extern "C" int tsl_range_count(const void* x, long long n, int mode, float flo, float fhi,
                               long long ilo, long long ihi, void* count, int blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x);
  if (n <= 0 || blocks <= 0 || addr % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  long long head = static_cast<long long>((16 - addr % 16) % 16 / 4);
  if (head > n) head = n;
  const cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int h = static_cast<int>(head);
  switch (mode) {
    case 6: return static_cast<int>(launch<6>(x, n, h, flo, fhi, ilo, ihi, count, blocks, s));
    case 1: return static_cast<int>(launch<1>(x, n, h, flo, fhi, ilo, ihi, count, blocks, s));
    case 3: return static_cast<int>(launch<3>(x, n, h, flo, fhi, ilo, ihi, count, blocks, s));
    case 5: return static_cast<int>(launch<5>(x, n, h, flo, fhi, ilo, ihi, count, blocks, s));
    case 7: return static_cast<int>(launch<7>(x, n, h, flo, fhi, ilo, ihi, count, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
