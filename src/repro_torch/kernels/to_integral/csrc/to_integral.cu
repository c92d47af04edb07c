// to_integral (movemask) for Hopper (sm_90a), written by hand in CUDA C++:
// pack each row of a (rows, n <= 32) mask into one 32-bit word, bit i =
// lane i (paper Fig 3/6).
//
// Replaces repro/kernels/to_integral/kernel.py:to_integral_2d
// (_to_integral_kernel), the Pallas TPU kernel that has no movemask and packs
// by the weighted bit-sum workaround (multiply each lane by 2^i, add up).
// On Hopper the workaround is not needed: __ballot_sync IS a movemask over
// the 32 lanes of a warp, so the h100 definition is native.
//
// Contract (the same as ref.to_integral): m (rows, n) bool / uint8,
// contiguous, a nonzero byte is a set lane; out (rows,) uint32. Bit 31
// survives (n = 32, all set: 0xFFFFFFFF).
//
// What bounds it on the H100: bytes. rows * n bytes in, rows * 4 bytes out
// at 3.35 TB/s ((2^25, 32): 1.07 GB + 0.13 GB, 0.36 ms).
//
// What the design does about it: a warp per row, lane i reading byte i (a
// warp reads the row's n bytes in one coalesced access), one ballot, lane 0
// stores the word. Each warp strides over rows, four rows per step with
// their loads issued before their ballots, so enough loads are in flight to
// keep memory busy without staging anything in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;             // warps per block
constexpr int ROWS = 4;                 // rows per warp step

__global__ void __launch_bounds__(NT) to_integral_kernel(const unsigned char* __restrict__ m,
                                                         long long rows, int n,
                                                         unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * NW + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * NW;
  for (long long r0 = warp * ROWS; r0 < rows; r0 += warps * ROWS) {
    unsigned char b[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const long long r = r0 + u;
      b[u] = (r < rows && lane < n) ? __ldg(m + r * n + lane) : 0;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const unsigned word = __ballot_sync(0xffffffffu, b[u] != 0);
      if (lane == 0 && r0 + u < rows) out[r0 + u] = word;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. m: rows * n bytes, 1 <= n <= 32; out:
// rows uint32; blocks: grid size (>= 1). Returns a cudaError_t (0 on
// success); nothing synchronises.
extern "C" int tsl_to_integral(const void* m, long long rows, int n, void* out, int blocks,
                               void* stream) {
  if (rows <= 0 || n < 1 || n > 32 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  to_integral_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(m), rows, n, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
