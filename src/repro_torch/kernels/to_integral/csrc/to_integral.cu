// to_integral (movemask) for Hopper (sm_90a), written by hand in CUDA C++:
// pack each row of a (rows, n <= 32) mask into one 32-bit word, bit i =
// lane i (paper Fig 3/6).
//
// Replaces repro/kernels/to_integral/kernel.py:to_integral_2d
// (_to_integral_kernel), the Pallas TPU kernel that has no movemask and packs
// by the weighted bit-sum workaround (multiply each lane by 2^i, add up).
//
// Contract (the same as ref.to_integral): m (rows, n) bool / uint8,
// contiguous, a nonzero byte is a set lane (any nonzero byte, not only 1);
// out (rows,) uint32. Bit 31 survives (n = 32, all set: 0xFFFFFFFF). One
// launch per call.
//
// What bounds it on the H100: bytes. rows * n bytes in, rows * 4 bytes out
// at 3.35 TB/s ((2^25, 32): 1.07 GB + 0.13 GB, 0.36 ms). By Little's law
// the card needs some 15-20 KB of loads in flight per SM to reach that rate.
//
// What the design does about it. Two bodies, chosen on the host by shape
// (kernel.py's body(): n and data_ptr() % 16), never as a fallback on failure:
//  * vector body, n = 32 with a 16-byte-aligned base (the app's (2^25, 32)
//    mask; every row then starts 16-byte aligned): each thread owns R = 4
//    whole 32-byte rows and reads each with two 16-byte non-coherent loads,
//    all 2R = 8 loads (128 B) issued before any is used, as hadd keeps 8 in
//    flight. Thread t of warp w takes rows base + w * 32R + 32u + t (u < R),
//    so for each u the warp's 32 words are consecutive and one store
//    instruction writes them (128 B). Bytes become bits in registers, with
//    no ballot: per 4-byte word, __vcmpne4 sets a byte to 0xFF where it is
//    nonzero, the mask 0x08040201 keeps bit j of byte j, and a multiply by
//    0x01010101 sums the four bytes into the top byte (the bits are distinct,
//    so nothing carries): four lane bits per word. A grid that strides over
//    tiles of NT * R rows, sized on the host to the blocks the card holds at
//    once, so every block stays resident and the loop, not the block
//    scheduler, walks the rows (VEC_BLOCKS a SM, which __launch_bounds__
//    keeps the registers low enough for). Rows past the end are neither
//    read nor written, so any row count works.
//  * ballot body, every other n or a base off 16-byte alignment: a warp per
//    row, lane i reading byte i (one coalesced access of the row's n bytes),
//    one __ballot_sync, lane 0 stores the word; each warp strides over rows,
//    four rows per step with their loads issued before their ballots.
//
// Memory ordering of the vector body: the card is little-endian, so the
// 4-byte word k of a row (k = 0..7: .x .y .z .w of the first 16-byte load,
// then of the second) holds row bytes 4k .. 4k+3 with byte 4k in its low 8
// bits. Byte j of word k is lane 4k + j: lanes4() puts it at bit j of a
// nibble and pack_row() shifts word k's nibble by 4k, so the bit of lane i
// comes from byte i of the row.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;             // warps per block
constexpr int ROWS = 4;                 // ballot body: rows per warp step
constexpr int R = 4;                    // vector body: rows per thread per tile
constexpr int TILE = NT * R;            // vector body: rows per block per tile
constexpr int VEC_BLOCKS = 4;           // vector body: resident blocks per SM it is sized for

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

// The lane bits of one 4-byte word: bit j set where byte j is nonzero.
__device__ __forceinline__ unsigned lanes4(unsigned w) {
  const unsigned set = __vcmpne4(w, 0u) & 0x08040201u;   // byte j -> its bit j
  return (set * 0x01010101u) >> 24;                      // the 4 bytes summed in the top one
}

// The word of one 32-byte row from its two 16-byte halves: bit i = byte i.
__device__ __forceinline__ unsigned pack_row(uint4 lo, uint4 hi) {
  return lanes4(lo.x) | lanes4(lo.y) << 4 | lanes4(lo.z) << 8 | lanes4(lo.w) << 12 |
         lanes4(hi.x) << 16 | lanes4(hi.y) << 20 | lanes4(hi.z) << 24 | lanes4(hi.w) << 28;
}

// n = 32, m 16-byte aligned: m4 is the mask as 2 * rows 16-byte vectors.
__global__ void __launch_bounds__(NT, VEC_BLOCKS)
to_integral_vec_kernel(const uint4* __restrict__ m4, long long rows, unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * TILE;
  for (long long t0 = static_cast<long long>(blockIdx.x) * TILE; t0 < rows; t0 += step) {
    const long long r0 = t0 + (threadIdx.x >> 5) * (32 * R) + lane;   // row of u: r0 + 32 u
    uint4 v[2 * R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const long long r = r0 + 32 * u;
      const bool in = r < rows;
      v[2 * u] = in ? __ldg(m4 + 2 * r) : make_uint4(0u, 0u, 0u, 0u);
      v[2 * u + 1] = in ? __ldg(m4 + 2 * r + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {     // one 128-byte store per warp for each s
      if (r0 + 32 * s < rows) out[r0 + 32 * s] = pack_row(v[2 * s], v[2 * s + 1]);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. m: rows * n bytes, 1 <= n <= 32; out:
// rows uint32; blocks: grid size (>= 1); vec: 1 = the vector body (needs
// n == 32 and m 16-byte aligned), 0 = the ballot body. Returns a
// cudaError_t (0 on success); nothing synchronises.
extern "C" int tsl_to_integral(const void* m, long long rows, int n, void* out, int blocks,
                               int vec, void* stream) {
  if (rows <= 0 || n < 1 || n > 32 || blocks <= 0 ||
      (vec && (n != 32 || reinterpret_cast<unsigned long long>(m) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    to_integral_vec_kernel<<<blocks, NT, 0, s>>>(static_cast<const uint4*>(m), rows,
                                                 static_cast<unsigned*>(out));
  else
    to_integral_kernel<<<blocks, NT, 0, s>>>(static_cast<const unsigned char*>(m), rows, n,
                                             static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
