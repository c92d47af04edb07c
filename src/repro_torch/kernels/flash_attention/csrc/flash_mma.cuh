// Building blocks of the bf16 flash-attention kernels for Hopper (sm_90a),
// shared by the forward (flash_attention.cu), the backward
// (flash_attention_bwd.cu) and the paged kernel: 64-row bf16 tiles in shared
// memory whose 16-byte chunks are XOR-swizzled by row (rows padded to a whole
// number of 8-chunk groups, row_chunks), filled by cp.async, read by ldmatrix into
// the fragments of mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Fragment layouts (g = lane / 4, t = lane % 4): an A operand (16x16, row)
// holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; a B operand
// (16x8, col) holds rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; the
// accumulator (16x8) holds rows g and g + 8, columns 2t, 2t + 1. So the
// accumulators of two neighbouring 8-wide column tiles are, packed to bf16,
// the A operand of a product over those 16 columns, without a shuffle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Raise a kernel's dynamic shared-memory limit once per card: `done` holds
// one bit per device ordinal the attribute was set on.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte chunks one row of a [rows][D] bf16 tile takes: D / 8 rounded up
// to a multiple of 8. swz XORs a chunk index with the row's low 3 bits, which
// keeps it inside its row only if the row has a whole number of 8-chunk
// groups: at D 112 (14 chunks) chunks 8-13 would XOR into 8-15 and land in
// the next row. So a D-112 row takes 16 chunks, the last 2 never read or
// written, and its tile takes D 128's shared memory. The other choice, a
// swizzle that stays inside 14 chunks, would cost every row's address an XOR
// against a non-power-of-two group; 2 idle chunks a row cost nothing but
// shared memory, which the kernels have to spare (80 KB of the 227 KB).
template <int D>
__host__ __device__ constexpr int row_chunks() {
  return (D / 8 + 7) / 8 * 8;
}

// bytes of one ROWS-row swizzled bf16 tile
template <int D, int ROWS = 64>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return static_cast<uint32_t>(ROWS * row_chunks<D>() * 16);
}

// byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile; the
// chunk index is XOR-ed with the row's low 3 bits, so the 8 rows an
// ldmatrix phase reads land on 8 different groups of 4 banks
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((r * row_chunks<D>() + (c ^ (r & 7))) * 16);
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid (src
// is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-fills when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats -> their bf16 roundings (hi) and the bf16 roundings of what
// those leave over (lo): hi + lo carries each value to ~16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// The A operands of a product over 16 columns from the accumulators of its
// two 8-wide column tiles c0 (columns 0-7) and c1 (8-15), each split into
// its bf16 part (a) and the bf16 remainder (a_lo).
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&a)[4], uint32_t (&a_lo)[4]) {
  split_bf16(c0[0], c0[1], a[0], a_lo[0]);
  split_bf16(c0[2], c0[3], a[1], a_lo[1]);
  split_bf16(c1[0], c1[1], a[2], a_lo[2]);
  split_bf16(c1[2], c1[3], a[3], a_lo[3]);
}

// The A operand of rows [r0, r0 + 16), columns [16 ks, 16 ks + 16) of a
// swizzled [rows][D] tile (one ldmatrix.x4: matrix i of lane / 8).
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t tile, int r0, int ks, int lane,
                                       uint32_t (&a)[4]) {
  const int mi = lane >> 3;
  ldsm_x4(tile + swz<D>(r0 + (lane & 7) + ((mi & 1) << 3), ks * 2 + (mi >> 1)), a[0], a[1],
          a[2], a[3]);
}

// B operands of a product whose B is the transpose of a row-major tile:
// rows [n0, n0 + 16) of the tile (the product's columns, two 8-wide tiles),
// columns [16 ks, 16 ks + 16) (its depth). {b0, b1} feed column tile n0,
// {b2, b3} column tile n0 + 8.
template <int D>
__device__ __forceinline__ void ldsm_bt(uint32_t tile, int n0, int ks, int lane,
                                        uint32_t& b0, uint32_t& b1, uint32_t& b2,
                                        uint32_t& b3) {
  const int mi = lane >> 3;
  ldsm_x4(tile + swz<D>(n0 + (lane & 7) + ((mi >> 1) << 3), ks * 2 + (mi & 1)), b0, b1, b2,
          b3);
}

// B operands of a product whose B is a row-major tile itself: rows
// [k0, k0 + 16) (the depth), columns [16 d2, 16 d2 + 16) (two 8-wide column
// tiles of the product), by ldmatrix.trans. {b0, b1} feed column tile 2 d2,
// {b2, b3} column tile 2 d2 + 1.
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t tile, int k0, int d2, int lane, uint32_t& b0,
                                       uint32_t& b1, uint32_t& b2, uint32_t& b3) {
  const int mi = lane >> 3;
  ldsm_x4_trans(tile + swz<D>(k0 + (lane & 7) + ((mi & 1) << 3), d2 * 2 + (mi >> 1)), b0, b1,
                b2, b3);
}

// copy rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into a swizzled
// tile, zero-filling rows >= lim; each of the NTH threads issues
// ROWS*D/8/NTH copies
template <int D, int ROWS = 64, int NTH = 128>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int row0,
                                          int lim, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < ROWS * CH / NTH; ++j) {
    const int i = tid + j * NTH, r = i / CH, c = i % CH;
    const bool ok = row0 + r < lim;
    cp_async16(dst + swz<D>(r, c), ok ? src + static_cast<size_t>(row0 + r) * D + c * 8 : src,
               ok);
  }
}

}  // namespace
