// Row softmax for Hopper (sm_90a), written by hand in CUDA C++: a stable
// softmax over the last axis of a (rows, d) array, one launch per call.
//
// Replaces repro/kernels/softmax/kernel.py:softmax_2d (_softmax_kernel), the
// Pallas TPU kernel that holds a block of whole rows in VMEM and computes
// max, exp, sum and the division in one pass over them.
//
// Contract (the same as ref.softmax): x, out (rows, d) contiguous, d >= 1,
// float32, bfloat16 or float16; statistics in float32, the output rounded
// once to x's dtype. An entry of -inf weighs 0; a row of only -inf gives NaN
// everywhere, as the plain version does.
//
// What bounds it on the H100: bytes. About 5 flops per element against the
// element read once and written once: 2 * rows * d * itemsize at 3.35 TB/s
// ((8, 152064) bf16: 4.9 MB, 1.45 us). At the sizes it runs at, latency,
// not the rate, sets the floor: the launch, one round trip to HBM, and the
// steps a row's CTAs take one after another (two passes over the chunk, two
// cluster barriers, the write); tools/softmax_anatomy.py times each. So a
// design must put enough SMs on a few rows to have the row in flight at
// once, read it from HBM only once, and keep each CTA's steps short.
//
// What the design does about it. The host's plan (kernel.plan, a function of
// the shape, the base alignment and the card, never of the data) picks one of
// three regimes:
//  * narrow rows (d <= 1024): a warp per row, 8 rows a block, the row in
//    registers (K = 4 .. 32 elements a lane, 16-byte loads where the rows
//    allow). x is read once; the warp's max and sum are butterfly shuffles.
//  * wide rows, the chunk fits in shared memory: a thread-block cluster of S
//    CTAs per row (S <= 16; above 8 the cluster is non-portable and must be
//    admitted by cudaOccupancyMaxActiveClusters), CTA `rank` owning the chunk
//    [rank * cs, min((rank + 1) * cs, d)). Chunks tile the row exactly, no
//    empty one, each a whole number of 16-byte vectors from the row start.
//    The CTA copies its chunk into dynamic shared memory with one
//    cp.async.bulk behind an mbarrier (16-byte-aligned rows) or by element
//    loads (any other row) and computes its (m, l) in float32 from shared
//    memory in two passes: the chunk's max m, then the sum l of exp2(s - m)
//    (each pass reduced per thread, over each warp by a butterfly, over the
//    warps in order; the exponentials of a pass do not wait on each other, as
//    an online max and sum's rescaling would). It publishes (m, l) in its own
//    shared memory; after a cluster barrier its first warp reads the S
//    partials through distributed shared memory (lane r from CTA r, all at
//    once) and adds them in rank order: every CTA computes the same M and L,
//    bit for bit, call after call. A second cluster barrier (arrived at once
//    the partials are read, waited on just before the CTA exits) keeps each
//    CTA's shared memory alive until every other CTA has read it. Then each
//    CTA writes exp(x - M) / L from shared memory with 16-byte stores where
//    the rows allow. HBM is read once; no global scratch, no atomics, so a
//    call can be captured in a CUDA graph.
//  * wide rows whose chunk does not fit (a row over 16 x 224 KB): the same
//    cluster, passes and merge, but each CTA reads its chunk from global
//    memory for each pass (the second and the write's from L2).
// The statistics are kept in base 2 (s = x * log2(e), exp2f). A chunk of
// only -inf has (m, l) = (-inf, 0): its sum pass is skipped, so nothing
// computes exp2(-inf - (-inf)); a -inf entry of a live chunk gives exp2(-inf)
// = 0; the merge weighs a chunk l * exp2(m - M), 0 for a chunk of only -inf.
// A row of only -inf has M = -inf and L = NaN.
// No path gives way to another: a refused cluster or launch is returned as a
// cudaError_t and raised by the launcher.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;                 // narrow: threads per block
constexpr int NW = NT / 32;             // narrow: rows (warps) per block
constexpr int CT = 256;                 // wide: threads per CTA
constexpr int CW = CT / 32;             // wide: warps per CTA
constexpr int MAX_CLUSTER = 16;         // CTAs per row at most (non-portable above 8)
constexpr int SMEM_MAX = 224 * 1024;    // dynamic shared memory a chunk may take
                                        // (kernel.SMEM_BUDGET)
constexpr int U = 4;                    // loads in flight per thread per step
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> constexpr int VW = 16 / sizeof(T);    // elements per 16 bytes

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// The VW<T> elements of one 16-byte vector, widened, and back.
template <typename T>
__device__ __forceinline__ void unpack(uint4 u, float (&f)[VW<T>]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < VW<T>; ++i) f[i] = to_f<T>(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[VW<T>]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < VW<T>; ++i) e[i] = from_f<T>(f[i]);
  return u;
}

// The largest v over the block, in every thread: each warp's butterfly, then
// the warps' (scratch: CW floats).
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < CW; ++w) v = fmaxf(v, scratch[w]);
  return v;
}

// The sum of v over the block, in every thread, in one fixed order: each
// warp's butterfly, then the warps' in order (scratch: CW floats).
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < CW; ++w) v += scratch[w];
  return v;
}

// f(index, value) over vectors [0, nv) of p (thread t: t, t + CT, ...), U
// loads issued before any is used.
template <typename F>
__device__ __forceinline__ void each_vec(const uint4* p, long long nv, F f) {
  for (long long j = threadIdx.x; j < nv; j += U * CT) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u * CT < nv) v[u] = p[j + u * CT];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u * CT < nv) f(j + u * CT, v[u]);
  }
}

template <typename T, typename F>
__device__ __forceinline__ void each_elem(const T* p, long long n, F f) {
  for (long long i = threadIdx.x; i < n; i += U * CT) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * CT < n) v[u] = p[i + u * CT];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * CT < n) f(i + u * CT, to_f<T>(v[u]));
  }
}

// --- mbarrier and the bulk copy (the TMA's 1-D form) ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival, expecting `bytes` from the copy that follows.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// The split cluster barrier: arrive once done with the others' shared
// memory, wait just before leaving.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// --- narrow rows: a warp per row, the row in registers ----------------------

// K elements a lane (d <= 32 K); VEC: 16-byte loads and stores (the host
// sets it where d * sizeof(T) and both bases are 16-byte multiples and
// K >= VW<T>): lane l holds vectors l + 32 i, else elements l + 32 k.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(NT) softmax_rows_kernel(const T* __restrict__ x,
                                                          T* __restrict__ out, long long rows,
                                                          int d) {
  const long long row = static_cast<long long>(blockIdx.x) * NW + (threadIdx.x >> 5);
  if (row >= rows) return;              // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  constexpr int V = VEC ? VW<T> : 1;
  float s[K];
#pragma unroll
  for (int i = 0; i < K / V; ++i) {
    const int j = lane + 32 * i;
    if constexpr (VEC) {
      float f[VW<T>];
      if (j < d / V) {
        unpack<T>(reinterpret_cast<const uint4*>(xr)[j], f);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) s[i * V + e] = f[e] * LOG2E;
    } else {
      s[i] = j < d ? to_f<T>(xr[j]) * LOG2E : -INFINITY;
    }
  }
  float m = s[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, s[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;                        // a row of only -inf: m = -inf, l = NaN
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] = exp2f(s[k] - m);
    l += s[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < K / V; ++i) {
    const int j = lane + 32 * i;
    if constexpr (VEC) {
      if (j < d / V) {
        float f[VW<T>];
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = s[i * V + e] * inv;
        reinterpret_cast<uint4*>(orow)[j] = pack<T>(f);
      }
    } else if (j < d) {
      orow[j] = from_f<T>(s[i] * inv);
    }
  }
}

// --- wide rows: a cluster of S CTAs per row ---------------------------------

// Block (x) of a cluster of S along x: row blockIdx.x / S, chunk rank. The
// chunk [c0, c1) is in dynamic shared memory unless STREAM; `vec`: the
// rows are 16-byte aligned (d * sizeof(T) and both bases), so a chunk on
// whole vectors is copied, read and written 16 bytes at a time. Each chunk is
// checked to be on whole vectors here too, so no bound can make a bulk copy
// or a 16-byte access illegal.
template <typename T, bool STREAM>
__global__ void __launch_bounds__(CT) softmax_cluster_kernel(const T* __restrict__ x,
                                                             T* __restrict__ out, long long d,
                                                             long long cs, bool vec) {
  constexpr int V = VW<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_m[CW], warp_l[CW];
  __shared__ float2 part;               // this CTA's (m, l), read by the whole cluster
  __shared__ float2 row_stats;          // the row's (M, 1 / L)
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / S;
  const long long c0 = static_cast<long long>(rank) * cs;
  const long long c1 = c0 + cs < d ? c0 + cs : d;
  const long long n = c1 - c0;
  const bool wide = vec && c0 % V == 0 && n % V == 0;
  const T* src = x + row * d + c0;
  T* dst = out + row * d + c0;
  T* buf = reinterpret_cast<T*>(smem_raw);
  const T* in = STREAM ? src : buf;     // a compile-time choice: loads from buf are
                                        // shared-memory loads

  if (!STREAM) {
    if (wide) {
      const uint32_t b = smem_addr(&bar);
      if (threadIdx.x == 0) {
        mbar_init(b);
        const uint32_t bytes = static_cast<uint32_t>(n * sizeof(T));
        mbar_expect(b, bytes);
        bulk_copy(smem_addr(buf), src, bytes, b);
      }
      __syncthreads();                  // the barrier is initialised before anyone waits
      mbar_wait(b, 0);
    } else {
      each_elem<T>(src, n, [&](long long i, float v) { buf[i] = from_f<T>(v); });
      __syncthreads();
    }
  }

  // this CTA's (m, l): the chunk's max (in base 2), then the sum of exp2(s -
  // m) over the chunk; a chunk of only -inf is (-inf, 0)
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  float m = -INFINITY;
  if (wide) {
    each_vec(in4, n / V, [&](long long, uint4 v) {
      float f[V];
      unpack<T>(v, f);
#pragma unroll
      for (int e = 0; e < V; ++e) m = fmaxf(m, f[e]);
    });
  } else {
    each_elem<T>(in, n, [&](long long, float v) { m = fmaxf(m, v); });
  }
  m = block_max(m, warp_m) * LOG2E;
  float l = 0.f;
  if (m > -INFINITY) {
    if (wide) {
      each_vec(in4, n / V, [&](long long, uint4 v) {
        float f[V];
        unpack<T>(v, f);
#pragma unroll
        for (int e = 0; e < V; ++e) l += exp2f(f[e] * LOG2E - m);
      });
    } else {
      each_elem<T>(in, n, [&](long long, float v) { l += exp2f(v * LOG2E - m); });
    }
  }
  l = block_sum(l, warp_l);
  if (threadIdx.x == 0) part = make_float2(m, l);
  cluster.sync();                       // every CTA's part is written and visible

  // the row's (M, L), by warp 0: lane r < S reads CTA r's part through the
  // cluster (S loads at once); M is the parts' max, L the sum of
  // l_r * exp2(m_r - M) added in rank order
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float2 p =
        lane < S ? *cluster.map_shared_rank(&part, lane) : make_float2(-INFINITY, 0.f);
    float M = p.x;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float w = p.y * exp2f(p.x - M);
    float L = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) L += __shfl_sync(0xffffffffu, w, r);
    if (lane == 0) row_stats = make_float2(M, 1.f / L);
  }
  __syncthreads();
  cluster_arrive();                     // done with the other CTAs' shared memory

  const float M = row_stats.x, inv = row_stats.y;
  if (wide) {
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    each_vec(in4, n / V, [&](long long j, uint4 v) {
      float f[V];
      unpack<T>(v, f);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = exp2f(f[e] * LOG2E - M) * inv;
      dst4[j] = pack<T>(f);
    });
  } else {
    each_elem<T>(in, n, [&](long long i, float v) {
      dst[i] = from_f<T>(exp2f(v * LOG2E - M) * inv);
    });
  }
  cluster_wait();                       // no CTA leaves while another may read its part
}

// Raise the shared-memory limit and allow clusters above 8, once per card.
template <typename Kernel>
cudaError_t prepare(Kernel kern, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, bool STREAM>
cudaError_t prepared_cluster_kernel() {
  static std::atomic<uint32_t> done{0};
  return prepare(softmax_cluster_kernel<T, STREAM>, done);
}

cudaLaunchConfig_t cluster_config(unsigned blocks, int cluster, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool STREAM>
cudaError_t launch_cluster(const void* x, void* out, long long rows, long long d, int cluster,
                           long long cs, int smem, bool vec, cudaStream_t st) {
  cudaError_t err = prepared_cluster_kernel<T, STREAM>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(static_cast<unsigned>(rows * cluster), cluster, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, softmax_cluster_kernel<T, STREAM>, static_cast<const T*>(x),
                           static_cast<T*>(out), d, cs, vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of cfg's shape the card holds at once (the shared-memory
// instantiation, the one whose chunk takes shared memory).
template <typename T>
cudaError_t max_clusters(const cudaLaunchConfig_t& cfg, int* count) {
  const cudaError_t err = prepared_cluster_kernel<T, false>();
  return err != cudaSuccess
             ? err
             : cudaOccupancyMaxActiveClusters(count, softmax_cluster_kernel<T, false>, &cfg);
}

template <typename T, int K>
cudaError_t launch_rows(const void* x, void* out, long long rows, int d, bool vec,
                        cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((rows + NW - 1) / NW);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if constexpr (K >= VW<T>) {
    if (vec) {
      softmax_rows_kernel<T, K, true><<<blocks, NT, 0, st>>>(xt, ot, rows, d);
      return cudaGetLastError();
    }
  }
  if (vec) return cudaErrorInvalidValue;  // the plan asks for vectors only where K holds one
  softmax_rows_kernel<T, K, false><<<blocks, NT, 0, st>>>(xt, ot, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long rows, long long d, int regime,
                   int cluster, long long chunk, int lane, int smem, bool vec,
                   cudaStream_t st) {
  if (regime == 0) {
    const int di = static_cast<int>(d);
    switch (lane) {
      case 4: return launch_rows<T, 4>(x, out, rows, di, vec, st);
      case 8: return launch_rows<T, 8>(x, out, rows, di, vec, st);
      case 16: return launch_rows<T, 16>(x, out, rows, di, vec, st);
      case 32: return launch_rows<T, 32>(x, out, rows, di, vec, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (vec && chunk % VW<T> != 0) return cudaErrorInvalidValue;
  if (regime == 1 && static_cast<long long>(smem) < chunk * static_cast<long long>(sizeof(T)))
    return cudaErrorInvalidValue;
  return regime == 2 ? launch_cluster<T, true>(x, out, rows, d, cluster, chunk, smem, vec, st)
                     : launch_cluster<T, false>(x, out, rows, d, cluster, chunk, smem, vec, st);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. regime (kernel.plan): 0 = narrow (a warp per row, `lane`
// elements a lane: 4, 8, 16 or 32, d <= 32 * lane), 1 = a cluster of
// `cluster` CTAs per row with the `chunk`-element chunk in `smem` bytes of
// shared memory, 2 = the same cluster streaming its chunk (smem 0). The
// chunks must tile each row with none empty: (cluster - 1) * chunk < d <=
// cluster * chunk. vec: d * itemsize and both bases are 16-byte multiples.
// One launch on `stream`; returns a cudaError_t (0 on success); nothing
// synchronises.
extern "C" int tsl_softmax(const void* x, void* out, long long rows, long long d, int dtype,
                           int regime, int cluster, long long chunk, int lane, int smem,
                           int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = regime == 1 || regime == 2;
  if (rows <= 0 || d <= 0 || regime < 0 || regime > 2 || (regime == 0 && d > 32LL * lane) ||
      (wide && (cluster < 1 || cluster > MAX_CLUSTER || chunk <= 0 ||
                (cluster - 1) * chunk >= d || cluster * chunk < d ||
                rows * cluster > 2147483647LL)) ||
      (regime == 0 && (rows + NW - 1) / NW > 2147483647LL) || smem < 0 || smem > SMEM_MAX ||
      (regime == 2 && smem != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(x, out, rows, d, regime, cluster, chunk, lane, smem, vec != 0, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, out, rows, d, regime, cluster, chunk,
                                                    lane, smem, vec != 0, st));
    case 2:
      return static_cast<int>(
          launch<__half>(x, out, rows, d, regime, cluster, chunk, lane, smem, vec != 0, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of `cluster` CTAs, each with `smem` bytes of dynamic
// shared memory, the card holds at once (cudaOccupancyMaxActiveClusters), into
// *count; 0 means the card refuses such a cluster. Returns a cudaError_t.
extern "C" int tsl_softmax_max_clusters(int dtype, int cluster, int smem, int* count) {
  if (cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(static_cast<unsigned>(cluster), cluster, smem, nullptr, &attr);
  switch (dtype) {
    case 0: return static_cast<int>(max_clusters<float>(cfg, count));
    case 1: return static_cast<int>(max_clusters<__nv_bfloat16>(cfg, count));
    case 2: return static_cast<int>(max_clusters<__half>(cfg, count));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
