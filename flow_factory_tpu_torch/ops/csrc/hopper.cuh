// Hopper (sm_90a) building blocks shared by the wgmma kernels of this
// directory: mbarriers, TMA tile loads from 4-D (D, S, H, B) tensor maps and
// their host-side encoding, wgmma shared-memory descriptors for TMA's
// 128-byte swizzle, the m64n{32,64,128}k16 bf16 products, and the fences
// around them. Included by each source that uses them; every source still
// builds alone into its own library (cuda_build.py hashes the headers a
// source includes into its library's key).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Until the phase of parity `parity` of the barrier has completed. A wait
// that lasts ~2^34 cycles (seconds) traps: a broken ring faults the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One box of a (D, S, H, B) tensor map, head-dim columns from `col` and rows
// from `row` of head (b, h), into a 1024-byte aligned tile; rows past S
// arrive as zeros. The barrier counts the box's bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// wgmma matrix descriptor of bf16 tiles as TMA's 128-byte swizzle lays them
// out (a 64-column row at 128 bytes, its 16-byte chunk c at chunk c ^ (row %
// 8), atoms of 8 rows = 1024 bytes), from `byte_offset` into the tile: the
// swizzle mode 128B, the stride byte offset 1024 (one 8-row group) and the
// leading byte offset `lbo` in 16-byte units. K-major use (rows are the
// outer axis, the head dim contracted) steps 32 bytes a k-step of 16 inside
// a 64-column atom and ignores `lbo`; MN-major use (a transposed B whose rows
// are contracted) steps 16 rows = 2048 bytes a k-step, and `lbo` is the
// distance between two 64-column halves of N (unused for N = 64).
__device__ __forceinline__ uint64_t gdesc(const void* tile, uint32_t byte_offset, uint32_t lbo = 1) {
  const uint64_t addr = (smem_u32(tile) + byte_offset) & 0x3FFFF;
  return (addr >> 4) | (uint64_t(lbo & 0x3FFF) << 16) | (uint64_t(64) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_one() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of an accumulator across an
// issue or a wait: the tensor cores write it asynchronously.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_OUT16(d)                                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_ACC32                                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32_AT(d, o)                                                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),             \
      "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),       \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]),   \
      "+f"(d[o + 18]), "+f"(d[o + 19]), "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]),   \
      "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]),   \
      "+f"(d[o + 30]), "+f"(d[o + 31])
#define WG_OUT32(d) WG_OUT32_AT(d, 0)
#define WG_ACC64                                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "  \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "   \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
  "%62, %63}"

// d (64 x 32, fp32) = [d +] A . B^T: A and B K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_ACC16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = [d +] A . B^T: A and B K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) = [d +] A . B^T: A and B K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32_AT(d, 0), WG_OUT32_AT(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = [d +] A . B: A (64 x 16) bf16 fragments in registers, B
// an MN-major shared tile (the transpose immediate, allowed for 16-bit types).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) = [d +] A . B: as wgmma_rs_t with N = 128.
__device__ __forceinline__ void wgmma_rs_t_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT32_AT(d, 0), WG_OUT32_AT(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// 2^x by the special-function unit alone (ex2.approx.ftz): exp2f's handling
// of subnormal results costs extra instructions a score, and the forwards
// ran measurably faster on the card without it. A p below 2^-126 becomes 0,
// far below what its bf16 rounding before a product and the fp32 sums can
// see; every other input gives exp2f's result (the same MUFU.EX2).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Named barriers 1.. of `count` threads (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that no source links libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Makes the primary context of the device that holds `ptr` current on the
// calling thread, through this library's runtime. A thread can reach a launch
// with no current context: an autograd worker thread whose first CUDA work in
// a backward is the launch (the hybrid backend's K3 recompute); the launch
// then fails with cudaErrorInvalidValue. Each entry point calls it first.
inline cudaError_t bind_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) return err;
  if (attr.type != cudaMemoryTypeDevice) return cudaErrorInvalidValue;
  return cudaSetDevice(attr.device);
}

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                       &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// One operand's tensor map from the 12 values the wrapper's tma_geometry
// computed: global dims innermost first (D, S, H, B), the byte strides of S,
// H and B, the box (cols, rows, 1, 1) and the CUtensorMapDataType. Only bf16
// boxes of `cols` x `rows` are taken (the caller's tile); 128-byte swizzle
// (what gdesc reads), so a box row is at most 64 columns; rows past S are
// zero-filled.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, const long long* g, int dim, int cols, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (g[0] != dim || g[7] != cols || g[8] != rows || g[9] != 1 || g[10] != 1 ||
      g[11] != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || cols * 2 > 128)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
