// Flash-attention forward with the q/k RMS-norm fused in (kernel K1).
//
// Replaces the TPU kernels `_flash_fwd_single_kernel_qkn` and
// `_flash_fwd_kernel_qkn` (flow_factory_tpu/ops/attention.py:368,398; launcher
// `_flash_forward_qkn`, :451). Same contract: raw q/k/v (B, H, S, D), fp32
// per-position scale maps gq (Sq, D) and gk (Sk, D); q rows are normalised in
// fp32 with gq * (scale * log2 e) folded in and rounded ONCE to the input type,
// k rows with gk; base-2 online softmax over key tiles with the ragged key tail
// masked; O in the input type and the natural-log lse in fp32.
//
// What bounds it on an H100: at the SD3.5-M shapes (B=16, H=24, S=1357 or
// 1024, D=64) the work is 4*B*H*S^2*D = 1.8e11 / 1.0e11 FLOP against ~1e8 bytes
// of q/k/v/O, so the tensor-core rate (989 TFLOP/s bf16) bounds it, not the
// 3.35 TB/s memory; at D=64 the exponentials (one ex2 a score, 7.1e8 / 4.0e8
// of them at 16 a clock an SM) take nearly as long as the products.
//
// No block talks to another, so there are no atomics and the summation
// order is fixed: rollout and replay give the same bits. Two variants:
// * bf16 (the SD3.5 path), head dim 64 (SD3.5-M and -L), two launches:
//   key_norm_kernel normalises every key row once into a contiguous bf16
//   buffer, then flash_fwd_wgmma.cuh's kernel with the norm (<64, true>)
//   normalises each q tile in shared memory (scale * log2 e folded into gq)
//   and runs K3's wgmma forward on the normalised keys: both products on
//   wgmma, key tiles of 128 through a TMA ring, two consumer warpgroups
//   taking turns on the tensor cores.
// * fp32, head dim 16 (the JAX tiny presets), 64 or 128, one launch:
//   flash_fwd_f32.cuh's kernel with the norm (<D, true>), register-tiled
//   fp32 FMAs from shared memory, which normalises each q tile and each key
//   tile as it loads them (right and simple). Rows past Sq load as zeros and
//   are never stored; key columns past Sk get -1e30.
#include "flash_fwd_f32.cuh"
#include "flash_fwd_wgmma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K1's key norm, a pre-pass: every (b, h, s) row of k RMS-normalised once
// into a contiguous (B, H, Sk, 64) bf16 buffer that the wgmma kernel reads,
// bf16(x * (rsqrt(mean(x^2) + eps) * g[s])); 8 threads a row, one 16-byte
// chunk each. Normalising each K tile inside the kernel instead made every
// q tile's block renormalise every key (11 times at the SD3.5 joint shape)
// and read gk's fp32 rows, twice K's bytes, again from L2: on the card that
// was slower than this pass's one read and write of k.
struct NormRows {
  const __nv_bfloat16* x;
  int64_t sb, sh, ss;
  const float* g;
  int S;
  int64_t rows;  // B * H * S
  __nv_bfloat16* out;
};

__global__ void __launch_bounds__(256) key_norm_kernel(const NormRows t, int H, float eps) {
  const int64_t row = (int64_t)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int c = threadIdx.x & 7;
  const bool valid = row < t.rows;
  const int64_t r = valid ? row : 0;
  const int s = (int)(r % t.S);
  const int64_t bh = r / t.S;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  uint4 u = *reinterpret_cast<const uint4*>(t.x + b * t.sb + h * t.sh + s * t.ss + c * 8);
  __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
  float x[8], sq = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(hv[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
    sq += f.x * f.x;
    sq += f.y * f.y;
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);  // the row's 8 lanes
  sq += __shfl_xor_sync(0xffffffffu, sq, 2);
  sq += __shfl_xor_sync(0xffffffffu, sq, 4);
  const float rs = rsqrtf(sq / 64.f + eps);
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(t.g + (int64_t)s * 64 + c * 8));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(t.g + (int64_t)s * 64 + c * 8 + 4));
  const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    hv[e] = __floats2bfloat162_rn(x[2 * e] * (rs * gv[2 * e]), x[2 * e + 1] * (rs * gv[2 * e + 1]));
  if (valid) *reinterpret_cast<uint4*>(t.out + row * 64 + c * 8) = u;
}

}  // namespace

extern "C" {

// d: head dim, 64 for bfloat16, 16, 64 or 128 for float32. dtype: 0 =
// float32, 1 = bfloat16. strides: 12
// element strides, in order (b, h, s) of q, k, v and o; the last axis of each
// must be contiguous. For bf16: kn, a contiguous (B, H, Sk, 64) bf16 scratch
// buffer for the normalised keys, and tma, the 3 x 12 TMA geometry values of
// q, kn and v (64 x 128 boxes); both null for float32. Returns the
// cudaError_t of the launches (0 on success).
int qknorm_flash_fwd(const void* q, const void* k, const void* v, const float* gq, const float* gk,
                     void* o, float* lse, int B, int H, int Sq, int Sk, int d,
                     const long long* strides, const long long* tma, void* kn, float qmul, float eps, int dtype,
                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return (int)bound;
  if (dtype == 1) {
    if (d != 64) return (int)cudaErrorInvalidValue;
    FwdParams f;
    f.gq = gq; f.gk = gk;
    f.o = static_cast<__nv_bfloat16*>(o);
    f.lse = lse;
    f.B = B; f.H = H; f.Sq = Sq; f.Sk = Sk;
    f.o_sb = strides[9]; f.o_sh = strides[10]; f.o_ss = strides[11];
    f.qmul = qmul; f.eps = eps;
    if (!fwd_aligned(f) || kn == nullptr) return (int)cudaErrorInvalidValue;
    const NormRows nk = {static_cast<const __nv_bfloat16*>(k), strides[3], strides[4], strides[5], gk, Sk,
                         (int64_t)B * H * Sk, static_cast<__nv_bfloat16*>(kn)};
    key_norm_kernel<<<(unsigned)((nk.rows + 31) / 32), 256, 0, s>>>(nk, H, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_fwd_wgmma<64, true>(f, q, kn, v, tma, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  F32FwdParams p;
  p.q = static_cast<const float*>(q); p.k = static_cast<const float*>(k); p.v = static_cast<const float*>(v);
  p.gq = gq; p.gk = gk; p.o = static_cast<float*>(o); p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  set_f32_strides(p, strides);
  p.qmul = qmul; p.eps = eps;
  return (int)launch_fwd_f32<true>(p, d, s);
}

// Dynamic shared memory of the bf16 launch, in bytes (for logs).
int qknorm_flash_fwd_smem_bytes() { return (int)FwdShape<64, true>::SMEM; }

const char* qknorm_flash_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
