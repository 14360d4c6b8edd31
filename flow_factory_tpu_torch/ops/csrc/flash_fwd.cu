// Plain flash-attention forward (kernel K3): non-causal attention over
// (B, H, S, D) bf16 tensors at head dim 64 or 128, or fp32 tensors at head dim
// 16, 64 or 128.
//
// Replaces the TPU kernels `_flash_fwd_kernel` (online softmax over key
// blocks) and `_flash_fwd_single_kernel` (one key block)
// (flow_factory_tpu/ops/attention.py:101,168; launcher `_flash_forward`,
// :268). Same contract: q is pre-scaled by scale*log2(e) in q's dtype (the
// constant rounded to bf16, the product rounded once, as the launcher's
// `q * (scale * _LOG2E)` does); s = q~ k^T accumulates in fp32; keys past Sk
// are masked with -1e30; exp2 online softmax; p is rounded to bf16 before
// the PV product, which accumulates in fp32; O = acc / l in bf16 and the
// natural-log lse = m*ln2 + ln(l) in fp32.
//
// What bounds it on an H100: at the Wan2.1-1.3B shapes (B=16, H=12,
// Sq=Sk=512, D=128) the work is 4*B*H*Sq*Sk*D = 2.6e10 FLOP against 1.0e8
// bytes of q/k/v/O, 256 FLOP a byte, just under the card's ~295: the bytes
// bound it (0.030 ms at 3.35 TB/s; the FLOP alone take 0.026 ms at 989
// TFLOP/s). At the reference's eval geometry (S=3600) it is 1800 FLOP a byte
// and the tensor cores bound it.
//
// Design: bf16 is flash_fwd_wgmma.cuh's kernel without the norm,
// instantiated at D = 64 and 128: wgmma for both products, key tiles through
// a TMA ring, two consumer warpgroups taking turns on the tensor cores. Its
// producer warpgroup makes q~ in shared memory. fp32 (the JAX package's fp32
// runs: every tiny preset at D = 16, the full models at 64 and 128) is
// flash_fwd_f32.cuh's kernel without the norm, register-tiled FMAs on the
// CUDA cores, since no tensor core takes fp32 without rounding it to TF32:
// q~ = q * fp32(scale * log2 e) as its q tile loads, the rest as above with
// every value fp32 (p is not rounded before PV). Its bound at the Wan shape
// is the fp32 CUDA-core rate: 2.6e10 FLOP, 0.385 ms at 66.9 TFLOP/s.
#include "flash_fwd_f32.cuh"
#include "flash_fwd_wgmma.cuh"

extern "C" {

// q (B, H, Sq, d), k/v (B, H, Sk, d) -> O (q's type) and lse (fp32, (B, H, Sq)
// contiguous). dtype: 0 = float32 (d: 16, 64 or 128), 1 = bfloat16 (d: 64 or
// 128). strides: 12 element strides, in order (b, h, s) of q, k, v and o
// (bf16 uses O's; q's, k's and v's are in the geometry). tma: for bf16 the 3
// x 12 TMA geometry values of q, k and v (64 x 128 boxes), null for float32.
// qmul: scale * log2 e rounded to q's type, as a float. Returns the
// cudaError_t of the launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq, int Sk,
              int d, const long long* strides, const long long* tma, float qmul, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    F32FwdParams f;
    f.q = static_cast<const float*>(q); f.k = static_cast<const float*>(k); f.v = static_cast<const float*>(v);
    f.gq = nullptr; f.gk = nullptr;
    f.o = static_cast<float*>(o); f.lse = lse;
    f.B = B; f.H = H; f.Sq = Sq; f.Sk = Sk;
    set_f32_strides(f, strides);
    f.qmul = qmul; f.eps = 0.f;
    const cudaError_t bound = bind_device_of(q);
    if (bound != cudaSuccess) return (int)bound;
    return (int)launch_fwd_f32<false>(f, d, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.gq = nullptr; p.gk = nullptr;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.qmul = qmul; p.eps = 0.f;
  if (!fwd_aligned(p)) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return (int)bound;
  if (d == 64) return (int)launch_fwd_wgmma<64, false>(p, q, k, v, tma, s);
  if (d == 128) return (int)launch_fwd_wgmma<128, false>(p, q, k, v, tma, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 launch at head dim d, in bytes (for logs).
int flash_fwd_smem_bytes(int d) {
  return d == 64 ? (int)FwdShape<64, false>::SMEM : d == 128 ? (int)FwdShape<128, false>::SMEM : 0;
}

const char* flash_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
