// Plain flash-attention forward (kernel K3): non-causal attention over
// (B, H, S, D) bf16 tensors, head dim 64 or 128.
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
// Design: flash_fwd_wgmma.cuh's kernel without the norm, instantiated at D =
// 64 and 128: wgmma for both products, key tiles through a TMA ring, two
// consumer warpgroups taking turns on the tensor cores. Its producer
// warpgroup makes q~ in shared memory.
#include "flash_fwd_wgmma.cuh"

extern "C" {

// bf16 q (B, H, Sq, d), k/v (B, H, Sk, d) -> O (bf16) and lse (fp32, (B, H, Sq)
// contiguous). d: 64 or 128. strides: 12 element strides, in order (b, h, s)
// of q, k, v and o (O's are used; q's, k's and v's are in the geometry).
// tma: the 3 x 12 TMA geometry values of q, k and v (64 x 128 boxes). qmul:
// bf16(scale * log2 e) as a float. Returns the cudaError_t of the launch (0
// on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq, int Sk,
              int d, const long long* strides, const long long* tma, float qmul, void* stream) {
  FwdParams p;
  p.gq = nullptr; p.gk = nullptr;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.qmul = qmul; p.eps = 0.f;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!fwd_aligned(p)) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return (int)bound;
  if (d == 64) return (int)launch_fwd_wgmma<64, false>(p, q, k, v, tma, s);
  if (d == 128) return (int)launch_fwd_wgmma<128, false>(p, q, k, v, tma, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the launch at head dim d, in bytes (for logs).
int flash_fwd_smem_bytes(int d) {
  return d == 64 ? (int)FwdShape<64, false>::SMEM : d == 128 ? (int)FwdShape<128, false>::SMEM : 0;
}

const char* flash_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
