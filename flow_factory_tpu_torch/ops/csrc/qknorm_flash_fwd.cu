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
// order is fixed: rollout and replay give the same bits. Head dim 64 only
// (SD3.5-M and -L). Two variants:
// * bf16 (the SD3.5 path), two launches: key_norm_kernel normalises every
//   key row once into a contiguous bf16 buffer, then flash_fwd_wgmma.cuh's
//   kernel with the norm (<64, true>) normalises each q tile in shared
//   memory (scale * log2 e folded into gq) and runs K3's wgmma forward on
//   the normalised keys: both products on wgmma, key tiles of 128 through a
//   TMA ring, two consumer warpgroups taking turns on the tensor cores.
// * fp32: 64-row q tiles, 256 threads, register-tiled 4x4 fp32 FMAs from
//   shared memory (right and simple, ~20 TFLOP/s). Rows past Sq load as zeros
//   and are never stored; key columns past Sk get the -1e30 of `_kpad_bias`.
#include "flash_fwd_wgmma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // q rows per block (fp32 variant)
constexpr int BN = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block (16 x 16 register tiles of 4x4)
constexpr int D = 64;     // head dim
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* gq;
  const float* gk;
  void* o;
  float* lse;
  int B, H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float qmul;  // scale * log2(e), folded into gq
  float eps;
};

// ---------------------------------------------------------------------------
// fp32: register-tiled FMA variant
// ---------------------------------------------------------------------------

// Loads rows [row0, row0 + 64) of one fp32 (S, 64) head slice into dst (row
// pitch D + 1). With g != nullptr each row is RMS-normalised,
// x * (rsqrt(mean(x^2) + eps) * (g * gmul)).
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int64_t row_stride, int row0,
                                              int S, const float* g, float gmul, float eps) {
  constexpr int TPR = NT / 64;  // threads per row
  constexpr int EPT = D / TPR;  // elements per thread
  const int r = threadIdx.x / TPR;
  const int c0 = (threadIdx.x % TPR) * EPT;
  const int row = row0 + r;
  float x[EPT];
  if (row < S) {
    const float* p = src + row * row_stride + c0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) x[e] = p[e];
  } else {
#pragma unroll
    for (int e = 0; e < EPT; ++e) x[e] = 0.f;
  }
  float* out = dst + r * (D + 1) + c0;
  if (g == nullptr) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) out[e] = x[e];
    return;
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) ss += x[e] * x[e];
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rs = rsqrtf(ss / (float)D + eps);
  const float* gr = g + (int64_t)min(row, S - 1) * D + c0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) out[e] = x[e] * (rs * (gr[e] * gmul));
}

__global__ void __launch_bounds__(NT) qknorm_flash_fwd_f32_kernel(Params p) {
  constexpr int DP = D + 1;       // padded row pitch (conflict-free column reads)
  constexpr int DJ = D / 16;      // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // BM x DP
  float* Ks = Qs + BM * DP;       // BN x DP
  float* Vs = Ks + BN * DP;       // BN x DP
  float* Ps = Vs + BN * DP;       // BM x (BN + 1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile_f32(Qs, qb, p.q_ss, q0, p.Sq, p.gq, p.qmul, p.eps);

  const int tx = threadIdx.x % 16;  // column group
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < p.Sk; n0 += BN) {
    __syncthreads();  // previous tile's Ks/Vs/Ps are no longer read
    load_tile_f32(Ks, kb, p.k_ss, n0, p.Sk, p.gk, 1.f, p.eps);
    load_tile_f32(Vs, vb, p.v_ss, n0, p.Sk, nullptr, 1.f, 0.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + tx + 16 * j >= p.Sk) s[i][j] = kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = exp2f(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = exp2f(s[i][j] - mn);
        rs += pij;
        Ps[(ty * 4 + i) * (BN + 1) + tx + 16 * j] = pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int n = 0; n < BN; ++n) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[n * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = reinterpret_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[row * p.o_ss + tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) p.lse[((int64_t)b * p.H + h) * p.Sq + row] = m[i] * kLn2 + logf(denom);
  }
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (size_t)(BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
  cudaError_t err = cudaFuncSetAttribute(qknorm_flash_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  qknorm_flash_fwd_f32_kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

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

// d: head dim, must be 64. dtype: 0 = float32, 1 = bfloat16. strides: 12
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
  if (d != D) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return (int)bound;
  if (dtype == 1) {
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
  Params p;
  p.q = q; p.k = k; p.v = v; p.gq = gq; p.gk = gk; p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.qmul = qmul; p.eps = eps;
  return (int)launch_f32(p, s);
}

// Dynamic shared memory of the bf16 launch, in bytes (for logs).
int qknorm_flash_fwd_smem_bytes() { return (int)FwdShape<64, true>::SMEM; }

const char* qknorm_flash_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
