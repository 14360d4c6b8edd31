// The fp32 flash-attention forward, shared by K1 (`qknorm_flash_fwd.cu`,
// NORM: the RMS qk-norm fused in) and K3 (`flash_fwd.cu`, plain): one
// template over the head dim D and the NORM flag, instantiated at D = 16 (the
// JAX tiny presets), 64 and 128 by each source, which builds alone.
//
// Contract (the TPU kernels' in fp32): q (B, H, Sq, D), k/v (B, H, Sk, D)
// fp32 views read in place through their (b, h, s) strides, the head dim
// contiguous. K3: q~ = q * qmul in fp32, qmul = fp32(scale * log2 e), one
// rounding (the JAX launcher's `q * (scale * _LOG2E)`, attention.py:279).
// K1 (NORM): q~ = q * (rsqrt(mean(q^2) + eps) * (gq * qmul)) and k^ = k *
// (rsqrt(mean(k^2) + eps) * gk) with the per-position fp32 (S, D) maps.
// s = q~ k^T in fp32; keys past Sk get -1e30; base-2 online softmax; O =
// acc / l in fp32 through O's strides; the natural-log lse = m ln2 + ln l,
// (B, H, Sq) contiguous; rows past Sq load as zeros and are never stored.
//
// What bounds it on an H100: no tensor core takes fp32 without rounding to
// TF32, so every product is an FMA on the CUDA cores, 66.9 TFLOP/s at 1.98
// GHz (132 SMs x 128 lanes x 2). At the Wan2.1-1.3B shape (B16 H12 S512
// D128) the 4 B H Sq Sk D = 2.6e10 FLOP take 0.385 ms against 0.060 ms for
// the 2.0e8 bytes of q/k/v/O: the operations bound it, at every head dim of
// the presets.
//
// Design (right and simple first): one block of 256 threads per (64 q rows,
// head, batch); the key axis is a loop inside the block over 64-key tiles.
// The q tile and each K and V tile sit in shared memory at a padded pitch of
// D + 1 floats (conflict-free column reads); the thread (tx, ty) of a 16 x 16
// grid holds a 4 x 4 register tile of the scores (rows ty*4.., keys tx + 16
// j) and a 4 x D/16 tile of the output (columns tx + 16 j), so a thread
// owns 1, 4 or 8 output columns at D = 16, 64 or 128. p goes through a 64 x
// 65 shared tile from the score layout to the PV layout. Shared memory: 29.7
// KB at D = 16, 66.6 KB at 64, 115.7 KB at 128 (dynamic, opted in above 48
// KB; one block an SM at 128). No block writes what another reads, no
// atomics, the summation order is fixed: rollout, replay and the training
// forward give the same bits, and a batch slice the whole batch's rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32BM = 64;   // q rows a block
constexpr int kF32BN = 64;   // keys a tile
constexpr int kF32NT = 256;  // threads a block (16 x 16 register tiles of 4 rows)
constexpr float kF32NegInf = -1e30f;
constexpr float kF32Ln2 = 0.6931471805599453f;

struct F32FwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* gq;  // K1: (Sq, D) fp32 scale map; else null
  const float* gk;  // K1: (Sk, D)
  float* o;
  float* lse;  // (B, H, Sq) contiguous
  int B, H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float qmul;  // scale * log2(e): K3 multiplies q by it, K1 folds it into gq
  float eps;
};

template <int D>
struct F32FwdShape {
  static_assert(D % 16 == 0 && D <= 128, "the 16 column threads take D / 16 columns each");
  static constexpr int DP = D + 1;  // padded row pitch
  static constexpr int DJ = D / 16;  // O columns a thread
  static constexpr size_t SMEM = sizeof(float) * (size_t)(kF32BM * DP + 2 * kF32BN * DP + kF32BM * (kF32BN + 1));
};

// Loads rows [row0, row0 + 64) of one fp32 (S, D) head slice into dst (row
// pitch D + 1), 4 threads a row. With g != nullptr each row is
// RMS-normalised, x * (rsqrt(mean(x^2) + eps) * (g * gmul)); else x * gmul.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int64_t row_stride, int row0, int S,
                                              const float* g, float gmul, float eps) {
  constexpr int TPR = kF32NT / kF32BM;  // threads per row
  constexpr int EPT = D / TPR;          // elements per thread
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
    for (int e = 0; e < EPT; ++e) out[e] = x[e] * gmul;
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

template <int D, bool NORM>
__global__ void __launch_bounds__(kF32NT) flash_fwd_f32_kernel(const F32FwdParams p) {
  constexpr int BM = kF32BM, BN = kF32BN;
  constexpr int DP = F32FwdShape<D>::DP;
  constexpr int DJ = F32FwdShape<D>::DJ;
  extern __shared__ float smem[];
  float* Qs = smem;          // BM x DP
  float* Ks = Qs + BM * DP;  // BN x DP
  float* Vs = Ks + BN * DP;  // BN x DP
  float* Ps = Vs + BN * DP;  // BM x (BN + 1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;

  load_tile_f32<D>(Qs, qb, p.q_ss, q0, p.Sq, NORM ? p.gq : nullptr, p.qmul, p.eps);

  const int tx = threadIdx.x % 16;  // column group
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kF32NegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < p.Sk; n0 += BN) {
    __syncthreads();  // previous tile's Ks/Vs/Ps are no longer read
    load_tile_f32<D>(Ks, kb, p.k_ss, n0, p.Sk, NORM ? p.gk : nullptr, 1.f, p.eps);
    load_tile_f32<D>(Vs, vb, p.v_ss, n0, p.Sk, nullptr, 1.f, 0.f);
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
      float mc = kF32NegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + tx + 16 * j >= p.Sk) s[i][j] = kF32NegInf;
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

  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[row * p.o_ss + tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) p.lse[((int64_t)b * p.H + h) * p.Sq + row] = m[i] * kF32Ln2 + logf(denom);
  }
}

template <int D, bool NORM>
cudaError_t launch_fwd_f32_at(const F32FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = F32FwdShape<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, NORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kF32BM - 1) / kF32BM, p.H, p.B);
  flash_fwd_f32_kernel<D, NORM><<<grid, kF32NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// The fp32 forward at head dim d (16, 64 or 128); another d is refused.
template <bool NORM>
cudaError_t launch_fwd_f32(const F32FwdParams& p, int d, cudaStream_t stream) {
  if (d == 16) return launch_fwd_f32_at<16, NORM>(p, stream);
  if (d == 64) return launch_fwd_f32_at<64, NORM>(p, stream);
  if (d == 128) return launch_fwd_f32_at<128, NORM>(p, stream);
  return cudaErrorInvalidValue;
}

// The 12 (b, h, s) element strides of q, k, v and o, in that order, into p.
inline void set_f32_strides(F32FwdParams& p, const long long* s) {
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2];
  p.k_sb = s[3]; p.k_sh = s[4]; p.k_ss = s[5];
  p.v_sb = s[6]; p.v_sh = s[7]; p.v_ss = s[8];
  p.o_sb = s[9]; p.o_sh = s[10]; p.o_ss = s[11];
}

}  // namespace
