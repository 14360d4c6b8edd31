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
// of q/k/v/O, so the bound is the tensor-core rate (989 TFLOP/s bf16), not the
// 3.35 TB/s memory.
//
// Design: one block per (64-row q tile, head, batch); the key axis is a loop
// inside the block; no block talks to another, so there are no atomics and
// the summation order is fixed: rollout and replay give the same bits. The q
// tile is normalised once (its scale map times scale*log2 e) and each 64-row
// key tile on load with its per-position gk, in fp32, each value rounded once
// to the input type exactly where the TPU kernel casts to o_ref.dtype; P is
// rounded to the input type before the PV product as the TPU kernel casts p
// to v's type; both products accumulate in fp32. Rows past Sq load as zeros
// and are never stored; key columns past Sk get the -1e30 of `_kpad_bias` and
// zero V rows. Head dim 64 only (SD3.5-M and -L). Two variants:
// * bf16 (the SD3.5 path): 128-row q tiles, 8 warps each owning 16 q rows;
//   both products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//   accumulate); the score fragment is re-packed in registers as the A
//   operand of PV (no shared-memory round trip for P); V's B fragments come
//   from ldmatrix.trans; tiles move as 16-byte vectors, so every pointer and
//   (b, h, s) stride must keep 16-byte alignment, else the launch is refused.
// * fp32: 64-row q tiles, 256 threads, register-tiled 4x4 fp32 FMAs from
//   shared memory (right and simple, ~20 TFLOP/s).
// No TMA, wgmma or pipelining of the tile loads yet: later work.
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

// ---------------------------------------------------------------------------
// bf16: tensor-core variant (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
constexpr int MBM = 128;    // q rows per block: 8 warps x 16 rows
constexpr int MNT = 256;
constexpr int MP = 64 + 8;  // bf16 row pitch (144 B): conflict-free fragment loads

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a row-major [k][n] bf16 tile: rows k0..k0+15, columns n0..n0+7
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                                  int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + (k0 + (lane & 15)) * MP + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// ROWS x 64 of a bf16 (S, 64) head slice → row-major shared memory (pitch MP),
// 4 threads per row, 16-byte loads and stores; RMS-normalised when g is set.
template <int ROWS>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int64_t row_stride, int row0, int S, const float* g,
                                               float gmul, float eps) {
  const int c0 = (threadIdx.x & 3) * 16;
#pragma unroll
  for (int rr = 0; rr < ROWS; rr += MNT / 4) {
    const int r = rr + (threadIdx.x >> 2), row = row0 + r;
    float x[16];
    if (row < S) {
      const uint4* p = reinterpret_cast<const uint4*>(src + row * row_stride + c0);
      const uint4 u[2] = {p[0], p[1]};
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(u);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = 0.f;
    }
    if (g != nullptr) {
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) ss += x[e] * x[e];
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float rs = rsqrtf(ss / 64.f + eps);
      const float4* gr = reinterpret_cast<const float4*>(g + (int64_t)min(row, S - 1) * 64 + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 gv = gr[e];
        x[4 * e] = x[4 * e] * (rs * (gv.x * gmul));
        x[4 * e + 1] = x[4 * e + 1] * (rs * (gv.y * gmul));
        x[4 * e + 2] = x[4 * e + 2] * (rs * (gv.z * gmul));
        x[4 * e + 3] = x[4 * e + 3] * (rs * (gv.w * gmul));
      }
    }
    uint4 out[2];
    uint32_t* w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
    uint4* d = reinterpret_cast<uint4*>(dst + r * MP + c0);
    d[0] = out[0];
    d[1] = out[1];
  }
}

__global__ void __launch_bounds__(MNT, 2) qknorm_flash_fwd_mma_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 Qs[MBM * MP];
  __shared__ __align__(16) __nv_bfloat16 Ks[64 * MP];
  __shared__ __align__(16) __nv_bfloat16 Vs[64 * MP];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MBM;
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_rows_bf16<MBM>(Qs, qb, p.q_ss, q0, p.Sq, p.gq, p.qmul, p.eps);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile
  uint32_t qf[4][4];                        // A fragments of the warp's 16 x 64 q rows
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = ld32(&Qs[(wr + g) * MP + kk * 16 + 2 * t]);
    qf[kk][1] = ld32(&Qs[(wr + g + 8) * MP + kk * 16 + 2 * t]);
    qf[kk][2] = ld32(&Qs[(wr + g) * MP + kk * 16 + 8 + 2 * t]);
    qf[kk][3] = ld32(&Qs[(wr + g + 8) * MP + kk * 16 + 8 + 2 * t]);
  }
  // this thread's rows are wr+g (fragment slots 0,1) and wr+g+8 (slots 2,3)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = 0; n0 < p.Sk; n0 += 64) {
    __syncthreads();  // the previous tile's Ks/Vs are no longer read
    load_rows_bf16<64>(Ks, kb, p.k_ss, n0, p.Sk, p.gk, 1.f, p.eps);
    load_rows_bf16<64>(Vs, vb, p.v_ss, n0, p.Sk, nullptr, 1.f, 0.f);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_16816(s[j], qf[kk], ld32(&Ks[(j * 8 + g) * MP + kk * 16 + 2 * t]),
                  ld32(&Ks[(j * 8 + g) * MP + kk * 16 + 8 + 2 * t]));

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n0 + j * 8 + 2 * t + e >= p.Sk) s[j][2 * r + e] = kNegInf;
          mc = fmaxf(mc, s[j][2 * r + e]);
        }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[r], mc);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      float rs = 0.f;  // this thread's part of the row sum, reduced at the end
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pij = exp2f(s[j][2 * r + e] - mn);
          s[j][2 * r + e] = pij;
          rs += pij;
        }
      l[r] = alpha[r] * l[r] + rs;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // P rounded to bf16 as the A operand: score tiles 2kk and 2kk+1 hold the
    // 16 key columns of PV's k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Vs, kk * 16, j * 8);
        mma_16816(acc[j], a, b0, b1);
      }
    }
  }

  auto* ob = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + wr + g + 8 * r;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
    if (t == 0) p.lse[((int64_t)b * p.H + h) * p.Sq + row] = m[r] * kLn2 + logf(denom);
  }
}

// The tensor-core variant moves 16-byte vectors: every pointer and stride
// must keep 8-element (16-byte) alignment.
bool mma_aligned(const Params& p) {
  auto a16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  const int64_t s[] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh, p.k_ss,
                       p.v_sb, p.v_sh, p.v_ss, p.o_sb, p.o_sh, p.o_ss};
  for (int64_t v : s)
    if (v % 8 != 0) return false;
  return a16(p.q) && a16(p.k) && a16(p.v) && a16(p.o) && a16(p.gq) && a16(p.gk);
}

cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  dim3 grid((p.Sq + MBM - 1) / MBM, p.H, p.B);
  qknorm_flash_fwd_mma_kernel<<<grid, MNT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d: head dim, must be 64. dtype: 0 = float32, 1 = bfloat16 (16-byte aligned
// pointers and strides). strides: 12 element strides, in order
// (b, h, s) of q, k, v and o; the last axis of each must be contiguous.
// Returns the cudaError_t of the launch (0 on success).
int qknorm_flash_fwd(const void* q, const void* k, const void* v, const float* gq, const float* gk,
                     void* o, float* lse, int B, int H, int Sq, int Sk, int d,
                     const long long* strides, float qmul, float eps, int dtype, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.gq = gq; p.gk = gk; p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.qmul = qmul; p.eps = eps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d != D) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_f32(p, s);
  if (dtype == 1 && mma_aligned(p)) return (int)launch_mma(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* qknorm_flash_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
