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
// Design (K1's third design without the norm, plus a two-stage copy ring):
// one block per (q tile, head, batch) with the key loop inside; no block
// talks to another, so there are no atomics and the summation order is
// fixed: two launches give the same bits, which keeps the rollout/replay
// ratio at exactly 1.0. Each warp owns 16 q rows; both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the score
// fragment is re-packed in registers as PV's A operand (no shared-memory
// round trip for p); V's B fragments come from ldmatrix.trans. Key/value
// tiles of 64 rows come in with cp.async (16 bytes a copy, zero-filled past
// Sk) into two shared-memory stages: the copy of tile n+1 is in flight while
// tile n is multiplied (tile 0 while the q tile is scaled and staged). With
// loads and products in turn instead (the first design) the kernel waited
// on its loads: 0.435 ms a launch at the Wan shape against 0.145 ms with the
// ring (chip_smoke.py's profile of one replayed Wan step on an H100). Every
// pointer and (b, h, s) stride must keep 16-byte alignment, else the launch
// is refused; every stride is taken as given, so head-split views are read
// in place. Rows past Sq load as zeros and are never stored; key columns
// past Sk get -1e30 and zero V rows.
//
// Register pressure sets the tile: a warp holds its q rows as A fragments
// (D/16 x 4 registers), O's accumulator (D/2 fp32) and a 16 x 64 score
// fragment (32 fp32). At D=64 that fits 8 warps (128 q rows) with 2 blocks
// an SM (K1's shape). At D=128 it is ~190 registers a thread, so the tile is
// 4 warps (64 q rows) with __launch_bounds__(128, 2): up to 255 registers,
// no spills; Wan's self-attention then has 16*12*8 = 1536 blocks. The q
// tile is staged through the second K/V stage, so a block needs 4 x 64
// rows of shared memory: 69.6 KB at D=128, 36.9 KB at D=64 (dynamic).
// No TMA or wgmma yet: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;  // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int B, H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float qmul;  // bf16(scale * log2(e)), as a float
};

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

// B fragments of a row-major [k][n] bf16 tile (row pitch P): rows k0..k0+15,
// columns n0..n0+7
template <int P>
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                                  int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + (k0 + (lane & 15)) * P + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// The q tile: ROWS x D of a bf16 (S, D) head slice -> row-major shared
// memory (pitch P), one 16-byte vector per thread per step, each value
// multiplied by qmul and rounded once to bf16; rows past S load as zeros.
template <int D, int P, int ROWS, int NT>
__device__ __forceinline__ void load_q_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t row_stride,
                                            int row0, int S, float qmul) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR, c = (idx % VPR) * 8, row = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) u = *reinterpret_cast<const uint4*>(src + row * row_stride + c);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x * qmul, f.y * qmul);
    }
    *reinterpret_cast<uint4*>(dst + r * P + c) = u;
  }
}

template <int D, int WARPS>
struct Shape {
  static constexpr int NT = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;        // q rows per block
  static constexpr int P = D + 8;              // bf16 row pitch: conflict-free fragment loads
  static constexpr int ROWS = 4 * BN;          // two stages of K and V tiles (the q tile fits in one)
  static_assert(BM <= 2 * BN, "the q tile is staged through one K/V stage");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// ROWS x D of a bf16 (S, D) head slice -> row-major shared memory (pitch P)
// with cp.async, 16 bytes a copy; rows past S are zero-filled.
template <int D, int P, int ROWS, int NT>
__device__ __forceinline__ void async_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t row_stride,
                                           int row0, int S) {
  constexpr int VPR = D / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR, c = (idx % VPR) * 8, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * P + c, src + (ok ? row : 0) * row_stride + c, ok);
  }
}

template <int D, int WARPS, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS) flash_fwd_kernel(Params p) {
  using S = Shape<D, WARPS>;
  constexpr int P = S::P, BM = S::BM, NT = S::NT;
  constexpr int KK = D / 16;  // k-steps of the QK^T product
  constexpr int NJ = D / 8;   // n-tiles of O
  // two stages of K/V tiles: stage s holds K at buf + 2s*BN*P and V at
  // buf + (2s+1)*BN*P; the q tile is staged through stage 1 before its first use
  extern __shared__ __align__(16) __nv_bfloat16 buf[];
  __nv_bfloat16* qstage = buf + 2 * BN * P;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // key tile 0 is in flight while the q tile is scaled and staged
  async_rows<D, P, BN, NT>(buf, kb, p.k_ss, 0, p.Sk);
  async_rows<D, P, BN, NT>(buf + BN * P, vb, p.v_ss, 0, p.Sk);
  asm volatile("cp.async.commit_group;\n" ::);
  load_q_rows<D, P, BM, NT>(qstage, qb, p.q_ss, q0, p.Sq, p.qmul);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile
  uint32_t qf[KK][4];                       // A fragments of the warp's 16 x D q rows
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    qf[kk][0] = ld32(&qstage[(wr + g) * P + kk * 16 + 2 * t]);
    qf[kk][1] = ld32(&qstage[(wr + g + 8) * P + kk * 16 + 2 * t]);
    qf[kk][2] = ld32(&qstage[(wr + g) * P + kk * 16 + 8 + 2 * t]);
    qf[kk][3] = ld32(&qstage[(wr + g + 8) * P + kk * 16 + 8 + 2 * t]);
  }
  // this thread's rows are wr+g (fragment slots 0,1) and wr+g+8 (slots 2,3)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = 0, it = 0; n0 < p.Sk; n0 += BN, ++it) {
    __syncthreads();  // the q tile, or the tiles of the stage refilled next, are no longer read
    if (n0 + BN < p.Sk) {  // prefetch the next key tile into the other stage
      __nv_bfloat16* next = buf + 2 * ((it + 1) & 1) * BN * P;
      async_rows<D, P, BN, NT>(next, kb, p.k_ss, n0 + BN, p.Sk);
      async_rows<D, P, BN, NT>(next + BN * P, vb, p.v_ss, n0 + BN, p.Sk);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's copies have landed
    __syncthreads();
    const __nv_bfloat16* Kt = buf + 2 * (it & 1) * BN * P;
    const __nv_bfloat16* Vt = Kt + BN * P;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_16816(s[j], qf[kk], ld32(&Kt[(j * 8 + g) * P + kk * 16 + 2 * t]),
                  ld32(&Kt[(j * 8 + g) * P + kk * 16 + 8 + 2 * t]));

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
    for (int j = 0; j < NJ; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // p rounded to bf16 as the A operand: score tiles 2kk and 2kk+1 hold the
    // 16 key columns of PV's k-step kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans<P>(b0, b1, Vt, kk * 16, j * 8);
        mma_16816(acc[j], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + wr + g + 8 * r;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
    if (t == 0) p.lse[((int64_t)b * p.H + h) * p.Sq + row] = m[r] * kLn2 + logf(denom);
  }
}

template <int D, int WARPS, int MIN_BLOCKS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Shape<D, WARPS>;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)S::ROWS * S::P;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, WARPS, MIN_BLOCKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + S::BM - 1) / S::BM, p.H, p.B);
  flash_fwd_kernel<D, WARPS, MIN_BLOCKS><<<grid, 32 * WARPS, smem, stream>>>(p);
  return cudaGetLastError();
}

// 16-byte vectors: every pointer and stride must keep 8-element alignment.
bool aligned(const Params& p) {
  auto a16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  const int64_t s[] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh, p.k_ss,
                       p.v_sb, p.v_sh, p.v_ss, p.o_sb, p.o_sh, p.o_ss};
  for (int64_t v : s)
    if (v % 8 != 0) return false;
  return a16(p.q) && a16(p.k) && a16(p.v) && a16(p.o);
}

}  // namespace

extern "C" {

// bf16 q (B, H, Sq, d), k/v (B, H, Sk, d) -> O (bf16) and lse (fp32, (B, H, Sq)
// contiguous). d: 64 or 128. strides: 12 element strides, in order (b, h, s)
// of q, k, v and o; the last axis of each must be contiguous and every
// pointer and stride 16-byte aligned. qmul: bf16(scale * log2 e) as a float.
// Returns the cudaError_t of the launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
              int Sk, int d, const long long* strides, float qmul, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.qmul = qmul;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!aligned(p) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (d == 64) return (int)launch<64, 8, 2>(p, s);
  if (d == 128) return (int)launch<128, 4, 2>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
