// Flash-attention backward: dq (kernel K2a) and dk/dv (kernel K2b).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (flow_factory_tpu/ops/attention.py:601,653; launcher `_flash_backward`, :708).
// Same contract: q, k, v, dO (B, H, S, D) in one input type; the natural-log
// lse of the forward turned base-2 (lse * log2 e) and Delta = rowsum(dO * O),
// both fp32 (B, H, Sq), computed by the caller. In the kernels q is pre-scaled
// by scale * log2 e, the constant rounded to the input type and the product
// rounded once (the TPU launcher's `q * (scale * _LOG2E)` in q's dtype); then
//   p  = exp2(min(s - lse2, 0)),  s = q~ k^T in fp32,
//   ds = p * (dO v^T - Delta), rounded to the input type before its products,
//   dq = scale * ds k,   dk = ln2 * ds^T q~,   dv = p^T dO (p rounded too),
// every product accumulated in fp32 and each output rounded once.
//
// What bounds them on an H100: at the SD3.5-M shapes (B=16, H=24, S=1357 or
// 1024, D=64) K2a does 6*B*H*S^2*D FLOP (2.7e11 / 1.5e11) and K2b
// 8*B*H*S^2*D (3.6e11 / 2.1e11) against ~1e8 bytes, so the bound is the
// tensor-core rate (989 TFLOP/s bf16), not the 3.35 TB/s memory. At the
// Wan2.1-1.3B shape (B=16, H=12, S=512, D=128) K2a does 3.9e10 FLOP against
// ~1.3e8 bytes and K2b 5.2e10 against ~1.5e8: ~300 FLOP a byte, on the line
// where the two bounds meet (0.04-0.05 ms each).
//
// Design (neither copies the TPU block structure, whose sequential grid
// carried sums in VMEM scratch across grid steps):
// * K2a: one block per (q tile, head, batch); the key axis is a loop inside
//   the block, dq accumulates in registers.
// * K2b: one block per (k tile, head, batch); the q axis is a loop inside the
//   block, dk and dv accumulate in registers.
// No block writes what another block reads or writes, so there are no atomics
// and every sum runs in a fixed order: two backward passes give the same bits.
// The ragged edges are masked in the kernel, not by padded copies: rows past
// Sq load as zeros, take lse = +inf (so p = 0) and are never stored; key
// columns past Sk get p = 0 in K2a and their dk/dv rows are never stored in
// K2b. Strides of every (b, h, s) axis are passed, so the head-split views of
// the attention layers, K1's head-interleaved O and whatever dO autograd hands
// over are read in place. Three variants:
// * bf16, head dim 64 (the SD3.5 path): 128-row tiles of the outer axis, 8 warps each
//   owning 16 rows; every product on the tensor cores with mma.sync m16n8k16
//   (bf16 in, fp32 accumulate); p and ds are re-packed in registers as A
//   operands; the B operands of the row-major tiles come from ldmatrix.trans;
//   tiles move as 16-byte vectors, so every pointer and (b, h, s) stride must
//   keep 16-byte alignment, else the launch is refused.
// * bf16, head dim 128 (the Wan path): the head-dim-64 design does not widen.
//   Its warps hold their 16 resident rows as A fragments; at D=128 those,
//   the doubled accumulators (dk and dv: 128 fp32 a thread) and the score
//   tiles pass the 255 registers a thread can have. So the resident tiles
//   (q~ and dO in K2a, K and V in K2b) stay in shared memory and each k-step
//   reads its A fragment from there; blocks are 4 warps (64 outer rows);
//   K2a streams 64-key tiles, K2b 32-row q tiles (its score tiles then take
//   32 registers, not 64). The streamed tiles come in with cp.async into two
//   shared-memory stages (tile n+1 in flight while tile n is multiplied, as
//   in K3); K2b scales each q tile by qmul in place once it has landed, every
//   thread the vectors it copied itself. Dynamic shared memory: 104.4 KB for
//   K2a, 69.6 KB for K2b. Same roundings, masks, layouts and alignment rules
//   as the head-dim-64 variant.
// * fp32, head dim 64: 64-row tiles, 256 threads, register-tiled 4x4 fp32
//   FMAs from shared memory (right and simple).
// No TMA, wgmma or fused dq/dkv pass yet: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;  // head dim
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse2;   // (B, H, Sq) base-2 lse, contiguous
  const float* delta;  // (B, H, Sq) rowsum(dO * O), contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;      // dO
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  float qmul;   // scale * log2(e) in the input type
  float scale;  // dq's finalize factor
};

__device__ __forceinline__ int64_t row_base(const Params& p, int b, int h) {
  return ((int64_t)b * p.H + h) * p.Sq;
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMA variant
// ---------------------------------------------------------------------------
constexpr int FB = 64;      // rows per tile
constexpr int FNT = 256;    // threads per block (16 x 16 register tiles of 4x4)
constexpr int FP = D + 1;   // padded row pitch (conflict-free column reads)
constexpr int FTILE = FB * FP;

// Rows [row0, row0 + 64) of an fp32 (S, 64) head slice times `mul` into dst;
// rows past S are zeros.
__device__ __forceinline__ void tile_f32(float* dst, const float* src, int64_t row_stride, int row0,
                                         int S, float mul) {
  for (int i = threadIdx.x; i < FB * D; i += FNT) {
    const int r = i / D, c = i % D, row = row0 + r;
    dst[r * FP + c] = row < S ? src[(int64_t)row * row_stride + c] * mul : 0.f;
  }
}

__global__ void __launch_bounds__(FNT) flash_bwd_dq_f32_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;           // q~ rows of this block
  float* Os = Qs + FTILE;     // dO rows of this block
  float* Ks = Os + FTILE;     // key tile
  float* Vs = Ks + FTILE;     // value tile
  float* Ss = Vs + FTILE;     // ds tile
  __shared__ float lse_s[FB], del_s[FB];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FB;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ob = reinterpret_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  tile_f32(Qs, qb, p.q_ss, q0, p.Sq, p.qmul);
  tile_f32(Os, ob, p.o_ss, q0, p.Sq, 1.f);
  if (threadIdx.x < FB) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
    del_s[threadIdx.x] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
  }

  const int tx = threadIdx.x % 16;  // column group: columns tx + 16 j
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < p.Sk; n0 += FB) {
    __syncthreads();  // the previous tile's Ks/Vs/Ss are no longer read
    tile_f32(Ks, kb, p.k_ss, n0, p.Sk, 1.f);
    tile_f32(Vs, vb, p.v_ss, n0, p.Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * FP + d];
        o[i] = Os[(ty * 4 + i) * FP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * FP + d];
        vv[j] = Vs[(tx + 16 * j) * FP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const float pv = n0 + c < p.Sk ? exp2f(fminf(s[i][j] - lse_s[r], 0.f)) : 0.f;
        Ss[r * FP + c] = pv * (dp[i][j] - del_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < FB; ++n) {
      float ds[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty * 4 + i) * FP + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[n * FP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  float* dqb = reinterpret_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dqb[(int64_t)row * p.dq_ss + tx + 16 * j] = acc[i][j] * p.scale;
  }
}

__global__ void __launch_bounds__(FNT) flash_bwd_dkv_f32_kernel(Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;           // key rows of this block
  float* Vs = Ks + FTILE;     // value rows of this block
  float* Qs = Vs + FTILE;     // q~ tile
  float* Os = Qs + FTILE;     // dO tile
  float* Ps = Os + FTILE;     // p^T tile (keys x q rows)
  float* Ss = Ps + FTILE;     // ds^T tile
  __shared__ float lse_s[FB], del_s[FB];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * FB;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ob = reinterpret_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  tile_f32(Ks, kb, p.k_ss, k0, p.Sk, 1.f);
  tile_f32(Vs, vb, p.v_ss, k0, p.Sk, 1.f);

  const int tx = threadIdx.x % 16;  // q-row group: q rows tx + 16 j of the tile
  const int ty = threadIdx.x / 16;  // keys ty*4 .. ty*4+3
  float acck[4][4], accv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acck[i][j] = accv[i][j] = 0.f;

  for (int m0 = 0; m0 < p.Sq; m0 += FB) {
    __syncthreads();  // the previous tile's Qs/Os/Ps/Ss are no longer read
    tile_f32(Qs, qb, p.q_ss, m0, p.Sq, p.qmul);
    tile_f32(Os, ob, p.o_ss, m0, p.Sq, 1.f);
    if (threadIdx.x < FB) {
      const int row = m0 + threadIdx.x;
      lse_s[threadIdx.x] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
      del_s[threadIdx.x] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * FP + d];
        vv[i] = Vs[(ty * 4 + i) * FP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = Qs[(tx + 16 * j) * FP + d];
        o[j] = Os[(tx + 16 * j) * FP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], a[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], o[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const float pv = exp2f(fminf(s[i][j] - lse_s[c], 0.f));
        Ps[r * FP + c] = pv;
        Ss[r * FP + c] = pv * (dp[i][j] - del_s[c]);
      }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < FB; ++n) {
      float pt[4], st[4], o[4], a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = Ps[(ty * 4 + i) * FP + n];
        st[i] = Ss[(ty * 4 + i) * FP + n];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = Os[n * FP + tx + 16 * j];
        a[j] = Qs[n * FP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accv[i][j] = fmaf(pt[i], o[j], accv[i][j]);
          acck[i][j] = fmaf(st[i], a[j], acck[i][j]);
        }
    }
  }

  float* dkb = reinterpret_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvb = reinterpret_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkb[(int64_t)row * p.dk_ss + tx + 16 * j] = acck[i][j] * kLn2;
      dvb[(int64_t)row * p.dv_ss + tx + 16 * j] = accv[i][j];
    }
  }
}

cudaError_t launch_f32(const Params& p, bool dkv, cudaStream_t stream) {
  const int tiles = dkv ? 6 : 5;
  const size_t smem = sizeof(float) * (size_t)tiles * FTILE;
  auto kernel = dkv ? flash_bwd_dkv_f32_kernel : flash_bwd_dq_f32_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((dkv ? p.Sk : p.Sq) + FB - 1) / FB, p.H, p.B);
  kernel<<<grid, FNT, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core variant (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
constexpr int MR = 128;     // rows of the outer axis per block: 8 warps x 16 rows
constexpr int MT = 64;      // rows of the inner (looped) axis per tile
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

// ROWS x 64 of a bf16 (S, 64) head slice → row-major shared memory (pitch MP),
// 4 threads per row, 16-byte loads and stores. Each value is multiplied by
// `mul` in fp32 and rounded once to bf16 (exact for mul = 1); rows past S are
// zeros.
template <int ROWS>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int64_t row_stride, int row0, int S, float mul) {
  const int c0 = (threadIdx.x & 3) * 16;
#pragma unroll
  for (int rr = 0; rr < ROWS; rr += MNT / 4) {
    const int r = rr + (threadIdx.x >> 2), row = row0 + r;
    uint4 out[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (row < S) {
      const uint4* src4 = reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride + c0);
      const uint4 u[2] = {src4[0], src4[1]};
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(u);
      uint32_t* w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 f = __bfloat1622float2(hv[e]);
        w[e] = pack_bf16(f.x * mul, f.y * mul);
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * MP + c0);
    d[0] = out[0];
    d[1] = out[1];
  }
}

// A fragments of the warp's 16 rows (from row `wr` of a shared tile) x 64
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], const __nv_bfloat16* tile, int wr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = ld32(&tile[(wr + g) * MP + kk * 16 + 2 * t]);
    f[kk][1] = ld32(&tile[(wr + g + 8) * MP + kk * 16 + 2 * t]);
    f[kk][2] = ld32(&tile[(wr + g) * MP + kk * 16 + 8 + 2 * t]);
    f[kk][3] = ld32(&tile[(wr + g + 8) * MP + kk * 16 + 8 + 2 * t]);
  }
}

// acc[8][4] (16 x 64) = A (16 x 64, fragments) . tile^T, tile a row-major
// [64 rows][64] shared tile read as the col-major B operand
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_16816(acc[j], a[kk], ld32(&tile[(j * 8 + g) * MP + kk * 16 + 2 * t]),
                ld32(&tile[(j * 8 + g) * MP + kk * 16 + 8 + 2 * t]));
}

// acc[8][4] (16 x 64) += X (16 x 64, an fp32 accumulator fragment rounded to
// bf16 as the A operand) . tile, tile a row-major [64][64] shared tile
__device__ __forceinline__ void mma_xb(float (&acc)[8][4], const float (&x)[8][4],
                                       const __nv_bfloat16* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // accumulator tiles 2kk and 2kk+1 hold the 16 inner columns of k-step kk
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      ldmatrix_x2_trans<MP>(b0, b1, tile, kk * 16, j * 8);
      mma_16816(acc[j], a, b0, b1);
    }
  }
}

__global__ void __launch_bounds__(MNT) flash_bwd_dq_mma_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 Rs[MR * MP];  // q~ rows, then dO rows
  __shared__ __align__(16) __nv_bfloat16 Ks[MT * MP];
  __shared__ __align__(16) __nv_bfloat16 Vs[MT * MP];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MR;
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const auto* ob = reinterpret_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile

  uint32_t qf[4][4], of[4][4];  // A fragments of the warp's q~ and dO rows
  load_rows_bf16<MR>(Rs, qb, p.q_ss, q0, p.Sq, p.qmul);
  __syncthreads();
  load_a_frags(qf, Rs, wr);
  __syncthreads();
  load_rows_bf16<MR>(Rs, ob, p.o_ss, q0, p.Sq, 1.f);
  __syncthreads();
  load_a_frags(of, Rs, wr);

  // this thread's rows are wr+g (fragment slots 0,1) and wr+g+8 (slots 2,3)
  float lse[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse[r] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
    del[r] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
  }
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = 0; n0 < p.Sk; n0 += MT) {
    __syncthreads();  // the previous tile's Ks/Vs are no longer read
    load_rows_bf16<MT>(Ks, kb, p.k_ss, n0, p.Sk, 1.f);
    load_rows_bf16<MT>(Vs, vb, p.v_ss, n0, p.Sk, 1.f);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt(s, qf, Ks);
    mma_abt(dp, of, Vs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = n0 + j * 8 + 2 * t + (e & 1) < p.Sk ? exp2f(fminf(s[j][e] - lse[r], 0.f)) : 0.f;
        s[j][e] = pv * (dp[j][e] - del[r]);  // ds, rounded to bf16 as the A operand
      }
    mma_xb(acc, s, Ks);
  }

  auto* dqb = reinterpret_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)row * p.dq_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
  }
}

__global__ void __launch_bounds__(MNT) flash_bwd_dkv_mma_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 Rs[MR * MP];  // key rows, then value rows
  __shared__ __align__(16) __nv_bfloat16 Qs[MT * MP];
  __shared__ __align__(16) __nv_bfloat16 Os[MT * MP];
  __shared__ float lse_s[MT], del_s[MT];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * MR;
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const auto* ob = reinterpret_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first key in the tile

  uint32_t kf[4][4], vf[4][4];  // A fragments of the warp's key and value rows
  load_rows_bf16<MR>(Rs, kb, p.k_ss, k0, p.Sk, 1.f);
  __syncthreads();
  load_a_frags(kf, Rs, wr);
  __syncthreads();
  load_rows_bf16<MR>(Rs, vb, p.v_ss, k0, p.Sk, 1.f);
  __syncthreads();
  load_a_frags(vf, Rs, wr);

  float acck[8][4], accv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;

  for (int m0 = 0; m0 < p.Sq; m0 += MT) {
    __syncthreads();  // the previous tile's Qs/Os/lse_s/del_s are no longer read
    load_rows_bf16<MT>(Qs, qb, p.q_ss, m0, p.Sq, p.qmul);
    load_rows_bf16<MT>(Os, ob, p.o_ss, m0, p.Sq, 1.f);
    if (threadIdx.x < MT) {
      const int row = m0 + threadIdx.x;
      lse_s[threadIdx.x] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
      del_s[threadIdx.x] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this warp's keys, columns the tile's q rows
    float st[8][4], dpt[8][4];
    mma_abt(st, kf, Qs);
    mma_abt(dpt, vf, Os);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float pv = exp2f(fminf(st[j][e] - lse_s[c], 0.f));
        st[j][e] = pv;                          // p^T, rounded to bf16 as the A operand
        dpt[j][e] = pv * (dpt[j][e] - del_s[c]);  // ds^T, likewise
      }
    mma_xb(accv, st, Os);
    mma_xb(acck, dpt, Qs);
  }

  auto* dkb = reinterpret_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  auto* dvb = reinterpret_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wr + g + 8 * r;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)row * p.dk_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acck[j][2 * r] * kLn2, acck[j][2 * r + 1] * kLn2);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)row * p.dv_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(accv[j][2 * r], accv[j][2 * r + 1]);
    }
  }
}

// The tensor-core variant moves 16-byte vectors: every pointer and stride it
// touches must keep 8-element (16-byte) alignment.
bool mma_aligned(const Params& p, bool dkv) {
  auto a16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  const int64_t common[] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh, p.k_ss,
                            p.v_sb, p.v_sh, p.v_ss, p.o_sb, p.o_sh, p.o_ss};
  for (int64_t v : common)
    if (v % 8 != 0) return false;
  if (!(a16(p.q) && a16(p.k) && a16(p.v) && a16(p.dout))) return false;
  if (!dkv) return a16(p.dq) && p.dq_sb % 8 == 0 && p.dq_sh % 8 == 0 && p.dq_ss % 8 == 0;
  return a16(p.dk) && a16(p.dv) && p.dk_sb % 8 == 0 && p.dk_sh % 8 == 0 && p.dk_ss % 8 == 0 &&
         p.dv_sb % 8 == 0 && p.dv_sh % 8 == 0 && p.dv_ss % 8 == 0;
}

cudaError_t launch_mma(const Params& p, bool dkv, cudaStream_t stream) {
  dim3 grid(((dkv ? p.Sk : p.Sq) + MR - 1) / MR, p.H, p.B);
  if (dkv)
    flash_bwd_dkv_mma_kernel<<<grid, MNT, 0, stream>>>(p);
  else
    flash_bwd_dq_mma_kernel<<<grid, MNT, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, head dim 128: resident tiles in shared memory, streamed tiles in a
// two-stage cp.async ring
// ---------------------------------------------------------------------------
constexpr int WD = 128;      // head dim of this variant
constexpr int WP = WD + 8;   // bf16 row pitch (272 B): conflict-free fragment loads and ldmatrix
constexpr int WNT = 128;     // 4 warps, each owning 16 rows of the outer axis
constexpr int WR = 64;       // outer rows per block
constexpr int WK = 64;       // K2a: keys per streamed tile
constexpr int WQ = 32;       // K2b: q rows per streamed tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// ROWS x 128 of a bf16 (S, 128) head slice -> row-major shared memory (pitch
// WP) with cp.async, 16 bytes a copy; rows past S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void async_rows_w(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t row_stride,
                                             int row0, int S) {
  constexpr int VPR = WD / 8;  // 16-byte vectors per row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += WNT) {
    const int r = idx / VPR, c = (idx % VPR) * 8, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * WP + c, src + (int64_t)(ok ? row : 0) * row_stride + c, ok);
  }
}

// Multiplies in place, by `mul` in fp32 with one rounding to bf16, the
// vectors of a tile that this thread copied with async_rows_w<ROWS> (so its
// own wait_group is enough before it reads them).
template <int ROWS>
__device__ __forceinline__ void scale_rows_w(__nv_bfloat16* tile, float mul) {
  constexpr int VPR = WD / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += WNT) {
    uint4* v = reinterpret_cast<uint4*>(tile + (idx / VPR) * WP + (idx % VPR) * 8);
    uint4 u = *v;
    __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(hv[e]);
      hv[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    *v = u;
  }
}

// acc[NJ][4] (16 x 8NJ) = R . C^T: R the warp's 16 rows (from row wr) of a
// [.][128] shared tile, its A fragments read at each k-step; C a row-major
// [8NJ][128] shared tile read as the col-major B operand.
template <int NJ>
__device__ __forceinline__ void mma_abt_w(float (&acc)[NJ][4], const __nv_bfloat16* rows, int wr,
                                          const __nv_bfloat16* cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WD / 16; ++kk) {
    const uint32_t a[4] = {ld32(&rows[(wr + g) * WP + kk * 16 + 2 * t]),
                           ld32(&rows[(wr + g + 8) * WP + kk * 16 + 2 * t]),
                           ld32(&rows[(wr + g) * WP + kk * 16 + 8 + 2 * t]),
                           ld32(&rows[(wr + g + 8) * WP + kk * 16 + 8 + 2 * t])};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_16816(acc[j], a, ld32(&cols[(j * 8 + g) * WP + kk * 16 + 2 * t]),
                ld32(&cols[(j * 8 + g) * WP + kk * 16 + 8 + 2 * t]));
  }
}

// acc[16][4] (16 x 128) += X . T: X (16 x 16KS) an fp32 accumulator fragment
// rounded to bf16 as the A operand, T a row-major [16KS][128] shared tile.
template <int KS>
__device__ __forceinline__ void mma_xb_w(float (&acc)[WD / 8][4], const float (&x)[2 * KS][4],
                                         const __nv_bfloat16* tile) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < WD / 8; ++j) {
      uint32_t b0, b1;
      ldmatrix_x2_trans<WP>(b0, b1, tile, kk * 16, j * 8);
      mma_16816(acc[j], a, b0, b1);
    }
  }
}

// Rows wr+g and wr+g+8 of a (16 x 128) accumulator, times `mul`, to bf16 rows
// of `out` (row stride `ss`) from row `row0`; rows at or past S are skipped.
__device__ __forceinline__ void store_rows_w(__nv_bfloat16* out, int64_t ss, int row0, int S,
                                             const float (&acc)[WD / 8][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < WD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

__global__ void __launch_bounds__(WNT, 2) flash_bwd_dq_w_kernel(Params p) {
  // q~ rows and dO rows of this block, then two stages of (K, V) tiles
  extern __shared__ __align__(16) __nv_bfloat16 wbuf[];
  __nv_bfloat16* Qs = wbuf;
  __nv_bfloat16* Os = Qs + WR * WP;
  __nv_bfloat16* ring = Os + WR * WP;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WR;
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const auto* ob = reinterpret_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile

  async_rows_w<WR>(Qs, qb, p.q_ss, q0, p.Sq);
  async_rows_w<WR>(Os, ob, p.o_ss, q0, p.Sq);
  async_rows_w<WK>(ring, kb, p.k_ss, 0, p.Sk);
  async_rows_w<WK>(ring + WK * WP, vb, p.v_ss, 0, p.Sk);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  scale_rows_w<WR>(Qs, p.qmul);  // q~ = q * qmul, rounded once

  // this thread's rows are wr+g (fragment slots 0,1) and wr+g+8 (slots 2,3)
  float lse[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse[r] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
    del[r] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
  }
  float acc[WD / 8][4];
#pragma unroll
  for (int j = 0; j < WD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = 0, it = 0; n0 < p.Sk; n0 += WK, ++it) {
    __syncthreads();  // the q~ tile is staged, or the stage refilled next is no longer read
    if (n0 + WK < p.Sk) {  // prefetch the next key tile into the other stage
      __nv_bfloat16* next = ring + 2 * ((it + 1) & 1) * WK * WP;
      async_rows_w<WK>(next, kb, p.k_ss, n0 + WK, p.Sk);
      async_rows_w<WK>(next + WK * WP, vb, p.v_ss, n0 + WK, p.Sk);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's copies have landed
    __syncthreads();
    const __nv_bfloat16* Kt = ring + 2 * (it & 1) * WK * WP;
    const __nv_bfloat16* Vt = Kt + WK * WP;

    float s[WK / 8][4], dp[WK / 8][4];
    mma_abt_w<WK / 8>(s, Qs, wr, Kt);
    mma_abt_w<WK / 8>(dp, Os, wr, Vt);
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = n0 + j * 8 + 2 * t + (e & 1) < p.Sk ? exp2f(fminf(s[j][e] - lse[r], 0.f)) : 0.f;
        s[j][e] = pv * (dp[j][e] - del[r]);  // ds, rounded to bf16 as the A operand
      }
    mma_xb_w<WK / 16>(acc, s, Kt);
  }

  auto* dqb = reinterpret_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows_w(dqb, p.dq_ss, q0 + wr, p.Sq, acc, p.scale);
}

__global__ void __launch_bounds__(WNT, 2) flash_bwd_dkv_w_kernel(Params p) {
  // key rows and value rows of this block, then two stages of (q~, dO) tiles
  extern __shared__ __align__(16) __nv_bfloat16 wbuf[];
  __nv_bfloat16* Ks = wbuf;
  __nv_bfloat16* Vs = Ks + WR * WP;
  __nv_bfloat16* ring = Vs + WR * WP;
  __shared__ float lse_s[2][WQ], del_s[2][WQ];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * WR;
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const auto* ob = reinterpret_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first key in the tile

  async_rows_w<WR>(Ks, kb, p.k_ss, k0, p.Sk);
  async_rows_w<WR>(Vs, vb, p.v_ss, k0, p.Sk);
  async_rows_w<WQ>(ring, qb, p.q_ss, 0, p.Sq);
  async_rows_w<WQ>(ring + WQ * WP, ob, p.o_ss, 0, p.Sq);
  asm volatile("cp.async.commit_group;\n" ::);
  if (threadIdx.x < WQ) {
    const int row = threadIdx.x;
    lse_s[0][threadIdx.x] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
    del_s[0][threadIdx.x] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
  }

  float acck[WD / 8][4], accv[WD / 8][4];
#pragma unroll
  for (int j = 0; j < WD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;

  for (int m0 = 0, it = 0; m0 < p.Sq; m0 += WQ, ++it) {
    const int stage = it & 1;
    __syncthreads();  // the stage refilled next (tiles, lse_s, del_s) is no longer read
    if (m0 + WQ < p.Sq) {  // prefetch the next q tile into the other stage
      __nv_bfloat16* next = ring + 2 * (stage ^ 1) * WQ * WP;
      async_rows_w<WQ>(next, qb, p.q_ss, m0 + WQ, p.Sq);
      async_rows_w<WQ>(next + WQ * WP, ob, p.o_ss, m0 + WQ, p.Sq);
      if (threadIdx.x < WQ) {
        const int row = m0 + WQ + threadIdx.x;
        lse_s[stage ^ 1][threadIdx.x] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
        del_s[stage ^ 1][threadIdx.x] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's copies have landed
    __nv_bfloat16* Qt = ring + 2 * stage * WQ * WP;
    const __nv_bfloat16* Ot = Qt + WQ * WP;
    scale_rows_w<WQ>(Qt, p.qmul);  // q~ = q * qmul, rounded once
    __syncthreads();

    // transposed scores: rows are this warp's keys, columns the tile's q rows
    float st[WQ / 8][4], dpt[WQ / 8][4];
    mma_abt_w<WQ / 8>(st, Ks, wr, Qt);
    mma_abt_w<WQ / 8>(dpt, Vs, wr, Ot);
#pragma unroll
    for (int j = 0; j < WQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float pv = exp2f(fminf(st[j][e] - lse_s[stage][c], 0.f));
        st[j][e] = pv;                                  // p^T, rounded to bf16 as the A operand
        dpt[j][e] = pv * (dpt[j][e] - del_s[stage][c]);  // ds^T, likewise
      }
    mma_xb_w<WQ / 16>(accv, st, Ot);
    mma_xb_w<WQ / 16>(acck, dpt, Qt);
  }

  auto* dkb = reinterpret_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  auto* dvb = reinterpret_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows_w(dkb, p.dk_ss, k0 + wr, p.Sk, acck, kLn2);
  store_rows_w(dvb, p.dv_ss, k0 + wr, p.Sk, accv, 1.f);
}

cudaError_t launch_w(const Params& p, bool dkv, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)WP * (2 * WR + 4 * (dkv ? WQ : WK));
  auto kernel = dkv ? flash_bwd_dkv_w_kernel : flash_bwd_dq_w_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((dkv ? p.Sk : p.Sq) + WR - 1) / WR, p.H, p.B);
  kernel<<<grid, WNT, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
                   const float* delta, int B, int H, int Sq, int Sk, const long long* s, float qmul,
                   float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse2 = lse2; p.delta = delta;
  p.dq = nullptr; p.dk = nullptr; p.dv = nullptr;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2];
  p.k_sb = s[3]; p.k_sh = s[4]; p.k_ss = s[5];
  p.v_sb = s[6]; p.v_sh = s[7]; p.v_ss = s[8];
  p.o_sb = s[9]; p.o_sh = s[10]; p.o_ss = s[11];
  p.dq_sb = p.dq_sh = p.dq_ss = 0;
  p.dk_sb = p.dk_sh = p.dk_ss = 0;
  p.dv_sb = p.dv_sh = p.dv_ss = 0;
  p.qmul = qmul; p.scale = scale;
  return p;
}

int launch(const Params& p, bool dkv, int d, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d == D && dtype == 0) return (int)launch_f32(p, dkv, s);
  if (dtype != 1 || !mma_aligned(p, dkv)) return (int)cudaErrorInvalidValue;
  if (d == D) return (int)launch_mma(p, dkv, s);
  if (d == WD) return (int)launch_w(p, dkv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Common arguments: q, k, v, dout (B, H, S, d) in one type; lse2 (base-2
// lse) and delta fp32 contiguous (B, H, Sq); d: head dim, 64 (float32 or
// bfloat16) or 128 (bfloat16); dtype: 0 = float32, 1 = bfloat16 (16-byte
// aligned pointers and strides); qmul:
// scale * log2(e) rounded to the input type. Returns the cudaError_t of the
// launch (0 on success).

// K2a. strides: 15 element strides, (b, h, s) of q, k, v, dout and dq.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
                 const float* delta, void* dq, int B, int H, int Sq, int Sk, int d,
                 const long long* strides, float qmul, float scale, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse2, delta, B, H, Sq, Sk, strides, qmul, scale);
  p.dq = dq;
  p.dq_sb = strides[12]; p.dq_sh = strides[13]; p.dq_ss = strides[14];
  return launch(p, false, d, dtype, stream);
}

// K2b. strides: 18 element strides, (b, h, s) of q, k, v, dout, dk and dv.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
                  const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int d,
                  const long long* strides, float qmul, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse2, delta, B, H, Sq, Sk, strides, qmul, 1.f);
  p.dk = dk; p.dv = dv;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_ss = strides[17];
  return launch(p, true, d, dtype, stream);
}

const char* flash_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
