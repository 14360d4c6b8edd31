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
// * bf16, head dim 64 (the SD3.5 path), for Hopper (sm_90a): every product
//   on wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate). A block is two
//   consumer warpgroups of 64 outer rows each (128 q rows in K2a, 128 keys in
//   K2b) and a producer (a warp in K2a, a warpgroup in K2b: see
//   flash_bwd_dkv_wgmma_kernel); the outer rows stay in shared memory, the
//   inner axis streams in 64-row tiles (K/V in K2a; q/dO plus their lse2 and
//   Delta in K2b) through a 4-stage TMA ring, each stage with a "full"
//   mbarrier (K2a: the TMA bytes; K2b: the producer's threads, once they have
//   made q~ and written lse2/Delta) and an "empty" one (the 8 consumer
//   warps). A warpgroup issues S = q~K^T and dP = dO V^T (K2a) or
//   S^T = K q~^T and dP^T = V dO^T (K2b)
//   from shared memory, turns them into p and ds in registers, packs those to
//   bf16 A fragments and issues dQ += dS K (K2a) or dV += P^T dO and dK +=
//   dS^T q~ (K2b) with the streamed tile as a transposed B; the next tile's
//   scores are issued behind those before the warpgroup waits. Accumulators:
//   K2a 96 fp32 a thread (S, dP, dQ), K2b 128 (S^T, dP^T, dK, dV). Dynamic
//   shared memory 99.1 KB, one block an SM. What to get right, named where
//   it is done:
//   - descriptor and swizzle agreement: a 64-column bf16 row is exactly 128
//     bytes, so the tensor maps use CU_TENSOR_MAP_SWIZZLE_128B and every wgmma
//     descriptor the 128B mode over 1024-byte aligned tiles (gdesc); a wrong
//     stride offset or mode gives wrong numbers without a fault, hence the
//     card tests at contiguous and head-split layouts;
//   - transposed B (dS K, P^T dO, dS^T q~): the tile's rows are the
//     contraction, read MN-major through the transpose immediate, which
//     wgmma allows for 16-bit types only (wgmma_rs_t);
//   - q~ rounded once: K2a's consumers scale their resident q rows in shared
//     memory, K2b's producer each landed q tile (a tile behind the copies
//     it issues, behind a third barrier per stage, "land"); the generic-proxy
//     writes are fenced (fence.proxy.async.shared::cta) before wgmma reads
//     them. (Scaling q in the wrapper instead would add a pass over q to
//     every K2b call: 2 x 67 MB at the SD3.5 joint shape.)
//   - the tensor maps: 4-D (D, S, H, B) with each view's byte strides, so
//     strided views are read in place and rows past S arrive as zeros; built
//     on the host for each call from the geometry the wrapper computes,
//     passed as __grid_constant__ parameters, the encoder found with
//     cudaGetDriverEntryPoint so that the build rule stays the other sources';
//   - wgmma fences and waits: wgmma.fence before every product that reads
//     registers written since, wait_group 0 before an accumulator is read or
//     an A fragment rewritten, and fence_acc so that the compiler moves no
//     accumulator access across either; no other instruction writes an
//     accumulator (nothing zeroes one, p and ds go straight into A
//     fragments), else ptxas serializes the products (its warning C7515).
//   Pointers and (b, h, s) strides keep 16-byte alignment (TMA's rule too),
//   else the launch is refused.
// * bf16, head dim 128 (the Wan path), mma.sync m16n8k16: warps holding
//   their 16 resident rows as A fragments do not widen to D=128 (those, the
//   doubled accumulators and the score tiles pass the 255 registers a
//   thread can have). So the resident tiles
//   (q~ and dO in K2a, K and V in K2b) stay in shared memory and each k-step
//   reads its A fragment from there; blocks are 4 warps (64 outer rows);
//   K2a streams 64-key tiles, K2b 32-row q tiles (its score tiles then take
//   32 registers, not 64). The streamed tiles come in with cp.async into two
//   shared-memory stages (tile n+1 in flight while tile n is multiplied, as
//   in K3); K2b scales each q tile by qmul in place once it has landed, every
//   thread the vectors it copied itself. Dynamic shared memory: 104.4 KB for
//   K2a, 69.6 KB for K2b. Same roundings, masks, layouts and alignment rules
//   as the head-dim-64 variant. No TMA or wgmma here yet: later work.
// * fp32, head dim 64: 64-row tiles, 256 threads, register-tiled 4x4 fp32
//   FMAs from shared memory (right and simple).
// No fused dq/dkv pass: it would need atomics or a B*H*Sq*Sk dS buffer.
#include <cuda.h>  // CUtensorMap and its enums; the encoder itself comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bf16 helpers of the tensor-core variants (mma.sync m16n8k16, head dim 128)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// ---------------------------------------------------------------------------
// bf16, head dim 64: wgmma fed by a TMA ring (sm_90a)
// ---------------------------------------------------------------------------
constexpr int GR = 64;                  // rows of a tile: wgmma M, the TMA box, the streamed step
constexpr int GWG = 2;                  // consumer warpgroups a block, each owning GR outer rows
constexpr int GNT_DQ = (4 * GWG + 1) * 32;   // K2a: + one producer warp
constexpr int GNT_DKV = 4 * (GWG + 1) * 32;  // K2b: + one producer warpgroup
// K2b's registers a thread after setmaxnreg: 2 x 128 x 224 + 128 x 56 is the
// 384 x 168 the block starts with
constexpr int GREGS_CONSUMER = 224;
constexpr int GREGS_PRODUCER = 56;
constexpr int GSTAGES = 4;              // streamed tiles in flight
constexpr int GTILE = GR * D;           // elements of a 64 x 64 tile: 8 KB, 64 rows of 128 bytes
constexpr uint32_t GTILE_BYTES = GTILE * 2;

// One 64 x 64 box of a (D, S, H, B) tensor map, rows `row`..`row`+63 of head
// (b, h), into a 1024-byte aligned tile; rows past S arrive as zeros.
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int h, int b) {
  tma_load(dst, map, bar, 0, row, h, b);
}

// d = R . C^T over the head dim: R and C two K-major 64 x 64 tiles.
__device__ __forceinline__ void wgmma_rows_cols(float (&d)[32], const __nv_bfloat16* rows,
                                                const __nv_bfloat16* cols) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(d, gdesc(rows, kk * 32), gdesc(cols, kk * 32), kk > 0);
}

// acc (+)= X . T: X (64 x 64) as bf16 A fragments, T a streamed tile whose 64
// rows are contracted (read MN-major). Accumulator slots i, i+1 (one row, two
// adjacent columns) of a 64 x 64 fp32 tile pack into fragment a[i / 8][i / 2
// % 4]: k-step kk takes the tile's columns 16kk..16kk+15. The first tile
// overwrites acc. No instruction but a wgmma ever writes an accumulator (p
// and ds go straight into fragments; nothing zeroes): any other write
// between an issue and its wait makes ptxas serialize the products.
__device__ __forceinline__ void wgmma_x_tile(float (&acc)[32], const uint32_t (&a)[4][4],
                                             const __nv_bfloat16* tile, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(acc, a[kk], gdesc(tile, kk * 16 * 128), kk > 0 || !first);
}

// Rows g and g+8 of the warp's 16 (from row `row0`) of a 64 x 64 accumulator,
// times `mul`, to bf16 rows of `out` (row stride `ss`); rows at or past S are
// skipped.
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, int64_t ss, int row0, int S, const float (&acc)[32],
                                          float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// Shared memory: two resident tiles per consumer warpgroup, GSTAGES stages of
// two streamed tiles, the stages' lse2/Delta (K2b), the barriers, and 1 KB to
// align the tiles to the swizzle's 1024-byte period.
constexpr size_t GSMEM = 1024 + (size_t)GTILE_BYTES * 2 * (GWG + GSTAGES) + GSTAGES * 2 * GR * sizeof(float) +
                         (3 * GSTAGES + 1) * sizeof(uint64_t);

struct GLayout {
  __nv_bfloat16* res;   // [2 * GWG] tiles: (q~ | K) of warpgroup w at w, (dO | V) at GWG + w
  __nv_bfloat16* ring;  // [GSTAGES][2] tiles: (K, V) in K2a, (q~, dO) in K2b
  float* lse;           // [GSTAGES][GR]
  float* del;           // [GSTAGES][GR]
  uint64_t* full;       // [GSTAGES]: the stage is ready for the consumers
  uint64_t* empty;      // [GSTAGES]: every consumer warp is done with the stage
  uint64_t* land;       // [GSTAGES]: K2b's copies of the stage have landed
  uint64_t* res_full;   // the resident tiles have landed
};

__device__ __forceinline__ GLayout g_layout(uint8_t* raw) {
  GLayout L;
  L.res = reinterpret_cast<__nv_bfloat16*>(align1024(raw));
  L.ring = L.res + 2 * GWG * GTILE;
  L.lse = reinterpret_cast<float*>(L.ring + 2 * GSTAGES * GTILE);
  L.del = L.lse + GSTAGES * GR;
  L.full = reinterpret_cast<uint64_t*>(L.del + GSTAGES * GR);
  L.empty = L.full + GSTAGES;
  L.land = L.empty + GSTAGES;
  L.res_full = L.land + GSTAGES;
  return L;
}

// K2a. Warps 0-7 are two consumer warpgroups of 64 q rows each; warp 8 is the
// producer: one lane puts the q and dO rows in place, then streams (K, V)
// tiles of 64 keys through the ring.
__global__ void __launch_bounds__(GNT_DQ, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                              Params p) {
  extern __shared__ uint8_t graw[];
  const GLayout L = g_layout(graw);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * GWG * GR;
  const int ntiles = (p.Sk + GR - 1) / GR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&L.full[s], 1);
      mbar_init(&L.empty[s], 4 * GWG);
    }
    mbar_init(L.res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * GWG) {  // producer
    if (lane == 0) {
      mbar_arrive_tx(L.res_full, 2 * GWG * GTILE_BYTES);
      for (int w = 0; w < GWG; ++w) {
        tma_tile(L.res + w * GTILE, &tq, L.res_full, q0 + w * GR, h, b);
        tma_tile(L.res + (GWG + w) * GTILE, &to, L.res_full, q0 + w * GR, h, b);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % GSTAGES;
        if (n >= GSTAGES) mbar_wait(&L.empty[s], (n / GSTAGES - 1) & 1);
        mbar_arrive_tx(&L.full[s], 2 * GTILE_BYTES);
        tma_tile(L.ring + 2 * s * GTILE, &tk, &L.full[s], n * GR, h, b);
        tma_tile(L.ring + (2 * s + 1) * GTILE, &tv, &L.full[s], n * GR, h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int wr = wg * GR + (warp & 3) * 16;  // the warp's first row in the block
  __nv_bfloat16* Qw = L.res + wg * GTILE;
  const __nv_bfloat16* Ow = L.res + (GWG + wg) * GTILE;
  mbar_wait(L.res_full, 0);
  // q~ = q * qmul in fp32, rounded once, in place: the warpgroup's own tile.
  // These are generic-proxy writes that wgmma (the async proxy) reads next.
  for (int i = threadIdx.x & 127; i < GTILE / 8; i += 128) {
    uint4* v = reinterpret_cast<uint4*>(Qw) + i;
    uint4 u = *v;
    __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(hv[e]);
      hv[e] = __floats2bfloat162_rn(f.x * p.qmul, f.y * p.qmul);
    }
    *v = u;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  // this thread's rows are wr+g (accumulator slots 4j, 4j+1) and wr+g+8 (4j+2, 4j+3)
  float lse[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse[r] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
    del[r] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
  }
  float acc[32], s[32], dp[32];  // written first by wgmma (see wgmma_x_tile)
  uint32_t a[4][4];

  mbar_wait(&L.full[0], 0);
  wgmma_fence();
  wgmma_rows_cols(s, Qw, L.ring);
  wgmma_rows_cols(dp, Ow, L.ring + GTILE);
  wgmma_commit();
  for (int n = 0; n < ntiles; ++n) {
    const __nv_bfloat16* Kt = L.ring + 2 * (n % GSTAGES) * GTILE;
    wgmma_wait_all();  // S and dP of tile n, and dQ of tile n - 1
    fence_acc(s);
    fence_acc(dp);
    fence_acc(acc);
    if (n > 0 && lane == 0) mbar_arrive(&L.empty[(n - 1) % GSTAGES]);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {  // slots i, i+1: row r, columns col, col + 1
      const int r = (i >> 1) & 1, col = n * GR + (i >> 2) * 8 + 2 * t;
      const float p0 = exp2f(fminf(s[i] - (col < p.Sk ? lse[r] : INFINITY), 0.f));  // p = 0 past Sk
      const float p1 = exp2f(fminf(s[i + 1] - (col + 1 < p.Sk ? lse[r] : INFINITY), 0.f));
      a[i >> 3][(i >> 1) & 3] = pack_bf16(p0 * (dp[i] - del[r]), p1 * (dp[i + 1] - del[r]));  // ds
    }
    wgmma_fence();
    wgmma_x_tile(acc, a, Kt, n == 0);  // dQ += dS . K
    wgmma_commit();
    if (n + 1 < ntiles) {  // the next tile's scores run behind this tile's dQ
      const int s1 = (n + 1) % GSTAGES;
      mbar_wait(&L.full[s1], ((n + 1) / GSTAGES) & 1);
      wgmma_fence();
      wgmma_rows_cols(s, Qw, L.ring + 2 * s1 * GTILE);
      wgmma_rows_cols(dp, Ow, L.ring + (2 * s1 + 1) * GTILE);
      wgmma_commit();
    }
  }
  wgmma_wait_all();
  fence_acc(acc);

  auto* dqb = reinterpret_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_acc(dqb, p.dq_ss, q0 + wr, p.Sq, acc, p.scale);
}

// K2b. Warps 0-7 are two consumer warpgroups of 64 keys each; warps 8-11 are
// the producer warpgroup: it puts the K and V rows in place, then streams
// (q, dO) tiles of 64 rows through the ring. One tile behind the copies it
// issues, it turns each landed q tile into q~ in place, writes the tile's
// lse2 and Delta, and only then marks the stage full. A whole producer
// warpgroup, so that setmaxnreg can hand its registers to the consumers
// (their S^T, dP^T, dK and dV take 128 a thread; the block starts with 168):
// ptxas still reports 120 bytes of spills and some wgmma serialized for
// registers (C7512), and more spills without setmaxnreg.
__global__ void __launch_bounds__(GNT_DKV, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                               Params p) {
  extern __shared__ uint8_t graw[];
  const GLayout L = g_layout(graw);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * GWG * GR;
  const int ntiles = (p.Sq + GR - 1) / GR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&L.land[s], 1);    // the TMA bytes
      mbar_init(&L.full[s], 128);  // the producer's threads, once q~, lse2 and Delta are written
      mbar_init(&L.empty[s], 4 * GWG);
    }
    mbar_init(L.res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * GWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GREGS_PRODUCER));
    const int pt = threadIdx.x - 128 * GWG;
    if (pt == 0) {
      mbar_arrive_tx(L.res_full, 2 * GWG * GTILE_BYTES);
      for (int w = 0; w < GWG; ++w) {
        tma_tile(L.res + w * GTILE, &tk, L.res_full, k0 + w * GR, h, b);
        tma_tile(L.res + (GWG + w) * GTILE, &tv, L.res_full, k0 + w * GR, h, b);
      }
    }
    const int64_t base = row_base(p, b, h);
    float lse_next = 0.f, del_next = 0.f;  // row pt of tile n, loaded while tile n - 1 is finished
    for (int n = 0; n <= ntiles; ++n) {
      const float lse_m = lse_next, del_m = del_next;
      if (n < ntiles) {  // copy tile n
        const int s = n % GSTAGES;
        if (pt == 0) {
          if (n >= GSTAGES) mbar_wait(&L.empty[s], (n / GSTAGES - 1) & 1);
          mbar_arrive_tx(&L.land[s], 2 * GTILE_BYTES);
          tma_tile(L.ring + 2 * s * GTILE, &tq, &L.land[s], n * GR, h, b);
          tma_tile(L.ring + (2 * s + 1) * GTILE, &to, &L.land[s], n * GR, h, b);
        }
        const int row = n * GR + pt;  // padded q rows: p = exp2(-inf) = 0
        if (pt < GR) {
          lse_next = row < p.Sq ? p.lse2[base + row] : INFINITY;
          del_next = row < p.Sq ? p.delta[base + row] : 0.f;
        }
      }
      if (n == 0) continue;
      const int m = n - 1, s = m % GSTAGES;  // finish tile n - 1
      mbar_wait(&L.land[s], (m / GSTAGES) & 1);
      // q~ = q * qmul in fp32, rounded once, in place: generic-proxy writes
      // that wgmma (the async proxy) reads once the stage is full
      uint4* tile = reinterpret_cast<uint4*>(L.ring + 2 * s * GTILE);
      uint4 u[GTILE / 8 / 128];
#pragma unroll
      for (int j = 0; j < GTILE / 8 / 128; ++j) u[j] = tile[pt + 128 * j];
#pragma unroll
      for (int j = 0; j < GTILE / 8 / 128; ++j) {
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(hv[e]);
          hv[e] = __floats2bfloat162_rn(f.x * p.qmul, f.y * p.qmul);
        }
        tile[pt + 128 * j] = u[j];
      }
      if (pt < GR) {
        L.lse[s * GR + pt] = lse_m;
        L.del[s * GR + pt] = del_m;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&L.full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(GREGS_CONSUMER));
  const int wg = warp >> 2, t = lane & 3;
  const int wr = wg * GR + (warp & 3) * 16;  // the warp's first key in the block
  const __nv_bfloat16* Kw = L.res + wg * GTILE;
  const __nv_bfloat16* Vw = L.res + (GWG + wg) * GTILE;
  float acck[32], accv[32], st[32], dpt[32];  // written first by wgmma (see wgmma_x_tile)
  uint32_t pa[4][4], sa[4][4];
  mbar_wait(L.res_full, 0);

  mbar_wait(&L.full[0], 0);
  wgmma_fence();
  wgmma_rows_cols(st, Kw, L.ring);  // transposed scores: rows are keys, columns the tile's q rows
  wgmma_rows_cols(dpt, Vw, L.ring + GTILE);
  wgmma_commit();
  for (int n = 0; n < ntiles; ++n) {
    const int stage = n % GSTAGES;
    const __nv_bfloat16* Qt = L.ring + 2 * stage * GTILE;
    const __nv_bfloat16* Ot = Qt + GTILE;
    const float* lse = L.lse + stage * GR;
    const float* del = L.del + stage * GR;
    wgmma_wait_all();  // S^T and dP^T of tile n, and dK, dV of tile n - 1
    fence_acc(st);
    fence_acc(dpt);
    fence_acc(acck);
    fence_acc(accv);
    if (n > 0 && lane == 0) mbar_arrive(&L.empty[(n - 1) % GSTAGES]);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {  // slots i, i+1: one key, q rows c, c + 1
      const int c = (i >> 2) * 8 + 2 * t;
      const float p0 = exp2f(fminf(st[i] - lse[c], 0.f)), p1 = exp2f(fminf(st[i + 1] - lse[c + 1], 0.f));
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);                                          // p^T
      sa[i >> 3][(i >> 1) & 3] = pack_bf16(p0 * (dpt[i] - del[c]), p1 * (dpt[i + 1] - del[c + 1]));  // ds^T
    }
    wgmma_fence();
    wgmma_x_tile(accv, pa, Ot, n == 0);  // dV += P^T . dO
    wgmma_x_tile(acck, sa, Qt, n == 0);  // dK += dS^T . q~
    wgmma_commit();
    if (n + 1 < ntiles) {  // the next tile's scores run behind this tile's dK, dV
      const int s1 = (n + 1) % GSTAGES;
      mbar_wait(&L.full[s1], ((n + 1) / GSTAGES) & 1);
      wgmma_fence();
      wgmma_rows_cols(st, Kw, L.ring + 2 * s1 * GTILE);
      wgmma_rows_cols(dpt, Vw, L.ring + (2 * s1 + 1) * GTILE);
      wgmma_commit();
    }
  }
  wgmma_wait_all();
  fence_acc(acck);
  fence_acc(accv);

  auto* dkb = reinterpret_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  auto* dvb = reinterpret_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_acc(dkb, p.dk_ss, k0 + wr, p.Sk, acck, kLn2);
  store_acc(dvb, p.dv_ss, k0 + wr, p.Sk, accv, 1.f);
}

// One operand's tensor map (hopper.cuh's encode_map): the kernels take bf16
// 64 x 64 boxes of head dim 64.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, const long long* g) {
  return encode_map(map, ptr, g, D, D, GR);
}

// tma: 4 x 12 geometry values, of q, k, v and dO in that order.
cudaError_t launch_wgmma(const Params& p, bool dkv, const long long* tma, cudaStream_t stream) {
  if (tma == nullptr) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_map(&maps[i], ptrs[i], tma + 12 * i);
    if (err != cudaSuccess) return err;
  }
  auto kernel = dkv ? flash_bwd_dkv_wgmma_kernel : flash_bwd_dq_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GSMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(((dkv ? p.Sk : p.Sq) + GWG * GR - 1) / (GWG * GR), p.H, p.B);
  kernel<<<grid, dkv ? GNT_DKV : GNT_DQ, GSMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// The tensor-core variants move 16-byte vectors: every pointer and stride
// they touch must keep 8-element (16-byte) alignment.
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

int launch(const Params& p, bool dkv, int d, int dtype, const long long* tma, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d == D && dtype == 0) return (int)launch_f32(p, dkv, s);
  if (dtype != 1 || !mma_aligned(p, dkv)) return (int)cudaErrorInvalidValue;
  if (d == D) return (int)launch_wgmma(p, dkv, tma, s);
  if (d == WD) return (int)launch_w(p, dkv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Common arguments: q, k, v, dout (B, H, S, d) in one type; lse2 (base-2
// lse) and delta fp32 contiguous (B, H, Sq); d: head dim, 64 (float32 or
// bfloat16) or 128 (bfloat16); dtype: 0 = float32, 1 = bfloat16 (16-byte
// aligned pointers and strides); qmul: scale * log2(e) rounded to the input
// type; tma: for bf16 at head dim 64, the TMA geometry of q, k, v and dout
// (4 x 12 values, see encode_map), else null. Returns the cudaError_t of the
// launch (0 on success).

// K2a. strides: 15 element strides, (b, h, s) of q, k, v, dout and dq.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
                 const float* delta, void* dq, int B, int H, int Sq, int Sk, int d,
                 const long long* strides, const long long* tma, float qmul, float scale, int dtype,
                 void* stream) {
  Params p = make_params(q, k, v, dout, lse2, delta, B, H, Sq, Sk, strides, qmul, scale);
  p.dq = dq;
  p.dq_sb = strides[12]; p.dq_sh = strides[13]; p.dq_ss = strides[14];
  return launch(p, false, d, dtype, tma, stream);
}

// K2b. strides: 18 element strides, (b, h, s) of q, k, v, dout, dk and dv.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
                  const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int d,
                  const long long* strides, const long long* tma, float qmul, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse2, delta, B, H, Sq, Sk, strides, qmul, 1.f);
  p.dk = dk; p.dv = dv;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_ss = strides[17];
  return launch(p, true, d, dtype, tma, stream);
}

const char* flash_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
