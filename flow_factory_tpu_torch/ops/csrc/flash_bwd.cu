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
// over are read in place. Two variants:
// * bf16, head dim 64 (the SD3.5 path) and 128 (the Wan path), for Hopper
//   (sm_90a): every product on wgmma.mma_async (bf16 in, fp32 accumulate).
//   A block is two consumer warpgroups of 64 outer rows each (128 q rows in
//   K2a, 128 keys in K2b) and a producer (a warp in K2a, a warpgroup in K2b:
//   see flash_bwd_dkv_wgmma_kernel); the outer rows stay in shared memory,
//   the inner axis streams in 64-row tiles (K/V in K2a; q/dO plus their lse2
//   and Delta in K2b) through a 4-stage TMA ring, each stage with a "full"
//   mbarrier (K2a: the TMA bytes; K2b: the producer's threads, once they have
//   made q~ and written lse2/Delta) and an "empty" one (the 8 consumer
//   warps). A warpgroup issues S = q~K^T and dP = dO V^T (K2a) or
//   S^T = K q~^T and dP^T = V dO^T (K2b)
//   from shared memory, turns them into p and ds in registers, packs those to
//   bf16 A fragments and issues dQ += dS K (K2a) or dV += P^T dO and dK +=
//   dS^T q~ (K2b) with the streamed tile as a transposed B; the next tile's
//   scores are issued behind those before the warpgroup waits. At head dim
//   64: m64n64k16 throughout; accumulators K2a 96 fp32 a thread (S, dP,
//   dQ), K2b 128 (S^T, dP^T, dK, dV); 99.1 KB of dynamic shared memory. At
//   head dim 128 (flash_bwd_{dq,dkv}_wgmma128_kernel) tiles are 64 x 128
//   (16 KB), 199.8 KB a block; dQ, dK and dV are m64n128 (64 fp32 a thread
//   each), and the consumers take each streamed tile in two halves of 32
//   rows, so the scores are m64n32 and the fragments half as many: K2a 104
//   a thread, K2b 176 under the 232 of setmaxnreg; p comes from
//   ex2.approx.ftz (exp2_ftz: only a p below 2^-126 differs, it becomes 0).
//   One block an SM at both head dims. What to get right, named where it is
//   done:
//   - descriptor and swizzle agreement: a 64-column bf16 row is exactly 128
//     bytes, so the tensor maps use CU_TENSOR_MAP_SWIZZLE_128B and every wgmma
//     descriptor the 128B mode over 1024-byte aligned tiles (gdesc); a wrong
//     stride offset or mode gives wrong numbers without a fault, hence the
//     card tests at contiguous and head-split layouts. A 128-wide row is two
//     such lines: every tile arrives as two 64 x 64 boxes (columns 0 and 64)
//     into its two 8 KB halves (tma_tile128), K-major products take k-steps
//     0-3 in the first half and 4-7 in the second (kstep128), and a
//     transposed B of N = 128 has its halves one leading-byte offset apart;
//   - transposed B (dS K, P^T dO, dS^T q~): the tile's rows are the
//     contraction, read MN-major through the transpose immediate, which
//     wgmma allows for 16-bit types only (wgmma_rs_t, wgmma_rs_t_n128);
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
//     fragments), else ptxas serializes the products (its warning C7515);
//   - registers: setmaxnreg moves them only within the block (3 x 128 x 168
//     at launch for K2b), so 2 x consumer + producer must be 504, or a
//     consumer's setmaxnreg.inc waits forever.
//   Pointers and (b, h, s) strides keep 16-byte alignment (TMA's rule too),
//   else the launch is refused.
// * fp32, head dim 16 (the JAX tiny presets), 64 or 128 (the fp32 runs of
//   the full models), a template over the head dim: 64-row tiles, 256
//   threads, register-tiled fp32 FMAs on the CUDA cores from shared memory
//   (right and simple: no tensor core takes fp32 without rounding to TF32).
//   The 16 x 16 threads hold 4 x 4 tiles of the 64 x 64 scores and 4 x D/16
//   of the outputs (columns tx + 16 j). The head tiles sit at a pitch of D +
//   1 floats, the score tiles at 65: K2a 4 head tiles and ds, 83.2 KB at
//   D=64, 148.7 KB at 128; K2b 4 and p, ds, 99.8 / 165.4 KB (dynamic, opted
//   in above 48 KB; one block an SM at 128). Bound at the Wan shape (B16 H12
//   S512 D128): the fp32 CUDA-core rate, 66.9 TFLOP/s, 0.578 ms (K2a, 6 B H
//   Sq Sk D = 3.9e10 FLOP) and 0.770 ms (K2b, 8 B H Sq Sk D = 5.2e10).
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
// fp32: register-tiled FMA variant, a template over the head dim FD
// ---------------------------------------------------------------------------
constexpr int FB = 64;      // rows per tile
constexpr int FNT = 256;    // threads per block (16 x 16 register tiles of 4 rows)
constexpr int FSP = FB + 1;  // padded row pitch of the 64 x 64 score tiles (p, ds)
constexpr int FSTILE = FB * FSP;

template <int FD>
struct F32Tile {
  static_assert(FD % 16 == 0 && FD <= 128, "the 16 column threads take FD / 16 columns each");
  static constexpr int FP = FD + 1;     // padded row pitch (conflict-free column reads)
  static constexpr int TILE = FB * FP;  // floats of a 64-row head tile
  static constexpr int DJ = FD / 16;    // output columns a thread: tx + 16 j
  // dynamic shared memory: K2a four head tiles and ds; K2b four and p, ds
  static constexpr size_t SMEM_DQ = sizeof(float) * (size_t)(4 * TILE + FSTILE);
  static constexpr size_t SMEM_DKV = sizeof(float) * (size_t)(4 * TILE + 2 * FSTILE);
};

// Rows [row0, row0 + 64) of an fp32 (S, FD) head slice times `mul` into dst;
// rows past S are zeros.
template <int FD>
__device__ __forceinline__ void tile_f32(float* dst, const float* src, int64_t row_stride, int row0,
                                         int S, float mul) {
  for (int i = threadIdx.x; i < FB * FD; i += FNT) {
    const int r = i / FD, c = i % FD, row = row0 + r;
    dst[r * F32Tile<FD>::FP + c] = row < S ? src[(int64_t)row * row_stride + c] * mul : 0.f;
  }
}

template <int FD>
__global__ void __launch_bounds__(FNT) flash_bwd_dq_f32_kernel(Params p) {
  constexpr int FP = F32Tile<FD>::FP, FTILE = F32Tile<FD>::TILE, DJ = F32Tile<FD>::DJ;
  extern __shared__ float smem[];
  float* Qs = smem;           // q~ rows of this block
  float* Os = Qs + FTILE;     // dO rows of this block
  float* Ks = Os + FTILE;     // key tile
  float* Vs = Ks + FTILE;     // value tile
  float* Ss = Vs + FTILE;     // ds tile (q rows x keys)
  __shared__ float lse_s[FB], del_s[FB];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FB;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ob = reinterpret_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  tile_f32<FD>(Qs, qb, p.q_ss, q0, p.Sq, p.qmul);
  tile_f32<FD>(Os, ob, p.o_ss, q0, p.Sq, 1.f);
  if (threadIdx.x < FB) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < p.Sq ? p.lse2[row_base(p, b, h) + row] : INFINITY;
    del_s[threadIdx.x] = row < p.Sq ? p.delta[row_base(p, b, h) + row] : 0.f;
  }

  const int tx = threadIdx.x % 16;  // column group: keys tx + 16 j, dq columns tx + 16 j
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < p.Sk; n0 += FB) {
    __syncthreads();  // the previous tile's Ks/Vs/Ss are no longer read
    tile_f32<FD>(Ks, kb, p.k_ss, n0, p.Sk, 1.f);
    tile_f32<FD>(Vs, vb, p.v_ss, n0, p.Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < FD; ++d) {
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
        Ss[r * FSP + c] = pv * (dp[i][j] - del_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < FB; ++n) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty * 4 + i) * FSP + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[n * FP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  float* dqb = reinterpret_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqb[(int64_t)row * p.dq_ss + tx + 16 * j] = acc[i][j] * p.scale;
  }
}

template <int FD>
__global__ void __launch_bounds__(FNT) flash_bwd_dkv_f32_kernel(Params p) {
  constexpr int FP = F32Tile<FD>::FP, FTILE = F32Tile<FD>::TILE, DJ = F32Tile<FD>::DJ;
  extern __shared__ float smem[];
  float* Ks = smem;           // key rows of this block
  float* Vs = Ks + FTILE;     // value rows of this block
  float* Qs = Vs + FTILE;     // q~ tile
  float* Os = Qs + FTILE;     // dO tile
  float* Ps = Os + FTILE;     // p^T tile (keys x q rows)
  float* Ss = Ps + FSTILE;    // ds^T tile
  __shared__ float lse_s[FB], del_s[FB];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * FB;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ob = reinterpret_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  tile_f32<FD>(Ks, kb, p.k_ss, k0, p.Sk, 1.f);
  tile_f32<FD>(Vs, vb, p.v_ss, k0, p.Sk, 1.f);

  const int tx = threadIdx.x % 16;  // q rows tx + 16 j of the tile; dk/dv columns tx + 16 j
  const int ty = threadIdx.x / 16;  // keys ty*4 .. ty*4+3
  float acck[4][DJ], accv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acck[i][j] = accv[i][j] = 0.f;

  for (int m0 = 0; m0 < p.Sq; m0 += FB) {
    __syncthreads();  // the previous tile's Qs/Os/Ps/Ss are no longer read
    tile_f32<FD>(Qs, qb, p.q_ss, m0, p.Sq, p.qmul);
    tile_f32<FD>(Os, ob, p.o_ss, m0, p.Sq, 1.f);
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
    for (int d = 0; d < FD; ++d) {
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
        Ps[r * FSP + c] = pv;
        Ss[r * FSP + c] = pv * (dp[i][j] - del_s[c]);
      }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < FB; ++n) {
      float pt[4], st[4], o[DJ], a[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = Ps[(ty * 4 + i) * FSP + n];
        st[i] = Ss[(ty * 4 + i) * FSP + n];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        o[j] = Os[n * FP + tx + 16 * j];
        a[j] = Qs[n * FP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
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
    for (int j = 0; j < DJ; ++j) {
      dkb[(int64_t)row * p.dk_ss + tx + 16 * j] = acck[i][j] * kLn2;
      dvb[(int64_t)row * p.dv_ss + tx + 16 * j] = accv[i][j];
    }
  }
}

template <int FD>
cudaError_t launch_f32_at(const Params& p, bool dkv, cudaStream_t stream) {
  const size_t smem = dkv ? F32Tile<FD>::SMEM_DKV : F32Tile<FD>::SMEM_DQ;
  void (*kernel)(Params) = flash_bwd_dq_f32_kernel<FD>;
  if (dkv) kernel = flash_bwd_dkv_f32_kernel<FD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((dkv ? p.Sk : p.Sq) + FB - 1) / FB, p.H, p.B);
  kernel<<<grid, FNT, smem, stream>>>(p);
  return cudaGetLastError();
}

// The fp32 kernels at head dim d: 16 (the JAX tiny presets), 64 or 128.
cudaError_t launch_f32(const Params& p, bool dkv, int d, cudaStream_t stream) {
  if (d == 16) return launch_f32_at<16>(p, dkv, stream);
  if (d == 64) return launch_f32_at<64>(p, dkv, stream);
  if (d == 128) return launch_f32_at<128>(p, dkv, stream);
  return cudaErrorInvalidValue;
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

// Rows g and g+8 of the warp's 16 (from row `row0`) of a 64 x (N / 2)
// accumulator (64 columns at N = 32, 128 at N = 64), times `mul`, to bf16
// rows of `out` (row stride `ss`); rows at or past S are skipped.
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, int64_t ss, int row0, int S, const float (&acc)[N],
                                          float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// Shared memory of tiles of `tile_bytes` (8 KB at head dim 64, 16 KB at 128):
// two resident tiles per consumer warpgroup, GSTAGES stages of two streamed
// tiles, the stages' lse2/Delta (K2b), the barriers, and 1 KB to align the
// tiles to the swizzle's 1024-byte period.
constexpr size_t g_smem(uint32_t tile_bytes) {
  return 1024 + (size_t)tile_bytes * 2 * (GWG + GSTAGES) + GSTAGES * 2 * GR * sizeof(float) +
         (3 * GSTAGES + 1) * sizeof(uint64_t);
}
constexpr size_t GSMEM = g_smem(GTILE_BYTES);

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

// The layout of g_smem over tiles of TILE elements.
template <int TILE>
__device__ __forceinline__ GLayout g_layout(uint8_t* raw) {
  GLayout L;
  L.res = reinterpret_cast<__nv_bfloat16*>(align1024(raw));
  L.ring = L.res + 2 * GWG * TILE;
  L.lse = reinterpret_cast<float*>(L.ring + 2 * GSTAGES * TILE);
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
  const GLayout L = g_layout<GTILE>(graw);
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
  const GLayout L = g_layout<GTILE>(graw);
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

// ---------------------------------------------------------------------------
// bf16, head dim 128: the same structure on 64 x 128 tiles (sm_90a)
// ---------------------------------------------------------------------------
constexpr int WD = 128;                       // head dim of this variant
constexpr int WTILE = GR * WD;                // elements of a 64 x 128 tile: 16 KB
constexpr uint32_t WTILE_BYTES = WTILE * 2;
constexpr uint32_t WATOM = GR * 128;          // bytes of one 64-column half (one swizzle atom wide) of a tile
constexpr int WQ = 32;                        // rows of a streamed tile a consumer step takes: half of it
constexpr size_t WSMEM = g_smem(WTILE_BYTES);  // 199,784 bytes
// K2b's registers a thread after setmaxnreg: the consumers' dK, dV, S^T, dP^T
// and p^T / ds^T fragments take 176; 2 x 232 + 40 is what the block launches
// with (3 x 128 x 168)
constexpr int WREGS_CONSUMER = 232;
constexpr int WREGS_PRODUCER = 40;
static_assert(2 * WREGS_CONSUMER + WREGS_PRODUCER == 3 * 168, "setmaxnreg moves registers within the block");

// Rows `row`..`row`+63 of head (b, h) of a (128, S, H, B) tensor map as one
// 64 x 128 tile: columns 0-63 into its first 8 KB, 64-127 into its second
// (a 128-wide bf16 row is two 128-byte swizzle lines). Rows past S arrive as
// zeros; the barrier counts both boxes' bytes.
__device__ __forceinline__ void tma_tile128(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                            int h, int b) {
  tma_load(dst, map, bar, 0, row, h, b);
  tma_load(dst + GR * 64, map, bar, 64, row, h, b);
}

// Byte offset of k-step kk (16 of the 128 head-dim columns) in a K-major
// 64 x 128 tile: steps 0-3 in the first half, 4-7 in the second.
__device__ __forceinline__ uint32_t kstep128(int kk) { return (kk >> 2) * WATOM + (kk & 3) * 32; }

// The descriptor of `tile`, `byte_offset` on, made opaque to the compiler.
// A descriptor's low bits hold the address / 16, so each k-step's descriptor
// is this one plus its offset / 16: one add where it is used. Left to
// itself, the compiler hoists the loop-invariant descriptors of the resident
// tiles out of the loop, 8 k-steps x 2 registers each; with that pressure
// ptxas serialized every wgmma (C7512) and spilled.
__device__ __forceinline__ uint64_t desc_at(const void* tile, uint32_t byte_offset, uint32_t lbo = 1) {
  uint64_t d = gdesc(tile, byte_offset, lbo);
  asm volatile("" : "+l"(d));
  return d;
}

// d (64 x 32) = R . C^T over the 128-wide head dim: R a resident K-major
// 64 x 128 tile, C the 32 rows from row `c_row` (0 or 32) of a streamed one.
__device__ __forceinline__ void wgmma_rows_cols128(float (&d)[16], const __nv_bfloat16* rows,
                                                   const __nv_bfloat16* cols, int c_row) {
  const uint64_t dr = desc_at(rows, 0), dc = desc_at(cols, c_row * 128);
#pragma unroll
  for (int kk = 0; kk < WD / 16; ++kk)
    wgmma_ss_n32(d, dr + (kstep128(kk) >> 4), dc + (kstep128(kk) >> 4), kk > 0);
}

// acc (+)= X . T: X (64 x 32) as bf16 A fragments (as in wgmma_x_tile), T
// the 32 rows from row `t_row` of a streamed 64 x 128 tile, contracted (read
// MN-major, N = 128 in two halves WATOM apart). The first use overwrites acc.
__device__ __forceinline__ void wgmma_x_tile128(float (&acc)[64], const uint32_t (&a)[2][4],
                                                const __nv_bfloat16* tile, int t_row, bool first) {
  const uint64_t dt = desc_at(tile, t_row * 128, WATOM >> 4);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wgmma_rs_t_n128(acc, a[kk], dt + (kk * 16 * 128 >> 4), kk > 0 || !first);
}

// q~ = q * qmul in fp32, rounded once, in place over the 16-byte vectors
// i0, i0 + step, ... of a 64 x 128 tile (the swizzle moves whole vectors,
// so the order does not matter).
__device__ __forceinline__ void scale_tile128(__nv_bfloat16* tile, int i0, int step, float qmul) {
#pragma unroll 2
  for (int i = i0; i < WTILE / 8; i += step) {
    uint4* v = reinterpret_cast<uint4*>(tile) + i;
    uint4 u = *v;
    __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(hv[e]);
      hv[e] = __floats2bfloat162_rn(f.x * qmul, f.y * qmul);
    }
    *v = u;
  }
}

// K2a at head dim 128: flash_bwd_dq_wgmma_kernel on 64 x 128 tiles, each
// streamed tile of 64 keys taken in two halves of 32. S and dP are m64n32
// (16 + 16 fp32 a thread), the dS fragments 8, dQ m64n128 (64): 104 a
// thread. With whole 64-key steps (S and dP m64n64, 144 with dQ and the
// fragments) ptxas serialized every wgmma (C7512): a block of 288 threads
// gets at most 168 registers a thread (a 183-register build was refused at
// launch for too many resources), and setmaxnreg with a producer warpgroup
// did not change that. Each loop keeps one copy of its body (unroll 1): an
// unrolled copy got other registers for the accumulators in flight, and
// ptxas serialized and spilled.
__global__ void __launch_bounds__(GNT_DQ, 1)
    flash_bwd_dq_wgmma128_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                                 Params p) {
  extern __shared__ uint8_t graw[];
  const GLayout L = g_layout<WTILE>(graw);
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
      mbar_arrive_tx(L.res_full, 2 * GWG * WTILE_BYTES);
      for (int w = 0; w < GWG; ++w) {
        tma_tile128(L.res + w * WTILE, &tq, L.res_full, q0 + w * GR, h, b);
        tma_tile128(L.res + (GWG + w) * WTILE, &to, L.res_full, q0 + w * GR, h, b);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % GSTAGES;
        if (n >= GSTAGES) mbar_wait(&L.empty[s], (n / GSTAGES - 1) & 1);
        mbar_arrive_tx(&L.full[s], 2 * WTILE_BYTES);
        tma_tile128(L.ring + 2 * s * WTILE, &tk, &L.full[s], n * GR, h, b);
        tma_tile128(L.ring + (2 * s + 1) * WTILE, &tv, &L.full[s], n * GR, h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int wr = wg * GR + (warp & 3) * 16;  // the warp's first row in the block
  __nv_bfloat16* Qw = L.res + wg * WTILE;
  const __nv_bfloat16* Ow = L.res + (GWG + wg) * WTILE;
  mbar_wait(L.res_full, 0);
  // q~ in place: generic-proxy writes that wgmma (the async proxy) reads next
  scale_tile128(Qw, threadIdx.x & 127, 128, p.qmul);
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
  float acc[64], s[16], dp[16];  // written first by wgmma (see wgmma_x_tile)
  uint32_t a[2][4];

  mbar_wait(&L.full[0], 0);
  wgmma_fence();
  wgmma_rows_cols128(s, Qw, L.ring, 0);
  wgmma_rows_cols128(dp, Ow, L.ring + WTILE, 0);
  wgmma_commit();
#pragma unroll 1
  for (int n = 0; n < ntiles; ++n) {
    const __nv_bfloat16* Kt = L.ring + 2 * (n % GSTAGES) * WTILE;
    const __nv_bfloat16* Vt = Kt + WTILE;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      wgmma_wait_all();  // S and dP of this half, and dQ of the one before
      fence_acc(s);
      fence_acc(dp);
      fence_acc(acc);
      if (half == 0 && n > 0 && lane == 0) mbar_arrive(&L.empty[(n - 1) % GSTAGES]);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {  // slots i, i+1: row r, keys col, col + 1
        const int r = (i >> 1) & 1, col = n * GR + half * WQ + (i >> 2) * 8 + 2 * t;
        const float p0 = exp2_ftz(fminf(s[i] - (col < p.Sk ? lse[r] : INFINITY), 0.f));  // p = 0 past Sk
        const float p1 = exp2_ftz(fminf(s[i + 1] - (col + 1 < p.Sk ? lse[r] : INFINITY), 0.f));
        a[i >> 3][(i >> 1) & 3] = pack_bf16(p0 * (dp[i] - del[r]), p1 * (dp[i + 1] - del[r]));  // ds
      }
      wgmma_fence();
      wgmma_x_tile128(acc, a, Kt, half * WQ, n == 0 && half == 0);  // dQ += dS . K
      wgmma_commit();
      // the next half's scores run behind this half's dQ
      if (half == 0) {
        wgmma_fence();
        wgmma_rows_cols128(s, Qw, Kt, WQ);
        wgmma_rows_cols128(dp, Ow, Vt, WQ);
        wgmma_commit();
      } else if (n + 1 < ntiles) {
        const int s1 = (n + 1) % GSTAGES;
        mbar_wait(&L.full[s1], ((n + 1) / GSTAGES) & 1);
        wgmma_fence();
        wgmma_rows_cols128(s, Qw, L.ring + 2 * s1 * WTILE, 0);
        wgmma_rows_cols128(dp, Ow, L.ring + (2 * s1 + 1) * WTILE, 0);
        wgmma_commit();
      }
    }
  }
  wgmma_wait_all();
  fence_acc(acc);

  auto* dqb = reinterpret_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_acc(dqb, p.dq_ss, q0 + wr, p.Sq, acc, p.scale);
}

// K2b at head dim 128: flash_bwd_dkv_wgmma_kernel on 64 x 128 tiles, with
// each streamed 64-row (q~, dO) tile taken by the consumers in two halves of
// 32 rows. dK and dV (m64n128) hold 64 + 64 fp32 a thread for the whole
// loop, so the scores of a half are m64n32, S^T and dP^T 16 + 16, and its
// p^T / ds^T fragments 8 + 8: 176 a thread with the next half's scores
// issued behind this half's dK and dV (whole 64-row steps would need 224
// before addresses). One copy of each loop body, as in K2a.
__global__ void __launch_bounds__(GNT_DKV, 1)
    flash_bwd_dkv_wgmma128_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                                  Params p) {
  extern __shared__ uint8_t graw[];
  const GLayout L = g_layout<WTILE>(graw);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WREGS_PRODUCER));
    const int pt = threadIdx.x - 128 * GWG;
    if (pt == 0) {
      mbar_arrive_tx(L.res_full, 2 * GWG * WTILE_BYTES);
      for (int w = 0; w < GWG; ++w) {
        tma_tile128(L.res + w * WTILE, &tk, L.res_full, k0 + w * GR, h, b);
        tma_tile128(L.res + (GWG + w) * WTILE, &tv, L.res_full, k0 + w * GR, h, b);
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
          mbar_arrive_tx(&L.land[s], 2 * WTILE_BYTES);
          tma_tile128(L.ring + 2 * s * WTILE, &tq, &L.land[s], n * GR, h, b);
          tma_tile128(L.ring + (2 * s + 1) * WTILE, &to, &L.land[s], n * GR, h, b);
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
      scale_tile128(L.ring + 2 * s * WTILE, pt, 128, p.qmul);  // read by wgmma once the stage is full
      if (pt < GR) {
        L.lse[s * GR + pt] = lse_m;
        L.del[s * GR + pt] = del_m;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&L.full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WREGS_CONSUMER));
  const int wg = warp >> 2, t = lane & 3;
  const int wr = wg * GR + (warp & 3) * 16;  // the warp's first key in the block
  const __nv_bfloat16* Kw = L.res + wg * WTILE;
  const __nv_bfloat16* Vw = L.res + (GWG + wg) * WTILE;
  float acck[64], accv[64], st[16], dpt[16];  // written first by wgmma (see wgmma_x_tile)
  uint32_t pa[2][4], sa[2][4];
  mbar_wait(L.res_full, 0);

  mbar_wait(&L.full[0], 0);
  wgmma_fence();
  wgmma_rows_cols128(st, Kw, L.ring, 0);  // transposed scores: rows are keys, columns q rows
  wgmma_rows_cols128(dpt, Vw, L.ring + WTILE, 0);
  wgmma_commit();
#pragma unroll 1
  for (int n = 0; n < ntiles; ++n) {
    const int stage = n % GSTAGES;
    const __nv_bfloat16* Qt = L.ring + 2 * stage * WTILE;
    const __nv_bfloat16* Ot = Qt + WTILE;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const float* lse = L.lse + stage * GR + half * WQ;
      const float* del = L.del + stage * GR + half * WQ;
      wgmma_wait_all();  // S^T and dP^T of this half, and dK, dV of the one before
      fence_acc(st);
      fence_acc(dpt);
      fence_acc(acck);
      fence_acc(accv);
      if (half == 0 && n > 0 && lane == 0) mbar_arrive(&L.empty[(n - 1) % GSTAGES]);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {  // slots i, i+1: one key, q rows c, c + 1 of the half
        const int c = (i >> 2) * 8 + 2 * t;
        const float p0 = exp2_ftz(fminf(st[i] - lse[c], 0.f)), p1 = exp2_ftz(fminf(st[i + 1] - lse[c + 1], 0.f));
        pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);                                               // p^T
        sa[i >> 3][(i >> 1) & 3] = pack_bf16(p0 * (dpt[i] - del[c]), p1 * (dpt[i + 1] - del[c + 1]));  // ds^T
      }
      wgmma_fence();
      wgmma_x_tile128(accv, pa, Ot, half * WQ, n == 0 && half == 0);  // dV += P^T . dO
      wgmma_x_tile128(acck, sa, Qt, half * WQ, n == 0 && half == 0);  // dK += dS^T . q~
      wgmma_commit();
      // the next half's scores run behind this half's dK, dV
      if (half == 0) {
        wgmma_fence();
        wgmma_rows_cols128(st, Kw, Qt, WQ);
        wgmma_rows_cols128(dpt, Vw, Ot, WQ);
        wgmma_commit();
      } else if (n + 1 < ntiles) {
        const int s1 = (n + 1) % GSTAGES;
        mbar_wait(&L.full[s1], ((n + 1) / GSTAGES) & 1);
        wgmma_fence();
        wgmma_rows_cols128(st, Kw, L.ring + 2 * s1 * WTILE, 0);
        wgmma_rows_cols128(dpt, Vw, L.ring + (2 * s1 + 1) * WTILE, 0);
        wgmma_commit();
      }
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

// tma: 4 x 12 geometry values, of q, k, v and dO in that order, each a map
// of 64 x 64 boxes (hopper.cuh's encode_map) of head dim d, 64 or 128.
cudaError_t launch_wgmma(const Params& p, bool dkv, int d, const long long* tma, cudaStream_t stream) {
  if (tma == nullptr) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_map(&maps[i], ptrs[i], tma + 12 * i, d, 64, GR);
    if (err != cudaSuccess) return err;
  }
  auto kernel = d == D ? (dkv ? flash_bwd_dkv_wgmma_kernel : flash_bwd_dq_wgmma_kernel)
                       : (dkv ? flash_bwd_dkv_wgmma128_kernel : flash_bwd_dq_wgmma128_kernel);
  const size_t smem = d == D ? GSMEM : WSMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((dkv ? p.Sk : p.Sq) + GWG * GR - 1) / (GWG * GR), p.H, p.B);
  kernel<<<grid, dkv ? GNT_DKV : GNT_DQ, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// The wgmma variants read their operands by TMA (16-byte aligned addresses
// and byte strides) and store bf16 pairs: every pointer and stride they
// touch must keep 8-element (16-byte) alignment.
bool aligned16(const Params& p, bool dkv) {
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
  const cudaError_t bound = bind_device_of(p.q);
  if (bound != cudaSuccess) return (int)bound;
  if (dtype == 0) return (int)launch_f32(p, dkv, d, s);
  if (dtype != 1 || (d != D && d != WD) || !aligned16(p, dkv)) return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma(p, dkv, d, tma, s);
}

}  // namespace

extern "C" {

// Common arguments: q, k, v, dout (B, H, S, d) in one type; lse2 (base-2
// lse) and delta fp32 contiguous (B, H, Sq); d: head dim, 16, 64 or 128 for
// float32, 64 or 128 for bfloat16; dtype: 0 = float32, 1 = bfloat16 (16-byte
// aligned pointers and strides); qmul: scale * log2(e) rounded to the input
// type; tma: for bf16 (head dim 64 or 128), the TMA geometry of q, k, v and
// dout (4 x 12 values of 64 x 64 boxes, see encode_map), else null. Returns
// the cudaError_t of the launch (0 on success).

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

// Dynamic shared memory of the bf16 kernels at head dim d (64 or 128), bytes.
int flash_bwd_smem_bytes(int d) { return (int)(d == WD ? WSMEM : GSMEM); }

}  // extern "C"
