// The bf16 flash-attention forward for Hopper (sm_90a), shared by K1
// (`qknorm_flash_fwd.cu`, the RMS qk-norm fused in, head dim 64) and K3
// (`flash_fwd.cu`, plain, head dim 64 or 128): one template over the head
// dim D and a NORM flag, instantiated by each source, which builds alone.
//
// Contract (both TPU kernels'): bf16 q (B, H, Sq, D), k/v (B, H, Sk, D)
// views read in place through their (b, h, s) strides. K3: q~ = bf16(q *
// qmul), qmul = bf16(scale * log2 e), rounded once. K1 (NORM): q~ =
// bf16(q * (rsqrt(mean(q^2) + eps) * (gq * scale * log2 e))) in fp32 with
// the per-position fp32 (Sq, D) map, rounded once; its keys arrive
// normalised the same way with gk (K1's pre-pass, qknorm_flash_fwd.cu).
// s = q~ k^T in fp32; keys past Sk get -1e30 (TMA's zero fill gives a score
// of 0, so they are masked here); base-2 online softmax; p rounded to bf16
// before PV, which accumulates in fp32; O = acc / l in bf16 through O's
// strides (head-interleaved as the wrapper allocates it); the natural-log
// lse = m ln2 + ln l, fp32 (B, H, Sq) contiguous; rows past Sq are never
// stored.
//
// What bounds it on an H100: the products (4 B H Sq Sk D FLOP at 989
// TFLOP/s) and, at D = 64, as much the exponentials: one ex2 a score at 16 a
// clock an SM (4.2e12/s over 132 SMs at 1.98 GHz), plus ~4 fp32 operations a
// score for the max, the subtraction, the sum and the packing. Done one after
// the other they cost more than the products; so two consumer warpgroups
// take turns on the tensor cores (a named-barrier ping-pong) and each one's
// softmax runs under the other's products.
//
// Design (FlashAttention-3's structure, written here from scratch): one
// block per (128 q rows, head, batch), 384 threads:
// * a producer warpgroup. One thread keeps a 4-stage ring of K and V tiles
//   in flight by cp.async.bulk.tensor from 4-D (D, S, H, B) tensor maps, with
//   full/empty mbarriers per stage and tile, K one tile ahead of V; the q
//   tile arrives by TMA once. The warpgroup's 128 threads turn it into q~ in
//   place, one row each, then fence.proxy.async between those generic-proxy
//   writes and the wgmma reads. K1's gq is indexed by the unswizzled column:
//   a 64-wide row is one 128-byte swizzle line whose 16-byte chunk c sits at
//   c ^ (row % 8); its row comes by 16-byte vector loads issued before the
//   q tile lands.
// * two consumer warpgroups of 64 q rows each, on key tiles of 128 (D = 64)
//   or 64 (D = 128: at 128 keys ptxas spilled the PV fragments and
//   serialized the products, C7512). S = q~ K^T is wgmma m64nBNk16 with both
//   operands in shared memory (K-major, 128B swizzle; at D = 128 a row is
//   two 64-column atoms and the k-steps 4..7 start in the second); O += P V
//   takes P from registers as A fragments and V as a transposed (MN-major) B,
//   m64nDk16, whose two 64-column halves at D = 128 lie one leading-byte
//   offset apart. Per key tile n a warpgroup issues S_n and PV_{n-1} back to
//   back, waits for S_n, runs the softmax of S_n (its exponentials in place)
//   while PV_{n-1} runs, then rescales O and packs P_n. Accumulators are
//   first written by a wgmma with scale-d 0 (the first tile), never zeroed
//   by other instructions.
// No block writes what another block reads, no atomics, no split over keys,
// and the key tile is fixed per (D, NORM): each output row depends on its
// own q row and its (b, h)'s keys in a fixed order, so rollout (B = 16
// under CFG), no-grad replay and the training forward give the same bits,
// and a batch slice gives the bits of the whole batch's rows.
#pragma once

#include "hopper.cuh"

namespace {

constexpr float kFwdNegInf = -1e30f;
constexpr float kFwdLn2 = 0.6931471805599453f;
constexpr int kFwdThreads = 384;  // two consumer warpgroups, then the producer warpgroup

struct FwdParams {
  const float* gq;  // K1: (Sq, D) fp32 scale map; else null
  const float* gk;  // K1: (Sk, D)
  __nv_bfloat16* o;
  float* lse;  // (B, H, Sq) contiguous
  int B, H, Sq, Sk;
  int64_t o_sb, o_sh, o_ss;
  float qmul;  // K3: bf16(scale * log2 e); K1: scale * log2 e, folded into gq
  float eps;
};

template <int D, bool NORM>
struct FwdShape {
  static constexpr int BM = 128;             // q rows a block: two consumer warpgroups of 64
  static constexpr int BN = D == 64 ? 128 : 64;  // keys a tile: the TMA box rows of k and v
  static constexpr int ATOMS = D / 64;       // 64-column (128-byte) halves of a row: TMA boxes a tile
  static constexpr int STAGES = 4;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr uint32_t Q_ATOM = BM * 128;      // bytes of one 64-column half of the q tile
  static constexpr uint32_t KV_ATOM = BN * 128;
  // Registers a thread after setmaxnreg. The block starts with 3 x 128 x 168
  // and setmaxnreg moves registers only within it: 2 x consumer + producer
  // must be 504, else a consumer's setmaxnreg.inc waits forever. K1's
  // producer holds a gamma row (64 fp32) in flight while it normalises.
  static constexpr int REGS_CONSUMER = NORM ? 200 : 232;
  static constexpr int REGS_PRODUCER = NORM ? 104 : 40;
  static constexpr int NBARS = 2 + 4 * STAGES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * (size_t)STAGES * KV_BYTES + NBARS * sizeof(uint64_t);
  static_assert(2 * REGS_CONSUMER + REGS_PRODUCER == 3 * 168, "setmaxnreg moves registers within the block");
  static_assert(D % 64 == 0 && (!NORM || D == 64), "K1: one 64-wide q row a producer thread");
};

// In place, row r of a swizzled (ATOMS x rows x 64) bf16 tile times `mul`,
// each value rounded once: K3's q~. Each thread walks its row's 16-byte
// chunks in logical order, which the swizzle spreads over the banks: the 8
// rows of a quarter-warp hit 8 different chunk positions.
template <int D>
__device__ __forceinline__ void scale_row(__nv_bfloat16* tile, int rows, int r, float mul) {
  uint8_t* row = reinterpret_cast<uint8_t*>(tile) + r * 128;
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint4* v = reinterpret_cast<uint4*>(row + a * rows * 128 + (c ^ (r & 7)) * 16);
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

// The 64 fp32 of gamma's row `pos` (clamped to S - 1: rows past S are zeros
// and stay zeros), by 16-byte loads issued together, before the tile they
// scale lands: one round trip to L2 a row, not one a chunk.
__device__ __forceinline__ void load_gamma(float4 (&gv)[16], const float* g, int pos, int S) {
  const float4* row = reinterpret_cast<const float4*>(g + (int64_t)min(pos, S - 1) * 64);
#pragma unroll
  for (int i = 0; i < 16; ++i) gv[i] = __ldg(row + i);
}

// In place, row r of a swizzled 64-column bf16 tile RMS-normalised in fp32:
// bf16(x * (rsqrt(mean(x^2) + eps) * (g * mul))), g indexed by the
// unswizzled column (logical chunk c holds columns 8c .. 8c + 7).
__device__ __forceinline__ void norm_row(__nv_bfloat16* tile, int r, const float4 (&gv)[16], float mul,
                                         float eps) {
  uint8_t* row = reinterpret_cast<uint8_t*>(tile) + r * 128;
  const int sw = r & 7;
  float ss[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: the sum is not one long dependency
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + (c ^ sw) * 16);
    const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(hv[e]);
      ss[e] += f.x * f.x;
      ss[e] += f.y * f.y;
    }
  }
  const float rs = rsqrtf(((ss[0] + ss[1]) + (ss[2] + ss[3])) / 64.f + eps);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint4* v = reinterpret_cast<uint4*>(row + (c ^ sw) * 16);
    uint4 u = *v;
    __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
    const float g[8] = {gv[2 * c].x, gv[2 * c].y, gv[2 * c].z, gv[2 * c].w,
                        gv[2 * c + 1].x, gv[2 * c + 1].y, gv[2 * c + 1].z, gv[2 * c + 1].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(hv[e]);
      hv[e] = __floats2bfloat162_rn(f.x * (rs * (g[2 * e] * mul)), f.y * (rs * (g[2 * e + 1] * mul)));
    }
    *v = u;
  }
}

template <int D, bool NORM>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, FwdParams p) {
  using S = FwdShape<D, NORM>;
  constexpr int BM = S::BM, BN = S::BN, ATOMS = S::ATOMS, STAGES = S::STAGES;
  extern __shared__ uint8_t fraw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(align1024(fraw));  // [ATOMS][BM][64]
  __nv_bfloat16* Ks = Qs + BM * D;                                         // [STAGES][ATOMS][BN][64]
  __nv_bfloat16* Vs = Ks + STAGES * BN * D;                                // [STAGES][ATOMS][BN][64]
  uint64_t* land_q = reinterpret_cast<uint64_t*>(Vs + STAGES * BN * D);    // the q tile's bytes
  uint64_t* full_q = land_q + 1;       // the producer's threads: q~ is in place
  uint64_t* full_k = full_q + 1;       // [STAGES] the TMA bytes
  uint64_t* full_v = full_k + STAGES;  // [STAGES] the TMA bytes
  uint64_t* empty_k = full_v + STAGES; // [STAGES] every consumer warp is done with the K tile
  uint64_t* empty_v = empty_k + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int ntiles = (p.Sk + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(land_q, 1);
    mbar_init(full_q, 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::REGS_PRODUCER));
    const int pt = threadIdx.x - 256;
    auto load = [&](const CUtensorMap* map, __nv_bfloat16* ring, uint64_t* full, int j) {
      const int s = j % STAGES;
      mbar_arrive_tx(&full[s], S::KV_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) tma_load(ring + (s * ATOMS + a) * BN * 64, map, &full[s], 64 * a, j * BN, h, b);
    };
    if (pt == 0) {
      mbar_arrive_tx(land_q, S::Q_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) tma_load(Qs + a * BM * 64, &tq, land_q, 64 * a, q0, h, b);
      for (int j = 0; j < STAGES && j < ntiles; ++j) load(&tk, Ks, full_k, j);
      for (int j = 0; j < STAGES - 1 && j < ntiles; ++j) load(&tv, Vs, full_v, j);
    }
    // q~ in place, one row a thread; then the consumers may read it
    if constexpr (NORM) {
      float4 gv[16];
      load_gamma(gv, p.gq, q0 + pt, p.Sq);
      mbar_wait(land_q, 0);
      norm_row(Qs, pt, gv, p.qmul, p.eps);  // scale * log2 e folded into gq
    } else {
      mbar_wait(land_q, 0);
      scale_row<D>(Qs, BM, pt, p.qmul);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(full_q);
    if (pt != 0) return;
    // K_j and V_j reuse the stage of tile j - STAGES, which the consumers
    // release in their step j - STAGES (K) or j - STAGES + 1 (V).
    for (int n = 0; n < ntiles; ++n) {
      const int jv = n + STAGES - 1, jk = n + STAGES;
      if (jv < ntiles) {
        if (n > 0) mbar_wait(&empty_v[jv % STAGES], ((n - 1) / STAGES) & 1);
        load(&tv, Vs, full_v, jv);
      }
      if (jk < ntiles) {
        mbar_wait(&empty_k[n % STAGES], (n / STAGES) & 1);
        load(&tk, Ks, full_k, jk);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::REGS_CONSUMER));
  const int wg = warp >> 2, g8 = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + (warp & 3) * 16;  // the warp's first row in the block
  const uint32_t q_off = wg * 64 * 128;        // the warpgroup's 64 rows in each half of the q tile
  float s[BN / 2];                             // S of one tile: rows g8, g8 + 8 of the warp's 16
  float o[D / 2];                              // O, written first by the first PV (scale-d 0)
  uint32_t pa[BN / 16][4];                     // P as the A fragments of PV's 8 k-steps
  float m[2] = {kFwdNegInf, kFwdNegInf}, l[2] = {0.f, 0.f};

  auto issue_s = [&](int n) {  // S = q~ K_n^T
    const __nv_bfloat16* Kt = Ks + (n % STAGES) * ATOMS * BN * 64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = kk / 4, k32 = (kk % 4) * 32;
      if constexpr (BN == 128)
        wgmma_ss_n128(s, gdesc(Qs, a * S::Q_ATOM + q_off + k32), gdesc(Kt, a * S::KV_ATOM + k32), kk > 0);
      else
        wgmma_ss(s, gdesc(Qs, a * S::Q_ATOM + q_off + k32), gdesc(Kt, a * S::KV_ATOM + k32), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int n, bool first) {  // O (+)= P_n V_n
    const __nv_bfloat16* Vt = Vs + (n % STAGES) * ATOMS * BN * 64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (D == 64)
        wgmma_rs_t(o, pa[kk], gdesc(Vt, kk * 16 * 128), kk > 0 || !first);
      else
        wgmma_rs_t_n128(o, pa[kk], gdesc(Vt, kk * 16 * 128, S::KV_ATOM >> 4), kk > 0 || !first);
    }
    wgmma_commit();
  };
  // The online softmax of tile n on S in place (p, unrounded), the row
  // maxima and partial sums updated; alpha rescales the O of earlier tiles.
  // Slot 4j + 2r + e holds row r (g8 + 8r), column 8j + 2t + e. Both rows go
  // through one loop, each reduction in four chains: a single chain a row
  // would make the softmax a string of dependent operations that the two
  // consumer warps a scheduler cannot hide.
  auto softmax = [&](int n, float (&alpha)[2]) {
    if (n * BN + BN > p.Sk) {  // the ragged last tile: keys past Sk get -1e30
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n * BN + 8 * j + 2 * t + e >= p.Sk) s[4 * j + e] = s[4 * j + 2 + e] = kFwdNegInf;
    }
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[r][c] = fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]);
#pragma unroll
    for (int j = 4; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r][j & 3] = fmaxf(mx[r][j & 3], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    float mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mn[r] = fmaxf(m[r], mc);
      alpha[r] = exp2_ftz(m[r] - mn[r]);
      m[r] = mn[r];
    }
    float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // this thread's parts of the row sums
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = exp2_ftz(s[4 * j + 2 * r + e] - mn[r]);
          s[4 * j + 2 * r + e] = pv;
          rs[r][j & 3] += pv;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  };
  // p rounded to bf16: accumulator slots i, i+1 (one row, two adjacent
  // columns) become fragment pa[i / 8][i / 2 % 4]
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) pa[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
  };
  // Ping-pong: warpgroup w issues its products after bar.sync 1 + w, then
  // lets the other one issue (bar.arrive on its barrier); warpgroup 0 goes
  // first.
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  if (wg == 1) named_arrive(other_bar, 256);  // a thread may not arrive twice in a phase: the other one opens
  mbar_wait(full_q, 0);

  float alpha[2];
  mbar_wait(&full_k[0], 0);
  named_sync(my_bar, 256);
  issue_s(0);
  named_arrive(other_bar, 256);
  wgmma_wait_all();
  fence_acc(s);
  if (lane == 0) mbar_arrive(&empty_k[0]);
  softmax(0, alpha);
  pack_p();
  for (int n = 1; n < ntiles; ++n) {
    const int sk = n % STAGES, sv = (n - 1) % STAGES;
    mbar_wait(&full_k[sk], (n / STAGES) & 1);
    mbar_wait(&full_v[sv], ((n - 1) / STAGES) & 1);
    named_sync(my_bar, 256);
    issue_s(n);
    issue_pv(n - 1, n == 1);
    named_arrive(other_bar, 256);
    wgmma_wait_one();  // S_n; PV_{n-1} runs on under the softmax
    fence_acc(s);
    if (lane == 0) mbar_arrive(&empty_k[sk]);
    softmax(n, alpha);
    wgmma_wait_all();
    fence_acc(o);
    if (lane == 0) mbar_arrive(&empty_v[sv]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  const int last = ntiles - 1;
  mbar_wait(&full_v[last % STAGES], (last / STAGES) & 1);
  named_sync(my_bar, 256);
  issue_pv(last, ntiles == 1);
  named_arrive(other_bar, 256);
  wgmma_wait_all();
  fence_acc(o);
  if (wg == 0) named_sync(my_bar, 256);  // the other warpgroup's last arrival: the barrier ends balanced

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + wrow + g8 + 8 * r;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    if (t == 0) p.lse[((int64_t)b * p.H + h) * p.Sq + row] = m[r] * kFwdLn2 + logf(denom);
  }
}

// Launches flash_fwd_wgmma_kernel<D, NORM>. tma: the 3 x 12 geometry values
// of q, k and v (hopper.cuh's encode_map), with 64 x BM and 64 x BN boxes.
template <int D, bool NORM>
cudaError_t launch_fwd_wgmma(const FwdParams& p, const void* q, const void* k, const void* v, const long long* tma,
                             cudaStream_t stream) {
  using S = FwdShape<D, NORM>;
  if (tma == nullptr || p.B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Sk <= 0) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = encode_map(&maps[i], ptrs[i], tma + 12 * i, D, 64, i == 0 ? S::BM : S::BN);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, NORM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + S::BM - 1) / S::BM, p.H, p.B);
  flash_fwd_wgmma_kernel<D, NORM><<<grid, kFwdThreads, S::SMEM, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// The O pointer and strides keep 4-byte alignment of its bf16 pairs, and the
// gamma maps 16-byte alignment of their vector loads; q, k and v meet TMA's
// rules or encode_map refuses them.
bool fwd_aligned(const FwdParams& p) {
  auto a16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  if (p.o_sb % 2 || p.o_sh % 2 || p.o_ss % 2 || (reinterpret_cast<uintptr_t>(p.o) & 3)) return false;
  return p.gq == nullptr || (a16(p.gq) && a16(p.gk));
}

}  // namespace
