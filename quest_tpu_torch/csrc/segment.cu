// Segment kernel: one launch applies a whole segment of band stages to
// the state, tile by tile, in place, under one of three drivers.
//
// Replaces the TPU segment drivers of compile_segment
// (quest_tpu/ops/pallas_band.py:1920), batch dimension included
// (compile_segment(..., batch=B), :1922), with the stage chain
// _apply_stages (:1528) for the stage kinds of the RCS statevector,
// density-matrix decoherence and batched-trajectory paths:
//   K1 _decoupled_kernel (:1715, the default; QUEST_FUSED_DRIVER=pipelined,
//      QUEST_FUSED_PIPELINE=1) -> ring_kernel<TIER, true>: persistent
//      blocks, a ring of 3 plane slots filled and drained by bulk async
//      copies, a slot refilled as soon as its store has READ it;
//   K2 _pipelined_kernel (:1628, QUEST_FUSED_PIPELINE=0) ->
//      ring_kernel<TIER, false>: the same walk with NBUF in-place plane
//      slots (QUEST_FUSED_NBUF, clamped to shared memory and the steps), a
//      slot refilled only once its store has LANDED;
//   K3 _segment_kernel (:1553, QUEST_FUSED_DRIVER=grid) ->
//      segment_kernel<TIER>: one block per tile (gather, chain,
//      write-back).
// Every driver runs the same run_chain<TIER> on the same tile contents, so
// the three give bit-identical planes; they differ only in when a tile's
// bytes move. Why planes and not tiles: a flagship tile is 2 planes of 64
// KiB, and the reference's 2 + 2 block rings (four tiles, 512 KiB) do not
// fit a block's 227 KB; three plane slots (192 KiB) do, and a tile may sit
// in any two slots (Tile carries re and im apart). See ring_kernel for the
// slot order.
// Batch: one launch covers every tile of every state of a batch of B
// states laid end to end ((B, 2, 2^n) f32), whose planes start state * 2 *
// 2^n floats in (64-bit offsets). Under K3 blockIdx.y is the state and
// blockIdx.x the tile; under K1/K2 a step s is tile s mod tiles of state
// s / tiles. S9 reads its state's row of a per-call selection
// table (slots, B, 8) that the caller writes on the device between
// launches. The TPU stage builds a 128-wide (or 2^(j+1)-wide) embedded
// operator from iota masks because the MXU wants a dot; here it is the
// butterfly it is — 2 complex MACs per amplitude on the bit's tile
// position (a lane bit, an inner row or a scattered axis alike), in
// place, the 8 scalars read once per block — a byte-bound pass inside a
// launch that is already paid for.
//
// S10 runs every PairStage form the Hopper planner emits (lane/scat,
// lane/sub, sub/scat, sc/scat) as one 4x4 butterfly on two tile index
// bits: the packer reduces the reference's 128x128 embedded blocks
// (lane and b1 forms, and _sublane_contract :1090) to their 2x2 cores,
// so a pair costs 4 complex MACs per amplitude, not a 128-wide
// contraction (2048 flop/amp). S8 reads its table through L1; targets
// may be lane, inner, scattered or free (block-index) bits, since the
// global index of every element is rebuilt from its tile row's id.
//
// Data-driven: the stage list is a device table of descriptors (one row
// of DESC_WORDS int64 per stage, packed by quest_tpu_torch/ops/segment.py)
// and one float buffer holding every operand in the reference's packing
// and orientation (G^T for b0, b1 and 128-wide scb; G for narrow scb and
// sc). One binary serves every segment whatever its angles, as the
// reference's compile_segment_cached serves every segment of one
// structure.
//
// For each tile, a block:
//   1. builds the global row id of each of its tile rows from the tile
//      index (free row bits), the inner rows and the scattered bits — the
//      reference's _row_ids;
//   2. brings the tile (2 planes x rows x 128 lanes f32, rows of 512
//      contiguous bytes) into dynamic shared memory: K3 with 16-byte loads,
//      K1/K2 with one cp.async.bulk per run of consecutive rows, ahead of
//      time;
//   3. runs the stage chain on the tile. A matrix stage is a batched
//      complex product over the `fibers` of the tile (all index bits but
//      the w contracted ones): each thread keeps RF fibers x RI outputs
//      in registers, reads the operand from global memory through L1/L2
//      and the tile from shared memory, and writes back after a barrier
//      (fibers are disjoint, so chunks of them update in place).
//      Predicates follow _mask_of: an element whose lane/row bits do not
//      match keeps its value. Plain fp32 FMA, 4 per complex MAC (2 when
//      the operator is real);
//   4. writes the tile back where it read it (K1/K2: bulk stores). Tiles
//      partition the index space, so the launch is in place.
//
// Bound on an H100 SXM: one pass moves 2 x 2^n x 4 B in and out (28q:
// 4 GiB, 1.28 ms at 3.35 TB/s; a stage-free segment is that copy and
// nothing else), and a 128-wide complex matrix stage costs
// 2^n x 128 x 8 flops (28q: 2.7e11, 4 ms at 67 TFLOP/s of non-tensor
// fp32). Segments with 128-wide matrix stages are therefore bound by
// operations, not bytes; a pair (32 flop per amplitude) or a diagonal (6)
// leaves its pass bound by bytes.
//
// S11, the matmul tiers. Replaces the HIGH and DEFAULT tiers of
// _mxu_dot_general (quest_tpu/ops/pallas_band.py:1039) inside the b0, b1
// and scb bodies of _apply_mat_stage. The kernel is instantiated once per
// tier (segment_kernel<TIER>), so the HIGHEST body keeps its registers.
//   HIGH: each f32 input x splits into hi = x & 0xFFFF0000 (exactly a
//     bf16) and lo = bf16_rn(x - hi); the stage sums hi*hi + hi*lo +
//     lo*hi with fp32 accumulation. DEFAULT: bf16_rn(x) of each input,
//     one product. Every bf16 rounding is round-to-nearest-even
//     (__float2bfloat16_rn), as tensor.to(torch.bfloat16) in the plain
//     version. A product of two bf16 values is exact in fp32, so kernel
//     and plain version differ only in the order of the fp32 sums.
//   Complex form: the real block [Xre Xim] . [[Gre^T, Gim^T], [-Gim^T,
//     Gre^T]]: four real products per complex product (two when the
//     operator is real), with no Gauss-trick sums rounded to bf16.
//   d >= 16: tensor cores, mma.sync.m16n8k16 bf16 -> f32. Fibers are the
//     M dimension, the contracted index K, the outputs N. The state tile
//     stays f32 in shared memory; each warp loads its A fragments through
//     the stage's position stride (the FMA body's addressing) and splits
//     or rounds them as it loads. The operator's B fragments come
//     pre-split from the operand buffer, in fragment order (16 or 32
//     bytes per lane per block, through L1/L2: a 128x128 operator's HIGH
//     planes are 128 KiB and do not fit beside the 128 KiB tile). Outputs
//     stay in registers until a barrier and are written in place, masked
//     by the predicates, as in the FMA body.
//   d < 16 (b1/scb at d = 2, 4, 8): CUDA-core FMAs on the tier-rounded
//     parts (exact products, fp32 sums) — the same function, no padding
//     of K to 16.
// Why tensor cores: at HIGH a 128-wide stage at 28 qubits is 3 x 2.75e11
// flop, 0.83 ms at 989 TFLOP/s of dense bf16, and at DEFAULT 0.28 ms, both
// under the pass's 1.28 ms of bytes: the tiers leave every matrix stage
// bound by bytes, where the fp32 FMA body is bound by operations (4.1 ms).
// The first form is mma.sync with A fragments read from the f32 tile
// (4-way bank conflicts); wgmma, TMA and a staged bf16 A are later work.
//
// The drivers and the pass bound. Under K3 a block (one per SM: 128 KiB of
// tile and 160-234 registers x 256 threads) loads, chains and stores in
// series, with ~16 KiB of loads in flight per SM: a byte-bound pass took
// ~3.2 ms against its 1.28 ms. K1 keeps a whole plane of loads in flight
// under the chain and lets the next tile's loads start as soon as the
// stores have read their slots, so a byte-bound pass can approach its
// bound; K2 is the reference's A/B control, its refills waiting for the
// writes to land. A producer warp, TMA tensor maps and wgmma are later
// work, as are bank-conflict-free write-back for row-bit contractions and
// operands kept in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int LANE_BITS = 7;
constexpr int LANES = 1 << LANE_BITS;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DESC_WORDS = 17;
constexpr int MAX_TILE_BITS = 14;
constexpr int MAX_MULTIPHASE_ROWS = 64;
constexpr int MAX_ROWS = 1 << (MAX_TILE_BITS - LANE_BITS);
constexpr int MAX_SLOTS = 8;       // plane slots of a ring (QUEST_FUSED_NBUF)

// descriptor fields (quest_tpu_torch/ops/segment.py DESC_FIELDS)
enum {
  F_KIND = 0, F_DIM = 1, F_POS = 2, F_REAL = 3, F_SI = 4, F_SJ = 5,
  F_LANE_MASK = 6, F_LANE_WANT = 7, F_ROW_MASK = 8, F_ROW_WANT = 9,
  F_OP_OFF = 10, F_FORMS = 11, F_MASKED = 12, F_TARGETS = 13, F_POS2 = 14,
  F_SLOT = 15, F_TIER = 16,
};
// matmul tiers (quest_tpu_torch/ops/segment.py TIER_CODE)
enum { T_HIGHEST = 0, T_HIGH = 1, T_DEFAULT = 2 };
constexpr int MMA_MIN_DIM = 16;
enum { K_MAT = 0, K_PHASE = 1, K_PARITY = 2, K_MULTIPHASE = 3, K_PAIR = 4,
       K_DIAGVEC = 5, K_BATCHSEL = 6 };
constexpr int SEL_WORDS = 8;       // one selection-table row
constexpr int MAX_GRID_BATCH = 65535;
constexpr int MAX_DIAG_TARGETS = 7;
constexpr int TARGET_BITS = 6;     // bits per qubit index in F_TARGETS

// shared memory after the tile's plane slots: row ids, multiphase rows
constexpr int EXTRA_WORDS = MAX_ROWS + 3 * MAX_MULTIPHASE_ROWS;

struct Tile {
  float* re;
  float* im;
  const int* row_id;   // global row id of each tile row
  int bits;            // index bits held: 7 lane bits + row bits
};

__device__ __forceinline__ int row_mask(float lo, float hi) {
  // row masks ride as f32 halves split at bit 15 (_row_halves)
  return static_cast<int>(lo) | (static_cast<int>(hi) << 15);
}

__host__ __device__ constexpr int log2i(int d) { return d <= 1 ? 0 : 1 + log2i(d >> 1); }

// The tier's parts of one f32 value: (hi, lo) at HIGH, (bf16_rn(x), 0) at
// DEFAULT, (x, 0) at HIGHEST.
template <int TIER>
__device__ __forceinline__ void tier_parts(float x, float& hi, float& lo) {
  if constexpr (TIER == T_HIGH) {
    hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
    lo = __bfloat162float(__float2bfloat16_rn(x - hi));
  } else if constexpr (TIER == T_DEFAULT) {
    hi = __bfloat162float(__float2bfloat16_rn(x));
    lo = 0.f;
  } else {
    hi = x;
    lo = 0.f;
  }
}

// acc + the tier's products of a = ah + al and x = xh + xl (each product
// of two bf16 values exact in fp32; fp32 sums)
template <int TIER>
__device__ __forceinline__ float tier_fma(float ah, float al, float xh,
                                          float xl, float acc) {
  acc = fmaf(ah, xh, acc);
  if constexpr (TIER == T_HIGH) acc = fmaf(al, xh, fmaf(ah, xl, acc));
  return acc;
}

template <int D, bool REAL, int TIER>
__device__ void mat_stage(const Tile& t, const long long* ds,
                          const float* __restrict__ ops) {
  constexpr int W = log2i(D);
  constexpr int TI = D < 32 ? D : 32;     // threads along the output index
  constexpr int RI = D / TI;              // outputs per thread
  constexpr int TF = NTHREADS / TI;       // threads along fibers
  constexpr int RF = D >= 64 ? 8 : 4;     // fibers per thread per chunk
  const int p = static_cast<int>(ds[F_POS]);
  const int si = static_cast<int>(ds[F_SI]);
  const int sj = static_cast<int>(ds[F_SJ]);
  const float* gre = ops + ds[F_OP_OFF];
  const float* gim = gre + D * D;
  const bool masked = ds[F_MASKED] != 0;
  const int lm = static_cast<int>(ds[F_LANE_MASK]);
  const int lw = static_cast<int>(ds[F_LANE_WANT]);
  const int rm = static_cast<int>(ds[F_ROW_MASK]);
  const int rw = static_cast<int>(ds[F_ROW_WANT]);
  const int nfib = 1 << (t.bits - W);
  const int lo_mask = (1 << p) - 1;
  const int ti = threadIdx.x % TI;
  const int tf = threadIdx.x / TI;

  for (int f0 = 0; f0 < nfib; f0 += TF * RF) {
    int base[RF];
    bool ok[RF];
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int f = f0 + tf + TF * r;
      ok[r] = f < nfib;
      const int fc = ok[r] ? f : 0;
      base[r] = ((fc >> p) << (p + W)) | (fc & lo_mask);
    }
    float ar[RF][RI], ai[RF][RI];
#pragma unroll
    for (int r = 0; r < RF; ++r)
#pragma unroll
      for (int q = 0; q < RI; ++q) { ar[r][q] = 0.f; ai[r][q] = 0.f; }

#pragma unroll 4
    for (int j = 0; j < D; ++j) {
      float gr[RI], gi[RI];
#pragma unroll
      for (int q = 0; q < RI; ++q) {
        const int o = (ti + TI * q) * si + j * sj;
        gr[q] = __ldg(gre + o);
        gi[q] = REAL ? 0.f : __ldg(gim + o);
      }
      const int jo = j << p;
      if constexpr (TIER == T_HIGHEST) {
#pragma unroll
        for (int r = 0; r < RF; ++r) {
          const float xr = t.re[base[r] + jo];
          const float xi = t.im[base[r] + jo];
#pragma unroll
          for (int q = 0; q < RI; ++q) {
            ar[r][q] = fmaf(gr[q], xr, ar[r][q]);
            ai[r][q] = fmaf(gr[q], xi, ai[r][q]);
            if (!REAL) {
              ar[r][q] = fmaf(-gi[q], xi, ar[r][q]);
              ai[r][q] = fmaf(gi[q], xr, ai[r][q]);
            }
          }
        }
      } else {
        // out_re += Gre x_re - Gim x_im, out_im += Gre x_im + Gim x_re,
        // each product over the tier's parts (the real-block form)
        float grh[RI], grl[RI], gih[RI], gil[RI];
#pragma unroll
        for (int q = 0; q < RI; ++q) {
          tier_parts<TIER>(gr[q], grh[q], grl[q]);
          tier_parts<TIER>(gi[q], gih[q], gil[q]);
        }
#pragma unroll
        for (int r = 0; r < RF; ++r) {
          float xrh, xrl, xih, xil;
          tier_parts<TIER>(t.re[base[r] + jo], xrh, xrl);
          tier_parts<TIER>(t.im[base[r] + jo], xih, xil);
#pragma unroll
          for (int q = 0; q < RI; ++q) {
            ar[r][q] = tier_fma<TIER>(grh[q], grl[q], xrh, xrl, ar[r][q]);
            ai[r][q] = tier_fma<TIER>(grh[q], grl[q], xih, xil, ai[r][q]);
            if (!REAL) {
              ar[r][q] = tier_fma<TIER>(-gih[q], -gil[q], xih, xil, ar[r][q]);
              ai[r][q] = tier_fma<TIER>(gih[q], gil[q], xrh, xrl, ai[r][q]);
            }
          }
        }
      }
    }
    __syncthreads();   // every read of this chunk's fibers is done
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      if (!ok[r]) continue;
#pragma unroll
      for (int q = 0; q < RI; ++q) {
        const int e = base[r] + ((ti + TI * q) << p);
        if (masked) {
          const int lane = e & ((1 << LANE_BITS) - 1);
          const int row = t.row_id[e >> LANE_BITS];
          if ((lane & lm) != lw || (row & rm) != rw) continue;
        }
        t.re[e] = ar[r][q];
        t.im[e] = ai[r][q];
      }
    }
    __syncthreads();
  }
}

// ---- tensor-core body of the HIGH and DEFAULT tiers (d >= 16) ----------

__device__ __forceinline__ uint32_t bf16x2_rn(float lo_k, float hi_k) {
  // the lower-k value in the low half, as mma's fragments want it
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A-fragment words of two neighbouring-k values: (hi, lo) parts at HIGH,
// (rn, unused) at DEFAULT
template <int TIER>
__device__ __forceinline__ void a_words(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (TIER == T_HIGH) {
    const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
    hi = __byte_perm(u0, u1, 0x7632);           // the two high halves
    lo = bf16x2_rn(x0 - __uint_as_float(u0 & 0xFFFF0000u),
                   x1 - __uint_as_float(u1 & 0xFFFF0000u));
  } else {
    hi = bf16x2_rn(x0, x1);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += the tier's products of A (parts a[0] = hi, a[1] = lo) and B (words
// bh = hi, bl = lo of the two B registers)
template <int TIER>
__device__ __forceinline__ void tier_mma(float (&c)[4],
                                         const uint32_t (&a)[2][4],
                                         uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
  mma_bf16(c, a[0], bh0, bh1);
  if constexpr (TIER == T_HIGH) {
    mma_bf16(c, a[0], bl0, bl1);
    mma_bf16(c, a[1], bh0, bh1);
  }
}

__device__ __forceinline__ float2 load_pair(const float* plane, int b, int j,
                                            int p) {
  // elements j and j+1 of the fiber at b (contracted bits at position p)
  if (p == 0) return *reinterpret_cast<const float2*>(plane + b + j);
  return make_float2(plane[b + (j << p)], plane[b + ((j + 1) << p)]);
}

template <int D, bool REAL, int TIER>
__device__ void mma_stage(const Tile& t, const long long* ds,
                          const float* __restrict__ ops) {
  constexpr int W = log2i(D);
  constexpr int KS = D / 16;                // input steps (mma K = 16)
  constexpr int WN = D == 128 ? 2 : 1;      // warps across the outputs
  constexpr int NTW = D / 8 / WN;           // 8-output blocks per warp
  constexpr int WM = NWARPS / WN;           // warps across the fibers
  constexpr int MT = D >= 64 ? 1 : 2;       // 16-fiber blocks per warp
  constexpr int CHUNK = WM * MT * 16;       // fibers per chunk
  constexpr int VEC = TIER == T_HIGH ? 2 : 1;   // uint4 per lane per block
  const int p = static_cast<int>(ds[F_POS]);
  const uint4* __restrict__ gw =
      reinterpret_cast<const uint4*>(ops + ds[F_OP_OFF]);
  const bool masked = ds[F_MASKED] != 0;
  const int lm = static_cast<int>(ds[F_LANE_MASK]);
  const int lw = static_cast<int>(ds[F_LANE_WANT]);
  const int rm = static_cast<int>(ds[F_ROW_MASK]);
  const int rw = static_cast<int>(ds[F_ROW_WANT]);
  const int nfib = 1 << (t.bits - W);
  const int lo_mask = (1 << p) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row group, column pair
  const int wn = warp % WN, wm = warp / WN;

  for (int f0 = 0; f0 < nfib; f0 += CHUNK) {
    const int fw = f0 + wm * MT * 16;       // this warp's first fiber
    const bool active = fw < nfib;          // warp-uniform
    int base[MT][2];
    bool ok[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {         // fragment rows g and g + 8
        const int f = fw + mt * 16 + g + 8 * h;
        ok[mt][h] = f < nfib;
        const int fc = ok[mt][h] ? f : 0;
        base[mt][h] = ((fc >> p) << (p + W)) | (fc & lo_mask);
      }
    float acc[MT][NTW][2][4];               // [..][..][re, im][fragment]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[mt][nt][0][c] = 0.f;
          acc[mt][nt][1][c] = 0.f;
        }
    if (active) {
#pragma unroll 1
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ar[MT][2][4], ai[MT][2][4];   // [..][hi, lo][register]
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {        // a0a1, a2a3, a4a5, a6a7
            const int b = base[mt][r & 1];
            const int j = ks * 16 + 2 * tq + 8 * (r >> 1);
            const float2 vr = load_pair(t.re, b, j, p);
            const float2 vi = load_pair(t.im, b, j, p);
            a_words<TIER>(vr.x, vr.y, ar[mt][0][r], ar[mt][1][r]);
            a_words<TIER>(vi.x, vi.y, ai[mt][0][r], ai[mt][1][r]);
          }
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const uint4* blk =
              gw + (((wn * NTW + nt) * KS + ks) * 32 + lane) * VEC;
          // HIGH: {re_hi w0, re_hi w1, re_lo w0, re_lo w1}, then im's;
          // DEFAULT: {re w0, re w1, im w0, im w1}
          const uint4 w0 = __ldg(blk);
          uint32_t rh0 = w0.x, rh1 = w0.y, rl0 = w0.z, rl1 = w0.w;
          uint32_t ih0, ih1, il0 = 0u, il1 = 0u;
          if constexpr (TIER == T_HIGH) {
            const uint4 w1 = __ldg(blk + 1);
            ih0 = w1.x; ih1 = w1.y; il0 = w1.z; il1 = w1.w;
          } else {
            ih0 = rl0; ih1 = rl1; rl0 = 0u; rl1 = 0u;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tier_mma<TIER>(acc[mt][nt][0], ar[mt], rh0, rh1, rl0, rl1);
            tier_mma<TIER>(acc[mt][nt][1], ai[mt], rh0, rh1, rl0, rl1);
            if (!REAL) {
              constexpr uint32_t NEG = 0x80008000u;   // -x: sign bits
              tier_mma<TIER>(acc[mt][nt][0], ai[mt], ih0 ^ NEG, ih1 ^ NEG,
                             il0 ^ NEG, il1 ^ NEG);
              tier_mma<TIER>(acc[mt][nt][1], ar[mt], ih0, ih1, il0, il1);
            }
          }
        }
      }
    }
    __syncthreads();   // every read of this chunk's fibers is done
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[mt][h]) continue;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = (wn * NTW + nt) * 8 + 2 * tq + e;
              const int el = base[mt][h] + (i << p);
              if (masked) {
                const int ln = el & ((1 << LANE_BITS) - 1);
                const int row = t.row_id[el >> LANE_BITS];
                if ((ln & lm) != lw || (row & rm) != rw) continue;
              }
              t.re[el] = acc[mt][nt][0][2 * h + e];
              t.im[el] = acc[mt][nt][1][2 * h + e];
            }
        }
    }
    __syncthreads();
  }
}

template <int D, int TIER>
__device__ void mat_dispatch(const Tile& t, const long long* ds,
                             const float* __restrict__ ops) {
  const bool real = ds[F_REAL] != 0;
  if constexpr (TIER != T_HIGHEST && D >= MMA_MIN_DIM) {
    if (real) mma_stage<D, true, TIER>(t, ds, ops);
    else mma_stage<D, false, TIER>(t, ds, ops);
  } else if constexpr (TIER != T_HIGHEST) {
    // narrow: the tier's FMA body; `sc` (descriptor tier HIGHEST) exact
    if (ds[F_TIER] == T_HIGHEST) {
      if (real) mat_stage<D, true, T_HIGHEST>(t, ds, ops);
      else mat_stage<D, false, T_HIGHEST>(t, ds, ops);
    } else if (real) {
      mat_stage<D, true, TIER>(t, ds, ops);
    } else {
      mat_stage<D, false, TIER>(t, ds, ops);
    }
  } else {
    if (real) mat_stage<D, true, T_HIGHEST>(t, ds, ops);
    else mat_stage<D, false, T_HIGHEST>(t, ds, ops);
  }
}

__device__ void phase_stage(const Tile& t, const float* __restrict__ g) {
  // (1, 8): [tre, tim, lane_mask, lane_want, row_mask_lo, row_mask_hi,
  //          row_want_lo, row_want_hi]
  const float tre = __ldg(g + 0), tim = __ldg(g + 1);
  const int lm = static_cast<int>(__ldg(g + 2));
  const int lw = static_cast<int>(__ldg(g + 3));
  const int rm = row_mask(__ldg(g + 4), __ldg(g + 5));
  const int rw = row_mask(__ldg(g + 6), __ldg(g + 7));
  const int size = 1 << t.bits;
  for (int e = threadIdx.x; e < size; e += NTHREADS) {
    const int lane = e & ((1 << LANE_BITS) - 1);
    const int row = t.row_id[e >> LANE_BITS];
    if ((lane & lm) == lw && (row & rm) == rw) {
      const float re = t.re[e], im = t.im[e];
      t.re[e] = re * tre - im * tim;
      t.im[e] = re * tim + im * tre;
    }
  }
}

__device__ void parity_stage(const Tile& t, const float* __restrict__ g) {
  // (1, 8): [cos, sin, lane_mask, row_mask_lo, row_mask_hi, 0, 0, 0]
  const float c = __ldg(g + 0), s = __ldg(g + 1);
  const int lm = static_cast<int>(__ldg(g + 2));
  const int rm = row_mask(__ldg(g + 3), __ldg(g + 4));
  const int size = 1 << t.bits;
  for (int e = threadIdx.x; e < size; e += NTHREADS) {
    const int lane = e & ((1 << LANE_BITS) - 1);
    const int row = t.row_id[e >> LANE_BITS];
    const int par = (__popc(lane & lm) ^ __popc(row & rm)) & 1;
    const float sn = par ? -s : s;
    const float re = t.re[e], im = t.im[e];
    t.re[e] = re * c + im * sn;
    t.im[e] = im * c - re * sn;
  }
}

__device__ void multiphase_stage(const Tile& t, const long long* ds,
                                 const float* __restrict__ g,
                                 float* s_ang, int* s_lm, int* s_rm) {
  // (m, 8) rows: [angle, lane_mask, row_mask_lo, row_mask_hi, 0, 0, 0, 0];
  // bit r of F_FORMS set: row r is a parity term, else an all-ones term
  const int m = static_cast<int>(ds[F_DIM]);
  const long long forms = ds[F_FORMS];
  for (int r = threadIdx.x; r < m; r += NTHREADS) {
    s_ang[r] = __ldg(g + 8 * r);
    s_lm[r] = static_cast<int>(__ldg(g + 8 * r + 1));
    s_rm[r] = row_mask(__ldg(g + 8 * r + 2), __ldg(g + 8 * r + 3));
  }
  __syncthreads();
  const int size = 1 << t.bits;
  for (int e = threadIdx.x; e < size; e += NTHREADS) {
    const int lane = e & ((1 << LANE_BITS) - 1);
    const int row = t.row_id[e >> LANE_BITS];
    float tot = 0.f;
    for (int r = 0; r < m; ++r) {
      const int lmr = s_lm[r], rmr = s_rm[r];
      if ((forms >> r) & 1) {
        const int par = (__popc(lane & lmr) ^ __popc(row & rmr)) & 1;
        tot += par ? -s_ang[r] : s_ang[r];
      } else if ((lane & lmr) == lmr && (row & rmr) == rmr) {
        tot += s_ang[r];
      }
    }
    float sn, cs;
    sincosf(tot, &sn, &cs);
    const float re = t.re[e], im = t.im[e];
    t.re[e] = re * cs - im * sn;
    t.im[e] = re * sn + im * cs;
  }
}

__device__ __forceinline__ bool selected(const Tile& t, int e, int lm, int lw,
                                         int rm, int rw) {
  return (e & lm) == lw && (t.row_id[e >> LANE_BITS] & rm) == rw;
}

__device__ void pair_stage(const Tile& t, const long long* ds,
                           const float* __restrict__ g) {
  // (2, 4, 2, 2) cores B[p][r * 2 + c][ao][ai]: sliced output r, sliced
  // input c, op-side output ao, input ai. Op bit at tile position F_POS,
  // sliced bit at F_POS2. Each thread owns whole fibers (the 4 elements
  // that differ in those two bits), so the update is in place.
  const int pa = static_cast<int>(ds[F_POS]);
  const int pb = static_cast<int>(ds[F_POS2]);
  const bool real = ds[F_REAL] != 0;
  const bool masked = ds[F_MASKED] != 0;
  const int lm = static_cast<int>(ds[F_LANE_MASK]);
  const int lw = static_cast<int>(ds[F_LANE_WANT]);
  const int rm = static_cast<int>(ds[F_ROW_MASK]);
  const int rw = static_cast<int>(ds[F_ROW_WANT]);
  float br[16], bi[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    br[k] = __ldg(g + k);
    bi[k] = real ? 0.f : __ldg(g + 16 + k);
  }
  const int lo = min(pa, pb), hi = max(pa, pb);
  const int nfib = 1 << (t.bits - 2);
  for (int f = threadIdx.x; f < nfib; f += NTHREADS) {
    int e = ((f >> lo) << (lo + 1)) | (f & ((1 << lo) - 1));
    e = ((e >> hi) << (hi + 1)) | (e & ((1 << hi) - 1));
    float xr[4], xi[4];
#pragma unroll
    for (int ca = 0; ca < 4; ++ca) {       // ca = c * 2 + ai
      const int a = e | ((ca >> 1) << pb) | ((ca & 1) << pa);
      xr[ca] = t.re[a];
      xi[ca] = t.im[a];
    }
#pragma unroll
    for (int ro = 0; ro < 4; ++ro) {       // ro = r * 2 + ao
      const int r = ro >> 1, ao = ro & 1;
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int ca = 0; ca < 4; ++ca) {
        const int k = (r * 2 + (ca >> 1)) * 4 + ao * 2 + (ca & 1);
        sr = fmaf(br[k], xr[ca], fmaf(-bi[k], xi[ca], sr));
        si = fmaf(br[k], xi[ca], fmaf(bi[k], xr[ca], si));
      }
      const int a = e | (r << pb) | (ao << pa);
      if (masked && !selected(t, a, lm, lw, rm, rw)) continue;
      t.re[a] = sr;
      t.im[a] = si;
    }
  }
}

__device__ void diagvec_stage(const Tile& t, const long long* ds,
                              const float* __restrict__ g) {
  // (2, 2^k) table: entry sum_j bit(targets[j]) << j of every element's
  // GLOBAL index (row id << 7 | lane); identity where predicates fail
  const int k = static_cast<int>(ds[F_DIM]);
  const long long packed = ds[F_TARGETS];
  const bool masked = ds[F_MASKED] != 0;
  const int lm = static_cast<int>(ds[F_LANE_MASK]);
  const int lw = static_cast<int>(ds[F_LANE_WANT]);
  const int rm = static_cast<int>(ds[F_ROW_MASK]);
  const int rw = static_cast<int>(ds[F_ROW_WANT]);
  int tq[MAX_DIAG_TARGETS];
#pragma unroll
  for (int j = 0; j < MAX_DIAG_TARGETS; ++j)
    tq[j] = static_cast<int>((packed >> (TARGET_BITS * j)) & 63);
  const float* gim = g + (1 << k);
  const int size = 1 << t.bits;
  for (int e = threadIdx.x; e < size; e += NTHREADS) {
    if (masked && !selected(t, e, lm, lw, rm, rw)) continue;
    const unsigned gidx = (static_cast<unsigned>(t.row_id[e >> LANE_BITS])
                           << LANE_BITS) | static_cast<unsigned>(e & (LANES - 1));
    int idx = 0;
#pragma unroll
    for (int j = 0; j < MAX_DIAG_TARGETS; ++j)
      if (j < k) idx |= static_cast<int>((gidx >> tq[j]) & 1u) << j;
    const float fr = __ldg(g + idx), fi = __ldg(gim + idx);
    const float re = t.re[e], im = t.im[e];
    t.re[e] = re * fr - im * fi;
    t.im[e] = re * fi + im * fr;
  }
}

__device__ void batchsel_stage(const Tile& t, const long long* ds,
                               const float* __restrict__ g) {
  // g: this state's selection row [g00re, g00im, g01re, g01im, g10re,
  // g10im, g11re, g11im]; new_0 = g00 x_0 + g01 x_1, new_1 = g10 x_0 +
  // g11 x_1 on tile bit F_POS. Each thread owns whole pairs: in place.
  const int p = static_cast<int>(ds[F_POS]);
  float v[SEL_WORDS];
#pragma unroll
  for (int j = 0; j < SEL_WORDS; ++j) v[j] = __ldg(g + j);
  const int npairs = 1 << (t.bits - 1);
  for (int f = threadIdx.x; f < npairs; f += NTHREADS) {
    const int e0 = ((f >> p) << (p + 1)) | (f & ((1 << p) - 1));
    const int e1 = e0 | (1 << p);
    const float r0 = t.re[e0], i0 = t.im[e0];
    const float r1 = t.re[e1], i1 = t.im[e1];
    t.re[e0] = fmaf(v[0], r0, fmaf(-v[1], i0, fmaf(v[2], r1, -v[3] * i1)));
    t.im[e0] = fmaf(v[0], i0, fmaf(v[1], r0, fmaf(v[2], i1, v[3] * r1)));
    t.re[e1] = fmaf(v[4], r0, fmaf(-v[5], i0, fmaf(v[6], r1, -v[7] * i1)));
    t.im[e1] = fmaf(v[4], i0, fmaf(v[5], r0, fmaf(v[6], i1, v[7] * r1)));
  }
}

// ---- the tile's rows, the stage chain ------------------------------------

// Row bits taken by the tile index: the free row bits, low bits first, so
// neighbouring tiles read neighbouring rows (a pdep of `tile` into
// `free_mask`).
__device__ __forceinline__ int tile_base(unsigned long long tile,
                                         unsigned free_mask) {
  int base = 0;
  for (unsigned fm = free_mask; fm; fm &= fm - 1) {
    base |= static_cast<int>(tile & 1ull) << (__ffs(fm) - 1);
    tile >>= 1;
  }
  return base;
}

// Global row id of tile row r: inner rows, then the scattered bits (the
// reference's _row_ids).
__device__ __forceinline__ int tile_row(int base, int r, int inner_bits,
                                        unsigned scat_mask) {
  int row = base | (r & ((1 << inner_bits) - 1));
  int k = inner_bits;
  for (unsigned sm = scat_mask; sm; sm &= sm - 1, ++k)
    row |= ((r >> k) & 1) << (__ffs(sm) - 1);
  return row;
}

struct SweepArgs {
  float* amps;          // the batch's planes, state s at 2 * 2^n * s floats
  int n, tile_bits, inner_bits;
  unsigned scat_mask, free_mask;
  const long long* desc;
  int nstages;
  const float* ops;
  int batch;
  const float* sel;
};

// The segment's stages on one resident tile, in order; every driver calls
// this one function, so the three schedules compute the same bits.
template <int TIER>
__device__ __forceinline__ void run_chain(const Tile& t, const SweepArgs& a,
                                          int state, float* s_ang, int* s_lm,
                                          int* s_rm) {
  for (int s = 0; s < a.nstages; ++s) {
    const long long* ds = a.desc + s * DESC_WORDS;
    const float* g = a.ops + ds[F_OP_OFF];
    switch (static_cast<int>(ds[F_KIND])) {
      case K_MAT:
        switch (static_cast<int>(ds[F_DIM])) {
          case 2: mat_dispatch<2, TIER>(t, ds, a.ops); break;
          case 4: mat_dispatch<4, TIER>(t, ds, a.ops); break;
          case 8: mat_dispatch<8, TIER>(t, ds, a.ops); break;
          case 16: mat_dispatch<16, TIER>(t, ds, a.ops); break;
          case 32: mat_dispatch<32, TIER>(t, ds, a.ops); break;
          case 64: mat_dispatch<64, TIER>(t, ds, a.ops); break;
          default: mat_dispatch<128, TIER>(t, ds, a.ops); break;
        }
        break;
      case K_PHASE: phase_stage(t, g); break;
      case K_PARITY: parity_stage(t, g); break;
      case K_MULTIPHASE: multiphase_stage(t, ds, g, s_ang, s_lm, s_rm); break;
      case K_PAIR: pair_stage(t, ds, g); break;
      case K_DIAGVEC: diagvec_stage(t, ds, g); break;
      case K_BATCHSEL:
        batchsel_stage(t, ds,
                       a.sel + (ds[F_SLOT] * a.batch + state) * SEL_WORDS);
        break;
    }
    __syncthreads();
  }
}

// ---- K3, the grid driver: one block per tile -----------------------------

template <int TIER>
__global__ void __launch_bounds__(NTHREADS, 1)
segment_kernel(SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int size = 1 << a.tile_bits;
  const int rows = size >> LANE_BITS;
  int* row_id = reinterpret_cast<int*>(smem + 2 * size);
  float* s_ang = reinterpret_cast<float*>(row_id + MAX_ROWS);
  int* s_lm = reinterpret_cast<int*>(s_ang + MAX_MULTIPHASE_ROWS);
  int* s_rm = s_lm + MAX_MULTIPHASE_ROWS;
  const Tile t{smem, smem + size, row_id, a.tile_bits};

  const int base = tile_base(blockIdx.x, a.free_mask);
  for (int r = threadIdx.x; r < rows; r += NTHREADS)
    row_id[r] = tile_row(base, r, a.inner_bits, a.scat_mask);
  __syncthreads();

  // 64-bit offsets: plane 1 of a 30-qubit state starts 2^30 floats in,
  // state s of a batch 2 * 2^n * s floats in
  const long long plane = 1LL << a.n;
  const int state = static_cast<int>(blockIdx.y);
  float* __restrict__ amps = a.amps + 2 * plane * state;
  const int n4 = rows * (1 << (LANE_BITS - 2));     // float4 per plane
  float4* tre4 = reinterpret_cast<float4*>(t.re);
  float4* tim4 = reinterpret_cast<float4*>(t.im);
#pragma unroll 4
  for (int k = threadIdx.x; k < 2 * n4; k += NTHREADS) {
    const int pl = k >= n4;
    const int kk = pl ? k - n4 : k;
    const long long off = pl * plane
        + (static_cast<long long>(row_id[kk >> 5]) << LANE_BITS);
    const float4 v = reinterpret_cast<const float4*>(amps + off)[kk & 31];
    (pl ? tim4 : tre4)[kk] = v;
  }
  __syncthreads();

  run_chain<TIER>(t, a, state, s_ang, s_lm, s_rm);

#pragma unroll 4
  for (int k = threadIdx.x; k < 2 * n4; k += NTHREADS) {
    const int pl = k >= n4;
    const int kk = pl ? k - n4 : k;
    const long long off = pl * plane
        + (static_cast<long long>(row_id[kk >> 5]) << LANE_BITS);
    reinterpret_cast<float4*>(amps + off)[kk & 31] = (pl ? tim4 : tre4)[kk];
  }
}

// ---- bulk async copies and mbarriers (sm_90) -----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` on the mbarrier's phase
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in the issuing thread's open bulk group
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N of this thread's bulk groups are pending: READ,
// until their sources have been read (the slot may be refilled); else
// until their writes have landed in device memory
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;" :: "n"(N) : "memory");
}

// order this thread's generic-proxy shared accesses before later
// async-proxy ones (a bulk store reading, a bulk load writing)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- K1 and K2: the persistent plane-slot ring ---------------------------
//
// The launch walks steps blockIdx.x, +gridDim.x, ... (tile = step mod
// tiles, state = step / tiles: the batch slowest, the reference's
// _step_index). A block's local step k holds planes j = 2k (re) and 2k + 1
// (im); plane j lives in slot j mod S of a ring of S plane slots, in place
// (loaded, chained and stored from the same slot). Warp 0 issues the
// copies: one bulk copy per run of 2^inner_bits consecutive rows (512
// bytes each; the run is contiguous in the state and in the slot), lane L
// for runs L, L + 32, ...; loads complete on the step's mbarrier (one
// arrival expecting both planes), stores go in one bulk group per plane
// and lane. At step k it
// issues the loads of planes [2k - 2 + S, 2k + S) (k = 0: [0, S)): the
// step's own im plane and S - 2 planes of read-ahead. Before refilling a
// slot it waits for the store of the slot's previous plane j - S, which is
// one of the two groups its lane committed last step:
//   ON_READ (K1): wait_group.read — the store has READ the slot; its write
//     to device memory may still be in flight (the reference's decoupled
//     rings: neither DMA direction gates the other). S = 3: re(k + 1)
//     loads under chain k, im(k + 1) as soon as re(k)'s store has read its
//     slot.
//   else (K2): wait_group — the store has LANDED (the reference's in-place
//     NBUF slots: in(s+1) waits for out(s+1-nbuf) to drain). S = 2 has no
//     read-ahead.
// The chain writes the tile with generic stores; fence.proxy.async and a
// barrier order them before the bulk store that reads them. Each lane
// waits for all of its stores to land before the block exits.

template <int TIER, bool ON_READ>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_kernel(SweepArgs a, int slots, long long steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int size = 1 << a.tile_bits;
  const int rows = size >> LANE_BITS;
  int* row_id = reinterpret_cast<int*>(smem + slots * size);
  float* s_ang = reinterpret_cast<float*>(row_id + MAX_ROWS);
  int* s_lm = reinterpret_cast<int*>(s_ang + MAX_MULTIPHASE_ROWS);
  int* s_rm = s_lm + MAX_MULTIPHASE_ROWS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_rm + MAX_MULTIPHASE_ROWS);

  const int tile_shift = a.n - a.tile_bits;         // log2 tiles per state
  const long long plane = 1LL << a.n;
  const unsigned plane_bytes = static_cast<unsigned>(size) * 4u;
  // the inner rows of a tile are consecutive rows of the state: one bulk
  // copy per run of 2^inner_bits rows (a whole plane when no bit is
  // scattered)
  const unsigned run_bytes = (LANES * 4u) << a.inner_bits;
  const int lane = threadIdx.x & 31;
  const int nk = static_cast<int>((steps - blockIdx.x + gridDim.x - 1)
                                  / gridDim.x);     // this block's steps
  if (threadIdx.x < slots) mbar_init(&bars[threadIdx.x], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  for (int k = 0; k < nk; ++k) {
    if (threadIdx.x < 32) {
      const int lo = k == 0 ? 0 : 2 * k - 2 + slots;
      const int hi = min(2 * k + slots, 2 * nk);
      for (int j = lo; j < hi; ++j) {
        if (j >= slots) {                // the slot's previous plane j - S
          if (j == lo) bulk_wait<1, ON_READ>();
          else bulk_wait<0, ON_READ>();
        }
        const int kj = j >> 1;
        const long long g = blockIdx.x + static_cast<long long>(kj) * gridDim.x;
        const float* src = a.amps
            + (2 * (g >> tile_shift) + (j & 1)) * plane;
        uint64_t* bar = &bars[kj % slots];
        if ((j & 1) == 0 && lane == 0) mbar_arrive_expect(bar, 2 * plane_bytes);
        __syncwarp();
        float* dst = smem + (j % slots) * size;
        const int base = tile_base(g & ((1ull << tile_shift) - 1), a.free_mask);
        for (int r = lane << a.inner_bits; r < rows; r += 32 << a.inner_bits) {
          const int row = tile_row(base, r, a.inner_bits, a.scat_mask);
          bulk_load(dst + r * LANES,
                    src + (static_cast<long long>(row) << LANE_BITS),
                    run_bytes, bar);
        }
      }
    }
    const long long g = blockIdx.x + static_cast<long long>(k) * gridDim.x;
    const int state = static_cast<int>(g >> tile_shift);
    const int base = tile_base(g & ((1ull << tile_shift) - 1), a.free_mask);
    for (int r = threadIdx.x; r < rows; r += NTHREADS)
      row_id[r] = tile_row(base, r, a.inner_bits, a.scat_mask);
    __syncthreads();
    mbar_wait(&bars[k % slots], (k / slots) & 1);

    const Tile t{smem + ((2 * k) % slots) * size,
                 smem + ((2 * k + 1) % slots) * size, row_id, a.tile_bits};
    run_chain<TIER>(t, a, state, s_ang, s_lm, s_rm);
    fence_proxy_async();
    __syncthreads();

    if (threadIdx.x < 32) {
      for (int p = 0; p < 2; ++p) {
        float* dst = a.amps + (2LL * state + p) * plane;
        const float* src = p ? t.im : t.re;
        for (int r = lane << a.inner_bits; r < rows; r += 32 << a.inner_bits) {
          const int row = tile_row(base, r, a.inner_bits, a.scat_mask);
          bulk_store(dst + (static_cast<long long>(row) << LANE_BITS),
                     src + r * LANES, run_bytes);
        }
        bulk_commit();
      }
    }
  }
  if (threadIdx.x < 32) bulk_wait<0, false>();   // every store has landed
}

// ---- launch --------------------------------------------------------------

enum { D_DECOUPLED = 0, D_INPLACE = 1, D_GRID = 2 };   // segment.py DRIVER_CODE
constexpr long long BLOCK_SMEM_LIMIT = 232448;   // opt-in max per block, sm_90

long long grid_smem_bytes(int tile_bits) {
  return (2LL << tile_bits) * sizeof(float) + EXTRA_WORDS * 4LL;
}

long long ring_smem_bytes(int tile_bits, int slots) {
  return static_cast<long long>(slots) * (4LL << tile_bits)
      + EXTRA_WORDS * 4LL + 8LL * slots;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, long long smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int TIER>
cudaError_t launch_grid(const SweepArgs& a, long long blocks, long long smem,
                        cudaStream_t stream) {
  cudaError_t e = set_smem(segment_kernel<TIER>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(a.batch));
  segment_kernel<TIER><<<grid, NTHREADS, static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

template <int TIER, bool ON_READ>
cudaError_t launch_ring(const SweepArgs& a, long long steps, int slots,
                        long long smem, cudaStream_t stream) {
  auto kernel = ring_kernel<TIER, ON_READ>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, static_cast<size_t>(smem))) != cudaSuccess)
    return e;
  // per_sm == 0 (the block does not fit an SM): launch one block per SM
  // and let the launch report why it is refused
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(steps < resident ? steps : resident);
  kernel<<<blocks, NTHREADS, static_cast<size_t>(smem), stream>>>(a, slots, steps);
  return cudaGetLastError();
}

template <int TIER>
cudaError_t launch(const SweepArgs& a, long long blocks, int driver,
                   int slots, long long smem, cudaStream_t stream) {
  const long long steps = blocks * a.batch;
  switch (driver) {
    case D_GRID: return launch_grid<TIER>(a, blocks, smem, stream);
    case D_DECOUPLED: return launch_ring<TIER, true>(a, steps, slots, smem, stream);
    case D_INPLACE: return launch_ring<TIER, false>(a, steps, slots, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Layout constants the Python packer checks against before a launch.
int quest_segment_desc_words() { return DESC_WORDS; }
int quest_segment_max_tile_bits() { return MAX_TILE_BITS; }
int quest_segment_max_multiphase_rows() { return MAX_MULTIPHASE_ROWS; }

// Least dynamic shared memory of one launch: the grid driver's two tile
// planes, or a ring of `slots` plane slots with one mbarrier each, beside
// the row ids and multiphase rows (band_plan.sweep_smem_bytes computes the
// same; the wrapper checks the two agree).
long long quest_segment_smem_bytes(int tile_bits, int driver, int slots) {
  return driver == D_GRID ? grid_smem_bytes(tile_bits)
                          : ring_smem_bytes(tile_bits, slots);
}

const char* quest_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one segment over `batch` states on `stream` (`sel`: the
// selection table (slots, batch, 8), or null when no stage reads it), the
// matrix stages at matmul `tier` (T_HIGHEST, T_HIGH or T_DEFAULT), under
// `driver` (D_DECOUPLED, D_INPLACE with `slots` plane slots, or D_GRID)
// with `smem` bytes of dynamic shared memory. Returns the launch's
// cudaError_t: nothing is allocated and nothing is synchronised here.
int quest_segment_sweep(void* amps, int n, int tile_bits, int inner_bits,
                        unsigned scat_mask, unsigned free_mask,
                        const void* desc, int nstages, const void* ops,
                        long long blocks, int batch, const void* sel,
                        int tier, int driver, int slots, long long smem,
                        void* stream) {
  if (tile_bits < LANE_BITS + 3 || tile_bits > MAX_TILE_BITS
      || batch < 1 || batch > MAX_GRID_BATCH || blocks < 1
      || (driver != D_GRID && (slots < 2 || slots > MAX_SLOTS))
      || smem < quest_segment_smem_bytes(tile_bits, driver, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs a{static_cast<float*>(amps), n, tile_bits, inner_bits,
                    scat_mask, free_mask, static_cast<const long long*>(desc),
                    nstages, static_cast<const float*>(ops), batch,
                    static_cast<const float*>(sel)};
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (tier) {
    case T_HIGHEST: e = launch<T_HIGHEST>(a, blocks, driver, slots, smem, st); break;
    case T_HIGH: e = launch<T_HIGH>(a, blocks, driver, slots, smem, st); break;
    case T_DEFAULT: e = launch<T_DEFAULT>(a, blocks, driver, slots, smem, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
