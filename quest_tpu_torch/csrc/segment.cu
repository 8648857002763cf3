// Segment kernel: one launch applies a whole segment of band stages to
// the state, one tile per thread block, in place.
//
// Replaces the TPU segment driver K1, _decoupled_kernel
// (quest_tpu/ops/pallas_band.py:1715), batch dimension included
// (compile_segment(..., batch=B), :1922), with the stage chain
// _apply_stages (:1528) for the stage kinds of the RCS statevector,
// density-matrix decoherence and batched-trajectory paths:
//   S1 b0   128x128 complex operator on lane bits 0-6       (:1135)
//   S2 b1   d x d operator on the lowest log2(d) row bits   (:1139)
//   S3 scb  2^w x 2^w operator over w scattered row bits    (:1156)
//   S4 sc   2x2 butterfly on one scattered row bit          (:1213)
//   S5 phase      all-ones controlled phase                 (:1256)
//   S6 parity     exp(-i theta/2 Z..Z)                      (:1273)
//   S7 multiphase m phases summed per element, one sincos   (:1289)
//   S8 diagvec    k-qubit diagonal: entry of a (2, 2^k) table chosen
//                 by the target-bit pattern, controls           (:1324)
//   S9 batchsel   per-state 2x2 (a trajectory's drawn Kraus branch) on
//                 one tile bit                             (:1345-1432)
//   S10 pair      Kraus pair on (op qubit, sliced qubit)        (:1435)
//
// Batch: one launch covers every tile of every state of a batch of B
// states laid end to end ((B, 2, 2^n) f32): blockIdx.y is the state,
// whose planes start state * 2 * 2^n floats in (64-bit offsets), and
// blockIdx.x the tile. S9 reads its state's row of a per-call selection
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
// Each block:
//   1. builds the global row id of each of its tile rows from blockIdx
//      (free row bits), the inner rows and the scattered bits — the
//      reference's _row_ids;
//   2. gathers the tile (2 planes x rows x 128 lanes f32, rows of 512
//      contiguous bytes, 16-byte loads) into dynamic shared memory;
//   3. runs the stage chain on the tile. A matrix stage is a batched
//      complex product over the `fibers` of the tile (all index bits but
//      the w contracted ones): each thread keeps RF fibers x RI outputs
//      in registers, reads the operand from global memory through L1/L2
//      and the tile from shared memory, and writes back after a barrier
//      (fibers are disjoint, so chunks of them update in place).
//      Predicates follow _mask_of: an element whose lane/row bits do not
//      match keeps its value. Plain fp32 FMA, 4 per complex MAC (2 when
//      the operator is real);
//   4. writes the tile back where it read it. Tiles partition the index
//      space, so the launch is in place.
//
// Bound on an H100 SXM: one pass moves 2 x 2^n x 4 B in and out (28q:
// 4 GiB, 1.3 ms at 3.35 TB/s), and a 128-wide complex matrix stage costs
// 2^n x 128 x 8 flops (28q: 2.7e11, 4 ms at 67 TFLOP/s of non-tensor
// fp32). Segments with 128-wide matrix stages are therefore bound by
// operations, not bytes; a pair (32 flop per amplitude) or a diagonal (6)
// leaves its pass bound by bytes. Left for later: tensor cores (wgmma/TMA, with
// an fp32-accurate split), overlapping the tile's load and store with
// the stage chain (cp.async/TMA rings), bank-conflict-free write-back
// for row-bit contractions, and keeping operands in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int LANE_BITS = 7;
constexpr int LANES = 1 << LANE_BITS;
constexpr int DESC_WORDS = 16;
constexpr int MAX_TILE_BITS = 14;
constexpr int MAX_MULTIPHASE_ROWS = 64;

// descriptor fields (quest_tpu_torch/ops/segment.py DESC_FIELDS)
enum {
  F_KIND = 0, F_DIM = 1, F_POS = 2, F_REAL = 3, F_SI = 4, F_SJ = 5,
  F_LANE_MASK = 6, F_LANE_WANT = 7, F_ROW_MASK = 8, F_ROW_WANT = 9,
  F_OP_OFF = 10, F_FORMS = 11, F_MASKED = 12, F_TARGETS = 13, F_POS2 = 14,
  F_SLOT = 15,
};
enum { K_MAT = 0, K_PHASE = 1, K_PARITY = 2, K_MULTIPHASE = 3, K_PAIR = 4,
       K_DIAGVEC = 5, K_BATCHSEL = 6 };
constexpr int SEL_WORDS = 8;       // one selection-table row
constexpr int MAX_GRID_BATCH = 65535;
constexpr int MAX_DIAG_TARGETS = 7;
constexpr int TARGET_BITS = 6;     // bits per qubit index in F_TARGETS

// shared memory after the two tile planes: row ids, multiphase rows
constexpr int EXTRA_WORDS = (1 << (MAX_TILE_BITS - LANE_BITS)) + 3 * MAX_MULTIPHASE_ROWS;

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

template <int D, bool REAL>
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

template <int D>
__device__ void mat_dispatch(const Tile& t, const long long* ds,
                             const float* __restrict__ ops) {
  if (ds[F_REAL]) mat_stage<D, true>(t, ds, ops);
  else mat_stage<D, false>(t, ds, ops);
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

__global__ void __launch_bounds__(NTHREADS, 1)
segment_kernel(float* __restrict__ amps_all, int n, int tile_bits,
               int inner_bits, unsigned scat_mask, unsigned free_mask,
               const long long* __restrict__ desc, int nstages,
               const float* __restrict__ ops, int batch,
               const float* __restrict__ sel) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int size = 1 << tile_bits;
  const int rows = size >> LANE_BITS;
  int* row_id = reinterpret_cast<int*>(smem + 2 * size);
  float* s_ang = reinterpret_cast<float*>(row_id + (1 << (MAX_TILE_BITS - LANE_BITS)));
  int* s_lm = reinterpret_cast<int*>(s_ang + MAX_MULTIPHASE_ROWS);
  int* s_rm = s_lm + MAX_MULTIPHASE_ROWS;
  const Tile t{smem, smem + size, row_id, tile_bits};

  // free row bits take the block index, low bits first, so neighbouring
  // blocks read neighbouring rows
  int base = 0;
  unsigned b = blockIdx.x;
  for (unsigned fm = free_mask; fm; fm &= fm - 1) {
    base |= static_cast<int>(b & 1u) << (__ffs(fm) - 1);
    b >>= 1;
  }
  for (int r = threadIdx.x; r < rows; r += NTHREADS) {
    int row = base | (r & ((1 << inner_bits) - 1));
    int k = inner_bits;
    for (unsigned sm = scat_mask; sm; sm &= sm - 1, ++k)
      row |= ((r >> k) & 1) << (__ffs(sm) - 1);
    row_id[r] = row;
  }
  __syncthreads();

  // 64-bit offsets: plane 1 of a 30-qubit state starts 2^30 floats in,
  // state s of a batch 2 * 2^n * s floats in
  const long long plane = 1LL << n;
  const int state = static_cast<int>(blockIdx.y);
  float* __restrict__ amps = amps_all + 2 * plane * state;
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

  for (int s = 0; s < nstages; ++s) {
    const long long* ds = desc + s * DESC_WORDS;
    const float* g = ops + ds[F_OP_OFF];
    switch (static_cast<int>(ds[F_KIND])) {
      case K_MAT:
        switch (static_cast<int>(ds[F_DIM])) {
          case 2: mat_dispatch<2>(t, ds, ops); break;
          case 4: mat_dispatch<4>(t, ds, ops); break;
          case 8: mat_dispatch<8>(t, ds, ops); break;
          case 16: mat_dispatch<16>(t, ds, ops); break;
          case 32: mat_dispatch<32>(t, ds, ops); break;
          case 64: mat_dispatch<64>(t, ds, ops); break;
          default: mat_dispatch<128>(t, ds, ops); break;
        }
        break;
      case K_PHASE: phase_stage(t, g); break;
      case K_PARITY: parity_stage(t, g); break;
      case K_MULTIPHASE: multiphase_stage(t, ds, g, s_ang, s_lm, s_rm); break;
      case K_PAIR: pair_stage(t, ds, g); break;
      case K_DIAGVEC: diagvec_stage(t, ds, g); break;
      case K_BATCHSEL:
        batchsel_stage(t, ds, sel + (ds[F_SLOT] * batch + state) * SEL_WORDS);
        break;
    }
    __syncthreads();
  }

#pragma unroll 4
  for (int k = threadIdx.x; k < 2 * n4; k += NTHREADS) {
    const int pl = k >= n4;
    const int kk = pl ? k - n4 : k;
    const long long off = pl * plane
        + (static_cast<long long>(row_id[kk >> 5]) << LANE_BITS);
    reinterpret_cast<float4*>(amps + off)[kk & 31] = (pl ? tim4 : tre4)[kk];
  }
}

}  // namespace

extern "C" {

// Layout constants the Python packer checks against before a launch.
int quest_segment_desc_words() { return DESC_WORDS; }
int quest_segment_max_tile_bits() { return MAX_TILE_BITS; }
int quest_segment_max_multiphase_rows() { return MAX_MULTIPHASE_ROWS; }

long long quest_segment_smem_bytes(int tile_bits) {
  return (2LL << tile_bits) * sizeof(float) + EXTRA_WORDS * 4LL;
}

const char* quest_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one segment over `batch` states on `stream` (`sel`: the
// selection table (slots, batch, 8), or null when no stage reads it).
// Returns the launch's cudaError_t: nothing is allocated and nothing is
// synchronised here.
int quest_segment_sweep(void* amps, int n, int tile_bits, int inner_bits,
                        unsigned scat_mask, unsigned free_mask,
                        const void* desc, int nstages, const void* ops,
                        long long blocks, int batch, const void* sel,
                        void* stream) {
  if (tile_bits < LANE_BITS + 3 || tile_bits > MAX_TILE_BITS
      || batch < 1 || batch > MAX_GRID_BATCH)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = quest_segment_smem_bytes(tile_bits);
  cudaError_t e = cudaFuncSetAttribute(
      segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(quest_segment_smem_bytes(MAX_TILE_BITS)));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  segment_kernel<<<grid, NTHREADS, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(amps), n, tile_bits, inner_bits, scat_mask,
      free_mask, static_cast<const long long*>(desc), nstages,
      static_cast<const float*>(ops), batch,
      static_cast<const float*>(sel));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
