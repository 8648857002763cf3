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
//      blocks, a ring of 3 plane slots filled and drained by tensor-map
//      (TMA) copies, a slot refilled as soon as its store has READ it;
//   K2 _pipelined_kernel (:1628, QUEST_FUSED_PIPELINE=0) ->
//      ring_kernel<TIER, false>: the same walk with NBUF in-place plane
//      slots (QUEST_FUSED_NBUF, clamped to shared memory and the steps), a
//      slot refilled only once its store has LANDED;
//   K3 _segment_kernel (:1553, QUEST_FUSED_DRIVER=grid) ->
//      segment_kernel<TIER>: one block per tile (tensor-map loads, chain,
//      tensor-map stores).
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
// blockIdx.x the tile, and a batch above gridDim.y's 65535 launches in
// slices, each from its first state (SweepArgs::state0); under K1/K2 a
// step s is tile s mod tiles of state s / tiles, any B. S9 reads its
// state's row of a per-call selection
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
// contraction (2048 flop/amp). S8 copies its table (at most 1 KiB) to
// shared memory; targets may be lane, inner, scattered or free
// (block-index) bits: bit q of an element's global index is lane bit q (q
// < 7) or bit q - 7 of its tile row's id, as the reference's _bit_of
// (:1317) takes it.
//
// Data-driven: the stage list is a device table of descriptors (one row
// of DESC_WORDS int64 per stage, packed by quest_tpu_torch/ops/segment.py)
// and one float buffer holding every operand. Narrow matrix stages (d <
// 16, sc) keep the reference's packing and orientation (G^T for b0, b1
// and 128-wide scb; G for narrow scb and sc), read through strides; a
// matrix stage of d >= 16 is packed as the slices its body streams (see
// below). One binary serves every segment whatever its angles, as the
// reference's compile_segment_cached serves every segment of one
// structure.
//
// For each tile, a block:
//   1. builds the global row id of each of its tile rows from the tile
//      index (free row bits), the inner rows and the scattered bits — the
//      reference's _row_ids. A segment of S5 stages only launches just the
//      tiles it can change: free row bits that every stage's predicate
//      fixes are held at their value (SweepArgs::fixed_rows);
//   2. brings the tile (2 planes x rows x 128 lanes f32, rows of 512
//      contiguous bytes) into dynamic shared memory as cp.async.bulk.tensor
//      boxes of a tensor map that sees the scattered row bits as
//      dimensions (one request per plane on most of today's plans): K1/K2
//      ahead of time into their ring of plane slots, K3 while the block
//      writes its row ids and starts its operator ring;
//   3. runs the stage chain on the tile (a run of consecutive S5/S6
//      stages as one pass, diag_run). A matrix stage is a batched
//      complex product over the `fibers` of the tile (all index bits but
//      the w contracted ones), outputs kept in registers until a barrier
//      and written back in place (fibers are disjoint, so chunks of them
//      update in place). Predicates follow _mask_of: an element whose
//      lane/row bits do not match keeps its value;
//   4. writes the tile back where it read it, as tensor-map stores.
//      Tiles partition the index space, so the launch is in place.
//
// Matrix stages of d >= 16 (S1-S3 at every tier, S11) read their operator
// from shared memory: a ring of OP_SLOTS = 2 slices of OP_SLICE_BYTES =
// 16 KiB (OpRing), each filled by one cp.async.bulk completing on its own
// mbarrier; thread 0 keeps the next two slices of the block's sequence in
// flight, across stages and into the next tile, and one copy serves all 8
// warps. The ring fits beside K1's three 64 KiB plane slots (230,696 of
// 232,448 bytes at 14-bit tiles). A stage streams its operator once per
// chunk of 128 fibers, and at d = 128 on a 14-bit tile one chunk is the
// whole tile.
//   HIGHEST (fma_stage): IEEE fp32 FMAs, 4 per complex MAC (2 for a real
//     operator). A slice holds KB inputs, row j = [Gre[:, j], Gim[:, j]].
//     Each thread keeps 64 complex outputs in registers (d = 128) and
//     reads the operator as 16-byte loads: for b0 (contracted bits at
//     position 0) the lanes take 4 consecutive outputs each and a warp
//     16 fibers (x read as float4 over 4 inputs, broadcast in the warp;
//     outputs stored as float4); for row-bit contractions (position >= 7)
//     the lanes take consecutive fibers (conflict-free loads and stores)
//     and a warp 16 outputs (operator rows broadcast). 16-25 FMAs per
//     shared load.
//   HIGH and DEFAULT (mma_stage, S11): tensor cores, wgmma.mma_async
//     m64nDk16 bf16 -> f32, A (the fibers x inputs of the f32 tile, split
//     or rounded as it loads, as _mxu_dot_general's tiers do) from
//     registers, B (the operator's bf16 parts, packed on the host in the
//     layout wgmma reads) from the slice. Each warpgroup takes 64 fibers,
//     so the two cover a d = 128 tile in one pass; re and im accumulate
//     as m64nD f32 fragments (d registers per thread). Inputs and
//     outputs run in a permuted order inside each group of 16 (perm16,
//     the same on the host) so that at position 0 a thread reads its four
//     inputs as one float4 and stores four outputs as one float4; at
//     position >= 7 half the lanes take their second fragment row first,
//     so a load or store touches 16 fibers (banks), not 8.
//     HIGH: each f32 input x splits into hi = x & 0xFFFF0000 (exactly a
//     bf16) and lo = bf16_rn(x - hi); the stage sums hi*hi + hi*lo +
//     lo*hi with fp32 accumulation. DEFAULT: bf16_rn(x) of each input,
//     one product. Every bf16 rounding is round-to-nearest-even, as
//     tensor.to(torch.bfloat16) in the plain version. A product of two
//     bf16 values is exact in fp32, so kernel and plain version differ
//     only in the order of the fp32 sums. Complex form: the real block
//     [Xre Xim] . [[Gre^T, Gim^T], [-Gim^T, Gre^T]], the minus as wgmma's
//     negated A: four real products per complex product (two when the
//     operator is real), with no Gauss-trick sums rounded to bf16.
//   d < 16 (b1/scb at d = 2, 4, 8) and sc: CUDA-core FMAs on the operand
//     read through L1 (mat_narrow), at the tier's rounded parts for b1/scb.
//
// Bound on an H100 SXM: one pass moves 2 x 2^n x 4 B in and out (28q:
// 4 GiB, 1.28 ms at 3.35 TB/s; a stage-free segment is that copy and
// nothing else), and a 128-wide complex matrix stage costs
// 2^n x 128 x 8 flops (28q: 2.7e11, 4 ms at 67 TFLOP/s of non-tensor
// fp32). At HIGH a 128-wide stage is 3 x 2.75e11 tensor flop (0.83 ms at
// 989 TFLOP/s) and at DEFAULT 0.28 ms, both under the pass's bytes: the
// tiers leave every matrix stage bound by bytes, HIGHEST by operations; a
// pair (32 flop per amplitude) or a diagonal (6) leaves its pass bound by
// bytes.
//
// The drivers and the pass bound. Under K3 a block (one per SM: 128 KiB of
// tile) loads, chains and stores in series, but every SM has its whole
// tile of loads (or stores) in flight as boxes, so the SMs' phases
// overlap one another and a byte-bound pass runs at a copy_'s pace (with
// 16-byte loads, ~16 KiB in flight per SM, it took twice its 1.28 ms).
// K1 keeps a whole plane of loads in flight under its own chain and lets
// the next tile's loads start as soon as the stores have read their
// slots; K2 is the reference's A/B control, its refills waiting for the
// writes to land. The tensor map sees a tile's scattered row bits as
// dimensions, so a scattered-row tile moves in as few requests as an
// inner-row one (one box a plane on most plans of the paths, at most 4),
// all issued by one thread. A producer warp is later work.

#include <cuda.h>            // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Phase counters, in the build with -DQUEST_PHASE_COUNTERS only
// (quest_tpu_torch.profiling.segment_phase_report): thread 32 of every
// block (a compute warp, not the copy warp) adds the clock cycles of each
// phase to a device counter; K3's stores and whole block are thread 0's,
// which issues the stores and waits for them. Without the define the
// macros are empty.
enum { PC_SLICE_WAIT = 0, PC_SLICE_RELEASE = 1, PC_PROLOGUE = 2,
       PC_CHAIN = 3, PC_STORE = 4, PC_BLOCK = 5, PC_BLOCKS = 6,
       PC_COUNT = 7 };
#ifdef QUEST_PHASE_COUNTERS
__device__ unsigned long long quest_phase_cycles[PC_COUNT];
#define PHASE_START(v) const long long v = clock64()
#define PHASE_ADD_AT(tid, i, v)                                          \
  do {                                                                   \
    if (threadIdx.x == (tid))                                            \
      atomicAdd(&quest_phase_cycles[i],                                  \
                static_cast<unsigned long long>(clock64() - (v)));       \
  } while (0)
#define PHASE_COUNT(i)                                                   \
  do {                                                                   \
    if (threadIdx.x == 32) atomicAdd(&quest_phase_cycles[i], 1ull);      \
  } while (0)
#else
#define PHASE_START(v)
#define PHASE_ADD_AT(tid, i, v)
#define PHASE_COUNT(i)
#endif
#define PHASE_ADD(i, v) PHASE_ADD_AT(32, i, v)

namespace {

constexpr int NTHREADS = 256;
constexpr int LANE_BITS = 7;
constexpr int LANES = 1 << LANE_BITS;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DESC_WORDS = 18;
constexpr int MAX_TILE_BITS = 14;
constexpr int MAX_MULTIPHASE_ROWS = 64;
constexpr int MAX_ROWS = 1 << (MAX_TILE_BITS - LANE_BITS);
constexpr int MAX_SLOTS = 8;       // plane slots of a ring (QUEST_FUSED_NBUF)
constexpr int OP_SLOTS = 2;        // operator slices of the OpRing
constexpr int OP_SLICE_BYTES = 16384;
constexpr int OP_SLICE_FLOATS = OP_SLICE_BYTES / 4;

// descriptor fields (quest_tpu_torch/ops/segment.py DESC_FIELDS)
enum {
  F_KIND = 0, F_DIM = 1, F_POS = 2, F_REAL = 3, F_SI = 4, F_SJ = 5,
  F_LANE_MASK = 6, F_LANE_WANT = 7, F_ROW_MASK = 8, F_ROW_WANT = 9,
  F_OP_OFF = 10, F_FORMS = 11, F_MASKED = 12, F_TARGETS = 13, F_POS2 = 14,
  F_SLOT = 15, F_TIER = 16, F_RUN = 17,
};
// matmul tiers (quest_tpu_torch/ops/segment.py TIER_CODE)
enum { T_HIGHEST = 0, T_HIGH = 1, T_DEFAULT = 2 };
constexpr int SLICED_MIN_DIM = 16;   // d from which the operator is sliced
enum { K_MAT = 0, K_PHASE = 1, K_PARITY = 2, K_MULTIPHASE = 3, K_PAIR = 4,
       K_DIAGVEC = 5, K_BATCHSEL = 6 };
constexpr int SEL_WORDS = 8;       // one selection-table row
constexpr int MAX_GRID_BATCH = 65535;   // K3's gridDim.y: states per launch
constexpr int MAX_DIAG_TARGETS = 7;
constexpr int TARGET_BITS = 6;     // bits per qubit index in F_TARGETS
constexpr int DIAG_TABLE_WORDS = 2 << MAX_DIAG_TARGETS;   // S8's (2, 2^k)
constexpr int MAX_TMA_PARTS = 4;   // parts of a plane (band_plan.TMA_PARTS)
constexpr int TMA_ERROR_BASE = 10000;   // + CUresult of a failed encoding

// shared memory after the tile's plane slots: row ids, multiphase rows,
// S8's table or S7's per-row term bits (then the operator ring and the
// mbarriers)
constexpr int EXTRA_WORDS = MAX_ROWS + 3 * MAX_MULTIPHASE_ROWS
                            + DIAG_TABLE_WORDS;

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

// bulk_wait for a count known only at run time (0 .. 2 * MAX_TMA_PARTS -
// 1; a larger one waits for all but 7, which is stricter, never looser)
template <bool READ>
__device__ __forceinline__ void bulk_wait_n(int n) {
  switch (n) {
    case 0: bulk_wait<0, READ>(); break;
    case 1: bulk_wait<1, READ>(); break;
    case 2: bulk_wait<2, READ>(); break;
    case 3: bulk_wait<3, READ>(); break;
    case 4: bulk_wait<4, READ>(); break;
    case 5: bulk_wait<5, READ>(); break;
    case 6: bulk_wait<6, READ>(); break;
    default: bulk_wait<7, READ>(); break;
  }
}

// ---- tensor-map copies (TMA) ----------------------------------------------
//
// Every driver sees the batch's planes through one f32 tensor map of 5
// dimensions (band_plan.tma_boxes, which the wrapper checks against
// quest_segment_tma_geometry): the 128 lanes; the 2^s0 rows below the
// lowest scattered row bit s0; the 2^w rows of the lowest contiguous group
// of scattered bits; the rows above it; the 2B planes. A box is 2^b2 rows
// along dimension 2 times 2^b3 along dimension 3: 2^(b2 + b3) consecutive
// tile rows (inner rows, then the group's bits). A request's coordinates
// come from the global row of its first tile row; free bits and higher
// scattered groups ride in them.

struct CopyUnit {
  int s0, w;           // the map splits a state's rows at s0 and s0 + w
  int b2, b3;          // log2 of the box's rows along dimensions 2 and 3
  int parts_log2;      // a plane moves in 2^parts_log2 parts
};

// global -> shared: the box whose first row is global row `row` of plane
// `plane` (2 * state + re/im), completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         const CopyUnit& cu, int row,
                                         int plane, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(row & ((1 << cu.s0) - 1)), "r"((row >> cu.s0) & ((1 << cu.w) - 1)),
         "r"(row >> (cu.s0 + cu.w)), "r"(plane), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in the issuing thread's open bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const CopyUnit& cu, int row,
                                          int plane, const float* src) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4, %5}], [%6];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(row & ((1 << cu.s0) - 1)), "r"((row >> cu.s0) & ((1 << cu.w) - 1)),
         "r"(row >> (cu.s0 + cu.w)), "r"(plane), "r"(smem_addr(src))
      : "memory");
}

// ---- the operator ring ---------------------------------------------------
//
// OP_SLOTS slices of OP_SLICE_BYTES in shared memory, one mbarrier each.
// A matrix stage of d >= SLICED_MIN_DIM consumes `total` slices, slice q
// being slice q % per of its packed operator (one pass over the operator
// per chunk of SLICE_CHUNK fibers); the block consumes the stages' streams
// in chain order, tile after tile. Slice u of that sequence sits in slot
// u % OP_SLOTS and completes phase u / OP_SLOTS of the slot's barrier.
// Thread 0 is the producer: it keeps the next OP_SLOTS slices of the
// sequence in flight, across stages and into the block's next tile, and
// refills a slot once every thread has released it (a block barrier), so
// a stage's first slices land under the previous stage's work. It stops
// after the block's last tile: no copy is in flight at exit.

// One slice of a d-wide stage's operator in a kernel at `tier`: KB =
// fma_rows input rows [Gre[:, j], Gim[:, j]] at HIGHEST (fma_stage), or
// mma_ksteps k-steps of mma_parts wgmma B tiles (16 inputs x d outputs,
// bf16) at HIGH and DEFAULT (mma_stage).
__host__ __device__ constexpr int fma_rows(int d) {
  return d < OP_SLICE_FLOATS / (2 * d) ? d : OP_SLICE_FLOATS / (2 * d);
}
__host__ __device__ constexpr int mma_parts(int tier) {
  return tier == T_HIGH ? 4 : 2;
}
__host__ __device__ constexpr int mma_ksteps(int d, int tier) {
  return d / 16 < OP_SLICE_BYTES / (mma_parts(tier) * 32 * d)
             ? d / 16 : OP_SLICE_BYTES / (mma_parts(tier) * 32 * d);
}
__host__ __device__ constexpr int slice_bytes(int d, int tier) {
  return tier == T_HIGHEST ? fma_rows(d) * 2 * d * 4
                           : mma_ksteps(d, tier) * mma_parts(tier) * 32 * d;
}
__host__ __device__ constexpr int slices_per_pass(int d, int tier) {
  return tier == T_HIGHEST ? d / fma_rows(d) : d / 16 / mma_ksteps(d, tier);
}
constexpr int SLICE_CHUNK = 128;   // fibers per pass over the operator

struct OpRing {
  float* buf;                // OP_SLOTS x OP_SLICE_FLOATS
  uint64_t* bar;             // OP_SLOTS mbarriers
  unsigned used;             // slices released by the block (every thread)
  // the producer's cursor (thread 0): the next slice to issue
  const long long* desc;
  const float* ops;
  int nstages, tile_bits, tier;
  unsigned issued;           // slices issued
  int stage, q;              // its stage (-1: none left), its index there
  int tiles;                 // tiles left to issue for, this one included

  __device__ bool sliced(int s) const {
    const long long* ds = desc + s * DESC_WORDS;
    return ds[F_KIND] == K_MAT && ds[F_DIM] >= SLICED_MIN_DIM;
  }

  // the first sliced stage from s on, wrapping to the next tile at the
  // end of the chain; -1 after the last tile
  __device__ int next_sliced(int s) {
    for (;; s = 0) {
      for (; s < nstages; ++s)
        if (sliced(s)) return s;
      if (--tiles <= 0) return -1;
    }
  }

  // thread 0: issue until OP_SLOTS slices are in flight or none is left
  __device__ void pump() {
    while (stage >= 0 && issued < used + OP_SLOTS) {
      const long long* ds = desc + stage * DESC_WORDS;
      const int d = static_cast<int>(ds[F_DIM]);
      const unsigned bytes = slice_bytes(d, tier);
      const int per = slices_per_pass(d, tier);
      const int chunks = ((1 << (tile_bits - log2i(d))) + SLICE_CHUNK - 1)
                         / SLICE_CHUNK;
      const unsigned u = issued++;
      uint64_t* b = &bar[u % OP_SLOTS];
      mbar_arrive_expect(b, bytes);
      bulk_load(buf + (u % OP_SLOTS) * OP_SLICE_FLOATS,
                ops + ds[F_OP_OFF]
                    + static_cast<long long>(q % per) * (bytes / 4),
                bytes, b);
      if (++q == chunks * per) {
        q = 0;
        stage = next_sliced(stage + 1);
      }
    }
  }
};

// The block's ring in shared memory after `extra` (the row ids and
// multiphase rows), its OP_SLOTS mbarriers at `bars` (initialised and
// fenced before a block barrier that precedes this call), for a block
// that runs the chain of `desc` on `tiles` tiles: the first slices start
// loading.
__device__ __forceinline__ OpRing op_ring(float* extra, uint64_t* bars,
                                          const long long* desc,
                                          const float* ops, int nstages,
                                          int tile_bits, int tier,
                                          int tiles) {
  OpRing r{extra + EXTRA_WORDS, bars, 0u, desc, ops, nstages, tile_bits,
           tier, 0u, -1, 0, tiles};
  if (threadIdx.x == 0) {
    r.stage = tiles > 0 ? r.next_sliced(0) : -1;
    r.pump();
  }
  return r;
}

// A stage's view of its slices: slice q of the stage's stream once it has
// landed; released once every thread is done with it.
struct OpStream {
  OpRing& ring;
  unsigned u0;

  __device__ explicit OpStream(OpRing& r) : ring(r), u0(r.used) {}

  __device__ const float* wait(int q) const {
    PHASE_START(t0);
    const unsigned u = u0 + q;
    mbar_wait(&ring.bar[u % OP_SLOTS], (u / OP_SLOTS) & 1);
    PHASE_ADD(PC_SLICE_WAIT, t0);
    return ring.buf + (u % OP_SLOTS) * OP_SLICE_FLOATS;
  }

  __device__ void release(int q) {
    PHASE_START(t0);
    __syncthreads();
    ring.used = u0 + q + 1;
    if (threadIdx.x == 0) ring.pump();
    PHASE_ADD(PC_SLICE_RELEASE, t0);
  }
};

// ---- predicates, stores --------------------------------------------------

struct Preds {
  bool masked;
  int lm, lw, rm, rw;
  __device__ explicit Preds(const long long* ds)
      : masked(ds[F_MASKED] != 0),
        lm(static_cast<int>(ds[F_LANE_MASK])),
        lw(static_cast<int>(ds[F_LANE_WANT])),
        rm(static_cast<int>(ds[F_ROW_MASK])),
        rw(static_cast<int>(ds[F_ROW_WANT])) {}
  __device__ bool keeps(const Tile& t, int e) const {
    return masked && (((e & (LANES - 1)) & lm) != lw
                      || (t.row_id[e >> LANE_BITS] & rm) != rw);
  }
};

__device__ __forceinline__ void store1(const Tile& t, const Preds& pr, int e,
                                       float re, float im) {
  if (pr.keeps(t, e)) return;
  t.re[e] = re;
  t.im[e] = im;
}

// four consecutive elements e..e+3 (one tile row, e % 4 == 0) as float4
__device__ __forceinline__ void store4(const Tile& t, const Preds& pr, int e,
                                       float4 re, float4 im) {
  if (pr.masked) {
    if ((t.row_id[e >> LANE_BITS] & pr.rm) != pr.rw) return;
    const int ln = e & (LANES - 1);
    const float4 ore = *reinterpret_cast<const float4*>(t.re + e);
    const float4 oim = *reinterpret_cast<const float4*>(t.im + e);
    if (((ln + 0) & pr.lm) != pr.lw) { re.x = ore.x; im.x = oim.x; }
    if (((ln + 1) & pr.lm) != pr.lw) { re.y = ore.y; im.y = oim.y; }
    if (((ln + 2) & pr.lm) != pr.lw) { re.z = ore.z; im.z = oim.z; }
    if (((ln + 3) & pr.lm) != pr.lw) { re.w = ore.w; im.w = oim.w; }
  }
  *reinterpret_cast<float4*>(t.re + e) = re;
  *reinterpret_cast<float4*>(t.im + e) = im;
}

// R consecutive floats (R a multiple of 4, or 2) from 16- (8-) byte
// aligned shared memory
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const float4 w = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = w.x; v[4 * k + 1] = w.y; v[4 * k + 2] = w.z; v[4 * k + 3] = w.w;
    }
  } else {
    static_assert(R == 2, "rows of 2 or 4k floats");
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x; v[1] = w.y;
  }
}

// Element of fiber f, contracted index 0, for w contracted bits at tile
// position p: the fiber's bits around the contracted ones.
__device__ __forceinline__ int fiber_base(int f, int p, int w) {
  return ((f >> p) << (p + w)) | (f & ((1 << p) - 1));
}

// ---- matrix stages -------------------------------------------------------

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

// d < 16 (and sc): CUDA-core FMAs, the operand read through L1 with the
// strides F_SI/F_SJ (G[i, j] = op[i*si + j*sj]); each thread keeps RF
// fibers x RI outputs.
template <int D, bool REAL, int TIER>
__device__ void mat_narrow(const Tile& t, const long long* ds,
                           const float* __restrict__ ops) {
  constexpr int W = log2i(D);
  constexpr int TI = D;                   // threads along the output index
  constexpr int TF = NTHREADS / TI;       // threads along fibers
  constexpr int RF = 4;                   // fibers per thread per chunk
  const int p = static_cast<int>(ds[F_POS]);
  const int si = static_cast<int>(ds[F_SI]);
  const int sj = static_cast<int>(ds[F_SJ]);
  const float* gre = ops + ds[F_OP_OFF];
  const float* gim = gre + D * D;
  const Preds pr(ds);
  const int nfib = 1 << (t.bits - W);
  const int ti = threadIdx.x % TI;
  const int tf = threadIdx.x / TI;

  for (int f0 = 0; f0 < nfib; f0 += TF * RF) {
    int base[RF];
    bool ok[RF];
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int f = f0 + tf + TF * r;
      ok[r] = f < nfib;
      base[r] = fiber_base(ok[r] ? f : 0, p, W);
    }
    float ar[RF], ai[RF];
#pragma unroll
    for (int r = 0; r < RF; ++r) { ar[r] = 0.f; ai[r] = 0.f; }

#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int o = ti * si + j * sj;
      const float gr = __ldg(gre + o);
      const float gi = REAL ? 0.f : __ldg(gim + o);
      const int jo = j << p;
      // out_re += Gre x_re - Gim x_im, out_im += Gre x_im + Gim x_re,
      // each product over the tier's parts (the real-block form)
      float grh, grl, gih, gil;
      tier_parts<TIER>(gr, grh, grl);
      tier_parts<TIER>(gi, gih, gil);
#pragma unroll
      for (int r = 0; r < RF; ++r) {
        float xrh, xrl, xih, xil;
        tier_parts<TIER>(t.re[base[r] + jo], xrh, xrl);
        tier_parts<TIER>(t.im[base[r] + jo], xih, xil);
        ar[r] = tier_fma<TIER>(grh, grl, xrh, xrl, ar[r]);
        ai[r] = tier_fma<TIER>(grh, grl, xih, xil, ai[r]);
        if (!REAL) {
          ar[r] = tier_fma<TIER>(-gih, -gil, xih, xil, ar[r]);
          ai[r] = tier_fma<TIER>(gih, gil, xrh, xrl, ai[r]);
        }
      }
    }
    __syncthreads();   // every read of this chunk's fibers is done
#pragma unroll
    for (int r = 0; r < RF; ++r)
      if (ok[r]) store1(t, pr, base[r] + (ti << p), ar[r], ai[r]);
    __syncthreads();
  }
}

// ---- HIGHEST, d >= 16: fp32 FMAs on the operator slices -------------------
//
// Slice rows j = [Gre[:, j] (D floats), Gim[:, j] (D floats)], KB inputs
// per slice; chunks of 128 fibers. LANES_OUT (contracted bits at position
// 0, d = 128): lane l owns outputs 4l..4l+3 and warp w the 16 fibers
// 16w..16w+15 (tile rows, 128 floats apart: one pointer and immediate
// offsets); x is read as float4 over 4 inputs (a warp-wide broadcast), the
// operator as float4, the outputs stored as float4. Else (position >= 7)
// lane l owns fibers l + 32r (consecutive addresses) and warp w outputs
// w*D/8 .. (w+1)*D/8 - 1 (operator rows broadcast in the warp).
template <int D, bool REAL, bool LANES_OUT>
__device__ void fma_stage(const Tile& t, const long long* ds,
                          const float* __restrict__ ops, OpRing& ring) {
  constexpr int W = log2i(D);
  constexpr int KB = fma_rows(D);                         // inputs / slice
  constexpr int PER = slices_per_pass(D, T_HIGHEST);      // slices / pass
  constexpr int RI = LANES_OUT ? 4 : D / NWARPS;          // outputs / thread
  constexpr int RF = LANES_OUT ? 16 : 4;                  // fibers / thread
  constexpr int CHUNK = SLICE_CHUNK;
  static_assert(!LANES_OUT || D == 128, "outputs across lanes need d = 128");
  const int p = static_cast<int>(ds[F_POS]);
  const Preds pr(ds);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nfib = 1 << (t.bits - W);
  const int nchunks = (nfib + CHUNK - 1) / CHUNK;
  const int o0 = LANES_OUT ? 4 * lane : warp * RI;        // first output
  OpStream os(ring);

  for (int c = 0; c < nchunks; ++c) {
    float ar[RF][RI], ai[RF][RI];
#pragma unroll
    for (int r = 0; r < RF; ++r)
#pragma unroll
      for (int q = 0; q < RI; ++q) { ar[r][q] = 0.f; ai[r][q] = 0.f; }
    if constexpr (LANES_OUT) {
      const int fw = c * CHUNK + warp * RF;       // the warp's first fiber
      const float* xre = t.re + (fw << LANE_BITS);
      const float* xim = t.im + (fw << LANE_BITS);
      // a warp holds 16 fibers or none: tiles of 11 or more bits have
      // nfib >= 16; a 10-bit tile's 8 rows read 8 rows on, still inside
      // the block's shared memory, and store none of them
      const bool busy = fw < nfib;
      for (int s = 0; s < PER; ++s) {
        const float* sl = os.wait(c * PER + s);
#pragma unroll 1
        for (int jj = 0; busy && jj < KB; jj += 4) {
          const int j = s * KB + jj;
          float gr[4][4], gi[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            load_row<4>(sl + (jj + u) * 2 * D + o0, gr[u]);
            if (!REAL) load_row<4>(sl + (jj + u) * 2 * D + D + o0, gi[u]);
          }
#pragma unroll
          for (int r = 0; r < RF; ++r) {
            float xr[4], xi[4];
            load_row<4>(xre + r * LANES + j, xr);
            load_row<4>(xim + r * LANES + j, xi);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int q = 0; q < RI; ++q) {
                ar[r][q] = fmaf(gr[u][q], xr[u], ar[r][q]);
                ai[r][q] = fmaf(gr[u][q], xi[u], ai[r][q]);
                if (!REAL) {
                  ar[r][q] = fmaf(-gi[u][q], xi[u], ar[r][q]);
                  ai[r][q] = fmaf(gi[u][q], xr[u], ai[r][q]);
                }
              }
          }
        }
        os.release(c * PER + s);   // (the last: every read of the chunk done)
      }
#pragma unroll
      for (int r = 0; r < RF; ++r)
        if (fw + r < nfib)
          store4(t, pr, ((fw + r) << LANE_BITS) + o0,
                 make_float4(ar[r][0], ar[r][1], ar[r][2], ar[r][3]),
                 make_float4(ai[r][0], ai[r][1], ai[r][2], ai[r][3]));
    } else {
      int base[RF];
#pragma unroll
      for (int r = 0; r < RF; ++r) {
        const int f = c * CHUNK + lane + 32 * r;
        base[r] = fiber_base(f < nfib ? f : 0, p, W);
      }
      for (int s = 0; s < PER; ++s) {
        const float* sl = os.wait(c * PER + s);
#pragma unroll 1
        for (int jj = 0; jj < KB; ++jj) {
          const int jo = (s * KB + jj) << p;
          float gr[RI], gi[RI];
          load_row<RI>(sl + jj * 2 * D + o0, gr);
          if (!REAL) load_row<RI>(sl + jj * 2 * D + D + o0, gi);
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
        os.release(c * PER + s);   // (the last: every read of the chunk done)
      }
#pragma unroll
      for (int r = 0; r < RF; ++r) {
        if (c * CHUNK + lane + 32 * r >= nfib) continue;
#pragma unroll
        for (int q = 0; q < RI; ++q)
          store1(t, pr, base[r] + ((o0 + q) << p), ar[r][q], ai[r][q]);
      }
    }
    __syncthreads();
  }
}

// ---- HIGH and DEFAULT, d >= 16: wgmma on the operator slices --------------

__device__ __forceinline__ uint32_t bf16x2_rn(float lo_k, float hi_k) {
  // the lower-k value in the low half, as the A fragments want it
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keep the compiler from moving accesses of these registers across an
// asynchronous product that reads or writes them
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void hold(uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
}

// Shared-memory matrix descriptor of one B tile (16 inputs x N outputs,
// bf16, K-major, no swizzle): 8x8 core matrices of 16-byte rows, the two
// input halves LBO = 128 bytes apart, each group of 8 outputs SBO = 256
// bytes on (segment.py _tier_words packs it so).
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4)
      | (static_cast<uint64_t>(128 >> 4) << 16)
      | (static_cast<uint64_t>(256 >> 4) << 32);
}

// d[D/2] += (SA = 1 or -1) x A (64 x 16, registers) . B (16 x D, desc):
// wgmma.mma_async m64nDk16, f32 accumulators, bf16 inputs
template <int SA>
__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, %14, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, %22, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, %38, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, %70, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(SA));
}

// A fragments of k-step ks for the thread's rows h = 0, 1 (fragment rows
// g, g + 8): its inputs 16 ks + 4 tq .. + 3, which perm16 places at k =
// 2tq, 2tq + 1 (register h) and 2tq + 8, 2tq + 9 (register 2 + h), split
// or rounded into parts [hi, lo]. At position 0 the four are one float4.
// At position >= 7 the element's bank is its fiber's: lanes of odd tq load
// row g + 8 first, so each load touches 16 rows (2 lanes a bank, not 4).
template <int TIER>
__device__ __forceinline__ void load_a(const Tile& t, const int (&base)[2],
                                       int p, int j0, bool sw,
                                       uint32_t (&ar)[2][4],
                                       uint32_t (&ai)[2][4]) {
  float xr[2][4], xi[2][4];
  if (p == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_row<4>(t.re + base[h] + j0, xr[h]);
      load_row<4>(t.im + base[h] + j0, xi[h]);
    }
  } else {
    const int first = sw ? base[1] : base[0], second = sw ? base[0] : base[1];
    float yr[2][4], yi[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      yr[0][c] = t.re[first + ((j0 + c) << p)];
      yi[0][c] = t.im[first + ((j0 + c) << p)];
      yr[1][c] = t.re[second + ((j0 + c) << p)];
      yi[1][c] = t.im[second + ((j0 + c) << p)];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xr[0][c] = sw ? yr[1][c] : yr[0][c];
      xr[1][c] = sw ? yr[0][c] : yr[1][c];
      xi[0][c] = sw ? yi[1][c] : yi[0][c];
      xi[1][c] = sw ? yi[0][c] : yi[1][c];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a_words<TIER>(xr[h][0], xr[h][1], ar[0][h], ar[1][h]);
    a_words<TIER>(xr[h][2], xr[h][3], ar[0][2 + h], ar[1][2 + h]);
    a_words<TIER>(xi[h][0], xi[h][1], ai[0][h], ai[1][h]);
    a_words<TIER>(xi[h][2], xi[h][3], ai[0][2 + h], ai[1][2 + h]);
  }
}

// Warpgroup wg (of 2) takes fibers 64 wg .. 64 wg + 63 of each 128-fiber
// chunk: warp w4 of it the fragment rows 16 w4 .. + 15, lane 4g + tq rows g
// and g + 8. A slice holds KSS k-steps of PARTS B tiles each, in
// tier_parts order ([re_hi, re_lo, im_hi, im_lo] at HIGH, [re, im] at
// DEFAULT). Per k-step the thread loads its A fragments, issues the
// tier's products and waits for them (the next k-step reuses the A
// registers; the other warpgroup's products keep the tensor cores busy
// meanwhile); a slice is released after its last k-step. The 2 x D/2
// accumulators take 128 registers at d = 128. Accumulator register
// 4 nb + 2 h + e holds row g + 8h, logical output 8 nb + 2 tq + e, i.e.
// output 16 (nb / 2) + 4 tq + 2 (nb % 2) + e.
template <int D, bool REAL, int TIER>
__device__ void mma_stage(const Tile& t, const long long* ds,
                          const float* __restrict__ ops, OpRing& ring) {
  constexpr int W = log2i(D);
  constexpr int KS = D / 16;                    // k-steps
  constexpr int PARTS = mma_parts(TIER);        // B tiles per k-step
  constexpr int BT = 16 * D * 2;                // bytes of one B tile
  constexpr int KSS = mma_ksteps(D, TIER);      // k-steps per slice
  constexpr int PER = slices_per_pass(D, TIER); // slices per pass
  constexpr int NR = D / 2;                     // accumulators per plane
  const int p = static_cast<int>(ds[F_POS]);
  const Preds pr(ds);
  const int wg = threadIdx.x >> 7, w4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const bool sw = p != 0 && (tq & 1);       // row g + 8 first (load_a)
  const int nfib = 1 << (t.bits - W);
  const int nchunks = (nfib + SLICE_CHUNK - 1) / SLICE_CHUNK;
  OpStream os(ring);

  for (int c = 0; c < nchunks; ++c) {
    int base[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = c * 128 + wg * 64 + w4 * 16 + g + 8 * h;
      ok[h] = f < nfib;
      base[h] = fiber_base(ok[h] ? f : 0, p, W);
    }
    float accr[NR], acci[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) { accr[i] = 0.f; acci[i] = 0.f; }
    hold(accr);
    hold(acci);
    uint32_t ar[2][4], ai[2][4];         // [hi, lo][register]
    const float* sl = nullptr;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a<TIER>(t, base, p, 16 * ks + 4 * tq, sw, ar, ai);
      if (ks % KSS == 0) sl = os.wait(c * PER + ks / KSS);
      const uint64_t b0 = b_desc(sl + (ks % KSS) * PARTS * BT / 4);
      constexpr uint64_t NEXT = BT >> 4;        // the next part's B tile
      wgmma_fence();
      if constexpr (TIER == T_HIGH) {
        // re += Xre.Gre - Xim.Gim, im += Xim.Gre + Xre.Gim, each product
        // hi.hi + hi.lo + lo.hi (B: 0 re_hi, 1 re_lo, 2 im_hi, 3 im_lo)
        wgmma<1>(accr, ar[0], b0);
        wgmma<1>(accr, ar[0], b0 + NEXT);
        wgmma<1>(accr, ar[1], b0);
        wgmma<1>(acci, ai[0], b0);
        wgmma<1>(acci, ai[0], b0 + NEXT);
        wgmma<1>(acci, ai[1], b0);
        if (!REAL) {
          wgmma<-1>(accr, ai[0], b0 + 2 * NEXT);
          wgmma<-1>(accr, ai[0], b0 + 3 * NEXT);
          wgmma<-1>(accr, ai[1], b0 + 2 * NEXT);
          wgmma<1>(acci, ar[0], b0 + 2 * NEXT);
          wgmma<1>(acci, ar[0], b0 + 3 * NEXT);
          wgmma<1>(acci, ar[1], b0 + 2 * NEXT);
        }
      } else {
        // B: 0 re, 1 im (RNE bf16)
        wgmma<1>(accr, ar[0], b0);
        wgmma<1>(acci, ai[0], b0);
        if (!REAL) {
          wgmma<-1>(accr, ai[0], b0 + NEXT);
          wgmma<1>(acci, ar[0], b0 + NEXT);
        }
      }
      wgmma_commit();
      // the products read A from these registers: they are done before
      // the next k-step's A is loaded, and the slice before it is released
      wgmma_wait<0>();
      hold(ar);
      hold(ai);
      if (ks % KSS == KSS - 1 && ks < KS - 1) os.release(c * PER + ks / KSS);
    }
    hold(accr);
    hold(acci);
    os.release(c * PER + PER - 1);   // also: every read of the chunk done
    if (p == 0) {
      // outputs 16 q + 4 tq .. + 3 of rows g and g + 8, as float4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
#pragma unroll
        for (int q = 0; q < D / 16; ++q)
          store4(t, pr, base[h] + 16 * q + 4 * tq,
                 make_float4(accr[8 * q + 2 * h], accr[8 * q + 2 * h + 1],
                             accr[8 * q + 4 + 2 * h], accr[8 * q + 5 + 2 * h]),
                 make_float4(acci[8 * q + 2 * h], acci[8 * q + 2 * h + 1],
                             acci[8 * q + 4 + 2 * h], acci[8 * q + 5 + 2 * h]));
      }
    } else {
      // as load_a: lanes of odd tq store row g + 8 first
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool h1 = (hh == 1) != sw;           // the row this store takes
        if (!(h1 ? ok[1] : ok[0])) continue;
        const int b = h1 ? base[1] : base[0];
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 16 * (nb / 2) + 4 * tq + 2 * (nb % 2) + e;
            store1(t, pr, b + (o << p),
                   h1 ? accr[4 * nb + 2 + e] : accr[4 * nb + e],
                   h1 ? acci[4 * nb + 2 + e] : acci[4 * nb + e]);
          }
      }
    }
    __syncthreads();
  }
}

template <int D, int TIER>
__device__ void mat_dispatch(const Tile& t, const long long* ds,
                             const float* __restrict__ ops, OpRing& ring) {
  const bool real = ds[F_REAL] != 0;
  if constexpr (D >= SLICED_MIN_DIM && TIER != T_HIGHEST) {
    if (real) mma_stage<D, true, TIER>(t, ds, ops, ring);
    else mma_stage<D, false, TIER>(t, ds, ops, ring);
  } else if constexpr (D >= SLICED_MIN_DIM) {
    if constexpr (D == LANES) {
      if (ds[F_POS] < LANE_BITS) {
        if (real) fma_stage<D, true, true>(t, ds, ops, ring);
        else fma_stage<D, false, true>(t, ds, ops, ring);
        return;
      }
    }
    if (real) fma_stage<D, true, false>(t, ds, ops, ring);
    else fma_stage<D, false, false>(t, ds, ops, ring);
  } else if constexpr (TIER != T_HIGHEST) {
    // narrow: the tier's FMA body; `sc` (descriptor tier HIGHEST) exact
    if (ds[F_TIER] == T_HIGHEST) {
      if (real) mat_narrow<D, true, T_HIGHEST>(t, ds, ops);
      else mat_narrow<D, false, T_HIGHEST>(t, ds, ops);
    } else if (real) {
      mat_narrow<D, true, TIER>(t, ds, ops);
    } else {
      mat_narrow<D, false, TIER>(t, ds, ops);
    }
  } else {
    if (real) mat_narrow<D, true, T_HIGHEST>(t, ds, ops);
    else mat_narrow<D, false, T_HIGHEST>(t, ds, ops);
  }
}

// ---- elementwise, pair, diagonal and channel stages ----------------------

// The shared words after the row ids and the multiphase rows (the same
// place under every driver, DIAG_TABLE_WORDS of EXTRA_WORDS): S8's table,
// S7's per-row term bits or a diagonal run's row words. No two stages use
// them at once.
__device__ __forceinline__ float* stage_scratch(const Tile& t) {
  return reinterpret_cast<float*>(const_cast<int*>(t.row_id) + MAX_ROWS
                                  + 3 * MAX_MULTIPHASE_ROWS);
}
static_assert(DIAG_TABLE_WORDS >= 2 * MAX_ROWS, "a 64-bit word per row");
static_assert((MAX_ROWS + 3 * MAX_MULTIPHASE_ROWS) % 2 == 0,
              "the scratch words start 8-byte aligned");

typedef unsigned long long u64;

// Term bits of x (a lane, or a tile row's global id) under the masks
// mk[0..m): bit r is, for a parity term (bit r of `forms`), the parity of
// x & mk[r]; for an all-ones term, whether x holds every bit of mk[r].
__device__ __forceinline__ u64 term_bits(int x, const int* mk, u64 forms,
                                         int m) {
  u64 b = 0;
  for (int r = 0; r < m; ++r) {
    const int y = x & mk[r];
    const int on = ((forms >> r) & 1) ? (__popc(y) & 1) : (y == mk[r]);
    b |= static_cast<u64>(on) << r;
  }
  return b;
}

// S7's pass over the tile for m <= M terms. An element's term r adds, in
// order r = 0..m-1: a parity term -angle where its lane and row parities
// differ, else +angle; an all-ones term +angle where lane and row both
// match, else +0.0f (which leaves every sum but -0.0f as it is, and the
// sum starts at +0.0f and never reaches -0.0f: the same bits as adding
// nothing). Then one sincosf and the complex multiply. Each thread takes
// the float4 of lanes l0..l0+3 in rows warp, warp + NWARPS, ... (always
// the same 4 lanes), so its lane bits `lb` are worked out once per
// stage and each row's bits `rb[row]` once per tile. M <= 8: the angles
// in registers and the term loop unrolled; else read from shared memory
// (a broadcast) once per row for the thread's 4 elements.
template <int M>
__device__ __forceinline__ void multiphase_rows(const Tile& t,
                                                const float* s_ang, int m,
                                                u64 forms, const u64 (&lb)[4],
                                                const u64* rb) {
  constexpr int NA = M <= 8 ? M : 1;
  float ang[NA];
#pragma unroll
  for (int r = 0; r < NA; ++r) ang[r] = r < m ? s_ang[r] : 0.f;
  const int l0 = (threadIdx.x & 31) * 4;
  const int rows = 1 << (t.bits - LANE_BITS);
  for (int r = threadIdx.x >> 5; r < rows; r += NWARPS) {
    const u64 rw = rb[r];
    u64 plus[4], minus[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const u64 differ = lb[c] ^ rw;
      minus[c] = forms & differ;
      plus[c] = (forms & ~differ) | (~forms & lb[c] & rw);
    }
    float tot[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (M <= 8) {
#pragma unroll
      for (int k = 0; k < M; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tot[c] += ((plus[c] >> k) & 1) ? ang[k]
                    : ((minus[c] >> k) & 1) ? -ang[k] : 0.f;
    } else {
      for (int k = 0; k < m; ++k) {
        const float a = s_ang[k];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tot[c] += ((plus[c] >> k) & 1) ? a
                    : ((minus[c] >> k) & 1) ? -a : 0.f;
      }
    }
    const int e = (r << LANE_BITS) + l0;
    float4 vr = *reinterpret_cast<const float4*>(t.re + e);
    float4 vi = *reinterpret_cast<const float4*>(t.im + e);
    float* pre = &vr.x;
    float* pim = &vi.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float sn, cs;
      sincosf(tot[c], &sn, &cs);
      const float re = pre[c], im = pim[c];
      pre[c] = re * cs - im * sn;
      pim[c] = re * sn + im * cs;
    }
    *reinterpret_cast<float4*>(t.re + e) = vr;
    *reinterpret_cast<float4*>(t.im + e) = vi;
  }
}

__device__ void multiphase_stage(const Tile& t, const long long* ds,
                                 const float* __restrict__ g,
                                 float* s_ang, int* s_lm, int* s_rm) {
  // (m, 8) rows: [angle, lane_mask, row_mask_lo, row_mask_hi, 0, 0, 0, 0];
  // bit r of F_FORMS set: row r is a parity term, else an all-ones term.
  // The element's angle factors into a lane part and a row part (the
  // reference's _apply_multiphase_stage sums the group per element): the
  // rows go to shared memory, then each tile row's term bits into the
  // scratch words (a thread a row: on an H100 faster than each thread
  // working out the rows it visits, PERF.md), each thread's four lanes'
  // bits into registers, and m picks the body (structure, as d picks a
  // matrix stage's).
  const int m = static_cast<int>(ds[F_DIM]);
  const u64 forms = static_cast<u64>(ds[F_FORMS]);
  for (int r = threadIdx.x; r < m; r += NTHREADS) {
    s_ang[r] = __ldg(g + 8 * r);
    s_lm[r] = static_cast<int>(__ldg(g + 8 * r + 1));
    s_rm[r] = row_mask(__ldg(g + 8 * r + 2), __ldg(g + 8 * r + 3));
  }
  __syncthreads();
  u64* rb = reinterpret_cast<u64*>(stage_scratch(t));
  const int rows = 1 << (t.bits - LANE_BITS);
  for (int r = threadIdx.x; r < rows; r += NTHREADS)
    rb[r] = term_bits(t.row_id[r], s_rm, forms, m);
  const int l0 = (threadIdx.x & 31) * 4;
  u64 lb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) lb[c] = term_bits(l0 + c, s_lm, forms, m);
  __syncthreads();                   // every row's bits are in
  if (m <= 2) multiphase_rows<2>(t, s_ang, m, forms, lb, rb);
  else if (m <= 8) multiphase_rows<8>(t, s_ang, m, forms, lb, rb);
  else multiphase_rows<MAX_MULTIPHASE_ROWS>(t, s_ang, m, forms, lb, rb);
}

// S5 and S6 as runs (diag_run). prepare_segment writes, into the first
// descriptor of each maximal run of consecutive K_PHASE / K_PARITY
// descriptors (at most MAX_DIAG_RUN), the run's length (F_RUN); run_chain
// hands the run to diag_run and jumps over it. The operands are the
// reference's (1, 8) rows:
//   S5 (phase)  [tre, tim, lane_mask, lane_want, row_mask_lo, row_mask_hi,
//                row_want_lo, row_want_hi]: x * (tre + i tim) where lane
//                and row match;
//   S6 (parity) [cos, sin, lane_mask, row_mask_lo, row_mask_hi, 0, 0, 0]:
//                x * (cos - i sin (-1)^p), p the parity of the element's
//                lane and row under the masks.
// Stage s of a run is bit s of three 64-bit words: `par` (S6), a thread's
// lane word L (S5: its lane matches; S6: its lane parity) and each tile
// row's word R (the same of the row's global id), so an element's bit s
// of (L & R) for S5, or (L ^ R) for S6, says whether the stage changes it
// (S5) or which sign its sine takes (S6). L is built once per run for the
// thread's one lane (NTHREADS is a multiple of LANES, so the lane of every
// element a thread visits is the same), R once per tile row, into the
// stage scratch. Each element is read from shared memory once, takes the
// run's stages in registers in stage order, each the same formula as a
// one-stage segment's, and is written back once: a run of k stages gives
// the bits of k one-stage segments. A long run of unit-modulus factors
// takes the angle form instead (angle_run).
constexpr int MAX_DIAG_RUN = 64;   // ops/segment.py MAX_DIAG_RUN
static_assert(NTHREADS % LANES == 0, "a thread keeps one lane");
static_assert(MAX_DIAG_RUN <= MAX_MULTIPHASE_ROWS,
              "a run's (a, b) pairs fill s_ang and s_lm");
static_assert(MAX_DIAG_RUN == 64 && MAX_ROWS <= NTHREADS,
              "two stages a warp lane; a tile row a thread");

// A warp's copy of a run's stages: lane i holds stages i and i + 32 (the
// slots of stages past the run are zero), each as its (a, b) pair, its
// lane mask and want and its row mask and want, a want of -1 marking S6
// (which has none). Every warp loads it once per tile, one load per field
// and slot, so no thread walks the run's descriptors; run_word reads it
// with warp shuffles.
struct RunStages {
  float a[2], b[2];
  int lm[2], lw[2], rm[2], rw[2];
};

__device__ __forceinline__ RunStages run_stages(const long long* ds,
                                                const float* __restrict__ ops,
                                                int k) {
  RunStages r{};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = (threadIdx.x & 31) + 32 * h;
    if (s >= k) continue;
    const long long* d = ds + s * DESC_WORDS;
    const float* g = ops + d[F_OP_OFF];
    r.a[h] = __ldg(g);
    r.b[h] = __ldg(g + 1);
    r.lm[h] = static_cast<int>(__ldg(g + 2));
    if (d[F_KIND] == K_PHASE) {
      r.lw[h] = static_cast<int>(__ldg(g + 3));
      r.rm[h] = row_mask(__ldg(g + 4), __ldg(g + 5));
      r.rw[h] = row_mask(__ldg(g + 6), __ldg(g + 7));
    } else {
      r.lw[h] = r.rw[h] = -1;
      r.rm[h] = row_mask(__ldg(g + 3), __ldg(g + 4));
    }
  }
  return r;
}

// The run's word of x (a lane, or a tile row's global id) under the masks
// m and wants w of a RunStages (its lane or its row fields): bit s is, for
// S5, whether x matches stage s's predicate; for S6, the parity of x
// under its mask. Every lane of the warp calls it (the shuffles).
__device__ __forceinline__ u64 run_word(int x, const int (&m)[2],
                                        const int (&w)[2], int k) {
  u64 b = 0;
  for (int s = 0; s < k; ++s) {
    const int mm = __shfl_sync(~0u, s < 32 ? m[0] : m[1], s & 31);
    const int ww = __shfl_sync(~0u, s < 32 ? w[0] : w[1], s & 31);
    const int on = ww < 0 ? (__popc(x & mm) & 1) : ((x & mm) == ww);
    b |= static_cast<u64>(on) << s;
  }
  return b;
}

// x *= (a + i b), as the plain version forms it: re a - im b, im a + re b
__device__ __forceinline__ void cmul(float& re, float& im, float a, float b) {
  const float nr = fmaf(re, a, -__fmul_rn(im, b));
  im = fmaf(im, a, __fmul_rn(re, b));
  re = nr;
}

// The run on G elements of each of the thread's rows at a time: element
// e = threadIdx.x + j * NTHREADS for j in [j0, j0 + G). A warp's 32
// elements share a row, so the stages that can change a warp's G rows
// (every S6; an S5 whose row bit is set in one of the rows and whose lane
// bit in one of the warp's lanes, `lane_any`) are warp-uniform, and the
// loop visits only those.
template <int G>
__device__ __forceinline__ void run_rows(const Tile& t, const float2* cf,
                                         const u64* rb, u64 par, u64 lb,
                                         u64 lane_any) {
  const int per = (1 << t.bits) / NTHREADS;
  for (int j0 = 0; j0 < per; j0 += G) {
    float re[G], im[G];
    unsigned lo[G], hi[G];   // the element's bits: S5 applies / S6 sign
    u64 rows_any = 0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int e = threadIdx.x + (j0 + i) * NTHREADS;
      const u64 r = rb[e >> LANE_BITS];
      rows_any |= r;
      const u64 on = (par & (lb ^ r)) | (~par & lb & r);
      lo[i] = static_cast<unsigned>(on);
      hi[i] = static_cast<unsigned>(on >> 32);
      re[i] = t.re[e];
      im[i] = t.im[e];
    }
    const u64 live = par | (lane_any & rows_any);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned ph = static_cast<unsigned>(par >> (32 * h));
      unsigned m = static_cast<unsigned>(live >> (32 * h));
      // the next live stage's pair loads while this one computes (an
      // index past the last reads a slot that is not used)
      unsigned bit = m & (0u - m);
      float2 next = cf[32 * h + __ffs(bit | 0x80000000u) - 1];
      while (m) {
        m ^= bit;
        const float2 c = next;
        const unsigned nbit = m & (0u - m);
        next = cf[32 * h + __ffs(nbit | 0x80000000u) - 1];
        if (ph & bit) {                          // S6
#pragma unroll
          for (int i = 0; i < G; ++i)
            cmul(re[i], im[i], c.x, ((h ? hi[i] : lo[i]) & bit) ? c.y : -c.y);
        } else {                                 // S5
#pragma unroll
          for (int i = 0; i < G; ++i) {
            float nr = re[i], ni = im[i];
            cmul(nr, ni, c.x, c.y);
            const bool on = (h ? hi[i] : lo[i]) & bit;
            re[i] = on ? nr : re[i];
            im[i] = on ? ni : im[i];
          }
        }
        bit = nbit;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int e = threadIdx.x + (j0 + i) * NTHREADS;
      t.re[e] = re[i];
      t.im[e] = im[i];
    }
  }
}

// The angle form of a long run. A run of at least ANGLE_MIN_RUN stages
// whose factors all have unit modulus, and of which at most MAX_MIXED have
// both a lane and a row mask, carries from prepare_segment bit 0 of F_FORMS
// in its head and, at float offset F_TARGETS of the operand buffer, an
// int32 table of two turns per stage in units of 2 pi / 2^32: T_off, the
// element's turn where the stage's bit (S5: it matches; S6: its parity) is
// clear, and D, what the bit adds (S5: 0 and its phase; S6: -h and 2h for
// its half angle h). An element's factor is e^{i pi T / 2^31}, T the
// wrapping 32-bit sum of T_off + bit * D over the run: exact in any order,
// so T splits into a lane part (the stages whose row mask is empty, whose
// row bit is then the same in every row), a row part (the stages whose
// lane mask is empty, and every T_off of the rest) and the rest, the
// "mixed" stages, whose bits come per element from 32-bit lane and row
// words as in the exact form. Then one sincospif and one complex multiply
// an element. It does not give the exact form's bits: the card holds it to
// the plain version within STAGE_TOL.
constexpr int ANGLE_MIN_RUN = 8;   // ops/segment.py ANGLE_MIN_RUN
constexpr int MAX_MIXED = 32;      // ops/segment.py MAX_MIXED
static_assert(DIAG_TABLE_WORDS >= 2 * MAX_ROWS && MAX_MIXED <= 2 * MAX_DIAG_RUN,
              "a row's turn and mixed bits in the scratch; D in s_cf");

__device__ void angle_run(const Tile& t, const long long* ds,
                          const float* __restrict__ ops, int k,
                          const RunStages& st, float* s_cf) {
  const int* tab = reinterpret_cast<const int*>(ops + ds[F_TARGETS]);
  int toff[2] = {0, 0}, dt[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = (threadIdx.x & 31) + 32 * h;
    if (s < k) {
      toff[h] = __ldg(tab + 2 * s);
      dt[h] = __ldg(tab + 2 * s + 1);
    }
  }
  const int rows = 1 << (t.bits - LANE_BITS);
  const int lane = threadIdx.x & (LANES - 1);
  const int row = t.row_id[min(static_cast<int>(threadIdx.x), rows - 1)];
  unsigned lsum = 0, rsum = 0;          // the thread's lane's, its row's
  unsigned lbits = 0, rbits = 0, mpar = 0;
  unsigned* dmix = reinterpret_cast<unsigned*>(s_cf);
  int j = 0;                            // mixed stages so far
  for (int s = 0; s < k; ++s) {
    const int src = s & 31;
    const bool h = s >= 32;
    const int lm = __shfl_sync(~0u, h ? st.lm[1] : st.lm[0], src);
    const int lw = __shfl_sync(~0u, h ? st.lw[1] : st.lw[0], src);
    const int rm = __shfl_sync(~0u, h ? st.rm[1] : st.rm[0], src);
    const int rw = __shfl_sync(~0u, h ? st.rw[1] : st.rw[0], src);
    const unsigned o = __shfl_sync(~0u, h ? toff[1] : toff[0], src);
    const unsigned d = __shfl_sync(~0u, h ? dt[1] : dt[0], src);
    const bool par = lw < 0;
    const int lb = par ? (__popc(lane & lm) & 1) : ((lane & lm) == lw);
    const int rb = par ? (__popc(row & rm) & 1) : ((row & rm) == rw);
    const unsigned on = par ? (lb ^ rb) : (lb & rb);
    if (rm == 0) {
      lsum += o + on * d;
    } else if (lm == 0) {
      rsum += o + on * d;
    } else {
      rsum += o;
      lbits |= static_cast<unsigned>(lb) << j;
      rbits |= static_cast<unsigned>(rb) << j;
      mpar |= static_cast<unsigned>(par) << j;
      if (threadIdx.x == 0) dmix[j] = d;
      ++j;
    }
  }
  unsigned* rturn = reinterpret_cast<unsigned*>(stage_scratch(t));
  unsigned* rword = rturn + MAX_ROWS;
  if (threadIdx.x < rows) {
    rturn[threadIdx.x] = rsum;
    rword[threadIdx.x] = rbits;
  }
  __syncthreads();                   // the row parts and mixed turns are in
  const int per = (1 << t.bits) / NTHREADS;
#pragma unroll 4
  for (int q = 0; q < per; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = e >> LANE_BITS;
    unsigned tot = lsum + rturn[r];
    const unsigned rw = rword[r];
    const unsigned on = (mpar & (lbits ^ rw)) | (~mpar & lbits & rw);
    for (int m = 0; m < j; ++m)
      tot += ((on >> m) & 1u) ? dmix[m] : 0u;
    float sn, cs;
    sincospif(static_cast<float>(static_cast<int>(tot)) * 0x1p-31f, &sn, &cs);
    float re = t.re[e], im = t.im[e];
    cmul(re, im, cs, sn);
    t.re[e] = re;
    t.im[e] = im;
  }
}

// The run whose first descriptor is ds (its length in F_RUN) on the tile;
// returns the length. Each stage's (a, b) pair goes to s_cf (s_ang and
// s_lm): S5's (tre, tim), S6's (cos, sin), the sine's sign flipped per
// element (x (cos - i sn) with sn = +-sin is a b of -sn).
__device__ int diag_run(const Tile& t, const long long* ds,
                        const float* __restrict__ ops, float* s_cf) {
  const int k = max(1, static_cast<int>(ds[F_RUN]));
  float2* cf = reinterpret_cast<float2*>(s_cf);
  u64* rb = reinterpret_cast<u64*>(stage_scratch(t));
  const RunStages st = run_stages(ds, ops, k);
  if (ds[F_FORMS] & 1) {
    angle_run(t, ds, ops, k, st, s_cf);
    return k;
  }
  const u64 par = static_cast<u64>(__ballot_sync(~0u, st.lw[0] < 0))
                  | (static_cast<u64>(__ballot_sync(~0u, st.lw[1] < 0)) << 32);
  if (threadIdx.x < 32) {
    cf[threadIdx.x] = make_float2(st.a[0], st.b[0]);
    cf[threadIdx.x + 32] = make_float2(st.a[1], st.b[1]);
  }
  // a row word per tile row (every thread computes one: the shuffles)
  const int rows = 1 << (t.bits - LANE_BITS);
  const u64 rw = run_word(t.row_id[min(static_cast<int>(threadIdx.x),
                                       rows - 1)], st.rm, st.rw, k);
  if (threadIdx.x < rows) rb[threadIdx.x] = rw;
  const u64 lb = run_word(threadIdx.x & (LANES - 1), st.lm, st.lw, k);
  const u64 lane_any =
      static_cast<u64>(__reduce_or_sync(~0u, static_cast<unsigned>(lb)))
      | (static_cast<u64>(__reduce_or_sync(~0u,
                                           static_cast<unsigned>(lb >> 32)))
         << 32);
  __syncthreads();                   // the row words and pairs are in
  const int per = (1 << t.bits) / NTHREADS;
  // 8 elements in flight a thread where the tile has them (11-bit tiles
  // and up), else 4: on an H100, 16 ran the exact-form diagonal layer 12 %
  // faster but the flagship at HIGH 4.6 % slower (PERF.md)
  if (per >= 8) run_rows<8>(t, cf, rb, par, lb, lane_any);
  else run_rows<4>(t, cf, rb, par, lb, lane_any);
  return k;
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
  const Preds pr(ds);
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
      if (pr.keeps(t, a)) continue;
      t.re[a] = sr;
      t.im[a] = si;
    }
  }
}

__device__ void diagvec_stage(const Tile& t, const long long* ds,
                              const float* __restrict__ g) {
  // (2, 2^k) table: entry sum_j bit(targets[j]) << j of every element's
  // GLOBAL index; bit q is lane bit q (q < 7) or bit q - 7 of the tile
  // row's id (the reference's _bit_of), so targets of 32 and above keep
  // their bit; identity where predicates fail. The table is copied to
  // shared memory once per stage. A thread takes 4 consecutive lanes as a
  // float4 and always the same 4 (NTHREADS is a multiple of a row's 32
  // float4s), so the index's lane part and the lane predicate are worked
  // out once per thread, the row part and the row predicate once per row.
  const int k = static_cast<int>(ds[F_DIM]);
  const long long packed = ds[F_TARGETS];
  const Preds pr(ds);
  float* tab = stage_scratch(t);
  for (int i = threadIdx.x; i < (2 << k); i += NTHREADS) tab[i] = __ldg(g + i);
  const int l0 = (threadIdx.x & 31) * 4;
  int lidx[4] = {0, 0, 0, 0};
  int rq[MAX_DIAG_TARGETS];          // row bit of target j, or -1 (a lane)
#pragma unroll
  for (int j = 0; j < MAX_DIAG_TARGETS; ++j) {
    const int q = static_cast<int>((packed >> (TARGET_BITS * j)) & 63);
    rq[j] = j < k && q >= LANE_BITS ? q - LANE_BITS : -1;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j < k && q < LANE_BITS) lidx[c] |= (((l0 + c) >> q) & 1) << j;
  }
  bool lok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) lok[c] = !pr.masked || ((l0 + c) & pr.lm) == pr.lw;
  const float* tim = tab + (1 << k);
  __syncthreads();                   // the table is in
  // the thread's 4 factors, read again only when the row part changes
  // (never on a tile whose rows leave every row target fixed)
  float fr[4], fi[4];
  int cur = -1;
  const int rows = 1 << (t.bits - LANE_BITS);
  for (int r = threadIdx.x >> 5; r < rows; r += NTHREADS / 32) {
    const int row = t.row_id[r];
    if (pr.masked && (row & pr.rm) != pr.rw) continue;
    int ridx = 0;
#pragma unroll
    for (int j = 0; j < MAX_DIAG_TARGETS; ++j)
      if (rq[j] >= 0) ridx |= ((row >> rq[j]) & 1) << j;
    if (ridx != cur) {
      cur = ridx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        fr[c] = tab[lidx[c] | ridx];
        fi[c] = tim[lidx[c] | ridx];
      }
    }
    const int e = (r << LANE_BITS) + l0;
    float4 vr = *reinterpret_cast<const float4*>(t.re + e);
    float4 vi = *reinterpret_cast<const float4*>(t.im + e);
    float* pre = &vr.x;
    float* pim = &vi.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!lok[c]) continue;
      const float re = pre[c], im = pim[c];
      pre[c] = re * fr[c] - im * fi[c];
      pim[c] = re * fi[c] + im * fr[c];
    }
    *reinterpret_cast<float4*>(t.re + e) = vr;
    *reinterpret_cast<float4*>(t.im + e) = vi;
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
// `free_mask`). The drivers OR in SweepArgs::fixed_rows: the free bits a
// launch keeps fixed (see SweepArgs).
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

// free_mask holds the free row bits the tile index walks: 2^popc tiles
// per state. A segment of S5 stages only can leave out the tiles it cannot
// change: the free row bits every stage's row predicate fixes to one value
// are taken out of free_mask, and every tile has them at fixed_rows
// (ops/segment.py phase_skip); else fixed_rows is 0 and the launch walks
// every tile.
struct SweepArgs {
  float* amps;          // the batch's planes, state s at 2 * 2^n * s floats
  int n, tile_bits, inner_bits;
  unsigned scat_mask, free_mask, fixed_rows;
  const long long* desc;
  int nstages;
  const float* ops;
  int batch;            // states of the whole batch (the selection stride)
  const float* sel;
  int state0;           // first state of this launch (K3 slices a batch)
};

// Thread 0's requests for `reqs` consecutive boxes of one plane, from tile
// row r0 of the tile at global row `base`: LOAD, the map's plane `plane`
// into `buf` on mbarrier `bar`; else `buf` into the map's plane, in the
// thread's open bulk group. Every driver issues its copies through this.
template <bool LOAD>
__device__ __forceinline__ void plane_boxes(const CUtensorMap* map,
                                            const CopyUnit& cu,
                                            const SweepArgs& a, int base,
                                            int r0, int reqs, int plane,
                                            float* buf, uint64_t* bar) {
  const int box_log2 = cu.b2 + cu.b3;
  for (int q = 0; q < reqs; ++q) {
    const int r = r0 + (q << box_log2);
    const int row = tile_row(base, r, a.inner_bits, a.scat_mask);
    if constexpr (LOAD) tma_load(buf + r * LANES, map, cu, row, plane, bar);
    else tma_store(map, cu, row, plane, buf + r * LANES);
  }
}

// The segment's stages on one resident tile, in order (a run of S5/S6
// stages in one pass, diag_run), a block barrier after each; every driver
// calls this one function, so the three schedules compute the same bits.
template <int TIER>
__device__ __forceinline__ void run_chain(const Tile& t, const SweepArgs& a,
                                          int state, float* s_ang, int* s_lm,
                                          int* s_rm, OpRing& ring) {
  for (int s = 0; s < a.nstages; ++s) {
    const long long* ds = a.desc + s * DESC_WORDS;
    const float* g = a.ops + ds[F_OP_OFF];
    switch (static_cast<int>(ds[F_KIND])) {
      case K_MAT:
        switch (static_cast<int>(ds[F_DIM])) {
          case 2: mat_dispatch<2, TIER>(t, ds, a.ops, ring); break;
          case 4: mat_dispatch<4, TIER>(t, ds, a.ops, ring); break;
          case 8: mat_dispatch<8, TIER>(t, ds, a.ops, ring); break;
          case 16: mat_dispatch<16, TIER>(t, ds, a.ops, ring); break;
          case 32: mat_dispatch<32, TIER>(t, ds, a.ops, ring); break;
          case 64: mat_dispatch<64, TIER>(t, ds, a.ops, ring); break;
          default: mat_dispatch<128, TIER>(t, ds, a.ops, ring); break;
        }
        break;
      case K_PHASE:
      case K_PARITY: s += diag_run(t, ds, a.ops, s_ang) - 1; break;
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
//
// Block (x, y) holds tile x of state state0 + y, through the launch's
// tensor map and copy unit (see CopyUnit; K3 issues a plane's boxes in row
// order and ignores the parts, which only time the ring drivers' refills).
// Thread 0 initialises the tile's mbarrier (one arrival expecting both
// planes' bytes) beside the operator ring's and, after the barrier that
// publishes them, issues both planes' loads; while they are in flight the
// block writes its row ids and starts the operator ring, which need
// nothing from the tile. The chain starts once the tile has landed. Then
// fence.proxy.async and a barrier order the chain's generic stores before
// the bulk tensor stores that read them, thread 0 stores each plane as one
// bulk group, and the block exits as soon as the stores have READ the
// tile (wait_group.read): the SM's shared memory goes to the next block's
// loads while the writes drain. A later launch on the stream still sees
// every write: it starts only after this grid has completed, and a grid
// completes only once the bulk stores its threads issued have been
// performed (CUTLASS's TMA epilogues end on the same wait). On an H100
// this exit beat waiting for the writes to land, as K1's blocks do, in
// every timed pair with a phase stage and tied on the stage-free copy
// (PERF.md). One block per SM: two 128
// KiB tiles do not fit 227 KB; the SMs' load, chain and store phases
// overlap one another, each SM with a whole tile of boxes in flight.

template <int TIER>
__global__ void __launch_bounds__(NTHREADS, 1)
segment_kernel(SweepArgs a, __grid_constant__ const CUtensorMap map,
               CopyUnit cu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int size = 1 << a.tile_bits;
  const int rows = size >> LANE_BITS;
  int* row_id = reinterpret_cast<int*>(smem + 2 * size);
  float* s_ang = reinterpret_cast<float*>(row_id + MAX_ROWS);
  int* s_lm = reinterpret_cast<int*>(s_ang + MAX_MULTIPHASE_ROWS);
  int* s_rm = s_lm + MAX_MULTIPHASE_ROWS;
  // the tile's mbarrier, then the operator ring's OP_SLOTS
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + 2 * size + EXTRA_WORDS + OP_SLOTS * OP_SLICE_FLOATS);
  PHASE_START(t_block);
  const Tile t{smem, smem + size, row_id, a.tile_bits};
  const int state = a.state0 + static_cast<int>(blockIdx.y);
  const int base = tile_base(blockIdx.x, a.free_mask) | a.fixed_rows;
  const int reqs = rows >> (cu.b2 + cu.b3);        // boxes a plane
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + OP_SLOTS; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect(&bars[0], 2u * static_cast<unsigned>(size) * 4u);
    for (int p = 0; p < 2; ++p)
      plane_boxes<true>(&map, cu, a, base, 0, reqs, 2 * state + p,
                        p ? t.im : t.re, &bars[0]);
  }
  for (int r = threadIdx.x; r < rows; r += NTHREADS)
    row_id[r] = tile_row(base, r, a.inner_bits, a.scat_mask);
  __syncthreads();
  OpRing ring = op_ring(smem + 2 * size, bars + 1, a.desc, a.ops, a.nstages,
                        a.tile_bits, TIER, 1);
  mbar_wait(&bars[0], 0);
  PHASE_ADD(PC_PROLOGUE, t_block);

  PHASE_START(t_chain);
  run_chain<TIER>(t, a, state, s_ang, s_lm, s_rm, ring);
  PHASE_ADD(PC_CHAIN, t_chain);
  fence_proxy_async();
  __syncthreads();

  PHASE_START(t_store);
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {
      plane_boxes<false>(&map, cu, a, base, 0, reqs, 2 * state + p,
                         p ? t.im : t.re, nullptr);
      bulk_commit();
    }
    bulk_wait<0, true>();
  }
  PHASE_ADD_AT(0, PC_STORE, t_store);
  PHASE_ADD_AT(0, PC_BLOCK, t_block);
  PHASE_COUNT(PC_BLOCKS);
}

// ---- K1 and K2: the persistent plane-slot ring ---------------------------
//
// The launch walks steps blockIdx.x, +gridDim.x, ... (tile = step mod
// tiles, state = step / tiles: the batch slowest, the reference's
// _step_index). A block's local step k holds planes j = 2k (re) and 2k + 1
// (im); plane j lives in slot j mod S of a ring of S plane slots, in place
// (loaded, chained and stored from the same slot). Thread 0 issues every
// copy, as tensor-map requests (see CopyUnit): a plane moves in P =
// 2^parts_log2 parts of consecutive tile rows (P = 1 by default: one box
// a plane wherever the tile's rows are contiguous in slot order), each
// part as one or more boxes; loads complete on the step's mbarrier (one
// arrival expecting both planes), and the stores of each part go out as
// one bulk group (re's parts, then im's). The block first loads planes
// [0, S). Plane j >= S refills the slot of plane j - S, part by part,
// each part after the store group of the same part of plane j - S has
// released it (N groups committed after it, band_plan
// ring_wait_groups):
//   ON_READ (K1): wait_group.read — the store has READ its part of the
//     slot; its write to device memory may still be in flight (the
//     reference's decoupled rings: neither DMA direction gates the other).
//   else (K2): wait_group — the store has LANDED (the reference's in-place
//     NBUF slots: in(s+1) waits for out(s+1-nbuf) to drain). S = 2 has no
//     read-ahead.
// A refill for the next step goes out as soon as the store that frees its
// slot is committed, so it queues ahead of the step's other store (K1, S
// = 3: after chain k, store re(k), load im(k + 1) into its slot, store
// im(k)); a refill for a later step goes out once the block's tile has
// landed, before its chain (K1: re(k + 1) loads under chain k). The chain
// writes the tile with generic stores; fence.proxy.async and a barrier
// order them before the bulk stores that read them. Thread 0 waits for
// all of its stores to land before the block exits. The operator ring and
// its OP_SLOTS mbarriers follow the plane slots' S.

template <int TIER, bool ON_READ>
__global__ void __launch_bounds__(NTHREADS, 1)
ring_kernel(SweepArgs a, int slots, long long steps,
            __grid_constant__ const CUtensorMap map, CopyUnit cu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int size = 1 << a.tile_bits;
  const int rows = size >> LANE_BITS;
  int* row_id = reinterpret_cast<int*>(smem + slots * size);
  float* s_ang = reinterpret_cast<float*>(row_id + MAX_ROWS);
  int* s_lm = reinterpret_cast<int*>(s_ang + MAX_MULTIPHASE_ROWS);
  int* s_rm = s_lm + MAX_MULTIPHASE_ROWS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + slots * size + EXTRA_WORDS + OP_SLOTS * OP_SLICE_FLOATS);

  const int tile_shift = __popc(a.free_mask);       // log2 tiles per state
  const unsigned plane_bytes = static_cast<unsigned>(size) * 4u;
  // a part is 2^part_log2 consecutive tile rows, `reqs` boxes of
  // 2^(b2 + b3) rows
  const int parts = 1 << cu.parts_log2;
  const int part_log2 = a.tile_bits - LANE_BITS - cu.parts_log2;
  const int reqs = 1 << (part_log2 - cu.b2 - cu.b3);
  const int nk = static_cast<int>((steps - blockIdx.x + gridDim.x - 1)
                                  / gridDim.x);     // this block's steps
  if (threadIdx.x < slots + OP_SLOTS) mbar_init(&bars[threadIdx.x], 1);
  if (threadIdx.x == 0)
    asm volatile("prefetch.tensormap [%0];"
                 :: "l"(reinterpret_cast<uint64_t>(&map)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  OpRing ring = op_ring(smem + slots * size, bars + slots, a.desc, a.ops,
                        a.nstages, a.tile_bits, TIER, nk);
  PHASE_START(t_block);

  // thread 0: refill the slot of plane j, part by part. Before part i it
  // waits for the store group of part i of the slot's previous plane
  // j - S; the stores of planes up to `last` are committed, so (last -
  // (j - S)) * P + P - 1 - i groups follow that one.
  auto refill = [&](int j, int last) {
    const int kj = j >> 1;
    const long long g = blockIdx.x + static_cast<long long>(kj) * gridDim.x;
    const int plane = 2 * (a.state0 + static_cast<int>(g >> tile_shift))
                      + (j & 1);
    const int base = tile_base(g & ((1ull << tile_shift) - 1), a.free_mask)
                     | a.fixed_rows;
    uint64_t* bar = &bars[kj % slots];
    if ((j & 1) == 0) mbar_arrive_expect(bar, 2 * plane_bytes);
    float* dst = smem + (j % slots) * size;
    for (int i = 0; i < parts; ++i) {
      if (j >= slots)
        bulk_wait_n<ON_READ>((last - (j - slots)) * parts + parts - 1 - i);
      plane_boxes<true>(&map, cu, a, base, i << part_log2, reqs, plane, dst,
                        bar);
    }
  };

  if (threadIdx.x == 0)
    for (int j = 0; j < min(slots, 2 * nk); ++j) refill(j, -1);
  for (int k = 0; k < nk; ++k) {
    PHASE_START(t_step);
    const long long g = blockIdx.x + static_cast<long long>(k) * gridDim.x;
    const int state = a.state0 + static_cast<int>(g >> tile_shift);
    const int base = tile_base(g & ((1ull << tile_shift) - 1), a.free_mask)
                     | a.fixed_rows;
    for (int r = threadIdx.x; r < rows; r += NTHREADS)
      row_id[r] = tile_row(base, r, a.inner_bits, a.scat_mask);
    __syncthreads();
    mbar_wait(&bars[k % slots], (k / slots) & 1);
    // the later steps' planes of the slots step k - 1 stored
    if (threadIdx.x == 0)
      for (int j = max(max(2 * k + 2, 2 * k - 2 + slots), slots);
           j < min(2 * k + slots, 2 * nk); ++j)
        refill(j, 2 * k - 1);
    PHASE_ADD(PC_PROLOGUE, t_step);

    const Tile t{smem + ((2 * k) % slots) * size,
                 smem + ((2 * k + 1) % slots) * size, row_id, a.tile_bits};
    PHASE_START(t_chain);
    run_chain<TIER>(t, a, state, s_ang, s_lm, s_rm, ring);
    PHASE_ADD(PC_CHAIN, t_chain);
    fence_proxy_async();
    __syncthreads();

    if (threadIdx.x == 0) {
      for (int p = 0; p < 2; ++p) {
        for (int i = 0; i < parts; ++i) {
          plane_boxes<false>(&map, cu, a, base, i << part_log2, reqs,
                             2 * state + p, p ? t.im : t.re, nullptr);
          bulk_commit();
        }
        // the next step's plane for the slot this store frees, at once
        const int j = 2 * k + p + slots;
        if (j < 2 * nk && (j >> 1) == k + 1) refill(j, 2 * k + p);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait<0, false>();   // every store has landed
  PHASE_ADD(PC_BLOCK, t_block);
  PHASE_COUNT(PC_BLOCKS);
}

// ---- launch --------------------------------------------------------------

enum { D_DECOUPLED = 0, D_INPLACE = 1, D_GRID = 2 };   // segment.py DRIVER_CODE

// beside the plane slots (each with its mbarrier; K3's tile one): row ids,
// multiphase rows, the stage scratch, the operator ring and its mbarriers
constexpr long long FIXED_SMEM_BYTES =
    EXTRA_WORDS * 4LL + OP_SLOTS * (OP_SLICE_BYTES + 8LL);

long long grid_smem_bytes(int tile_bits) {
  return (2LL << tile_bits) * sizeof(float) + FIXED_SMEM_BYTES + 8LL;
}

long long ring_smem_bytes(int tile_bits, int slots) {
  return static_cast<long long>(slots) * (4LL << tile_bits)
      + FIXED_SMEM_BYTES + 8LL * slots;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, long long smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int TIER>
cudaError_t launch_grid(const SweepArgs& a, long long blocks, int states,
                        long long smem, const CUtensorMap& map,
                        const CopyUnit& cu, cudaStream_t stream) {
  cudaError_t e = set_smem(segment_kernel<TIER>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(states));
  segment_kernel<TIER><<<grid, NTHREADS, static_cast<size_t>(smem), stream>>>(
      a, map, cu);
  return cudaGetLastError();
}

// A launch's tensor map (every driver's): dims, byte strides of
// dimensions 2-5, the box and the copy unit (band_plan.tma_boxes computes
// the same; the wrapper checks the two agree). False for a copy unit the
// geometry cannot take: `parts` a power of two up to MAX_TMA_PARTS and the
// tile's rows, `box_rows` a power of two within a part and within the
// tile rows that are contiguous in slot order (inner rows, then the lowest
// scattered group).
struct TmaGeometry {
  cuuint64_t dims[5];
  cuuint64_t strides[4];
  cuuint32_t box[5];
  CopyUnit cu;
  int requests_per_plane;
};

bool tma_geometry(int n, int tile_bits, int inner_bits, unsigned scat_mask,
                  int batch, int parts, int box_rows, TmaGeometry* t) {
  const int row_bits = n - LANE_BITS;
  const int rows_log2 = tile_bits - LANE_BITS;
  if (parts < 1 || parts > MAX_TMA_PARTS || (parts & (parts - 1))
      || parts > (1 << rows_log2) || box_rows < 1 || (box_rows & (box_rows - 1)))
    return false;
  const int part_log2 = rows_log2 - log2i(parts);
  int s0 = row_bits, w = 0;
  if (scat_mask) {
    s0 = __builtin_ctz(scat_mask);
    while ((scat_mask >> (s0 + w)) & 1u) ++w;
  }
  const int b = log2i(box_rows);
  if (b > part_log2 || b > inner_bits + w) return false;
  const int b2 = b < inner_bits ? b : inner_bits;
  const cuuint64_t row_bytes = LANES * 4ull;
  const cuuint64_t dims[5] = {LANES, 1ull << s0, 1ull << w,
                              1ull << (row_bits - s0 - w), 2ull * batch};
  const cuuint64_t strides[4] = {row_bytes, row_bytes << s0,
                                 row_bytes << (s0 + w), 4ull << n};
  const cuuint32_t box[5] = {LANES, 1u << b2, 1u << (b - b2), 1u, 1u};
  for (int d = 0; d < 5; ++d) t->dims[d] = dims[d], t->box[d] = box[d];
  for (int d = 0; d < 4; ++d) t->strides[d] = strides[d];
  t->cu = CopyUnit{s0, w, b2, b - b2, log2i(parts)};
  t->requests_per_plane = parts << (part_log2 - b);
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Encode the map over the batch's planes at `amps` (f32, no interleave,
// no swizzle; boxes never leave the tensor, so no fill). The driver's
// cuTensorMapEncodeTiled is fetched through the runtime, so the library
// links nothing beyond it. Returns cudaSuccess, the runtime's error, or
// TMA_ERROR_BASE + the driver's CUresult.
int encode_map(CUtensorMap* map, void* amps, const TmaGeometry& t) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, amps, t.dims, t.strides, t.box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ERROR_BASE + static_cast<int>(r);
}

template <int TIER, bool ON_READ>
cudaError_t launch_ring(const SweepArgs& a, long long steps, int slots,
                        long long smem, const CUtensorMap& map,
                        const CopyUnit& cu, cudaStream_t stream) {
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
  kernel<<<blocks, NTHREADS, static_cast<size_t>(smem), stream>>>(
      a, slots, steps, map, cu);
  return cudaGetLastError();
}

template <int TIER>
cudaError_t launch(const SweepArgs& a, long long blocks, int states,
                   int driver, int slots, long long smem,
                   const CUtensorMap& map, const CopyUnit& cu,
                   cudaStream_t stream) {
  const long long steps = blocks * states;
  switch (driver) {
    case D_GRID:
      return launch_grid<TIER>(a, blocks, states, smem, map, cu, stream);
    case D_DECOUPLED:
      return launch_ring<TIER, true>(a, steps, slots, smem, map, cu, stream);
    case D_INPLACE:
      return launch_ring<TIER, false>(a, steps, slots, smem, map, cu, stream);
    default: return cudaErrorInvalidValue;
  }
}

#ifdef QUEST_PHASE_COUNTERS
__global__ void __launch_bounds__(NTHREADS, 1)
fma_probe(float* out, int iters) {
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = static_cast<float>(threadIdx.x + i);
  float x = 1.0f + threadIdx.x * 1e-6f;
  const float y = 1e-3f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = fmaf(acc[i], x, y);
    x += 1e-7f;
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) sum += acc[i];
  out[blockIdx.x * NTHREADS + threadIdx.x] = sum;
}
#endif

}  // namespace

extern "C" {

// Layout constants the Python packer checks against before a launch.
int quest_segment_desc_words() { return DESC_WORDS; }
int quest_segment_max_tile_bits() { return MAX_TILE_BITS; }
int quest_segment_max_multiphase_rows() { return MAX_MULTIPHASE_ROWS; }
int quest_segment_op_slice_bytes() { return OP_SLICE_BYTES; }
int quest_segment_max_grid_batch() { return MAX_GRID_BATCH; }

// Least dynamic shared memory of one launch: the grid driver's two tile
// planes and their mbarrier, or a ring of `slots` plane slots with one
// mbarrier each, beside the row ids, multiphase rows, the stage scratch and
// the operator ring (band_plan.smem_layout
// computes the same; the wrapper checks the two agree).
long long quest_segment_smem_bytes(int tile_bits, int driver, int slots) {
  return driver == D_GRID ? grid_smem_bytes(tile_bits)
                          : ring_smem_bytes(tile_bits, slots);
}

const char* quest_cuda_error_string(int code) {
  if (code >= TMA_ERROR_BASE)
    return "cuTensorMapEncodeTiled refused the launch's tensor map "
           "(code - 10000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A launch's tensor map (host only, no device): out[0..4]
// its dims, out[5..8] the byte strides of dimensions 2-5, out[9..13] the
// box, out[14] the requests per plane. Returns 0, or cudaErrorInvalidValue
// for a copy unit the geometry cannot take (tma_geometry).
int quest_segment_tma_geometry(int n, int tile_bits, int inner_bits,
                               unsigned scat_mask, int batch, int parts,
                               int box_rows, long long* out) {
  TmaGeometry t;
  if (!tma_geometry(n, tile_bits, inner_bits, scat_mask, batch, parts,
                    box_rows, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < 5; ++d) out[d] = static_cast<long long>(t.dims[d]);
  for (int d = 0; d < 4; ++d) out[5 + d] = static_cast<long long>(t.strides[d]);
  for (int d = 0; d < 5; ++d) out[9 + d] = static_cast<long long>(t.box[d]);
  out[14] = t.requests_per_plane;
  return 0;
}

// Encode that map on `amps` `count` times, as each launch does once
// (the caller times it: the host cost of a launch's map). Returns 0 or the
// first failure (encode_map's codes).
int quest_segment_tma_encode(void* amps, int n, int tile_bits, int inner_bits,
                             unsigned scat_mask, int batch, int parts,
                             int box_rows, int count) {
  TmaGeometry t;
  if (!tma_geometry(n, tile_bits, inner_bits, scat_mask, batch, parts,
                    box_rows, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  for (int i = 0; i < count; ++i)
    if (const int e = encode_map(&map, amps, t)) return e;
  return 0;
}

// Launch one segment over states [state0, state0 + states) of a batch of
// `batch` states on `stream` (`sel`: the selection table (slots, batch,
// 8), or null when no stage reads it), the matrix stages at matmul `tier`
// (T_HIGHEST, T_HIGH or T_DEFAULT), under `driver` (D_DECOUPLED,
// D_INPLACE with `slots` plane slots, or D_GRID, whose launch takes at
// most MAX_GRID_BATCH states) with `smem` bytes of dynamic shared memory.
// Each state's tiles are the 2^popc(free_mask) `blocks` values of its
// free row bits, fixed_rows ORed in (SweepArgs). Every driver moves each
// plane as `box_rows`-row boxes (the ring drivers in `parts` parts)
// through a tensor map over the whole batch, encoded here per launch (it
// holds `amps`). Returns the launch's cudaError_t, or
// encode_map's code when the map is refused (no launch then): nothing is
// allocated and nothing is synchronised here.
#ifdef QUEST_PHASE_COUNTERS
// The yardstick of the fp32 FMA pipe at this card's clocks and power:
// `blocks` blocks of NTHREADS threads, each thread 128 independent fp32
// FMA chains of `iters` steps (operands in registers), their sums in
// `out` (blocks * NTHREADS floats). 2 * 128 * iters flops per thread.
int quest_fma_probe(float* out, int blocks, int iters, void* stream) {
  fma_probe<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}

// The phase counters (PC_* order, PC_COUNT of them) into `out`, then to 0
// when `reset`.
int quest_segment_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, quest_phase_cycles,
                                       sizeof(quest_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[PC_COUNT] = {};
    e = cudaMemcpyToSymbol(quest_phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#endif

int quest_segment_sweep(void* amps, int n, int tile_bits, int inner_bits,
                        unsigned scat_mask, unsigned free_mask,
                        unsigned fixed_rows, const void* desc, int nstages, const void* ops,
                        long long blocks, int batch, int state0, int states,
                        const void* sel, int tier, int driver, int slots,
                        int parts, int box_rows, long long smem,
                        void* stream) {
  const unsigned row_bits = (1u << (n - LANE_BITS)) - 1u;
  const unsigned inner = (1u << inner_bits) - 1u;
  if (tile_bits < LANE_BITS + 3 || tile_bits > MAX_TILE_BITS
      || (free_mask & (scat_mask | inner)) || (free_mask & ~row_bits)
      || (fixed_rows & (free_mask | scat_mask | inner | ~row_bits))
      || blocks != (1ll << __builtin_popcount(free_mask))
      || batch < 1 || state0 < 0 || states < 1
      || static_cast<long long>(state0) + states > batch
      || (driver == D_GRID && states > MAX_GRID_BATCH) || blocks < 1
      || (driver != D_GRID && (slots < 2 || slots > MAX_SLOTS))
      || smem < quest_segment_smem_bytes(tile_bits, driver, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs a{static_cast<float*>(amps), n, tile_bits, inner_bits,
                    scat_mask, free_mask, fixed_rows,
                    static_cast<const long long*>(desc),
                    nstages, static_cast<const float*>(ops), batch,
                    static_cast<const float*>(sel), state0};
  auto* st = static_cast<cudaStream_t>(stream);
  CUtensorMap map{};
  TmaGeometry t{};
  if (!tma_geometry(n, tile_bits, inner_bits, scat_mask, batch, parts,
                    box_rows, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = encode_map(&map, amps, t)) return e;
  cudaError_t e;
  switch (tier) {
    case T_HIGHEST:
      e = launch<T_HIGHEST>(a, blocks, states, driver, slots, smem, map, t.cu, st);
      break;
    case T_HIGH:
      e = launch<T_HIGH>(a, blocks, states, driver, slots, smem, map, t.cu, st);
      break;
    case T_DEFAULT:
      e = launch<T_DEFAULT>(a, blocks, states, driver, slots, smem, map, t.cu, st);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
