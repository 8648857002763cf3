#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --upto stages   # build + per-stage checks only
    python3 chip_smoke.py --diag-runs     # the S5/S6 run timings and the
                                          # flagship step at each tier
    python3 chip_smoke.py --ham-profile   # profiler tables of the
                                          # Hamiltonian layers, 30 qubits
    python3 -c "import torch, chip_smoke as C; C.phase_build();
                C.phase_f64(torch)"      # one phase alone

Drives quest_tpu_torch (never JAX, never quest_tpu) on the card. Every
phase runs the default segment driver, K1 (QUEST_FUSED_DRIVER=pipelined,
QUEST_FUSED_PIPELINE=1), unless it names another:

  1. prints the card's name and power limit (nvidia-smi) and builds the
     segment kernel (csrc/segment.cu) for sm_90a from the checkout: nine
     instantiations, the three drivers at the three matmul tiers, and its
     phase-counter build beside it (two nvcc processes at once); while
     nvcc compiles, the probe and sanitize subprocesses start (they wait
     on the build lock, their timeouts counted from the build's end),
     a host thread runs the host half of the front ends (phase 34) and
     three more draw the seeded full-width input planes of diag_layer,
     dma_floor, stage_timing, phase_counters and scan;
     probe: in a subprocess with a 120 s timeout (a slip of an mbarrier's
     phase hangs rather than errs), the first launches of every driver —
     K1, K2 at 2, 3 and 8 plane slots, K3 — on every stage case below,
     on segments whose blocks walk many tiles (26 qubits, an 11-bit
     tile, 16 states), on the scattered-row geometries of the paths'
     plans ((0,(7,)), (4,(1,1,1)), (0,(6,1)), (5,(1,1)): 5 states, a
     diagonal with controls) and on S7 at 1, 2, 8 and 64 terms:
     bit-identical to K3, K3 within 1e-5 of the plain version;
  2. per-stage check at 20 qubits: one segment per stage kind S1-S8 and
     S10 (b0; b1 d=128 and d=32; scb d=128/64/4, one real; sc; phase;
     parity; multiphase; a matrix stage with lane and row predicates;
     Kraus pairs in every form the Hopper planner emits — lane/scat,
     lane/sub, sub/scat, sc/scat, real-only, with predicates; diagonals
     of 1, 3 and 7 targets with controls; chains), plus row bits above 15
     at 23 qubits: kernel against its plain PyTorch version on the same
     inputs, max|diff| <= 1e-5 max|amp|; and batched segments (5 states
     of 17 qubits, each with its own selection-table rows): S9
     (BatchSelStage) on a lane bit, inner rows and a scattered bit, within
     1e-6 max|amp|, and a barrier S9 leading a chain of other kinds;
     S5/S6 runs (two around a b0, 65 stages cut 64 + 1) and a
     phase-only segment that launches half its tiles;
     diag_layer: entry.diag_layer_circuit (rz on every qubit, cphase on a
     ring; one launch of 54 stages) and entry.cz_brick_circuit at 28
     qubits under K1, K2 and K3: against the plain path, bit-identical
     across drivers, within 1e-5 of the same stages one per segment (bit
     for bit where every run keeps the exact form) and, launched in
     pieces of 7 stages (exact-form runs), bit for bit those one-stage
     segments;
     big_batch (ROADMAP C1): 65,539 states of 10 qubits through one
     segment under every driver, against the plain version and bit for
     bit against the batch split by hand (K3 launches in slices of
     65,535 states); high_target (C2): a diagonal on qubits (32, 3) of a
     33-qubit state (64 GiB), chosen basis amplitudes against the
     table's entries and a chunked norm; drivers: the flagship at HIGHEST, HIGH and DEFAULT, 30q d20, the
     density step, the batched step and the first trajectory chunk, each
     compiled under K1 (run twice), K2 at 2 and 3 slots and K3: planes
     (and draws) bit-identical across drivers and runs, every launch on
     its driver, median ms per driver; dma_floor: at 28 qubits, per
     driver, profiling.sweep_dma_report (the stage-free launch, each
     flagship sweep's total and compute adder), the stage-free launch on
     a scattered-row geometry (7 scattered row bits) beside its time
     before the driver's tensor-map copies and its requests per plane,
     and single-stage launches beside the bound and a torch copy_ of the
     planes (the yardstick, never called by the port); K3's stage-free
     launches on inner-row and scattered tiles beside copy_, the bound
     and their times before the tensor-map copies; under K1 the
     tensor-map copy units (512-byte rows, one box per plane, 2 and 4
     parts refilled one by one) on the scattered and inner-row copies and
     on scb-128 and b0 at DEFAULT, and the host time of one map's
     encoding; sanitize: compute-sanitizer memcheck and
     racecheck on a 17-qubit segment per driver, in subprocesses
     (memcheck must be clean where the tool brings the device up; where
     it cannot, its message is recorded);
  3. the main path: quest_tpu_torch.entry.entry() (28 qubits, RCS depth 4,
     seed 7) through the kernel, with the launch counters (all launches
     and launches per stage kind) set to 0 just before and read just after; compared with the plain path on the card
     (max|diff| <= 1e-4 max|amp|, |1 - norm| <= 1e-4); median of 5 warm
     steps;
  4. the BASELINE config, 30-qubit RCS depth 20 on one card: launch
     count, compared with the plain path on the card (max|diff| <= 1e-4
     max|amp|), norm, median time;
  5. density: quest_tpu_torch.entry.density_entry() — noisy RCS depth 3
     (seed 11) on a 14-qubit density register, 28 state qubits — with the
     counters set to 0 just before and read just after: launches per
     stage kind equal to the plan; against the plain path on the card
     (max|diff| <= 1e-4 max|amp|), |1 - Tr rho| <= 1e-4, max|rho - rho^+|
     <= 1e-4 max|amp|, purity <= 1 + 1e-4; median of 5 warm steps;
  6. density_bench: the repo bench's density scenario at 15 qubits (30
     state qubits, 8 GiB), iters=4, plain path first (out of place), the
     same checks; its 4-target depolarising superoperator runs through
     apply_matrix_rows between launches, as the reference runs it
     outside its kernel;
  7. clifford_t_density: Clifford+T with damping at 14 qubits, the same
     checks; its plan holds the path's general diagonals;
  8. batched: quest_tpu_torch.entry.batched_entry() — the flagship circuit
     at 24 qubits on a batch of 64 random states (8 GiB), one launch per
     swept segment for the whole batch — counted against the unbatched
     plan, against the plain path (max|diff| <= 1e-4 max|amp|), per-state
     |1 - norm| <= 1e-4, 4 states against the unbatched program; ms per
     call and per state beside the unbatched step x 64;
  9. trajectory_physics: noisy RCS d3 on 14 qubits, 1024 trajectories:
     <Z_q> of every qubit within 5 sigma of the density path on the card
     (density_entry's state, 28 state qubits);
 10. trajectories: quest_tpu_torch.entry.trajectory_entry() — the bench's
     trajectory scenario, noisy RCS d3 on 24 qubits, 256 shots in chunks
     of 64 with a per-chunk <Z_23> reduction — with the counters set to 0
     just before and read just after: launches per chunk equal to the
     plan; the first chunk's 64 shots again through the kernel and all
     of them through the plain path, 8 shots per call (draws equal,
     planes within 1e-4 max|amp|, |1 - norm| <= 1e-4), and its first 8
     shots through the kernel alone (the same launches and planes);
     shots/s and the bound per chunk;
 11. precision_stages: every matrix-stage case above (and b1/scb at the
     other widths the planner emits) at the HIGH and DEFAULT matmul tiers
     (S11): the tier's kernel against the tier's plain version (1e-5 x
     max|amp|; a chained case may round an input one bf16 step apart, see
     tier_agreement) and against the HIGHEST kernel (different bits,
     within 1e-4 / 1e-2 x max|amp|);
 12. precision_flagship: entry() compiled at HIGH and at DEFAULT, counted
     (9 launches, '@high'/'@default' labels), against the tier's plain
     path and the HIGHEST kernel (1e-4 / 1e-2 x max|amp| and norm, or 1.5x
     the distance the tier's own plain version shows: see envelope);
     median of 5 warm steps;
 13. precision_baseline: 30q d20 at HIGH the same way (5e-4), 46 launches;
 14. precision_density: density_entry() at HIGH, the same way, with Tr
     rho and purity within 1e-4 of the HIGHEST run's (or the plain
     version's envelope) and Hermiticity;
 15. single-stage segments at 28 qubits — b0, b1, scb-128, sc, phase,
     parity, multiphase (8 terms of both forms, and the main paths' 2
     all-ones terms), each Kraus pair form and a diagonal, and b0,
     b1, scb-128 at HIGH and DEFAULT — and S9 at 24 qubits x 64 states on
     a lane bit, a row bit and a scattered bit: kernel, plain version
     and, where PyTorch computes the same function, that yardstick (the
     port never calls it): one call, or for HIGH the three bf16 calls of
     the split parts together. b0, b1-128 and scb-128 at every tier and
     the diagonal also print their time before the tensor-map copies and
     S8's redesign, the 8-term multiphase its time before S7's factored
     angles; and diag_run_cases — the diagonal layer's and the cz
     brick's launches in the angle form and the exact form, the brick's
     multiphase alone, the flagship's launch 0 (two parity stages and a
     b0) beside its b0 alone — with phase and parity their time before
     the runs and the skip (before_redesign_ms);
 16. phase_counters: the same b0, b1-128 and scb-128 launches at each
     tier, a phase stage and both multiphase rows through the kernel's
     phase-counter build (profiling.segment_phase_report: cycles per
     block in operator-slice waits and releases, step prologues and the
     chain) with the prologue's share on inner-row (b0, b1) and
     scattered-row (scb-128) tiles per tier; K3 launches (stage-free, a
     phase stage, b0 at DEFAULT) with their prologue, chain and store
     shares of a block; and the fp32 FMA rate the card sustains
     (profiling.fma_rate).

 17. pergate: entry.pergate_entry() — the flagship (28q RCS d4, f32)
     through the per-gate engine (Circuit.compiled: every op through
     ops/apply, no kernel launch) — against K1's fused step within 1e-4
     x max|amp|; ms per step (median of 5), state passes (a pass: the
     state read and written once) and their bound;
 18. banded: entry.banded_entry() through compiled_banded at HIGHEST
     (against pergate within 1e-4 x max|amp|), HIGH and DEFAULT (against
     HIGHEST within the tier's envelope, the fused plain version's
     distance from precision_flagship); ms, passes, bound;
 19. f64: the flagship at f64 through compiled_fused (its plan's banded
     items) and compiled, within 1e-12 x max|amp| of each other, norm
     within 1e-12, and within 1e-4 of the f32 fused step; 30q d20 at f64
     (16 GiB) through compiled_banded, one step, its norm, ms and peak
     memory; density_entry at f64 (28 state qubits): trace, Hermiticity
     and purity within 1e-12;
 20. wide_gates: BASELINE config 3 at 28 qubits (entry.wide_gates_circuit:
     a 5-target and a 6-target Haar unitary and a 2-target unitary under
     3 controls after RCS d4) through compiled_fused (K1 segments, the
     three matrices as passthroughs; launches counted against the plan),
     compiled_banded and compiled, all within 1e-4 x max|amp|;
 21. small_registers: the tutorial on 3 qubits and random 5- and 9-qubit
     circuits through compiled_fused (the banded fallback) on the card and
     the CPU, f32 within 2e-5 and f64 within 1e-12 x max|amp|; the
     tutorial's prob |111> = 0.112422 and prob(qubit 2 = 1) = 0.749178
     within 1e-6;
 22. batched_banded: batched_entry()'s call through compiled_batched(
     engine='banded') against the fused call within 1e-4 x max|amp|, and
     16 of its states at f64 against the f32 result; ms per call;
 23. trajectories_banded: 1024 shots at 9 qubits through the default
     engine (banded), <Z_q> within 5 sigma of the f64 density path; at 14
     qubits engine='banded' against 'fused' from one generator state:
     draws equal wherever no uniform lies within 1e-5 of a branch
     boundary, planes of equal-draw shots within 1e-4 x max|amp|.

 The QuEST user surface (PR 11; no kernel is added, the states come from
 the paths above):
 24. program_cache: the flagship's apply_fused 5 times plans once
     (fused_plan counted) and launches its segments every call; a tier
     flip plans once more, within HIGH's envelope of HIGHEST; the same
     for apply_batched (24q x 64); first-call and cached-call host ms;
 25. measurement: on the 30q d20 state, calc_prob_of_outcome of every
     qubit against one f64 pass over all 30 marginals (1e-6); sample of
     2^20 shots, each qubit's frequency within 5 sigma, peak memory <= 18
     GiB; measure_with_stats and collapse_to_outcome, norm within 1e-5,
     the other outcome at P <= 1e-6;
 26. xeb: entry.xeb_entry() — the flagship step, 2^20 samples, the linear
     XEB against an f64 recomputation (1e-4); ms of each part;
 27. dynamic: entry.measured_entry() — a repetition-code cycle on 28 data
     qubits + 2 ancillas (30 qubits) under engine='banded' and 'xla' from
     equal seeds: identical outcomes, planes within 1e-4 x max|amp|, reset
     ancillas at P(1) <= 1e-6; ms per cycle;
 28. calculations: inner product, fidelity and a 56-term Ising
     expectation on the flagship state, purity, density inner product,
     Hilbert-Schmidt distance and density fidelity on the density step's
     register, each against an f64 recomputation on the card (1e-5); ms
     and peak memory;
 29. eager: the tutorial through ops.gates (0.112422, 0.749178 within
     2e-6); a 20-gate eager sequence at 28 qubits and with 3 channels on a
     12-qubit density register against the same circuit's per-gate
     program (1e-6 x max|amp|).

 The Hamiltonian layers (PR 12; no kernel is added; each phase prints
 its wall seconds):
 30. expec: on a 30-qubit state (random circuit depth 4), TFIM-30 (60
     terms) and the bench's 100-term random-support sum through
     calc_expec_pauli_sum, grouped (QUEST_EXPEC_FUSION=1) and per term
     (0), each within 1e-5 x max(|E|, 1) of an f64 recomputation on the
     card; TFIM-14 on density_entry's register (28 state qubits) the same
     way; apply_pauli_sum of TFIM-30 (<psi|H psi> against the f64
     energy); sweeps, ms, peak memory and the byte bound of each;
 31. evolution: entry.evolution_entry() — the TFIM-30 quench, order 2,
     dt 0.05, 4 steps, the energy after each — through the fused engine
     (every launch K1, counted), against engine='banded' (planes within
     1e-4 x max|amp|, energies within 1e-5 relative); one legacy
     per-term step (QUEST_TROTTER_FUSION=0) against one fused step;
     imaginary time at 26 qubits, 8 steps (the energy never rises by
     more than 1e-5 relative, the norm within 1e-5 of 1); ms per step of
     each engine, each launch's device ms, K1 launches per step and
     their stage mix, the byte bound and the operations bound per step;
 32. variational: at 20 qubits a 2-layer hardware-efficient ansatz's
     torch.autograd gradient against the parameter-shift rule for all 80
     parameters (1e-4); sweep of 32 parameter sets at 16 qubits against
     the per-set loop (1e-6);
 33. adjoint: entry.vqe_entry() at 30 qubits (120 parameters, the
     adjoint walk): two parameters against the parameter-shift rule
     (1e-3), peak memory above the base within 3 x 8 GiB + 1 GiB, ms of
     the forward and the backward walk; at 20 qubits adjoint against
     taped (1e-5 values, 1e-4 gradients); a 10-qubit density register's
     gradients against the statevector ones (1e-5); what 'auto' chooses
     at 20 and 30 qubits and its capacity numbers.

 The front ends (no kernel is added; each phase prints its wall
 seconds):
 34. frontends: the repo bench's QASM gallery (entry.gallery_qasm: qft,
     qaoa, rcs, adder, ghz in the rebased 1q+CX basis) at 28 qubits:
     per class the ops and stream_cost sweeps raw and transpiled, host ms
     of the import, the transpile and the autotune search (cold and warm,
     in a throwaway QUEST_PLAN_CACHE_DIR; taken on a host thread while
     nvcc builds, phase 1), the chosen engine and its
     priced ms; the raw and the transpiled stream through compiled_fused
     (K1 launches counted, at least one; warm step ms, median of 3, CUDA
     events), the transpiled planes within 1e-4 x max|amp| of the raw and
     each norm within 1e-4 of 1; ghz on its measured program, raw and
     transpiled outcomes equal given the same uniforms, and the GHZ
     prefix with every qubit measured giving equal bits within each
     shot. At 24 qubits every selectable engine (per-gate, banded,
     fused) of the transpiled qft and of rcs, timed: priced against
     measured ms and whether autotune's pick was the fastest (printed,
     not gated; the engines' planes agree within 1e-4 x max|amp|);
 35. api: the tutorial through quest_tpu_torch.api on the card
     (0.112422, 0.749178 within 1e-6; the recorded QASM byte-equal to the
     same script's with device="cpu"); a QuEST-style script of ~200 API
     calls (gates, calcProbOfOutcome, one seeded measure) on a 28-qubit
     register beside the same calls through ops.gates: host ms per call
     of each and the front end's overhead per call; the final planes bit
     for bit equal.
 36. scan: QUEST_FUSED_SCAN at 0 and 1 on the 28q QFT and on the 28q
     diagonal layer run 8 times in one program (eight sweeps of one
     structure: one group of the reference's scan partition): planes bit
     for bit, launches, build s and warm ms of each;
 37. sharded: the 28q flagship over 4 shards of the one card through
     compiled_sharded_fused (K1 on every shard), compiled_sharded_banded
     and compiled_sharded, each within 1e-4 x max|amp| of entry()'s K1
     step with its norm within 1e-4 and the mesh recorder's exchanges
     equal to comm_stats' prediction (and to the dry walk's); warm ms,
     K1 launches per shard, exchanges and bytes, one pair permute's and
     one relabel all-to-all's ms (device-local copies on one card); then
     phase_baseline's 30q d20 through the fused engine, one warm step,
     against the single-register K1 step;
 38. sharded_batched: 24q x 64 states over 4 shards against
     compiled_batched within 1e-4 x max|amp|, launches per shard;
 39. sharded_measured: the 30q repetition-code cycle over 4 shards
     (engine 'fused'), fed the uniforms of the single-register measured
     program with the first forcing outcome 1, so the feedback flips a
     global ancilla: equal outcomes, planes within 1e-4 x max|amp|, the
     recorder's exchanges equal to the schedule priced on the run's
     outcomes, ms a cycle.

 The sharded consumers and durable execution (no kernel is added;
 each phase prints its wall seconds):
 40. sharded_consumers: a 30-qubit state (8 GiB of f32 planes) over 4
     shards of the card against the same state on one register:
     calc_total_prob, calc_prob_of_outcome on a local and a global qubit,
     collapse_to_outcome and a seeded measure (1e-5, planes 1e-4 x
     max|amp|); sample of 2^20 shots given the same uniforms: the share
     of indices equal to one register's (f32 CDFs tie runs of
     neighbours), every pick of both samplers within 2^-20 of a correct
     inverse-CDF pick in f64, and the total-variation distance to
     |amp|^2 on the 20 low qubits' marginal within 1.2x the multinomial
     noise expected there; calc_expec_pauli_sum of TFIM-30 (1e-5
     relative; its exchanges equal to the distinct global flip masks);
     value_and_grad(mesh=) of entry.hea_circuit at VQE_QUBITS (energy
     1e-5 relative, gradients 1e-4; exchanges equal to
     predict_vjp_collectives; ms and peak GiB); run_evolution(mesh=) of
     TFIM-30, 4 steps (1e-4 x max|amp|, K1 launches a shard); the priced
     autotune(devices=4) of the 28q flagship (the chosen plan, search
     ms). Every measured call's ms.
 41. durable: random_circuit(28, 20) through run_durable(engine='fused')
     (one K1 launch or one passthrough a step, `every` set for one
     checkpoint before the kill) preempted at a seeded step by a
     FaultPlan and resumed:
     bit for bit the uninterrupted run_durable and compiled_fused; the
     same on 4 shards (engine 'sharded'), bit for bit
     compiled_sharded_fused; the 4-shard chain re-entered elastically on
     one register (within 1e-4 x max|amp| of compiled_fused, as
     tests/test_elastic.py holds a general circuit); one
     save_sharded(block=False) while the register keeps evolving, the
     restored planes equal to the snapshot. K1 launches, steps,
     checkpoint GiB, each run's mean ms to take a checkpoint (sentinel,
     copy, reorder, hash, write: the executor's durable_checkpoint_s),
     the ms to hash one checkpoint measured alone, and the resume's
     extra ms. Checkpoints go to a temporary directory
     removed at the end of the phase.

 Serving with the native host engine as its floor (no kernel is added):
 42. serve: ServeEngine on the card. The apply stream is the repo
     bench's serving workload (bench.py _measure_serve: 20 qubits, 16 rx
     rotations, 512 normalised states from default_rng(7), max_batch 64,
     max_wait_ms 5), at saturation (all submitted at once, after one
     warm request) and in the no-coalescing mode (max_wait_ms 0):
     requests/s, mean batch occupancy, p50/p99 end-to-end latency,
     batches and K1 launches (counters set to 0 before each run, read
     after); every output within 1e-4 x max|amp| of the state alone
     through compiled_fused, at most ceil(512/64) + 1 batches at
     saturation, no degraded dispatch. The observable stream: 64 of
     those states with a TFIM-20 PauliSum, each value within 1e-5
     relative of expec on the state alone. The trajectory stream: four
     requests of 64 shots (seeds 0-3) of entry.noisy_rcs_circuit(24, 3)
     with <Z_23> (K1 with S9, chunks of 64 states, 8 GiB): draws equal to
     run_batched's from the same generator state, values within 1e-4, ms
     per request and per chunk. The ladder: injected build failures on a
     12-qubit program fail their own requests while its breaker is
     closed and open it at the threshold; then requests complete on
     banded, then on host once banded fails too, within 1e-4 of K1, the
     degraded dispatches counted exactly, and after the cooldown one
     half-open probe restores fused. The host engine: compiled_host of the
     rotation circuit at 20 qubits and of the trajectory circuit's first
     unitary stretch at 24, each within 1e-4 of K1, ms a state beside
     K1's with the CPU's model and cores, and the native library's build
     seconds apart from its run time.

 The serving fleet (no kernel is added):
 43. fleet: the serve phase's circuit and first 128 states through one
     ServeEngine, a 2-replica thread ServeFleet and a 2-worker process
     ServeFleet on the card (each worker its own interpreter and CUDA
     context, launching K1), at saturation: requests/s, latency,
     occupancy; the process fleet's outputs bit for bit the one
     engine's (a), K1 launches per worker read from the workers'
     heartbeats just before and after the stream. Worker boot to hello
     cold (the first fleet) and warm (a respawn, a scale-up), and each
     context's memory by the card's free memory. (c) two 32-shot
     trajectory requests of noisy_rcs_circuit(20, 3) with a PauliSum
     <Z_19> through a worker: draws equal to run_batched's from the same
     generator state, values within 1e-4. (b) + (d): one card worker with
     48 requests held (max_queue 64); Autoscaler.tick() grows the fleet
     to 2 workers, the first worker is SIGKILLed with the 48 in flight
     (>= 32 gated), and the respawned worker serves them bit for bit the
     one engine's (losses, respawns, resubmits >= 1; kill to all
     resolved timed); after the drain the ticks shrink it back to 1,
     never outside [1, 2].

 Profiling and the runtime audits (no kernel is added):
 44. profiling: the flagship step once inside profiling.trace and
     profiling.annotate("flagship"): the device kernels the region
     launched, read back from the trace's JSON, are exactly the
     program's planned K1 launches (by their demangled names), their
     summed device time within 10 % of the same call's CUDA-event time;
     the traced step beside the untraced median (the profiler's cost).
     profiling.op_metrics of the flagship (one counted call) equal to
     program_bound's count. profiling.stage_report at 30 qubits (phase,
     b0, b1, scb-128 probe segments under K1): each case's state against
     the plain version applied as often, within 1e-4 max|amp| and norm
     within 1e-4; its ms, the cost model's band and the verdict (a DRIFT
     is a finding, not a failure).
 45. audit: at 10 qubits on the card, analysis.audit's golden check (a
     second pass builds no program and loads no library) and
     audit_knob_flips over every keyed knob (a same-value rerun builds
     nothing; each flip misses the per-gate, banded and fused caches);
     the driver flips launch K3 and K2 and the tier flip builds at HIGH.

 Meshes over processes (no kernel is added):
 46. multiprocess: the parent builds the kernel and the native library
     under build/quest_tpu_torch/.build.lock, then exec-spawns two rank
     processes (`chip_smoke.py --mp-rank r`, BUILD_ALLOWED False), each
     with its own CUDA context on cuda:0, joined by a gloo group through
     a FileStore in a temporary directory, each holding 2 of a 4-shard
     process mesh; every collective and the join are bounded, a dead
     rank fails the other and the phase. (a) the 28q flagship through
     compiled_sharded_fused on the process mesh: each rank's shards bit
     for bit the one-process 4-shard mesh's (priced alike: that mesh
     under QUEST_COMM_TOPOLOGY=hosts=2), within 1e-4 x max|amp| of
     entry()'s K1 step, the norm all-reduced within 1e-4, K1 launches a
     rank equal to the plan, issued exchanges equal to the prediction
     on both ranks, the topology derived (hosts = 2) with the knob
     unset; warm step ms (median of 3) beside the one-process mesh's,
     and one cross-process all-to-all split into copy-out, gloo and
     copy-in; K1 on rank 0's shards alone (rank 1 waiting) against the
     plain version; the flagship once through compiled_sharded_banded,
     with the same gates but the launches. (b) the reference worker's Bell pair with feedback
     at 28 qubits: both ranks read the same outcomes, the second 0.
     (c) gang durable at 26q d20: uninterrupted; preempted and resumed
     bit for bit; the mid-save kill (rank 1 dies between its slice and
     its stamp in the second save, rank 0 is preempted after it): the
     step never commits, both resume the same earlier cut, bit for bit;
     one gang save, hash and load timed per rank. Then, at 28 qubits
     over the same mesh: (d) value_and_grad(mesh=) with the adjoint walk
     of a 2-layer rx/ry ansatz (56 parameters) against TFIM-28: energy
     and gradient equal on both ranks, within 1e-5 relative of the
     one-process 4-shard mesh (rank 0 alone), issued exchanges equal to
     fn.comm_record; ms a call, its pair exchanges' copy-out / gloo /
     copy-in split and a rank's peak memory; (e) the taped engine on
     the process mesh at MP_TAPED_QUBITS, where auto picks it by
     capacity_stats (the widest such width of this ansatz on the card is
     recorded), within 1e-5 relative of the adjoint walk there; (f)
     plan.autotune(mesh=): both ranks' plans equal and equal to the
     one-process autotune(devices=4) under the mesh's topology; (g)
     save_sharded of a 28q register across the ranks (each writes its
     own shards), then load_sharded onto a one-process 4-shard mesh on
     each rank, bit for bit; ms a rank.

Every phase record carries `seconds` (since the phase began); the
`seconds` line before the kernels line lists them all.

Bounds (quest_tpu_torch.profiling's counting rules, which
profiling.op_metrics shares): bytes over 3.35 TB/s against operations
over their peak, fp32 at 67 TFLOP/s and the tiers' bf16 products at 989
TFLOP/s (H100 SXM data sheet); a segment of phase stages only counts the
rows its predicates select (moved_rows), the rest every row.

Each phase prints one JSON line. Before the last line come the kernels
line {"kernels": [...]} and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0
and no result line is printed. Without a CUDA device it exits 2 at once.
Everything it prints also goes to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the work counts and the card's rates behind every bound (bytes moved and
# operations done, over the H100's memory rate and peaks) live in the
# package, so the bounds here and profiling.op_metrics are one count
from quest_tpu_torch.profiling import (
    HBM_BYTES_PER_S, bound_ms, bound_of, passthrough_work, program_bound,
    segment_work, xla_bound, xla_item_work)

KERNEL_SOURCE = "quest_tpu_torch/csrc/segment.cu"
STAGE_TOL = 1e-5
PATH_TOL = 1e-4
TIMING_QUBITS = 28            # single-stage timings
BENCH_DENSITY_QUBITS = 15     # bench density scenario: 30 state qubits
CLIFFORD_T_QUBITS = 14
BATCHSEL_TOL = 1e-6
PHYSICS_SIGMAS = 5.0
PHYSICS_SHOTS = 1024
PLAIN_CHECK_SHOTS = 8
TIERS = ("high", "default")
# a tier's distance from the HIGHEST kernel, x max|amp| (and |1 - norm|):
# one stage, the flagship and density steps, and 30q d20 at HIGH
TIER_TOL = {"high": 1e-4, "default": 1e-2}
BASELINE_HIGH_TOL = 5e-4
ENVELOPE_SLACK = 1.5          # x the plain version's own distance
# one bf16 rounding step of an input, relative to it: HIGH's lo (an ulp
# of lo is at most 2^-14 of the value), DEFAULT's bf16 (2^-7)
FLIP_TOL = {"high": 2.0 ** -14, "default": 2.0 ** -7}
PHASES = ("build", "probe", "stages", "diag_layer", "big_batch",
          "high_target",
          "drivers", "dma_floor", "sanitize",
          "flagship", "baseline", "density",
          "density_bench", "clifford_t_density", "batched",
          "trajectory_physics", "trajectories", "precision_stages",
          "precision_flagship", "precision_baseline", "precision_density",
          "stage_timing", "phase_counters", "pergate", "banded", "f64",
          "wide_gates", "small_registers", "batched_banded",
          "trajectories_banded", "program_cache", "measurement", "xeb",
          "dynamic", "calculations", "eager", "expec", "evolution",
          "variational", "adjoint", "frontends", "api", "scan", "sharded",
          "sharded_batched", "sharded_measured", "sharded_consumers",
          "durable", "serve", "fleet", "profiling", "audit",
          "multiprocess")

RECORD = []
T_START = time.perf_counter()
# the phase main() is running and when it began: emit() stamps every
# phase record with its seconds since then; PHASE_SECONDS keeps each
# phase's whole time
PHASE_CLOCK = {"name": None, "t0": None}
PHASE_SECONDS = {}


def emit(obj) -> None:
    if ("phase" in obj and "seconds" not in obj
            and PHASE_CLOCK["t0"] is not None):
        obj["seconds"] = time.perf_counter() - PHASE_CLOCK["t0"]
    line = json.dumps(obj)
    print(line, flush=True)
    RECORD.append(obj)


def run_phase(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) as phase `name`: its records carry their
    seconds since it began, and its whole time lands in PHASE_SECONDS."""
    PHASE_CLOCK.update(name=name, t0=time.perf_counter())
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + (
            time.perf_counter() - PHASE_CLOCK["t0"])
        PHASE_CLOCK.update(name=None, t0=None)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of `fn` over `reps` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_resources(log: str):
    """Registers and spills of each driver-tier instantiation of the
    segment kernel (K3 segment_kernel<0|1|2>, K1 ring_kernel<t, true>, K2
    ring_kernel<t, false>), keyed 'driver/tier', from nvcc -Xptxas -v:
    'registers', 'spill_bytes' (stores + loads) and ptxas's lines."""
    tiers = {"ILi0E": "highest", "ILi1E": "high", "ILi2E": "default"}
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            tier = next((t for key, t in tiers.items() if key in ln), None)
            driver = ("grid" if "segment_kernel" in ln else
                      "decoupled" if "Lb1E" in ln else
                      "inplace" if "Lb0E" in ln else None)
            entry = (f"{driver}/{tier}" if tier and driver else
                     ln.split("'")[1] if "'" in ln else ln.strip())
            out[entry] = {}
        elif entry is not None and "spill" in ln:
            out[entry]["spill"] = ln.strip()
            words = ln.replace(",", " ").split()
            out[entry]["spill_bytes"] = sum(
                int(words[i - 2]) for i, w in enumerate(words)
                if w == "spill" and i >= 2 and words[i - 2].isdigit())
        elif entry is not None and "registers" in ln:
            out[entry]["ptxas"] = ln.strip()
            words = ln.split()
            out[entry]["registers"] = int(words[words.index("registers,") - 1])
    return out


# ---------------------------------------------------------------------------
# work started just before the build, so that it runs while nvcc compiles
# (the host's other cores are idle then): the probe and sanitize
# subprocesses, which wait on the build lock for the kernel and whose
# timeouts count from the build's end; the host half of phase_frontends
# on a host thread; and the full-width input planes that five phases draw
# from seeded numpy generators (PLANE_DRAWS), on three host threads. The
# threads are joined at the build's end; the phases read the results in
# their usual places.
# ---------------------------------------------------------------------------

DURING_BUILD = {}
BUILT = threading.Event()         # clear while a build runs
BUILT.set()


def _in_thread(fn, *args):
    """fn(*args) on a daemon thread: a Future of its result."""
    from concurrent.futures import Future
    fut = Future()

    def run():
        try:
            fut.set_result(fn(*args))
        except BaseException as e:          # raised by fut.result()
            fut.set_exception(e)
    threading.Thread(target=run, daemon=True).start()
    return fut


def _spawn_self(flag: str, prefix=()):
    """This script with `flag` in a subprocess (after the command
    `prefix`), its output in a temp file: (Popen, file)."""
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [*prefix, sys.executable, os.path.abspath(__file__), flag],
        stdout=out, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, out


def _finish(proc, out, timeout: float):
    """(exit code or None on timeout, output) of a _spawn_self process,
    waited on for `timeout` seconds after the build; killed on timeout."""
    BUILT.wait()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out.seek(0)
    text = out.read()
    out.close()
    return rc, text


def start_during_build(want) -> None:
    """Start what runs while nvcc compiles (above), for the wanted phases.
    The gallery's plan cache is a fresh directory named in the
    environment here, before any thread or subprocess starts."""
    BUILT.clear()
    _queue_plane_draws(want)
    if want("probe"):
        DURING_BUILD["probe"] = _spawn_self("--probe")
    if want("sanitize"):
        DURING_BUILD["sanitize"] = _in_thread(sanitize_checks)
    if want("frontends"):
        plans = tempfile.mkdtemp(prefix="quest_plans_")
        DURING_BUILD["plans"] = (plans, os.environ.get("QUEST_PLAN_CACHE_DIR"))
        os.environ["QUEST_PLAN_CACHE_DIR"] = plans
        DURING_BUILD["frontends"] = _in_thread(frontends_host,
                                               FRONTEND_QUBITS)


# the full-width input planes that phases draw on the host from a seeded
# numpy generator (one draw of 2^29 normals takes seconds on the card's
# host): (seed, shape, draws) -> [Future of (generator state after the
# draws, the draws as float32), uses left]
PLANE_DRAWS = {}


def _draw_planes(seed: int, shape, count: int):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(count)]
    return rng.bit_generator.state, arrays


def seeded_planes(seed: int, shape, count: int = 1):
    """(rng, draws): np.random.default_rng(seed) after its first `count`
    draws of standard normals of `shape`, and those draws as float32 (the
    same numbers, drawn while nvcc built where start_during_build
    queued them, or drawn here)."""
    key = (seed, tuple(shape), count)
    entry = PLANE_DRAWS.get(key)
    if entry is None:
        state, arrays = _draw_planes(seed, shape, count)
    else:
        state, arrays = entry[0].result()
        entry[1] -= 1
        if not entry[1]:
            del PLANE_DRAWS[key]
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng, arrays


def _queue_plane_draws(want) -> None:
    """Queue the wanted phases' plane draws on three host threads (the
    generator's fill runs without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    from quest_tpu_torch.state import fused_state_shape
    full = (2, 1 << TIMING_QUBITS)
    draws = [("diag_layer", 12, (2, 1 << DIAG_QUBITS), 1),
             ("dma_floor", 5, full, 1), ("stage_timing", 7, full, 1),
             ("phase_counters", 7, full, 1),
             ("scan", 11, fused_state_shape(SCAN_QUBITS), 2)]
    pool = ThreadPoolExecutor(3)
    for phase, seed, shape, count in draws:
        if not want(phase):
            continue
        key = (seed, tuple(shape), count)
        if key in PLANE_DRAWS:
            PLANE_DRAWS[key][1] += 1
        else:
            PLANE_DRAWS[key] = [pool.submit(_draw_planes, seed, shape,
                                            count), 1]
    pool.shutdown(wait=False)


def stop_during_build() -> None:
    """Kill what start_during_build started that still runs."""
    DURING_BUILD["stopped"] = True
    for key in ("probe", "sanitize_proc"):
        if key in DURING_BUILD:
            DURING_BUILD[key][0].kill()


def phase_build():
    from quest_tpu_torch.ops import _build
    t0 = time.perf_counter()
    try:
        # the kernel and its phase-counter build (phase_counters), side by
        # side
        built = _build.build(_build.KERNEL, _build.COUNTERS)
    except BaseException:
        stop_during_build()
        raise
    finally:
        BUILT.set()
    t_nvcc = time.perf_counter() - t0
    # joined here, raised by their phases
    for fut in ([DURING_BUILD[k] for k in ("sanitize", "frontends")
                 if k in DURING_BUILD]
                + [entry[0] for entry in PLANE_DRAWS.values()]):
        fut.exception()
    if "frontends" in DURING_BUILD:
        plans, saved = DURING_BUILD.pop("plans")
        DURING_BUILD["plans_dir"] = plans
        if saved is None:
            os.environ.pop("QUEST_PLAN_CACHE_DIR", None)
        else:
            os.environ["QUEST_PLAN_CACHE_DIR"] = saved
    from quest_tpu_torch.ops import segment as S
    S._lib()
    kernels = kernel_resources(_build.BUILD_LOG)
    want = {f"{d}/{t}" for d in ("decoupled", "inplace", "grid")
            for t in ("highest", "high", "default")}
    if _build.BUILD_LOG and set(kernels) != want:
        raise AssertionError(f"build: kernel instantiations {sorted(kernels)}")
    spills = {k: v["spill_bytes"] for k, v in kernels.items()
              if v.get("spill_bytes")}
    if spills:
        raise AssertionError(f"build: register spills {spills}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "build_wall_s": t_nvcc,
          "during_build": sorted(k for k in DURING_BUILD
                                 if k != "plans_dir"),
          "plane_draws": len(PLANE_DRAWS),
          "kernels": kernels})


def _random_mat(rng, dim, real=False):
    g = rng.standard_normal((2, dim, dim)) / np.sqrt(dim)
    if real:
        g[1] = 0.0
    return g.astype(np.float32)


def mat_op(rng, kind, dim, bit=-1, real=False, lane_preds=(), row_preds=()):
    """(MatStage, random operand in the planner's packing)."""
    from quest_tpu_torch.ops import band_plan as BP
    return (BP.MatStage(kind, dim, real, tuple(lane_preds), tuple(row_preds),
                        bit), _random_mat(rng, dim, real))


def phase_op(rng, lm, lw, rm, rw):
    """(PhaseStage, (1, 8) operand) for a random unit phase."""
    from quest_tpu_torch.ops import band_plan as BP
    t = np.exp(1j * rng.uniform(0, 2 * np.pi))
    return BP.PhaseStage(), np.array(
        [[t.real, t.imag, lm, lw, rm & 0x7FFF, rm >> 15, rw & 0x7FFF,
          rw >> 15]], np.float32)


def parity_op(rng, lm, rm):
    from quest_tpu_torch.ops import band_plan as BP
    h = rng.uniform(0, np.pi)
    return BP.ParityStage(), np.array(
        [[np.cos(h), np.sin(h), lm, rm & 0x7FFF, rm >> 15, 0, 0, 0]],
        np.float32)


def multiphase_op(rng, terms):
    """terms: (form 'a' | 'p', lane mask, row mask) per row."""
    from quest_tpu_torch.ops import band_plan as BP
    rows = [[rng.uniform(-np.pi, np.pi), lm, rm & 0x7FFF, rm >> 15,
             0, 0, 0, 0] for _, lm, rm in terms]
    return (BP.MultiPhaseStage(tuple(f for f, _, _ in terms)),
            np.array(rows, np.float32))


def _cores(rng, real=False):
    g = rng.standard_normal((2, 4, 2, 2)) / 2
    if real:
        g[1] = 0.0
    return g.astype(np.float32)


def pair_op(rng, op_kind, op_bit, sliced_bit, real=False, lane_preds=(),
            row_preds=()):
    """(PairStage, (2, 4, 2, 2) cores) of a 2-wide 'sub' or 'sc' pair on
    a scattered sliced bit."""
    from quest_tpu_torch.ops import band_plan as BP
    return (BP.PairStage(op_kind, 2, op_bit, "scat", sliced_bit, real,
                         tuple(lane_preds), tuple(row_preds)),
            _cores(rng, real))


def lane_pair_op(rng, q, sliced_kind, sliced_bit):
    """(PairStage, operand) of a 'lane' pair as the planner packs it:
    2x2 cores embedded at lane bit q of 128x128 blocks, transposed."""
    from quest_tpu_torch.ops import band_plan as BP
    from quest_tpu_torch.ops.fusion import embed_operator
    cores = _cores(rng)
    emb = np.stack([embed_operator(cores[0, b] + 1j * cores[1, b], [q], [],
                                   [], 7).T for b in range(4)])
    return (BP.PairStage("lane", 128, -1, sliced_kind, sliced_bit, False,
                         (), ()),
            np.stack([emb.real, emb.imag]).astype(np.float32))


def diag_op(rng, targets, lane_preds=(), row_preds=()):
    """(DiagVecStage, (2, 2^k) table of random unit phases)."""
    from quest_tpu_torch.ops import band_plan as BP
    t = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << len(targets)))
    return (BP.DiagVecStage(tuple(targets), tuple(lane_preds),
                            tuple(row_preds)),
            np.stack([t.real, t.imag]).astype(np.float32))


def stage_cases(rng):
    """(name, n, stages, arrays): single-stage segments of every kind on
    the paths, predicated stages, chains, and masks and diagonal targets
    above row bit 15."""
    mat = functools.partial(mat_op, rng)
    phase = functools.partial(phase_op, rng)
    parity = functools.partial(parity_op, rng)
    multiphase = functools.partial(multiphase_op, rng)
    pair = functools.partial(pair_op, rng)
    lane_pair = functools.partial(lane_pair_op, rng)
    diag = functools.partial(diag_op, rng)
    n = 20
    singles = [
        ("b0", mat("b0", 128)),
        ("b1_128", mat("b1", 128)),
        ("b1_32", mat("b1", 32)),
        ("scb_128", mat("scb", 128, bit=6)),
        ("scb_64_real", mat("scb", 64, bit=7, real=True)),
        ("scb_4", mat("scb", 4, bit=11)),
        ("sc", mat("sc", 2, bit=12)),
        ("phase", phase(0b1000001, 0b1, 0b100000000010, 0b100000000000)),
        ("parity", parity(0b110, 0b1000000001001)),
        ("multiphase", multiphase([("a", 0b11, 0), ("p", 0b1000000, 0b10100),
                                   ("a", 0b100, 0b1000000000001),
                                   ("p", 0, 0b11000)])),
        ("b0_preds", mat("b0", 128, lane_preds=((3, 1),),
                         row_preds=((2, 1), (12, 0)))),
        ("scb_4_preds", mat("scb", 4, bit=10, lane_preds=((0, 0),),
                            row_preds=((1, 1),))),
        ("pair_lane_scat", lane_pair(3, "scat", 12)),
        ("pair_lane_sub", lane_pair(6, "sub", 5)),
        ("pair_sub_scat", pair("sub", 0, 12)),
        ("pair_sub5_scat", pair("sub", 5, 11)),
        ("pair_sc_scat", pair("sc", 6, 12)),
        ("pair_sc_scat_real", pair("sc", 12, 8, real=True)),
        ("pair_preds", pair("sub", 2, 12, lane_preds=((1, 1),),
                            row_preds=((4, 0),))),
        ("diagvec_k1", diag((9,))),
        ("diagvec_k3_preds", diag((0, 9, 12), ((2, 1),), ((1, 0),))),
        ("diagvec_k7", diag((1, 5, 8, 9, 12, 14, 19))),
    ]
    cases = [(name, n, [s], [a]) for name, (s, a) in singles]
    chain = [mat("b0", 128), phase(0b10, 0b10, 0b100, 0b100),
             mat("sc", 2, bit=12), parity(0b11, 0b11001),
             mat("scb", 4, bit=9, row_preds=((3, 1),)),
             multiphase([("p", 0b1, 0b1), ("a", 0b10, 0b10000)]),
             mat("b1", 16)]
    cases.append(("chain", n, [s for s, _ in chain], [a for _, a in chain]))
    rm = (1 << 15) | (1 << 3) | 1
    high = [phase(0b1, 0b1, rm, (1 << 15) | 1), parity(0b10, rm),
            multiphase([("a", 0, 1 << 15), ("p", 0b100, 1 << 15)])]
    cases.append(("row_bit_15", 23, [s for s, _ in high], [a for _, a in high]))
    dense = [mat("b0", 128), lane_pair(1, "scat", 12), diag((7, 2)),
             pair("sub", 2, 12), mat("sc", 2, bit=12), pair("sc", 6, 11)]
    cases.append(("density_chain", n, [s for s, _ in dense],
                  [a for _, a in dense]))
    st, arr = diag((22, 3, 8), (), ((15, 1),))
    cases.append(("diagvec_row_bit_15", 23, [st], [arr]))
    # S5/S6 runs: two runs around a b0 (masks on lanes, inner and free
    # rows), a 65-stage run (cut 64 + 1) and a phase-only segment that
    # launches only the tiles whose free row bit 12 is set
    runs = [parity(0b101, 0b1000000100), phase(0b10, 0b10, 0b1, 0),
            parity(0, 0b10000000000), phase(0, 0, 0b110000000000,
                                            0b100000000000),
            parity(0b1000000, 0), mat("b0", 128), phase(0b1, 0b1, 1 << 12,
                                                         1 << 12),
            parity(0b11, 0b11), phase(0b100, 0, 0b1010, 0b1000)]
    cases.append(("diag_runs", n, [s for s, _ in runs], [a for _, a in runs]))
    long = [phase(1 << (k % 7), 1 << (k % 7), 1 << (k % 13), 0) if k % 2
            else parity(1 << (k % 5), 1 << (k % 11)) for k in range(65)]
    cases.append(("diag_run_65", n, [s for s, _ in long], [a for _, a in long]))
    skip = [phase(0b1, 0b1, (1 << 12) | (1 << 3), 1 << 12),
            phase(0, 0, (1 << 12) | (1 << 9), (1 << 12) | (1 << 9))]
    cases.append(("phase_skip", n, [s for s, _ in skip], [a for _, a in skip]))
    return cases


def geometry_groups(geo):
    """(inner row bits, lengths of the contiguous groups of scattered row
    bits, lowest first) of a segment geometry: the shape of its tiles'
    copies."""
    scat, groups = sorted(geo.scat), []
    for b in scat:
        if groups and b == prev + 1:
            groups[-1] += 1
        else:
            groups.append(1)
        prev = b
    return geo.inner_bits, tuple(groups)


def tma_cases(rng):
    """(name, n, batch, stages, arrays, geometry_groups): segments over 5
    states of 20 qubits whose tiles take the scattered-row geometries of
    the paths' plans — (0,(7,)), (4,(1,1,1)), (0,(6,1)) and (5,(1,1)),
    several tensor-map requests per part where the groups are split —
    each ending in a diagonal with a lane and a row control whose targets
    are a lane bit, the lowest scattered bit and a free row bit."""
    from quest_tpu_torch.ops import band_plan as BP
    n, batch = 20, 5
    geos = {"scat_0_7": [mat_op(rng, "scb", 128, bit=6)],
            "scat_4_111": [mat_op(rng, "sc", 2, bit=b) for b in (5, 8, 11)],
            "scat_0_61": [mat_op(rng, "scb", 64, bit=3),
                          mat_op(rng, "sc", 2, bit=11)],
            "scat_5_11": [mat_op(rng, "sc", 2, bit=b) for b in (6, 9)]}
    out = []
    for name, ops in geos.items():
        geo = BP.segment_geometry([s for s, _ in ops], n)
        free = max(b for b in range(n - 7) if b not in geo.scat)
        ops = ops + [diag_op(rng, (2, 7 + min(geo.scat), 7 + free),
                             ((0, 1),), ((max(geo.scat), 1),))]
        out.append((name, n, batch, [s for s, _ in ops], [a for _, a in ops],
                    geometry_groups(geo)))
    return out


def multiphase_terms(rng, m, row_bits, forms=None):
    """m (form, lane mask, row mask) terms: forms drawn at random unless
    given; a parity term's masks random over the lanes and `row_bits` row
    bits, an all-ones term's of one or two bits so that it matches part
    of the state."""
    out = []
    for r in range(m):
        form = forms[r] if forms else ("a", "p")[int(rng.integers(2))]
        if form == "p":
            lm = int(rng.integers(0, 128))
            rm = int(rng.integers(0, 1 << row_bits))
        else:
            bits = rng.choice(7 + row_bits, size=int(rng.integers(1, 3)),
                              replace=False)
            lm = sum(1 << int(b) for b in bits if b < 7)
            rm = sum(1 << int(b - 7) for b in bits if b >= 7)
        out.append((form, lm, rm))
    return out


def multiphase_cases(rng):
    """(name, n, stages, arrays): S7 at m = 1, 2, 8 and 64 terms on 20
    qubits (row masks up to row bit 12) — mixed forms, and the main
    paths' two all-ones terms (a CZ on a lane and a row bit, one on two
    row bits) — each ending the segment after an scb-4 stage on row bit 9
    so that the tiles hold a scattered row bit."""
    n, row_bits = 20, 13
    cases = {"multiphase_m1": multiphase_terms(rng, 1, row_bits, ("p",)),
             "multiphase_m2_aa": [("a", 1 << 6, 1), ("a", 0, 3 << 11)],
             "multiphase_m8": multiphase_terms(rng, 8, row_bits),
             "multiphase_m64": multiphase_terms(rng, 64, row_bits)}
    out = []
    for name, terms in cases.items():
        ops = [mat_op(rng, "scb", 4, bit=9), multiphase_op(rng, terms)]
        out.append((name, n, [s for s, _ in ops], [a for _, a in ops]))
    return out


def batchsel_op(q, slot, barrier=True):
    """(BatchSelStage, the planner's (1, 8) placeholder operand)."""
    from quest_tpu_torch.ops import band_plan as BP
    return BP.BatchSelStage(q, slot, barrier), np.zeros((1, 8), np.float32)


def sel_table(rng, slots, batch, unitary=False):
    """(slots, batch, 8) selection rows: random 2x2s, or random unitaries
    (norm-preserving, for repeated timing launches)."""
    g = rng.standard_normal((slots, batch, 2, 2)) + 1j * rng.standard_normal(
        (slots, batch, 2, 2))
    if unitary:
        g = np.linalg.qr(g)[0]
    else:
        g = g / 2
    return np.stack([g.real, g.imag], -1).reshape(slots, batch, 8).astype(
        np.float32)


def batch_stage_cases(rng):
    """(name, n, batch, stages, arrays, tol): batched segments — S9 on a
    lane bit, inner rows (row bits 0 and 6) and a scattered bit, two S9
    in one launch, and a barrier S9 leading a chain of other kinds."""
    n, batch = 17, 5
    cases = [(f"batchsel_{name}", n, batch, [st], [a], BATCHSEL_TOL)
             for name, (st, a) in (("lane", batchsel_op(3, 0)),
                                   ("row0", batchsel_op(7, 1)),
                                   ("row6", batchsel_op(13, 0)),
                                   ("scat", batchsel_op(16, 1, False)))]
    two = [batchsel_op(2, 1, False), batchsel_op(15, 0, False)]
    cases.append(("batchsel_two", n, batch, [s for s, _ in two],
                  [a for _, a in two], BATCHSEL_TOL))
    chain = [batchsel_op(12, 1), mat_op(rng, "b0", 128),
             pair_op(rng, "sub", 2, 9), phase_op(rng, 0b10, 0b10, 0b100, 0b100),
             batchsel_op(4, 0, False), mat_op(rng, "sc", 2, bit=9)]
    cases.append(("batched_chain", n, batch, [s for s, _ in chain],
                  [a for _, a in chain], STAGE_TOL))
    return cases


def phase_stages(torch):
    from quest_tpu_torch.ops import segment as S
    rng = np.random.default_rng(20261016)
    worst = 0.0
    results = []
    for name, n, stages, arrays in stage_cases(rng):
        seg = S.prepare_segment(stages, arrays, n, "cuda")
        planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
        amps = torch.from_numpy(planes).cuda()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n)
        S.segment_sweep(amps, seg)
        torch.cuda.synchronize()
        err = (amps.reshape(2, -1) - want.reshape(2, -1)).abs().max().item()
        scale = want.abs().max().item()
        rel = err / scale
        results.append({"case": name, "n": n, "max_abs_err": err,
                        "rel_err": rel, "tile_bits": seg.geometry.tile_bits,
                        "blocks": seg.tiles})
        if not rel <= STAGE_TOL:
            raise AssertionError(f"stage case {name}: max|diff| {err} > "
                                 f"{STAGE_TOL} x max|amp| {scale}")
        worst = max(worst, rel)
    for name, n, batch, stages, arrays, tol in batch_stage_cases(rng):
        seg = S.prepare_segment(stages, arrays, n, "cuda")
        amps = torch.from_numpy(rng.standard_normal(
            (batch, 2, 1 << n)).astype(np.float32)).cuda()
        sel = torch.from_numpy(sel_table(rng, 2, batch)).cuda()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n,
                                         sel)
        S.segment_sweep(amps, seg, sel)
        torch.cuda.synchronize()
        err = (amps.reshape(-1) - want.reshape(-1)).abs().max().item()
        scale = want.abs().max().item()
        results.append({"case": name, "n": n, "batch": batch,
                        "max_abs_err": err, "rel_err": err / scale,
                        "tol": tol, "tile_bits": seg.geometry.tile_bits,
                        "blocks": seg.tiles})
        if not err <= tol * scale:
            raise AssertionError(f"batched stage case {name}: max|diff| "
                                 f"{err} > {tol} x max|amp| {scale}")
        worst = max(worst, err / scale)
    emit({"phase": "stages", "tol": STAGE_TOL, "worst_rel_err": worst,
          "cases": results})
    return worst


def one_stage_segments(torch, fn, x):
    """fn's steps on x in place, each segment's stages launched one stage
    per segment (K1), the passthroughs as they are."""
    from quest_tpu_torch.ops import segment as S
    for step in fn.steps:
        if isinstance(step, S.Segment):
            for st, arr in zip(step.stages, step.arrays):
                S.segment_sweep(x, S.prepare_segment(
                    [st], [arr], fn.n, "cuda", driver="decoupled"))
        else:
            step(x)
    return x


DIAG_QUBITS = 28


def angle_form(seg) -> bool:
    """Whether a run of the segment takes the angle form (F_FORMS bit 0 of
    a run's head)."""
    from quest_tpu_torch.ops import segment as S
    d = seg.desc.cpu()
    return bool(((d[:, S.F_RUN] > 0) & (d[:, S.F_FORMS] & 1 > 0)).any())


EXACT_PIECE = 7                # stages of a piece below the angle form's 8


def exact_pieces(torch, fn, x):
    """fn's steps on x in place, each segment's stages launched in pieces
    of EXACT_PIECE stages (K1): runs too short for the angle form, so
    each piece's runs take the exact form."""
    from quest_tpu_torch.ops import segment as S
    for step in fn.steps:
        if isinstance(step, S.Segment):
            for i in range(0, len(step.stages), EXACT_PIECE):
                S.segment_sweep(x, S.prepare_segment(
                    step.stages[i:i + EXACT_PIECE],
                    step.arrays[i:i + EXACT_PIECE], fn.n, "cuda",
                    driver="decoupled"))
        else:
            step(x)
    return x


def phase_diag_layer(torch):
    """entry.diag_layer_circuit (seed 10) and entry.cz_brick_circuit at 28
    qubits through compiled_fused under K1, K2 (3 slots) and K3 from one
    seeded normalised state: against the plain path (STAGE_TOL x
    max|amp|) and bit-identical across drivers; launches and median ms of
    3 calls per driver. The same stages launched one stage per segment
    must give the program's bits where every run keeps the exact form,
    else (a run in the angle form) agree within STAGE_TOL; and launched
    in pieces of EXACT_PIECE stages (exact-form runs of up to 7) they must
    give the bits of one stage per segment."""
    from quest_tpu_torch import entry as E
    from quest_tpu_torch.ops import segment as S
    n = DIAG_QUBITS
    rng, (host,) = seeded_planes(12, (2, 1 << n))
    planes = torch.from_numpy(host).cuda()
    del host
    planes /= planes.double().pow(2).sum().sqrt().float()
    recs = []
    for name, circ in (("diag_layer", E.diag_layer_circuit(n)),
                       ("cz_brick", E.cz_brick_circuit(n))):
        ref, per = None, {}
        for cfg in ("K1", "K2/3", "K3"):
            with driver_knobs(cfg):
                fn = circ.compiled_fused(n, device="cuda")
            x = planes.clone()
            S.segment_sweep.launches = 0
            fn(x)
            torch.cuda.synchronize()
            launches = S.segment_sweep.launches
            if ref is None:
                ref = x.clone()
                want = fn.plain(planes)
                err = (ref.reshape(2, -1) - want.reshape(2, -1)).abs().max()
                scale = want.abs().max().item()
                del want
                single = one_stage_segments(torch, fn, planes.clone())
                angles = any(angle_form(sg) for sg in fn.segments)
                one_rel = ((single - ref).abs().max() / scale).item()
                if not (one_rel <= STAGE_TOL if angles
                        else torch.equal(single, ref)):
                    raise AssertionError(f"diag_layer {name}: one stage per "
                                         f"segment {one_rel} from the runs")
                pieces = exact_pieces(torch, fn, planes.clone())
                if not torch.equal(pieces, single):
                    raise AssertionError(f"diag_layer {name}: exact-form "
                                         f"runs differ from one stage per "
                                         f"segment")
                del single, pieces
                if not err.item() <= STAGE_TOL * scale:
                    raise AssertionError(f"diag_layer {name}: max|diff| "
                                         f"{err.item()} > {STAGE_TOL} x {scale}")
            elif not torch.equal(x, ref):
                raise AssertionError(f"diag_layer {name}: {cfg} differs "
                                     f"from K1")
            per[cfg] = {"launches": launches, "stages": [
                len(s.stages) for s in fn.segments],
                "ms": time_ms(torch, lambda: fn(x), 3)}
            del x, fn
            torch.cuda.empty_cache()
        recs.append({"circuit": name, "max_abs_err": err.item(),
                     "rel_err": err.item() / scale, "bit_identical": True,
                     "angle_form": angles, "one_stage_rel_diff": one_rel,
                     "exact_pieces_identical": True, "drivers": per})
        del ref
    rec = {"phase": "diag_layer", "n": n, "tol": STAGE_TOL, "circuits": recs}
    emit(rec)
    del planes
    torch.cuda.empty_cache()
    return rec


BIG_BATCH = 65536 + 3          # states: above K3's gridDim.y of 65535
HIGH_TARGET_QUBITS = 33        # 64 GiB of planes: a target on qubit 32


def phase_big_batch(torch):
    """ROADMAP C1: one segment (an S9 channel row per state, a b0, a phase)
    over 65,539 states of 10 qubits under every driver configuration:
    against the plain version (STAGE_TOL) and bit for bit against the
    batch split by hand at 65,535 states; K3 runs two launches, the rings
    one."""
    from quest_tpu_torch.ops import segment as S
    n, batch = 10, BIG_BATCH
    rng = np.random.default_rng(31)
    stages = [batchsel_op(3, 0), mat_op(rng, "b0", 128),
              phase_op(rng, 0b11, 0b01, 0b101, 0b100)]
    planes = torch.from_numpy(rng.standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).cuda()
    sel = torch.from_numpy(sel_table(rng, 1, batch)).cuda()
    out = {}
    for cfg, (driver, nbuf) in DRIVER_CONFIGS.items():
        seg = S.prepare_segment([st for st, _ in stages],
                                [a for _, a in stages], n, "cuda",
                                driver=driver, nbuf=nbuf)
        want = S.segment_sweep_reference(planes, seg.stages, seg.operands, n,
                                         sel)
        got = planes.clone()
        before = S.segment_sweep.launches
        S.segment_sweep(got, seg, sel)
        torch.cuda.synchronize()
        launches = S.segment_sweep.launches - before
        if launches != len(S.grid_batch_slices(batch, driver)):
            raise AssertionError(f"big_batch {cfg}: {launches} launches")
        err = (got - want.reshape(got.shape)).abs().max().item()
        scale = want.abs().max().item()
        if not err <= STAGE_TOL * scale:
            raise AssertionError(f"big_batch {cfg}: max|diff| {err}")
        cut = S.MAX_GRID_BATCH
        halves = []
        for lo, hi in ((0, cut), (cut, batch)):
            part = planes[lo:hi].clone()
            S.segment_sweep(part, seg, sel[:, lo:hi].contiguous())
            halves.append(part)
        torch.cuda.synchronize()
        if not torch.equal(got, torch.cat(halves)):
            raise AssertionError(f"big_batch {cfg}: differs from the batch "
                                 f"split by hand")
        out[cfg] = {"launches": launches, "max_abs_err": err,
                    "rel_err": err / scale}
        del want, got, halves
    del planes
    torch.cuda.empty_cache()
    rec = {"phase": "big_batch", "n": n, "batch": batch, "configs": out}
    emit(rec)
    return rec


def phase_high_target(torch):
    """ROADMAP C2: a diagonal on qubits (32, 3) of a 33-qubit state (64
    GiB of planes, the caching allocator emptied first) under K1: basis
    amplitudes with qubit 32 and qubit 3 set and clear, each checked
    against its value times the table entry its bits select; the rest
    must stay 0 (a norm summed in chunks)."""
    from quest_tpu_torch.ops import band_plan as BP
    from quest_tpu_torch.ops import segment as S
    n = HIGH_TARGET_QUBITS
    torch.cuda.empty_cache()
    rng = np.random.default_rng(33)
    table = np.exp(1j * rng.uniform(0, 2 * np.pi, 4))
    arr = np.stack([table.real, table.imag]).astype(np.float32)
    seg = S.prepare_segment([BP.DiagVecStage((32, 3), (), ())], [arr], n,
                            "cuda")
    idx = [0, 8, (1 << 32) + 5, (1 << 32) + 8 + 130, (1 << 31) + 9,
           (1 << 33) - 1]
    vals = rng.standard_normal((len(idx), 2)).astype(np.float32)
    amps = torch.zeros((2, 1 << n), device="cuda")
    for k, i in enumerate(idx):
        amps[0, i], amps[1, i] = float(vals[k, 0]), float(vals[k, 1])
    before = S.segment_sweep.stage_launches.get("diagvec", 0)
    t0 = time.perf_counter()
    S.segment_sweep(amps, seg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if S.segment_sweep.stage_launches.get("diagvec", 0) != before + 1:
        raise AssertionError("high_target: the diagonal did not launch")
    norm = sum(amps[:, a:a + (1 << 26)].double().pow(2).sum().item()
               for a in range(0, 1 << n, 1 << 26))
    want_norm, worst = 0.0, 0.0
    for k, i in enumerate(idx):
        e = ((i >> 32) & 1) | (((i >> 3) & 1) << 1)
        w = complex(float(vals[k, 0]), float(vals[k, 1])) * complex(
            float(arr[0, e]), float(arr[1, e]))
        got = complex(amps[0, i].item(), amps[1, i].item())
        worst = max(worst, abs(got - w))
        want_norm += abs(w) ** 2
    del amps
    torch.cuda.empty_cache()
    if not (worst <= 1e-6 and abs(norm - want_norm) <= 1e-6):
        raise AssertionError(f"high_target: max|diff| {worst}, norm {norm} "
                             f"vs {want_norm}")
    rec = {"phase": "high_target", "n": n, "targets": [32, 3],
           "amplitudes": len(idx), "max_abs_err": worst, "norm": norm,
           "want_norm": want_norm, "seconds": seconds}
    emit(rec)
    return rec


def phase_flagship(torch):
    from quest_tpu_torch.entry import entry
    from quest_tpu_torch.ops import segment as S
    t0 = time.perf_counter()
    fn, (amps,) = entry()
    setup_s = time.perf_counter() - t0
    amps0 = amps.clone()
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    S.segment_sweep.driver_launches = {}
    fn(amps)
    torch.cuda.synchronize()
    launches = S.segment_sweep.launches
    stage_launches = dict(S.segment_sweep.stage_launches)
    if S.segment_sweep.driver_launches != {"decoupled": launches}:
        raise AssertionError(f"main path drivers "
                             f"{S.segment_sweep.driver_launches}: not K1")
    if launches != fn.launches_per_call or launches == 0:
        raise AssertionError(f"main path launched the segment kernel "
                             f"{launches} times for {fn.launches_per_call} "
                             f"segments")
    planned = {}
    for seg in fn.segments:
        for label in seg.labels:
            planned[label] = planned.get(label, 0) + fn.loop_iters
    if stage_launches != planned:
        raise AssertionError(f"main path launches per stage kind "
                             f"{stage_launches}, planned {planned}")
    want = fn.plain(amps0.clone())
    torch.cuda.synchronize()
    err = (amps - want).abs().max().item()
    scale = want.abs().max().item()
    norm = (amps.double() ** 2).sum().item()
    if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL):
        raise AssertionError(f"flagship: max|diff| {err} (max|amp| {scale}), "
                             f"norm {norm}")
    if not torch.isfinite(amps).all():
        raise AssertionError("flagship: non-finite amplitudes")
    step_ms = time_ms(torch, lambda: fn(amps), 5)
    plain_ms = time_ms(torch, lambda: fn.plain(amps0), 1)
    bound_ms, bound_by = bound_of(fn.segments)
    kinds = {}
    for seg in fn.segments:
        for st in seg.stages:
            k = getattr(st, "kind", type(st).__name__)
            k = f"{k}{st.dim}" if hasattr(st, "dim") else k
            kinds[k] = kinds.get(k, 0) + 1
    rec = {"phase": "flagship", "n": fn.n, "depth": 4, "segments":
           len(fn.segments), "launches": launches, "max_abs_err": err,
           "rel_err": err / scale, "norm": norm, "median_ms": step_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "setup_s": setup_s, "stages": kinds,
           "stage_launches": stage_launches}
    emit(rec)
    del fn, amps, amps0, want
    torch.cuda.empty_cache()
    return rec


def phase_baseline(torch):
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    n, depth = 30, 20
    fn = random_circuit(n, depth, seed=7, entangler="cz").compiled_fused(
        n, device="cuda")
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    # the plain path first (out of place, so no second copy of the 8 GiB
    # input): the kernel is held against it at 30 qubits, the only check
    # of scb d=4 stages inside a plan and of plane 1 starting 2^30 floats in
    want = fn.plain(amps)
    torch.cuda.synchronize()
    S.segment_sweep.launches = 0
    fn(amps)
    torch.cuda.synchronize()
    launches = S.segment_sweep.launches
    if launches != fn.launches_per_call:
        raise AssertionError(f"baseline: {launches} launches for "
                             f"{fn.launches_per_call} segments")
    err = max((amps[p] - want[p]).abs().max().item() for p in range(2))
    scale = want.abs().max().item()
    del want
    norm = (amps.double() ** 2).sum().item()
    if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL
            and torch.isfinite(amps).all()):
        raise AssertionError(f"baseline: max|diff| {err} (max|amp| "
                             f"{scale}), norm {norm}")
    ms = time_ms(torch, lambda: fn(amps), 1)
    bound_ms, bound_by = bound_of(fn.segments)
    rec = {"phase": "baseline", "n": n, "depth": depth,
           "segments": len(fn.segments), "launches": launches,
           "max_abs_err": err, "rel_err": err / scale, "norm": norm,
           "median_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    del amps
    torch.cuda.empty_cache()
    return rec


def hermitian_err(amps, nd: int) -> float:
    """max |rho - rho^+| of density planes: plane p viewed (2^N, 2^N) is
    [c, r] -> rho[r, c], so Re must be symmetric and Im antisymmetric.
    Taken in column blocks: no full-size temporary."""
    dim = 1 << nd
    re, im = amps.reshape(2, dim, dim)
    worst = 0.0
    for i in range(0, dim, 2048):
        j = min(dim, i + 2048)
        worst = max(worst, (re[i:j] - re[:, i:j].T).abs().max().item(),
                    (im[i:j] + im[:, i:j].T).abs().max().item())
    return worst


def density_checks(torch, name, amps, want, nd):
    """The density phases' gates: the kernel path against the plain path
    (max|diff| <= 1e-4 max|amp|), |1 - Tr rho| <= 1e-4, max|rho - rho^+|
    <= 1e-4 max|amp|, purity <= 1 + 1e-4, finite amplitudes."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.state import Qureg
    err = max((amps[p] - want[p]).abs().max().item() for p in range(2))
    scale = want.abs().max().item()
    q = Qureg(amps.reshape(2, -1), nd, is_density=True)
    trace, purity = K.calc_total_prob(q), K.calc_purity(q)
    herm = hermitian_err(amps, nd)
    finite = bool(torch.isfinite(amps).all().item())
    rec = {"max_abs_err": err, "rel_err": err / scale, "trace": trace,
           "hermitian_err": herm, "purity": purity}
    if not (err <= PATH_TOL * scale and abs(1.0 - trace) <= PATH_TOL
            and herm <= PATH_TOL * scale and purity <= 1.0 + PATH_TOL
            and finite):
        raise AssertionError(f"{name}: {rec}, finite={finite}")
    return rec


def planned_launches(fn):
    """Launches per stage label that one call of `fn` makes by its plan."""
    planned = {}
    for seg in fn.segments:
        for label in seg.labels:
            planned[label] = planned.get(label, 0) + fn.loop_iters
    return planned


def counted_call(torch, name, fn, amps):
    """Run fn(amps) once with the launch counters set to 0 just before
    and read just after; fail unless they equal the plan."""
    from quest_tpu_torch.ops import segment as S
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    S.segment_sweep.driver_launches = {}
    fn(amps)
    torch.cuda.synchronize()
    launches = S.segment_sweep.launches
    stage_launches = dict(S.segment_sweep.stage_launches)
    planned = planned_launches(fn)
    if S.segment_sweep.driver_launches != {"decoupled": launches}:
        raise AssertionError(f"{name}: drivers "
                             f"{S.segment_sweep.driver_launches}: not K1")
    if launches != fn.launches_per_call or not launches:
        raise AssertionError(f"{name}: {launches} launches for "
                             f"{fn.launches_per_call} segments")
    if stage_launches != planned:
        raise AssertionError(f"{name}: launches per stage kind "
                             f"{stage_launches}, planned {planned}")
    return launches, stage_launches


def run_density(torch, name, fn, amps, reps, time_plain):
    """One density phase on input planes `amps` (|0><0| of fn.n state
    qubits): the plain path first (out of place, so the input is never
    held twice), the kernel path counted against the plan, the density
    gates, then warm-step timing."""
    from quest_tpu_torch.circuit import XlaPass
    n = fn.n
    nd = n // 2
    want = fn.plain(amps)
    torch.cuda.synchronize()
    amps0 = amps.clone() if time_plain else None
    launches, stage_launches = counted_call(torch, name, fn, amps)
    rec = {"phase": name, "n": n, "density_qubits": nd,
           "segments": len(fn.segments),
           "passthroughs": sum(isinstance(s, XlaPass) for s in fn.steps),
           "loop_iters": fn.loop_iters, "launches": launches,
           "stage_launches": stage_launches}
    rec.update(density_checks(torch, name, amps, want, nd))
    del want
    torch.cuda.empty_cache()
    rec["median_ms"] = time_ms(torch, lambda: fn(amps), reps)
    rec["plain_ms"] = (time_ms(torch, lambda: fn.plain(amps0), 1)
                       if time_plain else None)
    rec["bound_ms"], rec["bound_by"] = program_bound(fn)
    emit(rec)
    del amps, amps0
    torch.cuda.empty_cache()
    return rec


def phase_density(torch):
    from quest_tpu_torch.entry import density_entry
    t0 = time.perf_counter()
    fn, (amps,) = density_entry()
    setup_s = time.perf_counter() - t0
    rec = run_density(torch, "density", fn, amps, 5, True)
    rec["setup_s"] = setup_s
    return rec


def _density_program(circuit, nd, iters=1):
    """(fn, |0><0| planes) of `circuit` on an nd-qubit density register."""
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    n = 2 * nd
    fn = circuit.compiled_fused(n, density=True, iters=iters, device="cuda")
    return fn, basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")


def phase_density_bench(torch):
    from quest_tpu_torch.entry import bench_density_circuit
    nd = BENCH_DENSITY_QUBITS
    fn, amps = _density_program(bench_density_circuit(nd), nd, iters=4)
    return run_density(torch, "density_bench", fn, amps, 3, False)


def phase_clifford_t_density(torch):
    from quest_tpu_torch.entry import clifford_t_density_circuit
    nd = CLIFFORD_T_QUBITS
    fn, amps = _density_program(clifford_t_density_circuit(nd), nd)
    return run_density(torch, "clifford_t_density", fn, amps, 5, True)


def phase_batched(torch):
    """The batched engine: batched_entry() (24 qubits, a batch of 64)
    counted against the unbatched plan and held against the plain path,
    per-state norms and the unbatched program on 4 states."""
    from quest_tpu_torch.entry import batched_entry, flagship_circuit
    from quest_tpu_torch.ops import segment as S
    t0 = time.perf_counter()
    fn, (amps,) = batched_entry()
    setup_s = time.perf_counter() - t0
    n, batch = fn.n, amps.shape[0]
    single = flagship_circuit(n).compiled_fused(n, device="cuda")
    picks = [0, batch // 3, 2 * batch // 3, batch - 1]
    inputs = amps[picks].clone()
    want = fn.plain(amps)               # out of place, 8 states at a time
    torch.cuda.synchronize()
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    fn(amps)
    torch.cuda.synchronize()
    launches = S.segment_sweep.launches
    if launches != single.launches_per_call or launches != fn.launches_per_call:
        raise AssertionError(f"batched: {launches} launches for a batch of "
                             f"{batch}, unbatched plan {single.launches_per_call}")
    err = (amps - want).abs().max().item()
    scale = want.abs().max().item()
    del want
    torch.cuda.empty_cache()
    norms = amps.double().pow(2).sum(dim=(1, 2, 3))
    norm_err = (1.0 - norms).abs().max().item()
    single_err = 0.0
    for j, s in enumerate(picks):
        x = single(inputs[j])
        single_err = max(single_err, (x - amps[s]).abs().max().item())
    if not (err <= PATH_TOL * scale and norm_err <= PATH_TOL
            and single_err <= PATH_TOL * scale
            and torch.isfinite(amps).all().item()):
        raise AssertionError(f"batched: max|diff| {err} (max|amp| {scale}), "
                             f"|1 - norm| {norm_err}, vs unbatched "
                             f"{single_err}")
    ms = time_ms(torch, lambda: fn(amps), 3)
    x = inputs[0]
    single_ms = time_ms(torch, lambda: single(x), 5)
    plain_ms = time_ms(torch, lambda: fn.plain(amps), 1)
    bound, bound_by = bound_of(fn.segments, batch=batch)
    rec = {"phase": "batched", "n": n, "batch": batch,
           "segments": len(fn.segments), "launches": launches,
           "stage_launches": dict(S.segment_sweep.stage_launches),
           "max_abs_err": err, "rel_err": err / scale, "max_norm_err": norm_err,
           "unbatched_max_abs_err": single_err, "ms_per_call": ms,
           "ms_per_state": ms / batch, "unbatched_ms": single_ms,
           "unbatched_ms_x_batch": single_ms * batch, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": bound_by, "setup_s": setup_s}
    emit(rec)
    del fn, amps, inputs, x
    torch.cuda.empty_cache()
    return rec


def z_all(planes):
    """Per-shot <Z_q> of every qubit q: (shots, n) from (shots, 2, 2^n)."""
    p = planes[:, 0] ** 2 + planes[:, 1] ** 2
    n = p.shape[1].bit_length() - 1
    cols = []
    for q in range(n):
        h = p.reshape(p.shape[0], -1, 2, 1 << q).sum(dim=(1, 3))
        cols.append(h[:, 0] - h[:, 1])
    import torch
    return torch.stack(cols, dim=1)


def phase_trajectory_physics(torch):
    """The trajectory estimator against the density path on the card:
    noisy RCS d3 on 14 qubits, PHYSICS_SHOTS trajectories; <Z_q> of every
    qubit within PHYSICS_SIGMAS standard errors of the density state's."""
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.entry import density_entry, noisy_rcs_circuit
    nd = 14
    fn, (rho,) = density_entry()
    fn(rho)
    diag = rho.reshape(2, -1)[0, ::(1 << nd) + 1].double()
    idx = torch.arange(1 << nd, device=diag.device)
    exact = torch.stack([(diag * (1 - 2 * ((idx >> q) & 1))).sum()
                         for q in range(nd)])
    del fn, rho
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    vals, draws = T.run_batched(noisy_rcs_circuit(nd, 3), PHYSICS_SHOTS,
                                generator=gen, observable=z_all,
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = vals.double()
    mean = vals.mean(0)
    sigma = vals.std(0) / PHYSICS_SHOTS ** 0.5
    dev_sig = ((mean - exact).abs() / sigma.clamp_min(1e-12)).cpu().tolist()
    rec = {"phase": "trajectory_physics", "n": nd, "shots": PHYSICS_SHOTS,
           "wall_s": wall, "z_exact": exact.cpu().tolist(),
           "z_mean": mean.cpu().tolist(), "z_sigma": sigma.cpu().tolist(),
           "max_sigmas": max(dev_sig),
           "branch_rate": draws.ne(0).double().mean().item()}
    emit(rec)
    if not max(dev_sig) <= PHYSICS_SIGMAS:
        raise AssertionError(f"trajectory_physics: <Z_q> off the density "
                             f"path by {max(dev_sig)} sigma")
    return rec


def trajectory_bound(prog, b):
    """(bound ms, by) of one chunk of `b` shots of a trajectory program:
    its launches over the chunk, each general-Kraus channel's Born
    reduction (one read of the batch, a complex MAC pair per amplitude),
    each passthrough per state."""
    from quest_tpu_torch.circuit import XlaPass
    n = prog.n
    work = [segment_work(s, b) for s in prog.segments]
    work += [passthrough_work(p, b) for p in prog.steps
             if isinstance(p, XlaPass)]
    barriers = sum(1 for c in prog.channels if c.probs is None)
    work += [(barriers * b * 2 * 4 * (1 << n), barriers * b * 8 * (1 << n),
              0.0)]
    return bound_ms(*(sum(w[k] for w in work) for k in range(3)))


def gate_bound(circ, batch, draws=None, channels=None):
    """(bound ms, by) of `circ` over `batch` f32 states, counted from the
    circuit's own gates, not from the bands a plan builds of them. Bytes:
    an apply reads the batch once and writes it once; a trajectory run
    (`draws` given) reads its (batch, C) f64 uniforms and writes its
    planes and int32 draws once, its states starting as |0> on the card.
    Operations: each gate's products on the share it selects
    (xla_item_work), and, for each shot, the Kraus operator it drew as a
    matrix on the channel's targets (`channels`: the program's
    channel_info) and, for a state-dependent channel, the Born weight of
    the half it selects (4 flops an amplitude of that half)."""
    n = circ.num_qubits
    amps = float(1 << n)
    plane_bytes = batch * 2 * 4 * amps
    flops = batch * sum(xla_item_work(op, n)[1] for op in circ.ops
                        if op.kind != "superop")
    if draws is None:
        return bound_ms(2 * plane_bytes, flops)
    d = np.asarray(draws)
    for c, ch in enumerate(channels):
        size = 1 << len(ch["targets"])
        for j, K in enumerate(ch["ops"]):
            per_mac = 4 if not np.any(np.imag(K)) else 8
            flops += int((d[:, c] == j).sum()) * amps * size * per_mac
        if ch["mixture_probs"] is None:
            flops += batch * amps / 2 * 4
    nbytes = plane_bytes + d.size * (8 + 4)
    return bound_ms(nbytes, flops)


def phase_trajectories(torch):
    """The trajectory path: trajectory_entry() (24 qubits, 256 shots in
    chunks of 64, <Z_23> reduced per chunk) counted against the plan; the
    first chunk's 64 shots again through the kernel, held against the
    plain path on all of them (PLAIN_CHECK_SHOTS shots per plain call),
    and its first PLAIN_CHECK_SHOTS shots through the kernel alone."""
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.entry import TRAJ_SEED, trajectory_entry, z_top
    from quest_tpu_torch.ops import segment as S
    fn, (gen,) = trajectory_entry()
    circ, shots, chunk = fn.circuit, fn.shots, fn.chunk
    n = circ.num_qubits
    t0 = time.perf_counter()
    prog = T._compiled_traj(circ, n, "cuda")
    setup_s = time.perf_counter() - t0
    planned = prog.launches_per_call
    warm = torch.rand((chunk, prog.num_channels), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(99))
    prog(warm)
    torch.cuda.synchronize()
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    t0 = time.perf_counter()
    vals, draws = fn(gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = S.segment_sweep.launches
    stage_launches = dict(S.segment_sweep.stage_launches)
    chunks = -(-shots // chunk)
    with_sel = sum(1 for s in prog.segments if "batchsel" in s.labels)
    if (launches != planned * chunks
            or stage_launches.get("batchsel") != with_sel * chunks):
        raise AssertionError(f"trajectories: {launches} launches "
                             f"({stage_launches}) for {chunks} chunks of "
                             f"{planned} ({with_sel} with channel stages)")
    if not (torch.isfinite(vals).all().item()
            and vals.abs().max().item() <= 1 + PATH_TOL):
        raise AssertionError("trajectories: <Z> out of [-1, 1]")
    # the first chunk again (the run's uniforms), kernel against plain
    u = torch.rand((shots, prog.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(TRAJ_SEED))
    ub, k = u[:chunk], PLAIN_CHECK_SHOTS
    pk, dk = prog(ub)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err = scale = 0.0
    draws_equal = torch.equal(dk, draws[:chunk])
    for lo in range(0, chunk, k):
        pp, dp = prog.plain(ub[lo:lo + k])
        draws_equal = draws_equal and torch.equal(dp, dk[lo:lo + k])
        err = max(err, (pk[lo:lo + k] - pp).abs().max().item())
        scale = max(scale, pp.abs().max().item())
        if lo == 0:
            first_plain = pp
        del pp
    torch.cuda.synchronize()
    plain_chunk_ms = (time.perf_counter() - t0) * 1e3
    norm_err = (1.0 - pk.double().pow(2).sum(dim=(1, 2))).abs().max().item()
    z_err = (z_top(pk) - vals[:chunk]).abs().max().item()
    # the first shots through the kernel alone: the same launches
    S.segment_sweep.launches = 0
    p8, d8 = prog(ub[:k])
    torch.cuda.synchronize()
    launches8 = S.segment_sweep.launches
    err8 = (p8 - first_plain).abs().max().item()
    norm_err8 = (1.0 - p8.double().pow(2).sum(dim=(1, 2))).abs().max().item()
    if not (draws_equal and torch.equal(d8, dk[:k])
            and err <= PATH_TOL * scale and err8 <= PATH_TOL * scale
            and max(norm_err, norm_err8) <= PATH_TOL and z_err <= PATH_TOL
            and launches8 == planned):
        raise AssertionError(f"trajectories: draws equal {draws_equal}/"
                             f"{torch.equal(d8, dk[:k])}, max|diff| {err} and "
                             f"{err8} at {k} shots (max|amp| {scale}), "
                             f"|1 - norm| {norm_err}/{norm_err8}, <Z> {z_err}, "
                             f"{launches8} launches at {k} shots")
    del pk, p8, first_plain
    u8 = ub[:k]
    chunk_ms = time_ms(torch, lambda: prog(ub), 3)
    plain8_ms = time_ms(torch, lambda: prog.plain(u8), 1)
    kernel8_ms = time_ms(torch, lambda: prog(u8), 3)
    bound, bound_by = trajectory_bound(prog, chunk)
    stats = T.plan_stats(circ, chunk)
    rec = {"phase": "trajectories", "n": n, "shots": shots,
           "chunk": chunk, "chunks": chunks,
           "channels": prog.num_channels, "plan": stats,
           "launches": launches, "launches_per_chunk": launches / chunks,
           "planned_per_chunk": planned, f"launches_{k}_shots": launches8,
           "stage_launches": stage_launches,
           "wall_s": wall, "shots_per_s": shots / wall,
           "chunk_ms": chunk_ms, "plain_chunk_ms": plain_chunk_ms,
           "bound_ms": bound, "bound_by": bound_by,
           f"ms_{k}_shots": kernel8_ms, f"plain_ms_{k}_shots": plain8_ms,
           "max_abs_err": err, f"max_abs_err_{k}_shots": err8,
           "rel_err": err / scale, "max_norm_err": max(norm_err, norm_err8),
           "branch_rate": draws.ne(0).double().mean().item(),
           "setup_s": setup_s}
    emit(rec)
    del vals, draws
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the matmul tiers (S11): HIGH and DEFAULT through the tensor-core bodies
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def session_tier(tier):
    """Programs compiled inside run at `tier`; the knob decides again
    afterwards."""
    from quest_tpu_torch import precision as P
    P.set_matmul_precision(tier)
    try:
        yield
    finally:
        P.set_matmul_precision(None)


def tier_stage_cases(rng):
    """(name, n, stages, arrays): every case of stage_cases that holds a
    b0, b1 or scb stage (predicated, real-only and chained ones too), and
    b1 and scb at the other widths the planner emits."""
    from quest_tpu_torch.ops import segment as S
    cases = [c for c in stage_cases(rng) if any(S.rounds(st) for st in c[2])]
    n = 20
    extra = [("b1_8", mat_op(rng, "b1", 8)), ("b1_16", mat_op(rng, "b1", 16)),
             ("b1_64_real", mat_op(rng, "b1", 64, real=True)),
             ("scb_8", mat_op(rng, "scb", 8, bit=9)),
             ("scb_16", mat_op(rng, "scb", 16, bit=8)),
             ("scb_32_preds", mat_op(rng, "scb", 32, bit=7,
                                     lane_preds=((5, 1),),
                                     row_preds=((0, 0),))),
             ("b1_128_preds", mat_op(rng, "b1", 128, lane_preds=((0, 1),),
                                     row_preds=((9, 1),)))]
    return cases + [(name, n, [st], [a]) for name, (st, a) in extra]


def envelope(tier, plain_dist, floor=None):
    """(gate, source) of a tier's distance from HIGHEST: the stated
    tolerance, or ENVELOPE_SLACK x the distance the plain version of the
    tier itself shows on the same input where that is larger (the tier's
    own arithmetic: HIGH's split truncates hi toward zero, so the dropped
    lo*lo term shrinks every product a little, stage after stage)."""
    tol = TIER_TOL[tier] if floor is None else floor
    own = ENVELOPE_SLACK * plain_dist
    return (tol, "stated") if tol >= own else (own, "plain")


def tier_agreement(torch, got, want, tol, tier, chained):
    """Kernel `got` against the tier's plain version `want`, plane by
    plane: {max_abs_err, rel_err, rel_l2, ok}. ok: max|diff| <= tol x
    max|amp|; or, where a rounding stage reads values that earlier stages
    computed (`chained`), max|diff| <= FLIP_TOL x max|amp| and the
    relative L2 distance within the tier's own TIER_TOL. The kernel and
    the plain version sum in different fp32 orders, and an input one ulp
    apart across a bf16 rounding boundary rounds to neighbouring bf16
    values in the two: a few inputs one bf16 step apart, not a wrong
    product (a wrong layout moves every element, by O(1))."""
    err = max((got[p] - want[p]).abs().max().item() for p in range(2))
    sq = sum((got[p] - want[p]).pow(2).sum(dtype=torch.float64).item()
             for p in range(2))
    rel_l2 = (sq / norm_of(want)) ** 0.5
    scale = want.abs().max().item()
    ok = err <= tol * scale or (
        chained and err <= FLIP_TOL[tier] * scale
        and rel_l2 <= TIER_TOL[tier])
    return {"max_abs_err": err, "rel_err": err / scale, "rel_l2": rel_l2,
            "ok": ok}


def chained(stages) -> bool:
    """Whether a rounding stage follows another stage in the segment."""
    from quest_tpu_torch.ops import segment as S
    return any(S.rounds(st) for st in stages[1:])


def phase_precision_stages(torch):
    """Every matrix-stage case at HIGH and DEFAULT: the tier's kernel
    against the tier's plain version (STAGE_TOL x max|amp|, see
    tier_agreement for chains) and against the HIGHEST kernel on the same
    input (bits differ; within TIER_TOL)."""
    from quest_tpu_torch.ops import segment as S
    results, failures = [], []
    for tier in TIERS:
        rng = np.random.default_rng(20261017)
        for name, n, stages, arrays in tier_stage_cases(rng):
            seg = S.prepare_segment(stages, arrays, n, "cuda", tier=tier)
            top = S.prepare_segment(stages, arrays, n, "cuda",
                                    tier="highest")
            amps = torch.from_numpy(rng.standard_normal(
                (2, 1 << n)).astype(np.float32)).cuda()
            want = S.segment_sweep_reference(amps, seg.stages, seg.operands,
                                             n, tier=tier)
            ref = amps.clone()
            S.segment_sweep(amps, seg)
            S.segment_sweep(ref, top)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            agree = tier_agreement(torch, amps.reshape(2, -1),
                                   want.reshape(2, -1), STAGE_TOL, tier,
                                   chained(stages))
            dist = (amps - ref).abs().max().item()
            rec = {"case": name, "tier": tier, "n": n, **agree,
                   "rel_vs_highest": dist / scale}
            results.append(rec)
            if not (agree["ok"] and 0.0 < dist <= TIER_TOL[tier] * scale):
                failures.append(rec)
    emit({"phase": "precision_stages", "tol": STAGE_TOL,
          "tier_tol": TIER_TOL, "cases": results,
          "worst_rel_err": {t: max(r["rel_err"] for r in results
                                   if r["tier"] == t) for t in TIERS}})
    if failures:
        raise AssertionError(f"precision_stages: {failures}")
    return results


def norm_of(planes) -> float:
    """Sum of squares in f64, one plane at a time (no 30-qubit-sized f64
    temporary of both planes)."""
    return sum((planes[p].double() ** 2).sum().item() for p in range(2))


def density_stats(planes, nd):
    """(Tr rho, purity) of density planes over nd qubits."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.state import Qureg
    q = Qureg(planes.reshape(2, -1), nd, is_density=True)
    return K.calc_total_prob(q), K.calc_purity(q)


def tier_run(torch, name, fn, amps, top_out, tol=None, density=False):
    """One program `fn` (compiled at a tier) on input planes `amps`: the
    plain version of the tier first (out of place), then the kernel with
    the counters set to 0 just before and read just after; gates: the
    plain version within PATH_TOL x max|amp|, sum of squares equal to the
    plain version's within PATH_TOL, the HIGHEST kernel's output
    `top_out` within the tier's envelope (bits differ), and for a
    statevector |1 - norm| within the tier's envelope. Returns the
    record (a density record also holds the plain path's trace and
    purity); `amps` holds the result."""
    want = fn.plain(amps)
    torch.cuda.synchronize()
    launches, stage_launches = counted_call(torch, name, fn, amps)
    scale = top_out.abs().max().item()
    agree = tier_agreement(torch, amps, want, PATH_TOL, fn.tier, True)
    plain_dist = max((want[p] - top_out[p]).abs().max().item()
                     for p in range(2)) / scale
    norm_plain = norm_of(want)
    plain_stats = density_stats(want, fn.n // 2) if density else None
    del want
    torch.cuda.empty_cache()
    dist = max((amps[p] - top_out[p]).abs().max().item()
               for p in range(2)) / scale
    norm = norm_of(amps)
    gate, source = envelope(fn.tier, plain_dist, tol)
    rec = {"phase": name, "tier": fn.tier, "n": fn.n,
           "segments": len(fn.segments), "launches": launches,
           "stage_launches": stage_launches, **agree, "rel_vs_highest": dist,
           "plain_rel_vs_highest": plain_dist, "envelope": gate,
           "envelope_from": source, "norm": norm, "plain_norm": norm_plain}
    norm_ok = True
    if density:            # the sum of squares is the purity: gated apart
        rec["plain_trace"], rec["plain_purity"] = plain_stats
    else:
        ngate, nsource = envelope(fn.tier, abs(1.0 - norm_plain), tol)
        rec["norm_envelope"], rec["norm_envelope_from"] = ngate, nsource
        norm_ok = abs(1.0 - norm) <= ngate
    if not (agree["ok"] and abs(norm - norm_plain) <= PATH_TOL
            and 0.0 < dist <= gate and norm_ok
            and torch.isfinite(amps).all().item()):
        raise AssertionError(f"{name}: {rec}")
    return rec


def phase_precision_flagship(torch, top):
    """entry()'s 28q d4 step at HIGH and DEFAULT: 9 launches like
    HIGHEST's (`top`, the flagship record), against the tier's plain path
    and the HIGHEST kernel, median of 5 warm steps."""
    from quest_tpu_torch.entry import entry
    fn, (amps,) = entry()
    x0 = amps.clone()
    fn(amps)
    top_out = amps
    recs = {}
    for tier in TIERS:
        with session_tier(tier):
            fn_t, (x,) = entry()
        x.copy_(x0)
        rec = tier_run(torch, "precision_flagship", fn_t, x, top_out)
        if rec["launches"] != top["launches"]:
            raise AssertionError(f"precision_flagship: {rec['launches']} "
                                 f"launches at {tier}, {top['launches']} at "
                                 f"highest")
        rec["median_ms"] = time_ms(torch, lambda: fn_t(x), 5)
        rec["plain_ms"] = time_ms(torch, lambda: fn_t.plain(x0), 1)
        rec["highest_median_ms"] = top["median_ms"]
        rec["bound_ms"], rec["bound_by"] = bound_of(fn_t.segments)
        emit(rec)
        recs[tier] = rec
        del fn_t, x
        torch.cuda.empty_cache()
    del fn, amps, x0, top_out
    torch.cuda.empty_cache()
    return recs


def phase_precision_baseline(torch):
    """30q d20 at HIGH: 46 launches, against the plain path at HIGH and
    the HIGHEST kernel (within 5e-5 x max|amp| and norm 5e-4, or the
    plain version's own distance)."""
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    n, depth = 30, 20
    circ = random_circuit(n, depth, seed=7, entangler="cz")
    top = circ.compiled_fused(n, device="cuda")
    top_out = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    top(top_out)
    del top
    with session_tier("high"):
        fn = circ.compiled_fused(n, device="cuda")
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    rec = tier_run(torch, "precision_baseline", fn, amps, top_out,
                   BASELINE_HIGH_TOL)
    del top_out
    torch.cuda.empty_cache()
    rec["depth"] = depth
    rec["median_ms"] = time_ms(torch, lambda: fn(amps), 1)
    rec["bound_ms"], rec["bound_by"] = bound_of(fn.segments)
    emit(rec)
    del fn, amps
    torch.cuda.empty_cache()
    return rec


def phase_precision_density(torch):
    """density_entry() at HIGH: against the plain path at HIGH and the
    HIGHEST kernel; Tr rho, Hermiticity and purity within 1e-4 of the
    HIGHEST run's."""
    from quest_tpu_torch.entry import density_entry
    fn, (amps,) = density_entry()
    x0 = amps.clone()
    fn(amps)
    top_out = amps
    nd = fn.n // 2
    with session_tier("high"):
        fn_t, (x,) = density_entry()
    x.copy_(x0)
    rec = tier_run(torch, "precision_density", fn_t, x, top_out,
                   density=True)
    for key, planes in (("", x), ("highest_", top_out)):
        rec[key + "trace"], rec[key + "purity"] = density_stats(planes, nd)
        rec[key + "hermitian_err"] = hermitian_err(planes, nd)
    scale = top_out.abs().max().item()
    ok = (rec["hermitian_err"]
          <= rec["highest_hermitian_err"] + PATH_TOL * scale)
    for key in ("trace", "purity"):
        # within 1e-4 of the HIGHEST run's, or of what the plain version
        # of the tier itself shows
        gate, source = envelope(
            "high", abs(rec["plain_" + key] - rec["highest_" + key]), PATH_TOL)
        rec[key + "_envelope"], rec[key + "_envelope_from"] = gate, source
        ok = ok and abs(rec[key] - rec["highest_" + key]) <= gate
    if not ok:
        raise AssertionError(f"precision_density: {rec}")
    rec["median_ms"] = time_ms(torch, lambda: fn_t(x), 5)
    rec["highest_median_ms"] = time_ms(torch, lambda: fn(top_out), 5)
    rec["bound_ms"], rec["bound_by"] = program_bound(fn_t)
    emit(rec)
    del fn, fn_t, amps, x, x0, top_out
    torch.cuda.empty_cache()
    return rec


def _pair_library(torch, st, arr, amps, n):
    """One torch.einsum applying the pair's 4x4 operator to a complex64
    copy of the state (bits: op qubit, sliced qubit)."""
    from quest_tpu_torch.ops import segment as S
    q, cores = S.pair_core(st, arr)
    q_op = q if st.op_kind == "lane" else 7 + q
    q_sl = 7 + st.sliced_bit
    hi, lo = max(q_op, q_sl), min(q_op, q_sl)
    m = torch.from_numpy(cores[0] + 1j * cores[1]).to(torch.complex64).cuda()
    m = m.reshape(2, 2, 2, 2).permute(0, 2, 1, 3)      # [r, ao, c, ai]
    x = torch.complex(amps.reshape(2, -1)[0], amps.reshape(2, -1)[1])
    x = x.reshape(1 << (n - hi - 1), 2, 1 << (hi - lo - 1), 2, 1 << lo)
    spec = ("rocf,acbfe->arboe" if q_sl > q_op else "rocf,afbce->aobre")
    return time_ms(torch, lambda: torch.einsum(spec, m, x), 5)


def _diag_library(torch, arr, amps, q):
    """One broadcast complex multiply: a 1-qubit diagonal on qubit q."""
    t = torch.from_numpy(arr[0] + 1j * arr[1]).to(torch.complex64).cuda()
    x = torch.complex(amps.reshape(2, -1)[0], amps.reshape(2, -1)[1])
    x = x.reshape(-1, 2, 1 << q)
    return time_ms(torch, lambda: x * t.reshape(1, 2, 1), 5)


def _condition_bits(arr, lane_col, row_col):
    """{qubit: wanted bit} of a phase or parity operand's lane mask (column
    `lane_col`, its wants beside it for a phase) and row mask (split at
    bit 15 over `row_col` and the column after it)."""
    lm = int(arr[0, lane_col])
    rm = int(arr[0, row_col]) | (int(arr[0, row_col + 1]) << 15)
    return ([q for q in range(7) if lm >> q & 1]
            + [q + 7 for q in range(32) if rm >> q & 1])


def _complex_view(torch, amps, n, qubits):
    """A complex64 copy of the planes (made untimed), viewed with one
    size-2 axis per qubit (ops.apply.bit_view), and those axes."""
    from quest_tpu_torch.ops.apply import bit_view
    dims, axis_of = bit_view(n, qubits)
    x = torch.complex(amps.reshape(2, -1)[0], amps.reshape(2, -1)[1])
    return x.view(dims), axis_of


def _phase_library(torch, arr, amps, n):
    """S5's function as one call: an in-place complex64 mul_ of the
    all-ones slice (the wanted bits) of a (2,)-axis view."""
    qubits = _condition_bits(arr, 2, 4)
    lw = int(arr[0, 3])
    rw = int(arr[0, 6]) | (int(arr[0, 7]) << 15)
    x, axis_of = _complex_view(torch, amps, n, qubits)
    idx = [slice(None)] * x.dim()
    for q in qubits:
        idx[axis_of[q]] = (lw >> q & 1) if q < 7 else (rw >> (q - 7) & 1)
    sl = x[tuple(idx)]
    t = complex(arr[0, 0], arr[0, 1])
    return time_ms(torch, lambda: sl.mul_(t), 5)


def _parity_library(torch, arr, amps, n):
    """S6's function as one call: a broadcast complex64 torch.mul by the
    (2,)*k factor cos h - i sin h (-1)^parity of the target bits."""
    qubits = _condition_bits(arr, 2, 3)
    x, axis_of = _complex_view(torch, amps, n, qubits)
    k = len(qubits)
    bits = (np.arange(1 << k)[:, None] >> np.arange(k)[::-1]) & 1
    sign = 1 - 2 * (bits.sum(1) % 2)
    f = (float(arr[0, 0]) - 1j * float(arr[0, 1]) * sign).astype(np.complex64)
    shape = [1] * x.dim()
    for q in qubits:
        shape[axis_of[q]] = 2
    # axes in ascending view order are descending qubits, as bits[:, 0..]
    fac = torch.from_numpy(f).cuda().reshape(shape)
    return time_ms(torch, lambda: torch.mul(x, fac), 5)


# K1 single-stage ms at 28 qubits before each kernel's latest redesign,
# on an NVIDIA H100 80GB HBM3 at 700 W, from this script's stage_timing
# phase on the tree of that time (PERF.md), printed beside the new times:
# b0, b1, scb-128 and diagvec before the ring drivers' tensor-map copies
# and S8's hoisted indexing; the multiphase rows before S7 factored its
# angles into lane and row parts (2 and 64 terms: this phase run against
# the package of that tree, the mean of two runs); S5 and S6 alone and the
# diag_run_cases before S5/S6 ran as runs and S5 skipped tiles (the mean
# of two `--diag-runs` runs against the package of that tree, with its
# entry.py given this tree's two diagonal circuits).
BEFORE_REDESIGN_MS = {"b0": 6.66, "b1": 6.96, "scb128": 9.08,
                      "b0@high": 2.26, "b1@high": 2.28, "scb128@high": 4.45,
                      "b0@default": 1.81, "b1@default": 1.78,
                      "scb128@default": 3.83, "diagvec": 1.92,
                      "multiphase": 4.76, "multiphase_aa": 2.405,
                      "multiphase_m64": 27.549,
                      "phase": 1.558, "parity": 1.563,
                      "diag_layer_run": 23.86, "diag_layer_exact": 23.86,
                      "cz_brick_run": 6.535, "cz_brick_exact": 6.535,
                      "parity_pair": 7.48}
# S7 on the main paths: two all-ones terms, a CZ on lane bit 6 and row bit
# 0 and one on row bits 13 and 14 (the flagship's and 30q d20's stages)
MAIN_PATH_MULTIPHASE = [("a", 1 << 6, 1), ("a", 0, 3 << 13)]
DIAG_RUN_TIMED = ("diag_layer_run", "diag_layer_exact", "cz_brick_run",
                  "cz_brick_exact", "cz_brick_s7", "parity_pair",
                  "parity_pair_b0")


def planned_segment(circuit, n, index=0):
    """(stages, arrays) of segment `index` of the circuit's swept plan at
    n qubits (compiled_fused's launches, before packing)."""
    parts = [p for p in circuit.fused_parts(n)[0] if p[0] == "segment"]
    return list(parts[index][1]), list(parts[index][2])


def diag_run_cases(n=TIMING_QUBITS):
    """(name, stages, arrays) of the S5/S6 timing cases at n qubits: a
    lone phase (lane bit 0, row bit 20) and parity (lane bits 0-1, row
    bit 20), as stage_timing's; the diagonal layer's one launch
    (entry.diag_layer_circuit: a phase, a multiphase, then a run of 28
    parity and 24 phase stages); the cz brick's (entry.cz_brick_circuit:
    a multiphase and 12 phase stages) and its multiphase alone, the two
    runs also in the exact form (`_exact`: the packed run heads' angle-form
    bit cleared, so the kernel applies each stage's formula); the
    flagship's launch 0 cut after its b0 (two parity stages on lane bits 0
    and 1, then the b0) and that b0 alone."""
    from quest_tpu_torch import entry as E
    rng = np.random.default_rng(10)
    phase, parity = (phase_op(rng, 0b1, 0b1, 1 << 20, 1 << 20),
                     parity_op(rng, 0b11, 1 << 20))
    flag = planned_segment(E.flagship_circuit(n, 4), n)
    cz = planned_segment(E.cz_brick_circuit(n), n)
    layer = planned_segment(E.diag_layer_circuit(n), n)
    return [("phase", [phase[0]], [phase[1]]),
            ("parity", [parity[0]], [parity[1]]),
            ("diag_layer_run",) + layer,
            ("diag_layer_exact",) + layer,
            ("cz_brick_run",) + cz,
            ("cz_brick_exact",) + cz,
            ("cz_brick_s7", cz[0][:1], cz[1][:1]),
            ("parity_pair", flag[0][:3], flag[1][:3]),
            ("parity_pair_b0", flag[0][2:3], flag[1][2:3])]


def flagship_tier_ms(torch):
    """{tier: median device ms of 5 warm steps} of entry()'s flagship step
    compiled at each matmul tier under K1: the main path whose launches 0,
    3 and 6 hold S5/S6 runs."""
    from quest_tpu_torch.entry import entry
    out = {}
    for tier in ("highest", "high", "default"):
        with session_tier(tier):
            fn, (amps,) = entry()
        fn(amps)
        out[tier] = time_ms(torch, lambda: fn(amps), 5)
        del fn, amps
        torch.cuda.empty_cache()
    return out


def diag_run_timing(torch, planes, names=None):
    """The diag_run_cases named in `names` (all when None) under K1 on
    the planes: kernel against its plain version (STAGE_TOL x max|amp|),
    median ms of 5 launches and of 3 plain calls, the bound. Uses only
    the package's prepare_segment and segment_sweep, so it times an
    earlier tree's package too."""
    from quest_tpu_torch.ops import segment as S
    n = int(planes.numel()).bit_length() - 2
    out = []
    for name, stages, arrays in diag_run_cases(n):
        if names is not None and name not in names:
            continue
        seg = S.prepare_segment(stages, arrays, n, "cuda", driver="decoupled")
        if name.endswith("_exact"):
            desc = seg.desc.clone()
            desc[:, S.F_FORMS] *= (desc[:, S.F_KIND] == S.K_MULTIPHASE).long()
            seg = dataclasses.replace(seg, desc=desc)
        amps = planes.clone()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n)
        S.segment_sweep(amps, seg)
        torch.cuda.synchronize()
        err = (amps.reshape(2, -1) - want.reshape(2, -1)).abs().max().item()
        if not err <= STAGE_TOL * want.abs().max().item():
            raise AssertionError(f"{n}q {name}: max|diff| {err}")
        del want
        ms = time_ms(torch, lambda: S.segment_sweep(amps, seg), 5)
        plain_ms = time_ms(torch, lambda: S.segment_sweep_reference(
            amps, seg.stages, seg.operands, n), 1)
        bound, by = bound_of([seg])
        out.append({"name": name, "label": "diag_run", "stages": len(stages),
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bound, "bound_by": by, "max_abs_err": err})
        del amps
        torch.cuda.empty_cache()
    return out


def phase_stage_timing(torch):
    """Single-stage segments at 28 qubits: b0, b1, scb-128 and sc (with
    one complex64 torch.matmul in the stage's frame as the yardstick),
    phase (an in-place complex64 mul_ of the all-ones slice) and parity
    (a broadcast complex64 torch.mul by the parity factor), an 8-term
    multiphase of both forms, the main paths' 2-term all-ones multiphase
    and a 64-term one of alternating forms (m terms: no single library
    call),
    each Kraus pair form (one torch.einsum of the 4x4 operator as the
    yardstick) and a 1-qubit diagonal on row bit 14 (one broadcast
    complex multiply)."""
    from quest_tpu_torch.ops import band_plan as BP
    from quest_tpu_torch.ops import segment as S
    n = TIMING_QUBITS
    rng, (host,) = seeded_planes(7, (2, 1 << n))
    m64 = np.random.default_rng(64)
    planes = torch.from_numpy(host).cuda()
    del host
    planes /= planes.double().pow(2).sum().sqrt().float()
    # (name, (stage, operand), first qubit of the contracted bits or None)
    cases = [("b0", mat_op(rng, "b0", 128), 0),
             ("b1", mat_op(rng, "b1", 128), 7),
             ("scb128", mat_op(rng, "scb", 128, bit=7), 14),
             ("sc", mat_op(rng, "sc", 2, bit=20), 27),
             ("phase", phase_op(rng, 0b1, 0b1, 1 << 20, 1 << 20), None),
             ("parity", parity_op(rng, 0b11, 1 << 20), None),
             ("multiphase", multiphase_op(
                 rng, [("a" if k % 2 else "p", 1 << (k % 7), 1 << (2 * k + 5))
                       for k in range(8)]), None),
             ("multiphase_aa", multiphase_op(rng, MAIN_PATH_MULTIPHASE), None),
             # its own generator, so the operands after it stay as they were
             ("multiphase_m64", multiphase_op(m64, multiphase_terms(
                 m64, 64, n - 7, ("p", "a") * 32)), None),
             ("pair_lane_scat", lane_pair_op(rng, 3, "scat", 20), None),
             ("pair_lane_sub", lane_pair_op(rng, 5, "sub", 6), None),
             ("pair_sub_scat", pair_op(rng, "sub", 2, 20), None),
             ("pair_sc_scat", pair_op(rng, "sc", 6, 20), None),
             ("diagvec", diag_op(rng, (21,)), None)]
    out = []
    for name, (st, arr), q0 in cases:
        seg = S.prepare_segment([st], [arr], n, "cuda")
        amps = planes.clone()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n)
        S.segment_sweep(amps, seg)
        torch.cuda.synchronize()
        err = (amps.reshape(2, -1) - want.reshape(2, -1)).abs().max().item()
        if not err <= STAGE_TOL * want.abs().max().item():
            raise AssertionError(f"28q {name}: max|diff| {err}")
        del want
        ms = time_ms(torch, lambda: S.segment_sweep(amps, seg), 5)
        plain_ms = time_ms(torch, lambda: S.segment_sweep_reference(
            amps, seg.stages, seg.operands, n), 1)
        lib_ms = None
        if q0 is not None:
            # yardstick: out[a, i, b] = sum_j G[i, j] x[a, j, b] as one
            # complex64 matmul (b0/b1/scb-128 store G^T, sc stores G)
            d = st.dim
            x = torch.complex(amps.reshape(2, -1)[0], amps.reshape(2, -1)[1])
            x = x.reshape(1 << (n - q0 - d.bit_length() + 1), d, 1 << q0)
            gt = arr if st.kind != "sc" else arr.transpose(0, 2, 1)
            g = torch.from_numpy(gt[0].T + 1j * gt[1].T).to(
                torch.complex64).cuda()
            if q0 == 0:
                x = x.reshape(-1, d)
                lib_ms = time_ms(torch, lambda: torch.matmul(x, g.T), 5)
            else:
                lib_ms = time_ms(torch, lambda: torch.matmul(g, x), 5)
            del x
        elif isinstance(st, BP.PairStage):
            lib_ms = _pair_library(torch, st, arr, amps, n)
        elif isinstance(st, BP.DiagVecStage):
            lib_ms = _diag_library(torch, arr, amps, st.targets[0])
        elif isinstance(st, BP.PhaseStage):
            lib_ms = _phase_library(torch, arr, amps, n)
        elif isinstance(st, BP.ParityStage):
            lib_ms = _parity_library(torch, arr, amps, n)
        bound_ms, bound_by = bound_of([seg])
        out.append({"name": name, "label": S.stage_label(st), "ms": ms,
                    "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": err})
        del amps
        torch.cuda.empty_cache()
    out += diag_run_timing(torch, planes, DIAG_RUN_TIMED)
    out += tier_stage_timing(torch, planes, rng)
    del planes
    torch.cuda.empty_cache()
    out += batchsel_timing(torch)
    for rec in out:
        if rec["name"] in BEFORE_REDESIGN_MS:
            rec["before_redesign_ms"] = BEFORE_REDESIGN_MS[rec["name"]]
    emit({"phase": "stage_timing", "n": n, "stages": out})
    return out


def phase_phase_counters(torch):
    """Where single-stage 28-qubit launches under K1 spend their cycles
    (profiling.segment_phase_report, the COUNTERS build: operator-slice
    waits and releases, step prologues, the chain, per block; counters
    set to 0 before each launch and read after it) for b0, b1-128 and
    scb-128 at each tier, a phase stage, the 8- and 2-term multiphase of
    stage_timing and the diagonal layer's and cz brick's runs
    (diag_run_cases); and K3 launches (the stage-free copy, a phase stage,
    b0 at DEFAULT) with the prologue, chain and store shares of a block;
    beside the fp32 FMA rate the card sustains (profiling.fma_rate).
    Counted launches are not the main path's."""
    from quest_tpu_torch import profiling
    from quest_tpu_torch.ops import segment as S
    n = TIMING_QUBITS
    rng, (host,) = seeded_planes(7, (2, 1 << n))
    planes = torch.from_numpy(host).cuda()
    del host
    planes /= planes.double().pow(2).sum().sqrt().float()
    cases = [("b0", mat_op(rng, "b0", 128)), ("b1", mat_op(rng, "b1", 128)),
             ("scb128", mat_op(rng, "scb", 128, bit=7))]
    out = []
    for tier in ("highest",) + TIERS:
        for name, (st, arr) in cases:
            seg = S.prepare_segment([st], [arr], n, "cuda", tier=tier)
            rec = profiling.segment_phase_report(planes, seg)
            out.append(dict(rec, name=S.stage_label(st, tier)))
    st, arr = phase_op(rng, 0b1, 0b1, 1 << 20, 1 << 20)
    rec = profiling.segment_phase_report(
        planes, S.prepare_segment([st], [arr], n, "cuda"))
    out.append(dict(rec, name="phase"))
    # S7 at 8 terms of both forms and the main paths' 2 all-ones terms:
    # how much of a block the chain (the angle sums and sincosf) takes
    for name, terms in (("multiphase", [
            ("a" if k % 2 else "p", 1 << (k % 7), 1 << (2 * k + 5))
            for k in range(8)]), ("multiphase_aa", MAIN_PATH_MULTIPHASE)):
        mst, marr = multiphase_op(rng, terms)
        rec = profiling.segment_phase_report(
            planes, S.prepare_segment([mst], [marr], n, "cuda"))
        out.append(dict(rec, name=name))
    # the diagonal layer's and the cz brick's runs (54 and 13 stages)
    for name, stages, arrays in diag_run_cases(n):
        if name in ("diag_layer_run", "cz_brick_run"):
            rec = profiling.segment_phase_report(
                planes, S.prepare_segment(stages, arrays, n, "cuda"))
            out.append(dict(rec, name=name))
    # K3 blocks: prologue (the tile's loads in flight under the row ids and
    # the operator ring's start), chain, and stores (thread 0, until they
    # let the block exit), on the stage-free copy, a phase stage and b0 at
    # DEFAULT
    k3 = []
    for name, stages, arrays, tier in (
            ("stage_free", [], [], "highest"), ("phase", [st], [arr],
                                                "highest"),
            ("b0@default", [cases[0][1][0]], [cases[0][1][1]], "default")):
        rec = profiling.segment_phase_report(planes, S.prepare_segment(
            stages, arrays, n, "cuda", tier=tier, driver="grid"))
        k3.append(dict(rec, name=name))
    del planes
    torch.cuda.empty_cache()
    # the K1 step prologue's share of a block: inner-row tiles (b0, b1)
    # against scattered-row tiles (scb-128), per tier
    share = {r["name"]: r["share_of_block"]["prologue"] for r in out}
    prologue = {tier: {"inner_rows": max(share[S.stage_label(st, tier)]
                                         for _, (st, _) in cases[:2]),
                       "scattered_rows": share[S.stage_label(cases[2][1][0],
                                                             tier)]}
                for tier in ("highest",) + TIERS}
    rec = {"phase": "phase_counters", "n": n, "driver": "decoupled",
           "launches": out, "prologue_share": prologue,
           "k3_launches": k3,
           "k3_shares": {r["name"]: {k: r["share_of_block"][k] for k in
                                     ("prologue", "chain", "store")}
                         for r in k3},
           "fma_rate": profiling.fma_rate()}
    emit(rec)
    return rec


def _real_block(torch, gt, q0):
    """The stage's operator as one real matrix for a real-block product
    on the f32 planes: (2d, 2d) [[Gre^T, Gim^T], [-Gim^T, Gre^T]] for
    X [Xre Xim] (b0, lanes contracted), or [[Gre, -Gim], [Gim, Gre]] for
    [Xre; Xim] along the contracted axis (b1, scb). `gt`: the planner's
    G^T planes."""
    g = np.stack([gt[0].T, gt[1].T])
    if q0 == 0:
        blk = np.block([[gt[0], gt[1]], [-gt[1], gt[0]]])
    else:
        blk = np.block([[g[0], -g[1]], [g[1], g[0]]])
    return torch.from_numpy(blk.astype(np.float32)).cuda()


def tier_stage_timing(torch, planes, rng):
    """b0, b1-128 and scb-128 at HIGH and DEFAULT on the 28-qubit planes:
    kernel, plain version, bound (products at the bf16 tensor rate) and a
    yardstick the port never calls — for DEFAULT one real-block f32
    torch.matmul under set_float32_matmul_precision("medium") (bf16
    inputs, fp32 accumulation where cuBLAS takes it), for HIGH the three
    bf16 torch.matmul calls of the split parts, timed together."""
    from quest_tpu_torch import precision as P
    from quest_tpu_torch.ops import segment as S
    n = TIMING_QUBITS
    cases = [("b0", mat_op(rng, "b0", 128), 0),
             ("b1", mat_op(rng, "b1", 128), 7),
             ("scb128", mat_op(rng, "scb", 128, bit=7), 14)]
    out = []
    for tier in TIERS:
        for name, (st, arr), q0 in cases:
            seg = S.prepare_segment([st], [arr], n, "cuda", tier=tier)
            amps = planes.clone()
            want = S.segment_sweep_reference(amps, seg.stages, seg.operands,
                                             n, tier=tier)
            S.segment_sweep(amps, seg)
            torch.cuda.synchronize()
            err = (amps.reshape(2, -1)
                   - want.reshape(2, -1)).abs().max().item()
            if not err <= STAGE_TOL * want.abs().max().item():
                raise AssertionError(f"28q {name}@{tier}: max|diff| {err}")
            del want
            torch.cuda.empty_cache()
            ms = time_ms(torch, lambda: S.segment_sweep(amps, seg), 5)
            plain_ms = time_ms(torch, lambda: S.segment_sweep_reference(
                amps, seg.stages, seg.operands, n, tier=tier), 1)
            d = st.dim
            blk = _real_block(torch, arr, q0)
            x = amps.reshape(2, -1)
            if q0 == 0:
                xb = torch.cat([x[0].reshape(-1, d), x[1].reshape(-1, d)], 1)
            else:
                a = 1 << (n - q0 - 7)
                xb = torch.cat([x[0].reshape(a, d, -1),
                                x[1].reshape(a, d, -1)], 1)

            def call(u, v):
                return torch.matmul(u, v) if q0 == 0 else torch.matmul(v, u)
            if tier == "default":
                old = torch.get_float32_matmul_precision()
                torch.set_float32_matmul_precision("medium")
                try:
                    lib_ms = time_ms(torch, lambda: call(xb, blk), 5)
                finally:
                    torch.set_float32_matmul_precision(old)
                calls = 1
            else:
                parts = [(u.to(torch.bfloat16), v.to(torch.bfloat16))
                         for u, v in P.tier_products(xb, blk, "high")]
                del xb
                torch.cuda.empty_cache()
                lib_ms = time_ms(torch, lambda: [call(u, v) for u, v in parts],
                                 5)
                calls = 3
                del parts
            xb = None
            torch.cuda.empty_cache()
            bound, bound_by = bound_of([seg])
            label = S.stage_label(st, tier)
            out.append({"name": label, "label": label, "tier": tier,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "library_calls": calls, "bound_ms": bound,
                        "bound_by": bound_by, "max_abs_err": err})
            del amps
            torch.cuda.empty_cache()
    return out


def batchsel_timing(torch):
    """S9 alone at 24 qubits x 64 states (8 GiB) on a lane, a row and a
    scattered bit: kernel, plain version, and one per-state 2x2
    torch.matmul over a bit view of the complex64 batch as the yardstick
    (the port never calls it)."""
    from quest_tpu_torch.entry import random_states
    from quest_tpu_torch.ops import segment as S
    n, batch = 24, 64
    rng = np.random.default_rng(9)
    amps = random_states(batch, n, seed=9, device="cuda")
    out = []
    for name, q in (("batchsel_lane", 3), ("batchsel_row", 10),
                    ("batchsel_scat", 20)):
        st, _ = batchsel_op(q, 0)
        seg = S.prepare_segment([st], [np.zeros((batch, 8), np.float32)], n,
                                "cuda")
        table = sel_table(rng, 1, batch, unitary=True)
        sel = torch.from_numpy(table).cuda()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n,
                                         sel)
        S.segment_sweep(amps, seg, sel)
        torch.cuda.synchronize()
        err = (amps - want).abs().max().item()
        scale = want.abs().max().item()
        del want
        torch.cuda.empty_cache()
        if not err <= BATCHSEL_TOL * scale:
            raise AssertionError(f"24q x {batch} {name}: max|diff| {err}")
        ms = time_ms(torch, lambda: S.segment_sweep(amps, seg, sel), 5)
        plain_ms = time_ms(torch, lambda: S.segment_sweep_reference(
            amps, seg.stages, seg.operands, n, sel), 1)
        torch.cuda.empty_cache()
        g = torch.from_numpy(table[0, :, 0::2] + 1j * table[0, :, 1::2]).to(
            torch.complex64).cuda().reshape(batch, 1, 2, 2)
        x = torch.complex(amps[:, 0], amps[:, 1]).reshape(batch, -1, 2, 1 << q)
        lib_ms = time_ms(torch, lambda: torch.matmul(g, x), 5)
        del x
        torch.cuda.empty_cache()
        bound, bound_by = bound_of([seg], batch=batch)
        out.append({"name": name, "label": S.stage_label(st), "n": n,
                    "batch": batch, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound,
                    "bound_by": bound_by, "max_abs_err": err})
    del amps
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the segment drivers (K1, K2, K3)
# ---------------------------------------------------------------------------

# configuration -> (driver, nbuf): K1 the default, K2 at 2 and 3 plane
# slots, K3 one block per tile
# ---------------------------------------------------------------------------
# the reference's XLA engines (ROADMAP A3): per-gate and banded programs,
# f64 registers, wide gates, small registers, the banded batched and
# trajectory programs. No kernel of the port runs in them but the segment
# kernel of the fused programs they are held against.
# ---------------------------------------------------------------------------

F64_TOL = 1e-12
SMALL_TOL = {"float32": 2e-5, "float64": 1e-12}
TUTORIAL_TOL = 1e-6
TUTORIAL_PROBS = (0.112422, 0.749178)     # the reference binary's output
TRAJ_SMALL_QUBITS = 9
TRAJ_BANDED_QUBITS = 14
TRAJ_BANDED_SHOTS = 256
BOUNDARY_EPS = 1e-5
F64_BASELINE = (30, 20)        # BASELINE config 2 at f64: qubits, depth


def emit_card(rec) -> None:
    """emit(rec) with the card's name and power limit beside its numbers."""
    rec["card"] = smi_line()
    emit(rec)


def plane_err(a, b) -> float:
    """max |a - b| of two (2, ...) planes (or batches) in any view, in
    the wider of their dtypes, a plane (or a state) at a time."""
    x, y = a.reshape(-1), b.reshape(-1)
    dt = x.dtype if x.element_size() >= y.element_size() else y.dtype
    step = 1 << 28
    return max((x[i:i + step].to(dt) - y[i:i + step].to(dt)).abs().max().item()
               for i in range(0, x.numel(), step))


def uncounted_call(torch, name, fn, amps):
    """fn(amps) once with the segment kernel's counter set to 0 just
    before and read just after: a per-gate or banded program (or an f64
    fused program) launches no segment kernel."""
    from quest_tpu_torch.ops import segment as S
    S.segment_sweep.launches = 0
    fn(amps)
    torch.cuda.synchronize()
    if S.segment_sweep.launches:
        raise AssertionError(f"{name}: {S.segment_sweep.launches} segment "
                             f"launches on an XLA-engine path")


def engine_bound(fn, rbytes=4, batch=1):
    """xla_bound of an XlaProgram, or of a FusedProgram's f64 route."""
    return xla_bound(getattr(fn, "banded", fn), rbytes, batch)


def phase_pergate(torch):
    """entry.pergate_entry(): the flagship (28q RCS d4, f32) through the
    per-gate engine, every op of the flat list through ops/apply; against
    K1's fused step within 1e-4 x max|amp|; ms per step (median of 5),
    state passes and their bound. Returns (record, its planes)."""
    from quest_tpu_torch.entry import entry, pergate_entry
    fused, (ref,) = entry()
    fused(ref)
    fn, (amps,) = pergate_entry()
    t0 = time.perf_counter()
    uncounted_call(torch, "pergate", fn, amps)
    first_s = time.perf_counter() - t0
    err, scale = plane_err(amps, ref), ref.abs().max().item()
    norm = norm_of(amps)
    if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL
            and torch.isfinite(amps).all().item()):
        raise AssertionError(f"pergate: max|diff| {err} vs K1 (max|amp| "
                             f"{scale}), norm {norm}")
    del fused, ref
    x = amps.clone()
    rec = {"phase": "pergate", "n": fn.n, "ops": len(fn.items),
           "max_abs_err": err, "rel_err": err / scale, "norm": norm,
           "first_call_s": first_s,
           "median_ms": time_ms(torch, lambda: fn(x), 1), **engine_bound(fn)}
    emit_card(rec)
    del x
    torch.cuda.empty_cache()
    return rec, amps


def phase_banded(torch, pergate_out, tier_plain):
    """entry.banded_entry(): the flagship through the banded engine at
    HIGHEST (against the per-gate engine's planes `pergate_out` within
    1e-4 x max|amp|), HIGH and DEFAULT (against HIGHEST, and |1 - norm|,
    within the tier's envelopes: the stated tolerance, or 1.5x the fused
    flagship's plain version's distance and norm drift at that tier,
    `tier_plain`, as precision_flagship records them); ms (median of 5),
    passes, bound."""
    from quest_tpu_torch.entry import banded_entry
    scale = pergate_out.abs().max().item()
    recs, top = {}, None
    for tier in ("highest",) + TIERS:
        with session_tier(tier):
            fn, (amps,) = banded_entry()
        uncounted_call(torch, f"banded@{tier}", fn, amps)
        norm = norm_of(amps)
        rec = {"phase": "banded", "tier": tier, "n": fn.n,
               "items": len(fn.items), "norm": norm}
        if tier == "highest":
            err = plane_err(amps, pergate_out)
            rec.update(max_abs_err=err, rel_err=err / scale)
            ok = err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL
            top = amps
        else:
            dist = plane_err(amps, top) / scale
            plain_rel, plain_drift = tier_plain[tier]
            gate, source = envelope(tier, plain_rel)
            ngate, nsource = envelope(tier, plain_drift)
            rec.update(rel_vs_highest=dist, envelope=gate,
                       envelope_from=source, norm_envelope=ngate,
                       norm_envelope_from=nsource,
                       fused_plain_rel_vs_highest=plain_rel,
                       fused_plain_norm_drift=plain_drift)
            ok = 0.0 < dist <= gate and abs(1.0 - norm) <= ngate
        if not (ok and torch.isfinite(amps).all().item()):
            raise AssertionError(f"banded: {rec}")
        x = amps.clone()
        rec["median_ms"] = time_ms(torch, lambda: fn(x), 5)
        rec.update(engine_bound(fn))
        emit_card(rec)
        recs[tier] = rec
        del x
        if amps is not top:
            del amps
        torch.cuda.empty_cache()
    del top
    torch.cuda.empty_cache()
    return recs


def phase_f64(torch):
    """f64 planes: the flagship at f64 (4 GiB) through compiled_fused
    (its f64 route: the plan's banded items, no kernel launch) and
    through compiled, within 1e-12 x max|amp| of each other and of norm
    1; against the f32 fused step within 1e-4 x max|amp|. BASELINE's
    30q d20 at f64 (16 GiB) through compiled_banded: one step, its norm
    (within 1e-12), ms, bound. density_entry at f64 (28 state qubits):
    trace, Hermiticity and purity within 1e-12."""
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import density_entry, entry, pergate_entry
    from quest_tpu_torch.state import basis_planes
    c128 = np.complex128
    f32, (ref,) = entry()
    f32(ref)
    fn, (amps,) = entry(dtype=c128)
    uncounted_call(torch, "f64", fn, amps)
    pg, (x,) = pergate_entry(dtype=c128)
    uncounted_call(torch, "f64 pergate", pg, x)
    err, scale = plane_err(amps, x), x.abs().max().item()
    err32 = plane_err(amps, ref)
    norm = norm_of(amps)
    rec = {"phase": "f64", "workload": "flagship", "n": fn.n,
           "dtype": str(amps.dtype), "max_abs_err_vs_pergate": err,
           "rel_err_vs_pergate": err / scale, "max_abs_err_vs_f32": err32,
           "rel_err_vs_f32": err32 / scale, "norm": norm}
    if not (amps.dtype == torch.float64 and err <= F64_TOL * scale
            and abs(1.0 - norm) <= F64_TOL and err32 <= PATH_TOL * scale
            and torch.isfinite(amps).all().item()):
        raise AssertionError(f"f64: {rec}")
    del f32, ref
    rec["median_ms"] = time_ms(torch, lambda: fn(amps), 3)
    rec["pergate_median_ms"] = time_ms(torch, lambda: pg(x), 1)
    rec.update(engine_bound(fn, 8))
    rec["pergate_bound"] = engine_bound(pg, 8)
    emit_card(rec)
    del fn, amps, pg, x
    torch.cuda.empty_cache()

    n, depth = F64_BASELINE
    prog = random_circuit(n, depth, seed=7, entangler="cz").compiled_banded(
        n, device="cuda")
    amps = basis_planes(0, n=n, rdt=np.float64, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: uncounted_call(torch, "f64 30q", prog, amps),
                 1)
    peak = torch.cuda.max_memory_allocated() / 2**30     # the step's own
    norm = norm_of(amps)
    base = {"phase": "f64", "workload": "baseline_30q_d20", "n": n,
            "depth": depth, "items": len(prog.items), "norm": norm,
            "ms": ms, "peak_gib": peak, **engine_bound(prog, 8)}
    if not (abs(1.0 - norm) <= F64_TOL and torch.isfinite(amps).all().item()):
        raise AssertionError(f"f64: {base}")
    emit_card(base)
    del prog, amps
    torch.cuda.empty_cache()

    fnd, (rho,) = density_entry(dtype=c128)
    ms = time_ms(torch, lambda: uncounted_call(torch, "f64 density", fnd,
                                               rho), 1)
    nd = fnd.n // 2
    trace, purity = density_stats(rho, nd)
    herm = hermitian_err(rho, nd)
    dscale = rho.abs().max().item()
    dens = {"phase": "f64", "workload": "density", "n": fnd.n,
            "density_qubits": nd, "trace": trace, "purity": purity,
            "hermitian_err": herm, "ms": ms, **engine_bound(fnd, 8)}
    if not (abs(1.0 - trace) <= F64_TOL and herm <= F64_TOL * dscale
            and purity <= 1.0 + F64_TOL and torch.isfinite(rho).all().item()):
        raise AssertionError(f"f64: {dens}")
    emit_card(dens)
    del fnd, rho
    torch.cuda.empty_cache()
    return rec, base, dens


def phase_wide_gates(torch):
    """BASELINE config 3 at 28 qubits (entry.wide_gates_circuit: RCS d4,
    a 5-target and a 6-target Haar unitary, a 2-target unitary under 3
    controls, one at state 0) through compiled_fused (K1 segments, the
    three matrices as passthroughs between them; launches counted
    against the plan), compiled_banded and compiled: all three within
    1e-4 x max|amp|; passthroughs, ms per step, bounds."""
    from quest_tpu_torch.circuit import XlaPass
    from quest_tpu_torch.entry import FLAGSHIP_QUBITS, wide_gates_circuit
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    n = FLAGSHIP_QUBITS
    c = wide_gates_circuit(n)
    fused = c.compiled_fused(n, device="cuda")
    passes = [s for s in fused.steps if isinstance(s, XlaPass)]
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    launches, stage_launches = counted_call(torch, "wide_gates", fused, amps)
    outs, ms, bounds = {}, {}, {}
    for name in ("compiled_banded", "compiled"):
        fn = getattr(c, name)(n, device="cuda")
        x = basis_planes(0, n=n, device="cuda")
        uncounted_call(torch, f"wide_gates {name}", fn, x)
        outs[name] = x
        ms[name] = time_ms(torch, lambda: fn(x.clone()), 3)
        bounds[name] = engine_bound(fn)
    scale = amps.abs().max().item()
    errs = {"banded_vs_fused": plane_err(outs["compiled_banded"], amps),
            "pergate_vs_fused": plane_err(outs["compiled"], amps),
            "pergate_vs_banded": plane_err(outs["compiled"],
                                           outs["compiled_banded"])}
    norm = norm_of(amps)
    rec = {"phase": "wide_gates", "n": n, "segments": len(fused.segments),
           "passthroughs": len(passes),
           "passthrough_targets": [len(p.item.op.targets) for p in passes],
           "launches": launches, "stage_launches": stage_launches,
           **{k: v for k, v in errs.items()}, "scale": scale, "norm": norm}
    if not (all(e <= PATH_TOL * scale for e in errs.values())
            and abs(1.0 - norm) <= PATH_TOL and len(passes) >= 3
            and torch.isfinite(amps).all().item()):
        raise AssertionError(f"wide_gates: {rec}")
    rec["fused_median_ms"] = time_ms(torch, lambda: fused(amps), 5)
    rec["fused_bound_ms"], rec["fused_bound_by"] = program_bound(fused)
    rec["banded_median_ms"] = ms["compiled_banded"]
    rec["pergate_median_ms"] = ms["compiled"]
    rec["banded_bound"] = bounds["compiled_banded"]
    rec["pergate_bound"] = bounds["compiled"]
    emit_card(rec)
    del fused, amps, outs
    torch.cuda.empty_cache()
    return rec


def small_circuits():
    """(name, circuit): the tutorial on 3 qubits, and random 5- and
    9-qubit circuits (the 9-qubit one with a 5-target Haar unitary)."""
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import haar_unitary, tutorial_circuit
    wide = random_circuit(9, 6, seed=9, entangler="cnot")
    wide.gate(haar_unitary(5, np.random.default_rng(9)), (0, 2, 4, 6, 8))
    return [("tutorial", tutorial_circuit()),
            ("rcs5", random_circuit(5, 6, seed=5)), ("rcs9", wide)]


def phase_small_registers(torch):
    """Registers below the kernel's 10 qubits: small_circuits() through
    compiled_fused (the banded fallback) on the card and on the CPU, at
    f32 (2e-5 x max|amp|) and f64 (1e-12); the tutorial's prob |111>
    and prob(qubit 2 = 1) from the planes within 1e-6 of the reference
    binary's; ms per step on the card."""
    from quest_tpu_torch.state import create_qureg
    recs = []
    for name, c in small_circuits():
        n = c.num_qubits
        for dt in (np.complex64, np.complex128):
            fn = c.compiled_fused(n, device="cuda")
            q = create_qureg(n, dtype=dt, device="cuda")
            uncounted_call(torch, f"small {name}", fn, q.amps)
            cpu = c.apply_fused(create_qureg(n, dtype=dt, device="cpu"))
            got = q.amps.cpu()
            err = (got - cpu.amps).abs().max().item()
            scale = cpu.amps.abs().max().item()
            rdt = str(q.amps.dtype).replace("torch.", "")
            rec = {"phase": "small_registers", "circuit": name, "n": n,
                   "dtype": rdt, "engine": fn.kind, "max_abs_err": err,
                   "rel_err": err / scale, "norm": norm_of(got)}
            ok = (err <= SMALL_TOL[rdt] * scale
                  and abs(1.0 - rec["norm"]) <= PATH_TOL)
            if name == "tutorial":
                probs = (got.double() ** 2).sum(0)
                rec["prob_111"] = probs[7].item()
                rec["prob_q2"] = probs[4:].sum().item()
                ok = ok and all(abs(v - w) <= TUTORIAL_TOL for v, w in zip(
                    (rec["prob_111"], rec["prob_q2"]), TUTORIAL_PROBS))
            if not ok:
                raise AssertionError(f"small_registers: {rec}")
            x = q.amps.clone()
            rec["median_ms"] = time_ms(torch, lambda: fn(x), 5)
            emit_card(rec)
            recs.append(rec)
    return recs


def phase_batched_banded(torch):
    """batched_entry()'s call (24q x 64 states, f32) through
    compiled_batched(engine='banded'), against the fused batched call
    within 1e-4 x max|amp|; then 16 of the states at f64 through the
    batched engine (its f64 route), against the f32 result; ms per
    call."""
    from quest_tpu_torch.entry import batched_entry, flagship_circuit
    fn, (amps,) = batched_entry()
    n, batch = fn.n, amps.shape[0]
    banded = flagship_circuit(n).compiled_batched(batch, engine="banded",
                                                  device="cuda")
    x = amps.clone()
    x64 = amps[:16].double()
    fn(amps)
    uncounted_call(torch, "batched_banded", banded, x)
    scale = amps.abs().max().item()
    err = max(plane_err(x[i], amps[i]) for i in range(batch))
    uncounted_call(torch, "batched_banded f64", fn, x64)
    err64 = max(plane_err(x64[i], amps[i]) for i in range(16))
    norms = x64.pow(2).sum(dim=(1, 2, 3))
    rec = {"phase": "batched_banded", "n": n, "batch": batch,
           "items": len(banded.items), "max_abs_err": err,
           "rel_err": err / scale, "f64_states": 16,
           "f64_max_abs_err_vs_f32": err64,
           "f64_max_norm_err": (1.0 - norms).abs().max().item()}
    if not (err <= PATH_TOL * scale and err64 <= PATH_TOL * scale
            and rec["f64_max_norm_err"] <= PATH_TOL
            and torch.isfinite(x).all().item()):
        raise AssertionError(f"batched_banded: {rec}")
    rec["ms_per_call"] = time_ms(torch, lambda: banded(x), 3)
    rec["fused_ms_per_call"] = time_ms(torch, lambda: fn(amps), 3)
    rec["f64_ms_per_call"] = time_ms(torch, lambda: fn(x64), 3)
    rec.update(engine_bound(banded, 4, batch))
    rec["f64_bound"] = engine_bound(fn, 8, 16)
    emit_card(rec)
    del fn, banded, amps, x, x64
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def born_record(T, seen):
    """Record every Born-probability array the trajectory programs
    compute: seen[channel index] = (B, m) f64 on the host."""
    orig = T._Channel.born_probs

    def spy(self, planes, n):
        ps = orig(self, planes, n)
        seen[self.index] = ps.cpu()
        return ps
    T._Channel.born_probs = spy
    try:
        yield seen
    finally:
        T._Channel.born_probs = orig


def near_boundary(prog, u, seen) -> "np.ndarray":
    """(shots,) bool: a shot's uniform for some channel lies within
    BOUNDARY_EPS of a branch boundary (inner cumulative probability)."""
    u = u.cpu().numpy()
    near = np.zeros(u.shape[0], dtype=bool)
    for ch in prog.channels:
        p = (ch.probs.cpu().numpy()[None, :] if ch.probs is not None
             else seen[ch.index].numpy())
        cum = np.cumsum(np.clip(p, 0, None), axis=-1)
        cum = cum[:, :-1] / cum[:, -1:]
        near |= (np.abs(u[:, [ch.index]] - cum) < BOUNDARY_EPS).any(-1)
    return near


def phase_trajectories_banded(torch):
    """The banded trajectory program: (1) 1024 shots of noisy RCS d3 at
    9 qubits through the default engine (banded below the kernel tier),
    <Z_q> within 5 sigma of the f64 density path; (2) engine='banded'
    against 'fused' at 14 qubits from one generator state: draws equal
    wherever no uniform lies within 1e-5 of a branch boundary, equal-draw
    shots' planes within 1e-4 x max|amp|; ms per run."""
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.entry import noisy_rcs_circuit
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    nd = TRAJ_SMALL_QUBITS
    circ = noisy_rcs_circuit(nd, 3)
    dens = circ.compiled_fused(2 * nd, density=True, device="cuda")
    rho = basis_planes(0, n=2 * nd, rdt=np.float64,
                       shape=fused_state_shape(2 * nd), device="cuda")
    uncounted_call(torch, "trajectories_banded density", dens, rho)
    diag = rho.reshape(2, -1)[0, ::(1 << nd) + 1]
    idx = torch.arange(1 << nd, device=diag.device)
    exact = torch.stack([(diag * (1 - 2 * ((idx >> q) & 1))).sum()
                         for q in range(nd)])
    if T._resolve_engine(None, nd) != "banded":
        raise AssertionError("trajectories_banded: default engine not banded")
    t0 = time.perf_counter()
    vals, draws = T.run_batched(circ, PHYSICS_SHOTS,
                                generator=torch.Generator().manual_seed(2),
                                observable=z_all, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = vals.double()
    mean, sigma = vals.mean(0), vals.std(0) / PHYSICS_SHOTS ** 0.5
    dev_sig = ((mean - exact).abs() / sigma.clamp_min(1e-12)).max().item()
    physics = {"phase": "trajectories_banded", "part": "physics", "n": nd,
               "shots": PHYSICS_SHOTS, "wall_s": wall,
               "shots_per_s": PHYSICS_SHOTS / wall, "max_sigmas": dev_sig,
               "z_exact": exact.cpu().tolist(), "z_mean": mean.cpu().tolist()}
    emit_card(physics)
    if not dev_sig <= PHYSICS_SIGMAS:
        raise AssertionError(f"trajectories_banded: <Z_q> off the f64 "
                             f"density path by {dev_sig} sigma")

    n, shots = TRAJ_BANDED_QUBITS, TRAJ_BANDED_SHOTS
    circ = noisy_rcs_circuit(n, 3)
    runs, seen = {}, {}
    for engine in ("banded", "fused"):
        seen[engine] = {}
        with born_record(T, seen[engine]):
            t0 = time.perf_counter()
            planes, draws = T.run_batched(
                circ, shots, generator=torch.Generator().manual_seed(5),
                engine=engine, device="cuda")
            torch.cuda.synchronize()
        runs[engine] = (planes, draws, time.perf_counter() - t0)
    prog = T._compiled_traj(circ, n, "cuda", "banded")
    u = torch.rand((shots, prog.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(5))
    near = (near_boundary(prog, u, seen["banded"])
            | near_boundary(prog, u, seen["fused"]))
    (pb, db, wb), (pf, df, wf) = runs["banded"], runs["fused"]
    same = (db == df).all(dim=1).cpu().numpy()
    err = max([plane_err(pb[s], pf[s]) for s in np.flatnonzero(same)] or [0])
    scale = pf.abs().max().item()
    rec = {"phase": "trajectories_banded", "part": "banded_vs_fused",
           "n": n, "shots": shots, "channels": prog.num_channels,
           "equal_draw_shots": int(same.sum()),
           "near_boundary_shots": int(near.sum()),
           "max_abs_err": err, "rel_err": err / scale,
           "banded_wall_s": wb, "fused_wall_s": wf,
           "banded_shots_per_s": shots / wb, "fused_shots_per_s": shots / wf}
    emit_card(rec)
    if not ((same | near).all() and same.sum() > 0
            and err <= PATH_TOL * scale):
        raise AssertionError(f"trajectories_banded: {rec}")
    del runs, pb, pf
    torch.cuda.empty_cache()
    return physics, rec


DRIVER_CONFIGS = {"K1": ("decoupled", 3), "K2/2": ("inplace", 2),
                  "K2/3": ("inplace", 3), "K3": ("grid", 3)}
DRIVER_KNOBS = ("QUEST_FUSED_DRIVER", "QUEST_FUSED_PIPELINE",
                "QUEST_FUSED_NBUF")
DRIVER_REPLACES = {"decoupled": "quest_tpu/ops/pallas_band.py:1715",
                   "inplace": "quest_tpu/ops/pallas_band.py:1628",
                   "grid": "quest_tpu/ops/pallas_band.py:1553"}
K1_RUNS = 2
PROBE_TIMEOUT_S = 120
SANITIZE_TIMEOUT_S = 240
SANITIZE_QUBITS = 17
SANITIZE_UP = "sanitize_case: device up"
SANITIZE_DONE = "sanitize_case: every driver launched"


# ---------------------------------------------------------------------------
# PR 11: the QuEST user surface on the card (no kernel is added: these
# phases drive the program cache, measurement, sampling, dynamic circuits,
# calculations and the eager API, the states coming from the paths above)
# ---------------------------------------------------------------------------

SURFACE_TOL = 1e-6            # measurement and eager checks
CALC_TOL = 1e-5               # calculations against f64 recomputations
SAMPLE_PEAK_GIB = 18.0
GIB = float(1 << 30)


def host_ms(torch, fn):
    """Wall ms of fn() on the host, the device synchronised after it."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


@contextlib.contextmanager
def plan_counter():
    """Count Circuit.fused_plan calls (the fused engine's planner)."""
    from quest_tpu_torch.circuit import Circuit
    orig = Circuit.fused_plan
    calls = [0]

    def counted(self, *a, **k):
        calls[0] += 1
        return orig(self, *a, **k)
    Circuit.fused_plan = counted
    try:
        yield calls
    finally:
        Circuit.fused_plan = orig


def phase_program_cache(torch):
    """The program cache: apply_fused of the flagship (28q RCS d4) 5
    times plans once (fused_plan counted) and launches its 9 segments per
    call; a flip of the tier (set_matmul_precision('high')) plans once
    more and its step is within the tier's envelope of HIGHEST; then
    apply_batched of the 24q x 64 step the same way (3 calls, one plan;
    4 of its states at HIGH against HIGHEST). First-call and cached-call
    host ms (wall, synchronised)."""
    from quest_tpu_torch import precision as P
    from quest_tpu_torch.entry import (BATCHED_QUBITS, BATCHED_STATES,
                                       flagship_circuit, random_states)
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape
    rec = {"phase": "program_cache"}
    n = 28
    c = flagship_circuit(n)
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    q = Qureg(amps=amps, num_qubits=n)
    calls_ms = []
    with plan_counter() as plans:
        for _ in range(5):
            S.segment_sweep.launches = 0
            ms, _ = host_ms(torch, lambda: c.apply_fused(q))
            calls_ms.append(ms)
            prog = c.compiled_fused(n)
            if S.segment_sweep.launches != prog.launches_per_call:
                raise AssertionError(
                    f"program_cache: {S.segment_sweep.launches} launches "
                    f"for {prog.launches_per_call} segments")
        if plans[0] != 1:
            raise AssertionError(f"program_cache: {plans[0]} plans for 5 "
                                 f"apply_fused calls")
        rec["flagship_plans"] = plans[0]
        top = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
        prog(top)
        with session_tier("high"):
            x = basis_planes(0, n=n, shape=fused_state_shape(n),
                             device="cuda")
            ms_high, _ = host_ms(torch, lambda: c.apply_fused(
                Qureg(amps=x, num_qubits=n)))
            high = c.compiled_fused(n)
        if plans[0] != 2 or high.tier != "high" or high is prog:
            raise AssertionError(f"program_cache: tier flip made "
                                 f"{plans[0] - 1} plans, tier {high.tier}")
        if c.compiled_fused(n) is not prog or P.matmul_precision() != "highest":
            raise AssertionError("program_cache: the HIGHEST program was "
                                 "not found again")
        scale = top.abs().max().item()
        dist = plane_err(x, top) / scale
        plain = high.plain(basis_planes(0, n=n, shape=fused_state_shape(n),
                                        device="cuda"))
        gate, source = envelope("high", plane_err(plain, top) / scale)
        ngate, _ = envelope("high", abs(1.0 - norm_of(plain)))
        del plain
        drift = abs(1.0 - norm_of(x))
        if not (0.0 < dist <= gate and drift <= ngate):
            raise AssertionError(f"program_cache: HIGH step {dist} from "
                                 f"HIGHEST (gate {gate}), norm drift {drift} "
                                 f"(gate {ngate})")
        rec.update(flagship_first_call_ms=calls_ms[0],
                   flagship_cached_call_ms=statistics.median(calls_ms[1:]),
                   flagship_calls_ms=calls_ms,
                   high_first_call_ms=ms_high, high_rel_vs_highest=dist,
                   high_envelope=gate, high_envelope_from=source,
                   high_norm_drift=drift, high_norm_envelope=ngate)
        del amps, q, x, top, prog, high
        torch.cuda.empty_cache()
        nb, batch = BATCHED_QUBITS, BATCHED_STATES
        cb = flagship_circuit(nb)
        states = random_states(batch, nb, device="cuda")
        sub = states[:4].clone()
        plans[0] = 0
        bms = [host_ms(torch, lambda: cb.apply_batched(states))[0]
               for _ in range(3)]
        if plans[0] != 1:
            raise AssertionError(f"program_cache: {plans[0]} plans for 3 "
                                 f"apply_batched calls")
        ref = sub.clone()
        cb.apply_batched(ref)
        with session_tier("high"):
            cb.apply_batched(sub)
        if plans[0] != 2:
            raise AssertionError("program_cache: the batched tier flip did "
                                 "not plan anew")
        bscale = ref.abs().max().item()
        bdist = plane_err(sub, ref) / bscale
        if not 0.0 < bdist <= max(TIER_TOL["high"], gate):
            raise AssertionError(f"program_cache: batched HIGH {bdist} from "
                                 f"HIGHEST")
        rec.update(batched_first_call_ms=bms[0],
                   batched_cached_call_ms=statistics.median(bms[1:]),
                   batched_plans=1, batched_high_rel_vs_highest=bdist)
    emit_card(rec)
    del states, sub, ref
    torch.cuda.empty_cache()
    return rec


def marginals_f64(torch, planes, n: int):
    """P(qubit = 1) of every qubit of (2, 2^n) planes in one f64 pass,
    2^24 amplitudes at a time (independent of the port's reductions)."""
    flat = planes.reshape(2, -1)
    chunk = 1 << min(24, n)
    ones = torch.zeros(n, dtype=torch.float64, device=flat.device)
    for s in range(0, 1 << n, chunk):
        p = flat[0, s:s + chunk].double() ** 2 + flat[1, s:s + chunk].double() ** 2
        for q in range(min(24, n)):
            ones[q] += p.view(-1, 2, 1 << q)[:, 1].sum()
        hi = p.sum()
        for q in range(24, n):
            if (s >> q) & 1:
                ones[q] += hi
    return ones.cpu().numpy()


def phase_measurement(torch):
    """The 30q d20 state (8 GiB): calc_prob_of_outcome of every qubit
    against one f64 pass computing all 30 marginals (1e-6); sample of
    2^20 shots, each qubit's frequency within 5 sigma of its marginal,
    peak memory <= 18 GiB; measure_with_stats (seeded host stream) and
    collapse_to_outcome: norm within 1e-5 of 1, the measured qubit's
    other outcome at probability <= 1e-6. ms of each, bytes bounds."""
    from quest_tpu_torch import measurement as TM
    from quest_tpu_torch import random_
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape
    n, depth, shots = 30, 20, 1 << 20
    fn = random_circuit(n, depth, seed=7, entangler="cz").compiled_fused(
        n, device="cuda")
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    fn(amps)
    del fn
    torch.cuda.empty_cache()
    q = Qureg(amps=amps, num_qubits=n)
    want = marginals_f64(torch, amps, n)
    got = np.array([TM.calc_prob_of_outcome(q, k, 1) for k in range(n)])
    err = float(np.abs(got - want).max())
    if not err <= SURFACE_TOL:
        raise AssertionError(f"measurement: marginals off by {err}")
    prob_ms = statistics.median(
        time_ms(torch, lambda k=k: TM.calc_prob_of_outcome(q, k, 1), 3)
        for k in (0, n // 2, n - 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sample_ms, samples = host_ms(torch, lambda: TM.sample(
        q, shots, torch.Generator(device="cuda").manual_seed(11)))
    peak = torch.cuda.max_memory_allocated() / GIB
    freq = np.array([((samples >> k) & 1).double().mean().item()
                     for k in range(n)])
    sigma = np.sqrt(want * (1 - want) / shots)
    zmax = float((np.abs(freq - want) / np.maximum(sigma, 1e-12)).max())
    if not (zmax <= PHYSICS_SIGMAS and peak <= SAMPLE_PEAK_GIB
            and samples.device.type == "cuda"):
        raise AssertionError(f"measurement: sample z {zmax}, peak "
                             f"{peak} GiB")
    del samples
    torch.cuda.empty_cache()
    spare = torch.Generator(device="cuda").manual_seed(12)
    warm_ms = time_ms(torch, lambda: TM.sample(q, shots, spare), 3)
    torch.cuda.empty_cache()
    random_.seed_quest([2026, 11])
    mws_ms, (_, outcome, mprob) = host_ms(
        torch, lambda: TM.measure_with_stats(q, 5))
    norm1 = norm_of(amps)
    other1 = TM.calc_prob_of_outcome(q, 5, 1 - outcome)
    kept = (2 * n) // 3
    col_ms, (_, cprob) = host_ms(torch, lambda: TM.collapse_to_outcome(
        q, kept, 0))
    norm2 = norm_of(amps)
    other2 = TM.calc_prob_of_outcome(q, kept, 1)
    if not (abs(1 - norm1) <= CALC_TOL and abs(1 - norm2) <= CALC_TOL
            and other1 <= SURFACE_TOL and other2 <= SURFACE_TOL
            and abs(mprob - (want[5] if outcome else 1 - want[5])) <= 1e-6
            and torch.isfinite(amps).all().item()):
        raise AssertionError(f"measurement: norms {norm1} {norm2}, other "
                             f"outcomes {other1} {other2}")
    state_bytes = 2 * 4 * (1 << n)
    rec = {"phase": "measurement", "n": n, "depth": depth,
           "marginal_max_err": err, "calc_prob_ms": prob_ms,
           "calc_prob_bound_ms": 1e3 * (state_bytes / 2) / HBM_BYTES_PER_S,
           "sample_shots": shots, "sample_first_ms": sample_ms,
           "sample_ms": warm_ms,
           "sample_bound_ms": 1e3 * (state_bytes + 3 * 4 * (1 << n))
           / HBM_BYTES_PER_S,
           "sample_peak_gib": peak, "sample_base_gib": base / GIB,
           "sample_max_z": zmax, "measure_with_stats_ms": mws_ms,
           "measured_outcome": outcome, "collapse_ms": col_ms,
           "collapse_prob": cprob, "norm_after": [norm1, norm2],
           "other_outcome_prob": [other1, other2]}
    emit_card(rec)
    del q, amps
    torch.cuda.empty_cache()
    return rec


def xeb_f64(torch, planes, samples, n: int) -> float:
    """2^n <p(s)> - 1 recomputed in f64 from the planes and samples."""
    flat = planes.reshape(2, -1)
    re, im = flat[0][samples].double(), flat[1][samples].double()
    return float((1 << n) * (re * re + im * im).mean() - 1.0)


def phase_xeb(torch):
    """entry.xeb_entry(): the flagship step (28q RCS d4), 2^20 samples and
    the linear XEB, against an f64 recomputation from the same samples
    and state (1e-4); ms of the step, the sampling and the XEB."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch import measurement as TM
    from quest_tpu_torch.entry import xeb_entry
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import Qureg
    fn, (amps, gen) = xeb_entry()
    n = fn.step.n
    S.segment_sweep.launches = 0
    step_ms = time_ms(torch, lambda: fn.step(amps), 1)
    if S.segment_sweep.launches != fn.step.launches_per_call:
        raise AssertionError("xeb: the step did not launch its segments")
    q = Qureg(amps=amps, num_qubits=n)
    sample_ms, samples = host_ms(torch, lambda: TM.sample(q, fn.shots, gen))
    xeb_ms, xeb = host_ms(torch, lambda: K.calc_linear_xeb(q, samples))
    # warm times (the first calls above load their CUDA modules)
    spare = torch.Generator().manual_seed(0)
    warm_sample_ms = time_ms(torch, lambda: TM.sample(q, fn.shots, spare), 3)
    warm_xeb_ms = time_ms(torch, lambda: K.calc_linear_xeb(q, samples), 3)
    want = xeb_f64(torch, amps, samples, n)
    # the whole entry once more, from a fresh state: the same numbers
    fn2, (amps2, gen2) = xeb_entry()
    xeb2, samples2 = fn2(amps2, gen2)
    if not (abs(xeb - want) <= PATH_TOL and np.isfinite(xeb)
            and samples.shape == (fn.shots,)
            and torch.equal(samples, samples2) and abs(xeb2 - xeb) <= 1e-12):
        raise AssertionError(f"xeb: {xeb} against f64 {want}, rerun {xeb2}")
    rec = {"phase": "xeb", "n": n, "shots": fn.shots, "xeb": xeb,
           "xeb_f64": want, "abs_err": abs(xeb - want), "step_ms": step_ms,
           "sample_first_ms": sample_ms, "xeb_first_ms": xeb_ms,
           "sample_ms": warm_sample_ms, "xeb_ms": warm_xeb_ms,
           "sample_bound_ms": 1e3 * (2 * 4 + 3 * 4) * (1 << n)
           / HBM_BYTES_PER_S}
    emit_card(rec)
    del fn, fn2, amps, amps2, q, samples, samples2
    torch.cuda.empty_cache()
    return rec


def phase_dynamic(torch):
    """entry.measured_entry(): the repetition-code cycle at 28 data
    qubits + 2 ancillas (30 qubits, 8 GiB) under engine='banded' and
    'xla' from equal generator seeds: identical outcomes, planes within
    1e-4 x max|amp|, norm within 1e-4, each reset ancilla at P(1) <=
    1e-6; ms per cycle (wall: each measurement reads its outcome on the
    host)."""
    from quest_tpu_torch import measurement as TM
    from quest_tpu_torch.entry import MEASURED_ROUNDS, measured_entry
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import Qureg
    rec = {"phase": "dynamic", "rounds": MEASURED_ROUNDS}
    results = {}
    for engine in ("banded", "xla"):
        fn, (amps, gen) = measured_entry(engine=engine)
        n = fn.n
        S.segment_sweep.launches = 0
        ms, (out, outs) = host_ms(torch, lambda: fn(amps, gen))
        if S.segment_sweep.launches:
            raise AssertionError("dynamic: a segment launch on the XLA path")
        q = Qureg(amps=out, num_qubits=n)
        resets = [TM.calc_prob_of_outcome(q, a, 1) for a in (n - 2, n - 1)]
        norm = norm_of(out)
        if not (max(resets) <= SURFACE_TOL and abs(1 - norm) <= PATH_TOL
                and out.device.type == "cuda"):
            raise AssertionError(f"dynamic {engine}: ancillas {resets}, "
                                 f"norm {norm}")
        rec[f"{engine}_ms_per_cycle"] = ms / MEASURED_ROUNDS
        rec[f"{engine}_items"] = len(fn.items)
        rec[f"{engine}_norm"] = norm
        rec[f"{engine}_reset_p1"] = resets
        results[engine] = (out, outs)
        del fn, q
    (a, oa), (b, ob) = results["banded"], results["xla"]
    scale = b.abs().max().item()
    err = plane_err(a, b)
    if not (torch.equal(oa, ob) and err <= PATH_TOL * scale):
        raise AssertionError(f"dynamic: outcomes {oa.tolist()} / "
                             f"{ob.tolist()}, max|diff| {err}")
    rec.update(n=30, outcomes=oa.tolist(), max_abs_err=err,
               rel_err=err / scale)
    emit_card(rec)
    del results, a, b
    torch.cuda.empty_cache()
    return rec


def ising_f64(torch, planes, n: int, J: float, h: float) -> float:
    """<H> of H = J sum_i Z_i Z_{i+1 mod n} + h sum_i X_i on (2, 2^n)
    planes, in f64, by direct sums (independent of ops/apply)."""
    flat = planes.reshape(2, -1)
    p = flat[0].double() ** 2 + flat[1].double() ** 2
    k = torch.arange(1 << n, device=flat.device)
    zz = 0.0
    for i in range(n):
        j = (i + 1) % n
        par = ((k >> i) ^ (k >> j)) & 1
        zz += float((p * (1 - 2 * par).double()).sum())
    del p, k
    x = 0.0
    for i in range(n):
        re = flat[0].view(-1, 2, 1 << i)
        im = flat[1].view(-1, 2, 1 << i)
        x += 2.0 * float((re[:, 0].double() * re[:, 1].double()
                          + im[:, 0].double() * im[:, 1].double()).sum())
    return J * zz + h * x


def phase_calculations(torch):
    """On the flagship state (28q): calc_inner_product and calc_fidelity
    against a second state (the flagship then an eager hadamard on qubit
    14), and a 56-term transverse-field Ising calc_expec_pauli_sum (28
    ZZ on a ring + 28 X), against f64 recomputations on the card (1e-5);
    on the density step's register (28 state qubits): purity, density
    inner product, Hilbert-Schmidt distance against the same register
    after three eager depolarising channels, and density fidelity with
    |+>^14; ms and peak memory of each."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.entry import density_entry, entry
    from quest_tpu_torch.ops import channels as CH
    from quest_tpu_torch.ops import gates as G
    from quest_tpu_torch.state import (Qureg, clone, create_qureg,
                                       init_plus_state)
    rec = {"phase": "calculations"}
    fn, (amps,) = entry()
    fn(amps)
    n = fn.n
    bra = Qureg(amps=amps, num_qubits=n)
    ket = G.hadamard(clone(bra), n // 2)

    def timed(name, call):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, val = host_ms(torch, call)
        rec[f"{name}_ms"] = ms
        rec[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        return val
    inner = timed("inner_product", lambda: K.calc_inner_product(bra, ket))
    b2, k2 = bra.amps.reshape(2, -1).double(), ket.amps.reshape(2, -1).double()
    want = complex(float((b2[0] * k2[0] + b2[1] * k2[1]).sum()),
                   float((b2[0] * k2[1] - b2[1] * k2[0]).sum()))
    del b2, k2
    fid = timed("fidelity", lambda: K.calc_fidelity(bra, ket))
    J, h = 1.0, 0.7
    codes = []
    for i in range(n):
        row = [0] * n
        row[i] = row[(i + 1) % n] = 3
        codes.append(row)
    for i in range(n):
        row = [0] * n
        row[i] = 1
        codes.append(row)
    coeffs = [J] * n + [h] * n
    energy = timed("expec_pauli_sum", lambda: K.calc_expec_pauli_sum(
        bra, codes, coeffs))
    energy_want = ising_f64(torch, bra.amps, n, J, h)
    errs = {"inner_product": abs(inner - want),
            "fidelity": abs(fid - abs(want) ** 2),
            "expec_pauli_sum": abs(energy - energy_want)}
    rec.update(inner_product=[inner.real, inner.imag], fidelity=fid,
               ising_terms=len(codes), ising_energy=energy,
               ising_energy_f64=energy_want)
    del fn, amps, bra, ket
    torch.cuda.empty_cache()
    dfn, (rho_amps,) = density_entry()
    dfn(rho_amps)
    nq = dfn.n // 2
    rho = Qureg(amps=rho_amps, num_qubits=nq, is_density=True)
    sigma = clone(rho)
    for t in (0, nq // 2, nq - 1):
        CH.mix_depolarising(sigma, t, 0.1)
    purity = timed("purity", lambda: K.calc_purity(rho))
    dip = timed("density_inner_product",
                lambda: K.calc_density_inner_product(rho, sigma))
    hs = timed("hilbert_schmidt_distance",
               lambda: K.calc_hilbert_schmidt_distance(rho, sigma))
    psi = init_plus_state(create_qureg(nq, device="cuda"))
    dfid = timed("density_fidelity", lambda: K.calc_fidelity(rho, psi))
    r, s = rho.amps.reshape(2, -1), sigma.amps.reshape(2, -1)
    purity_want = sum(float((r[p].double() ** 2).sum()) for p in range(2))
    dip_want = sum(float((r[p].double() * s[p].double()).sum())
                   for p in range(2))
    hs_want = sum(float(((r[p].double() - s[p].double()) ** 2).sum())
                  for p in range(2)) ** 0.5
    dim = 1 << nq
    m = r[0].view(dim, dim).double()          # row c holds column c of rho
    v = torch.full((dim,), dim ** -0.5, dtype=torch.float64, device="cuda")
    # <psi| rho |psi> for a real psi: sum_rc psi_r Re(rho_rc) psi_c
    dfid_want = float(v @ (m @ v))
    del m, r, s
    errs.update(purity=abs(purity - purity_want),
                density_inner_product=abs(dip - dip_want),
                hilbert_schmidt_distance=abs(hs - hs_want),
                density_fidelity=abs(dfid - dfid_want))
    rec.update(purity=purity, density_inner_product=dip,
               hilbert_schmidt_distance=hs, density_fidelity=dfid,
               abs_err=errs, density_state_qubits=dfn.n)
    if not all(e <= CALC_TOL for e in errs.values()):
        raise AssertionError(f"calculations: {errs}")
    emit_card(rec)
    del dfn, rho_amps, rho, sigma, psi
    torch.cuda.empty_cache()
    return rec


def eager_sequence(G, CH, q, density: bool):
    """~20 eager gates (and on a density register 3 channels); returns the
    same sequence as a Circuit for the per-gate engine."""
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.ops import matrices as M
    n = q.num_qubits
    c = Circuit(n)
    rng = np.random.default_rng(17)
    u2 = np.linalg.qr(rng.standard_normal((4, 4))
                      + 1j * rng.standard_normal((4, 4)))[0]
    top, mid = n - 1, n // 2
    steps = [
        (lambda: G.hadamard(q, 0), lambda: c.h(0)),
        (lambda: G.hadamard(q, top), lambda: c.h(top)),
        (lambda: G.controlled_not(q, 0, mid), lambda: c.cnot(0, mid)),
        (lambda: G.rotate_x(q, 3, 0.3), lambda: c.rx(3, 0.3)),
        (lambda: G.rotate_y(q, top, 1.2), lambda: c.ry(top, 1.2)),
        (lambda: G.rotate_z(q, mid, -0.7), lambda: c.gate(
            M.rotation(-0.7, (0.0, 0.0, 1.0)), (mid,))),
        (lambda: G.t_gate(q, 1), lambda: c.t(1)),
        (lambda: G.s_gate(q, top), lambda: c.s(top)),
        (lambda: G.pauli_y(q, 2), lambda: c.y(2)),
        (lambda: G.controlled_phase_shift(q, 1, top, 0.9),
         lambda: c.cphase(0.9, 1, top)),
        (lambda: G.multi_controlled_phase_flip(q, [0, 2, mid]),
         lambda: c._add("allones", (0, 2, mid), -1.0 + 0.0j)),
        (lambda: G.swap_gate(q, 4, top - 1), lambda: c.swap(4, top - 1)),
        (lambda: G.two_qubit_unitary(q, 5, top, u2),
         lambda: c.gate(u2, (5, top))),
        (lambda: G.multi_rotate_z(q, [0, mid, top], 0.4),
         lambda: c.multi_rotate_z((0, mid, top), 0.4)),
        (lambda: G.multi_rotate_pauli(q, [1, mid + 1, top], [1, 2, 3], 0.6),
         lambda: c.multi_rotate_pauli((1, mid + 1, top), (1, 2, 3), 0.6)),
        (lambda: G.sqrt_swap_gate(q, 2, mid), lambda: c.sqrt_swap(2, mid)),
        (lambda: G.controlled_rotate_y(q, top, 6, 0.8),
         lambda: c.gate(M.rotation(0.8, (0.0, 1.0, 0.0)), (6,), (top,))),
        (lambda: G.phase_shift(q, 7, 0.25), lambda: c.phase(7, 0.25)),
        (lambda: G.multi_controlled_unitary(q, [0, 1], mid, M.HADAMARD),
         lambda: c.gate(M.HADAMARD, (mid,), (0, 1))),
        (lambda: G.pauli_x(q, top), lambda: c.x(top)),
    ]
    if density:
        steps += [
            (lambda: CH.mix_depolarising(q, 0, 0.1),
             lambda: c.depolarising(0, 0.1)),
            (lambda: CH.mix_dephasing(q, mid, 0.2),
             lambda: c.dephasing(mid, 0.2)),
            (lambda: CH.mix_damping(q, top, 0.3),
             lambda: c.damping(top, 0.3)),
        ]
    for eager, build in steps:
        eager()
        build()
    return c, len(steps)


def phase_eager(torch):
    """The eager API on the card: the tutorial circuit (tests/test_api.py)
    through ops.gates — prob |111> = 0.112422, prob(qubit 2 = 1) =
    0.749178 within 2e-6; a 20-gate eager sequence on 28 qubits and the
    same gates with 3 channels on a 12-qubit density register, each
    against the same circuit's per-gate compiled program on the card
    within 1e-6 x max|amp|; ms of each eager sequence."""
    from quest_tpu_torch import measurement as TM
    from quest_tpu_torch.ops import channels as CH
    from quest_tpu_torch.ops import gates as G
    from quest_tpu_torch.state import (create_density_qureg, create_qureg,
                                       get_prob_amp)
    rec = {"phase": "eager"}
    q = create_qureg(3, device="cuda")
    G.hadamard(q, 0)
    G.controlled_not(q, 0, 1)
    G.rotate_y(q, 2, 0.1)
    G.multi_controlled_phase_flip(q, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    G.unitary(q, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    G.compact_unitary(q, 1, a, b)
    G.rotate_around_axis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    G.controlled_compact_unitary(q, 0, 1, a, b)
    G.multi_controlled_unitary(q, [0, 1], 2, u)
    toff = np.eye(8, dtype=complex)[[0, 1, 2, 3, 4, 5, 7, 6]]
    G.multi_qubit_unitary(q, [0, 1, 2], toff)
    p111, p2 = get_prob_amp(q, 7), TM.calc_prob_of_outcome(q, 2, 1)
    if not (abs(p111 - 0.112422) <= 2e-6 and abs(p2 - 0.749178) <= 2e-6
            and q.amps.device.type == "cuda"):
        raise AssertionError(f"eager: tutorial {p111}, {p2}")
    rec.update(tutorial_prob_111=p111, tutorial_prob_q2=p2)
    for name, make, nq, density in (
            ("sv28", create_qureg, 28, False),
            ("dm12", create_density_qureg, 12, True)):
        q = make(nq, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, count = eager_sequence(G, CH, q, density)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = make(nq, device="cuda")
        c.compiled(ref.num_state_qubits, density)(ref.amps)
        torch.cuda.synchronize()
        scale = ref.amps.abs().max().item()
        err = plane_err(q.amps, ref.amps)
        if not (err <= SURFACE_TOL * scale
                and torch.isfinite(q.amps).all().item()):
            raise AssertionError(f"eager {name}: max|diff| {err} against "
                                 f"the per-gate program (max|amp| {scale})")
        rec[name] = {"ops": count, "ms": ms, "max_abs_err": err,
                     "rel_err": err / scale}
        del q, ref, c
        torch.cuda.empty_cache()
    emit_card(rec)
    return rec


# ---------------------------------------------------------------------------
# the Hamiltonian layers (PR 12; no kernel is added): expectation,
# evolution, variational energies, adjoint gradients
# ---------------------------------------------------------------------------

CARD = "cuda"                 # the device of the Hamiltonian phases
HAM_QUBITS = 30               # TFIM-30 and the random-support sum: 8 GiB
HAM_STATE_DEPTH = 4           # the random circuit that makes the state
RANDOM_SUM_TERMS = 100
HAM_DENSITY_QUBITS = 14       # density_entry's register: 28 state qubits
EXPEC_REL_TOL = 1e-5          # relative to max(|E|, 1)
EVOLUTION_STEPS = 4
IMAG_QUBITS = 26
IMAG_STEPS = 8
IMAG_TOL = 1e-5
VAR_QUBITS = 20
VAR_LAYERS = 2
VAR_SEED = 17
SHIFT_TOL = 1e-4
SWEEP_QUBITS = 16
SWEEP_SETS = 32
SWEEP_TOL = 1e-6
ADJ_QUBITS = 30
ADJ_SHIFT_PARAMS = (0, ADJ_QUBITS)    # the first ry and the first rz
ADJ_SHIFT_TOL = 1e-3
ADJ_SMALL_QUBITS = 20
ADJ_VALUE_TOL = 1e-5
ADJ_GRAD_TOL = 1e-4
ADJ_DENSITY_QUBITS = 10       # 20 state qubits
ADJ_DENSITY_TOL = 1e-5


def _sync(torch) -> None:
    if CARD == "cuda":
        torch.cuda.synchronize()


def _reset_peak(torch) -> int:
    """Reset the card's peak-memory counter; returns the bytes allocated
    now (the base a phase's peak is read above)."""
    if CARD != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_gib(torch, base: int) -> float:
    """GiB allocated at the peak since _reset_peak, above `base`."""
    if CARD != "cuda":
        return 0.0
    return (torch.cuda.max_memory_allocated() - base) / GIB


def _wall(torch, fn):
    """(wall ms, fn()) with the device synchronised around the call."""
    _sync(torch)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch)
    return (time.perf_counter() - t0) * 1e3, out


def _free(torch) -> None:
    if CARD == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def env_knob(name: str, value: str):
    """Set one QUEST_* knob inside the block, then restore it."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _parity_fold(torch, p):
    """p & 1 after folding the parity of p's low 32 bits into bit 0."""
    for s in (16, 8, 4, 2, 1):
        p = p ^ (p >> s)
    return p & 1


def _sign_table(mask: int, bits: int) -> np.ndarray:
    """(-1)^popcount(v & mask) for v < 2^bits, f64."""
    v = np.arange(1 << bits)
    par = np.zeros(1 << bits, dtype=np.int64)
    for b in range(bits):
        if (mask >> b) & 1:
            par ^= (v >> b) & 1
    return 1.0 - 2.0 * par


def pauli_sum_f64(torch, planes, n: int, codes, coeffs,
                  chunk_bits: int = 24) -> float:
    """sum_t c_t <P_t> of (2, 2^n) planes in f64 by direct sums, chunk by
    chunk: each mask's flipped read a gather at j ^ x, each term's sign
    the parity of j & zy as the outer product of the sign tables of j's
    low and high half-bits, contracted with the chunk's f64 product
    plane viewed as a matrix (two matrix-vector products), times the
    parity of the bits above the chunk (independent of ops/expec and
    ops/apply)."""
    flat = planes.reshape(2, -1)
    C = min(n, chunk_bits)
    h = C // 2
    dev = flat.device
    idx = torch.arange(1 << C, device=dev)
    groups = {}
    for row, c in zip(codes, coeffs):
        x = sum(1 << q for q, p in enumerate(row) if p in (1, 2))
        zy = sum(1 << q for q, p in enumerate(row) if p in (2, 3))
        ny = sum(1 for p in row if p == 2)
        lo = torch.as_tensor(_sign_table(zy, h), device=dev)
        hi = torch.as_tensor(_sign_table(zy >> h, C - h), device=dev)
        groups.setdefault(x, []).append((zy, ny, float(c), lo, hi))
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for c0 in range(0, 1 << n, 1 << C):
        ar = flat[0, c0:c0 + (1 << C)].double()
        ai = flat[1, c0:c0 + (1 << C)].double()
        for x, terms in groups.items():
            part = (idx + c0) ^ x
            br, bi = flat[0][part].double(), flat[1][part].double()
            planes_of = {0: (ar * br + ai * bi).view(1 << (C - h), 1 << h)}
            if any(ny % 2 for _, ny, _, _, _ in terms):
                planes_of[1] = (ar * bi - ai * br).view(1 << (C - h), 1 << h)
            for zy, ny, c, lo, hi in terms:
                sign = (1.0, 1.0, -1.0, -1.0)[ny % 4]
                if bin(c0 & zy).count("1") & 1:
                    sign = -sign
                total += (c * sign) * (hi @ (planes_of[ny % 2] @ lo))
            del planes_of, br, bi, part
    return float(total)


def pauli_trace_f64(torch, planes, N: int, codes, coeffs) -> float:
    """Re sum_t c_t Tr(P_t rho) of a density register's planes in f64:
    each term's 2^N entries rho[k, k ^ x] gathered and signed by the
    parity of k & zy (independent of ops/expec)."""
    flat = planes.reshape(2, -1)
    k = torch.arange(1 << N, device=flat.device)
    total = 0.0
    for row, c in zip(codes, coeffs):
        x = sum(1 << q for q, p in enumerate(row) if p in (1, 2))
        zy = sum(1 << q for q, p in enumerate(row) if p in (2, 3))
        ny = sum(1 for p in row if p == 2)
        at = k + (k ^ x) * (1 << N)
        r, m = flat[0][at].double(), flat[1][at].double()
        part = (r, -m, -r, m)[ny % 4]
        odd = _parity_fold(torch, k & zy).bool()
        total += float(c) * float(torch.where(odd, -part, part).sum())
    return total


def _expec_rows(torch, q, codes, coeffs, want, state_bytes):
    """calc_expec_pauli_sum under QUEST_EXPEC_FUSION=1 (grouped) and 0
    (per term): sweeps, ms, peak memory and the byte bound of each, held
    to `want` within EXPEC_REL_TOL x max(|want|, 1)."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.ops import expec as E
    rows = {}
    nq = q.num_qubits
    for name, fusion in (("grouped", "1"), ("per_term", "0")):
        with env_knob("QUEST_EXPEC_FUSION", fusion):
            stats = E.plan_stats(codes, nq, density=q.is_density)
            base = _reset_peak(torch)
            ms, val = _wall(torch, lambda: K.calc_expec_pauli_sum(
                q, codes, coeffs))
        err = abs(val - want)
        sweeps = stats["expec_hbm_sweeps"]
        rows[name] = {"value": val, "abs_err": err, "sweeps": sweeps,
                      "ms": ms, "peak_gib": _peak_gib(torch, base),
                      "bound_ms": sweeps * state_bytes / HBM_BYTES_PER_S
                      * 1e3}
        if not err <= EXPEC_REL_TOL * max(abs(want), 1.0):
            raise AssertionError(f"expec {name}: {val} against the f64 "
                                 f"recomputation {want}")
    rows["groups"] = stats["expec_groups"]
    return rows


def phase_expec(torch):
    """The grouped engine on a 30-qubit state (random circuit depth 4,
    seed 7, through the fused engine; 8 GiB planes): TFIM-30 (60 terms)
    and the bench's 100-term random-support sum, grouped
    (QUEST_EXPEC_FUSION=1) and per term (0), each against an f64
    recomputation on the card (pauli_sum_f64) within 1e-5 x max(|E|, 1);
    TFIM-14 on density_entry's register (28 state qubits) the same way
    (pauli_trace_f64); apply_pauli_sum of TFIM-30, its <psi|H psi>
    against the f64 energy. Sweeps (plan_stats), ms, peak memory above
    the state and the byte bound (sweeps x the planes' bytes over 3.35
    TB/s) of each."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import (density_entry, random_support_sum,
                                       tfim_sum)
    from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape
    t0 = time.perf_counter()
    n = HAM_QUBITS
    rec = {"phase": "expec", "n": n}
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=CARD)
    random_circuit(n, HAM_STATE_DEPTH, seed=7, entangler="cz").compiled_fused(
        n, device=CARD)(amps)
    q = Qureg(amps=amps, num_qubits=n)
    state_bytes = 2 * 4 * (1 << n)
    for name, (codes, coeffs) in (
            ("tfim", tfim_sum(n)),
            ("random_support", random_support_sum(n, RANDOM_SUM_TERMS))):
        want = pauli_sum_f64(torch, amps, n, codes, coeffs)
        rec[name] = dict(terms=len(codes), f64=want,
                         **_expec_rows(torch, q, codes, coeffs, want,
                                       state_bytes))
    codes, coeffs = tfim_sum(n)
    base = _reset_peak(torch)
    ms, out = _wall(torch, lambda: K.apply_pauli_sum(q, codes, coeffs))
    peak = _peak_gib(torch, base)
    hpsi = K.calc_inner_product(q, out)
    want = rec["tfim"]["f64"]
    rec["apply_pauli_sum"] = {
        "ms": ms, "peak_gib": peak, "psi_h_psi": [hpsi.real, hpsi.imag],
        "bound_ms": 2 * rec["tfim"]["groups"] * state_bytes
        / HBM_BYTES_PER_S * 1e3}
    if not (abs(hpsi.real - want) <= EXPEC_REL_TOL * max(abs(want), 1.0)
            and abs(hpsi.imag) <= EXPEC_REL_TOL * max(abs(want), 1.0)):
        raise AssertionError(f"apply_pauli_sum: <psi|H psi> {hpsi} against "
                             f"{want}")
    del out, amps, q
    _free(torch)
    dfn, (rho,) = density_entry(CARD, num_qubits=HAM_DENSITY_QUBITS)
    dfn(rho)
    nd = HAM_DENSITY_QUBITS
    codes, coeffs = tfim_sum(nd)
    want = pauli_trace_f64(torch, rho, nd, codes, coeffs)
    rec["density_tfim"] = dict(
        state_qubits=2 * nd, terms=len(codes), f64=want,
        **_expec_rows(torch, Qureg(amps=rho, num_qubits=nd, is_density=True),
                      codes, coeffs, want, 2 * 4 * (1 << nd)))
    del dfn, rho
    _free(torch)
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


def _stage_mix(prog):
    """Stage kinds of each launch of a fused program, in order."""
    mix = []
    for seg in prog.segments:
        kinds = {}
        for st in seg.stages:
            label = getattr(st, "kind", None) or type(st).__name__
            kinds[label] = kinds.get(label, 0) + 1
        mix.append(kinds)
    return mix


def _state_err(a, b) -> float:
    return plane_err(a.reshape(2, -1), b.reshape(2, -1))


def phase_evolution(torch):
    """entry.evolution_entry() at 30 qubits: the TFIM quench, order 2, dt
    0.05, 4 steps, the energy after each step, through run_evolution's
    default engine (fused: K1 launches of the pooled step), the launch
    counters set to 0 just before and read just after (every launch K1,
    as many as the program plans); the same quench through
    engine='banded': final planes within 1e-4 x max|amp| and energies
    within 1e-5 relative; one step under QUEST_TROTTER_FUSION=0 (the
    legacy per-term eager path) against one fused step, the same
    tolerances; imaginary time at 26 qubits from |+>, 8 steps: the
    energy never rises by more than 1e-5 relative, the norm within 1e-5
    of 1. ms per step of each engine (the step program alone, and the
    run with its energies), K1 launches per step, the stage mix of each
    launch, the byte bound per step (launches and passthroughs x the
    planes read and written once) and the step's bound (bytes against
    the matrix stages' operations, program_bound)."""
    from quest_tpu_torch import evolution as EV
    from quest_tpu_torch.entry import (EVOLUTION_DT, evolution_entry,
                                       tfim_sum)
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import create_qureg, init_plus_state
    t0 = time.perf_counter()
    n = HAM_QUBITS
    steps = EVOLUTION_STEPS
    state_bytes = 2 * 4 * (1 << n)
    rec = {"phase": "evolution", "n": n, "steps": steps, "dt": EVOLUTION_DT}
    fn, (q,) = evolution_entry(CARD, num_qubits=n, steps=steps)
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    S.segment_sweep.driver_launches = {}
    ms, fused = _wall(torch, lambda: fn(q))
    launches = S.segment_sweep.launches
    drivers = dict(S.segment_sweep.driver_launches)
    stage_launches = dict(S.segment_sweep.stage_launches)
    if CARD == "cuda" and (fused.stats["engine"] != "fused"
                           or launches != fused.stats["launches"]
                           or not launches
                           or drivers != {"decoupled": launches}):
        raise AssertionError(f"evolution: engine {fused.stats}, launches "
                             f"{launches}, drivers {drivers}")
    spec = EV.as_pauli_sum(tfim_sum(n))
    prog = EV.trotter_circuit(spec, EVOLUTION_DT, order=2,
                              steps=1).compiled_fused(n, device=CARD)
    x = fused.state.amps.clone()
    step_ms = statistics.median(_wall(torch, lambda: prog(x))[0]
                                for _ in range(3))
    # device time of the step and of each of its launches alone
    step_dev = time_ms(torch, lambda: prog(x), 3) if CARD == "cuda" else 0.0
    launch_ms = [time_ms(torch, lambda: S.segment_sweep(x, seg), 3)
                 if CARD == "cuda" else 0.0 for seg in prog.segments]
    del x
    passes = len(prog.steps)
    rec["fused"] = {
        "run_ms": ms, "step_ms": step_ms, "step_device_ms": step_dev,
        "launch_ms": launch_ms, "energies": fused.energies[:, 0]
        .tolist(), "launches": launches, "stage_launches": stage_launches,
        "launches_per_step": prog.launches_per_call,
        "passthroughs_per_step": passes - len(prog.segments),
        "stage_mix": _stage_mix(prog),
        "bytes_bound_ms_per_step": passes * 2 * state_bytes
        / HBM_BYTES_PER_S * 1e3,
        "bound_ms_per_step": program_bound(prog)[0],
        "bound_by": program_bound(prog)[1],
        "plan": EV.trotter_plan_stats(spec, EVOLUTION_DT, order=2)}
    bfn, (qb,) = evolution_entry(CARD, num_qubits=n, steps=steps,
                                 engine="banded")
    bms, banded = _wall(torch, lambda: bfn(qb))
    del qb
    scale = banded.state.amps.abs().max().item()
    err = _state_err(fused.state.amps, banded.state.amps)
    e_f, e_b = fused.energies[:, 0], banded.energies[:, 0]
    e_rel = float(np.max(np.abs(e_f - e_b) / np.maximum(np.abs(e_b), 1e-30)))
    bprog = EV.trotter_circuit(spec, EVOLUTION_DT, order=2,
                               steps=1).compiled_banded(n, device=CARD)
    x = banded.state.amps.clone()
    bstep, _ = _wall(torch, lambda: bprog(x))
    del x
    rec["banded"] = {"run_ms": bms, "step_ms": bstep, "max_abs_err": err,
                     "rel_err": err / scale, "energy_rel_err": e_rel,
                     "passes_per_step": len(bprog.items)}
    if not (err <= PATH_TOL * scale and e_rel <= IMAG_TOL):
        raise AssertionError(f"evolution: fused against banded {err} "
                             f"(max|amp| {scale}), energies {e_rel}")
    del banded, bfn
    _free(torch)
    f1, (q1,) = evolution_entry(CARD, num_qubits=n, steps=1)
    one = f1(q1)
    with env_knob("QUEST_TROTTER_FUSION", "0"):
        lfn, (ql,) = evolution_entry(CARD, num_qubits=n, steps=1)
        lms, legacy = _wall(torch, lambda: lfn(ql))
        plan = EV._plan_trotter(spec.codes)
        lstep, _ = _wall(torch, lambda: EV._legacy_step(
            ql, plan, spec, EVOLUTION_DT, 2))      # the step alone
    del q1, ql
    scale = one.state.amps.abs().max().item()
    err = _state_err(one.state.amps, legacy.state.amps)
    e1, el = one.energies[-1, 0], legacy.energies[-1, 0]
    rec["legacy"] = {"run_ms": lms, "step_ms": lstep,
                     "engine": legacy.stats["engine"],
                     "max_abs_err": err, "rel_err": err / scale,
                     "energy_rel_err": abs(e1 - el) / max(abs(el), 1e-30),
                     "term_applications": EV.trotter_plan_stats(
                         spec, EVOLUTION_DT, order=2, pooled=False)[
                         "baseline_hbm_sweeps_per_step"]}
    if not (legacy.stats["engine"] == "legacy-per-term"
            and err <= PATH_TOL * scale
            and rec["legacy"]["energy_rel_err"] <= IMAG_TOL):
        raise AssertionError(f"evolution: legacy step {rec['legacy']}")
    del one, legacy, fused, q, fn
    _free(torch)
    ni = IMAG_QUBITS
    qi = init_plus_state(create_qureg(ni, device=CARD))
    ims, imag = _wall(torch, lambda: EV.run_evolution(
        tfim_sum(ni), EVOLUTION_DT, IMAG_STEPS, state=qi, imag_time=True,
        energy_every=1))
    track = imag.energies[:, 0]
    rises = [float(b - a) / max(abs(a), 1e-30)
             for a, b in zip(track[:-1], track[1:])]
    norm = EV._norm(imag.state.amps).item()
    rec["imag_time"] = {"n": ni, "steps": IMAG_STEPS, "run_ms": ims,
                        "ms_per_step": ims / IMAG_STEPS,
                        "energies": track.tolist(), "max_rise": max(rises),
                        "norm": norm}
    if not (max(rises) <= IMAG_TOL and abs(norm - 1.0) <= IMAG_TOL):
        raise AssertionError(f"evolution: imaginary time {rec['imag_time']}")
    del qi, imag
    _free(torch)
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


def _hea_ansatz(V, n: int, layers: int):
    """entry.hea_circuit's gates as a variational ansatz: ry and rz on
    every qubit and a cz ring per layer, params in that order."""
    def ansatz(amps, params):
        k = 0
        for _ in range(layers):
            for q in range(n):
                amps = V.ry(amps, n, q, params[k])
                k += 1
            for q in range(n):
                amps = V.rz(amps, n, q, params[k])
                k += 1
            for q in range(n):
                amps = V.cz(amps, n, q, (q + 1) % n)
        return amps
    return ansatz


def phase_variational(torch):
    """variational.expectation of the hardware-efficient ansatz (2 layers)
    against TFIM-20 at 20 qubits: torch.autograd gradients against the
    parameter-shift rule, (E(theta + pi/2) - E(theta - pi/2)) / 2, for
    every parameter within 1e-4; sweep of 32 parameter sets at 16 qubits
    equal to the per-set loop within 1e-6. ms of each."""
    from quest_tpu_torch import variational as V
    from quest_tpu_torch.entry import tfim_sum
    t0 = time.perf_counter()
    n, layers = VAR_QUBITS, VAR_LAYERS
    codes, coeffs = tfim_sum(n)
    energy = V.expectation(_hea_ansatz(V, n, layers), n, codes, coeffs,
                           device=CARD)
    rng = np.random.default_rng(VAR_SEED)
    theta0 = rng.uniform(-np.pi, np.pi, 2 * n * layers)
    theta = torch.tensor(theta0, dtype=torch.float32, device=CARD,
                         requires_grad=True)

    def value_grad():
        v = energy(theta)
        return v, torch.autograd.grad(v, theta)[0]
    ms, (val, grad) = _wall(torch, value_grad)
    grad = grad.double().cpu().numpy()
    shift = np.zeros_like(grad)

    def at(th):
        with torch.no_grad():
            return float(energy(torch.tensor(th, dtype=torch.float32,
                                             device=CARD)))
    sms = time.perf_counter()
    for k in range(len(theta0)):
        up, dn = theta0.copy(), theta0.copy()
        up[k] += np.pi / 2
        dn[k] -= np.pi / 2
        shift[k] = (at(up) - at(dn)) / 2
    sms = (time.perf_counter() - sms) * 1e3
    err = float(np.abs(grad - shift).max())
    rec = {"phase": "variational", "n": n, "params": len(theta0),
           "energy": float(val.detach()), "value_and_grad_ms": ms,
           "shift_ms": sms, "grad_max_abs_err": err}
    if not err <= SHIFT_TOL:
        raise AssertionError(f"variational: autograd against parameter "
                             f"shift {err}")
    ns = SWEEP_QUBITS
    codes, coeffs = tfim_sum(ns)
    e16 = V.expectation(_hea_ansatz(V, ns, layers), ns, codes, coeffs,
                        device=CARD)
    batch = torch.tensor(rng.uniform(-np.pi, np.pi,
                                     (SWEEP_SETS, 2 * ns * layers)),
                         dtype=torch.float32, device=CARD)
    with torch.no_grad():
        wms, swept = _wall(torch, lambda: V.sweep(e16, batch))
        loop = torch.stack([e16(batch[i]) for i in range(SWEEP_SETS)])
    serr = (swept - loop).abs().max().item()
    rec.update(sweep_sets=SWEEP_SETS, sweep_qubits=ns, sweep_ms=wms,
               sweep_max_abs_err=serr)
    if not serr <= SWEEP_TOL:
        raise AssertionError(f"variational: sweep against the loop {serr}")
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


def phase_adjoint(torch):
    """entry.vqe_entry() at 30 qubits (120 parameters, the adjoint
    engine): one value and gradient (returned beside the record for
    phase_sharded_consumers), peak memory above the base within
    three 8 GiB registers + 1 GiB, two parameters (the first ry and rz)
    against the parameter-shift rule within 1e-3; ms of the forward
    (the energy alone) and of the backward walk. At 20 qubits
    engine='adjoint' against 'taped' (values 1e-5, gradients 1e-4); on a
    10-qubit density register (20 state qubits) the density gradients
    against the statevector ones (1e-5). What engine=None ('auto')
    chooses at 20 and 30 qubits, with the capacity numbers
    (adjoint.grad_record against the card's memory)."""
    from quest_tpu_torch import adjoint as AD
    from quest_tpu_torch.entry import hea_circuit, tfim_sum, vqe_entry
    t0 = time.perf_counter()
    n = ADJ_QUBITS
    rec = {"phase": "adjoint", "n": n}
    base = _reset_peak(torch)
    fn, (theta,) = vqe_entry(CARD, num_qubits=n)
    fwd_ms, _ = _wall(torch, lambda: fn.value(theta))
    base = _reset_peak(torch)
    ms, (val, grad) = _wall(torch, lambda: fn(theta))
    peak = _peak_gib(torch, base)
    state_gib = 2 * 4 * (1 << n) / GIB
    th = theta.double().cpu().numpy()
    shifts = {}
    for k in ADJ_SHIFT_PARAMS:
        up, dn = th.copy(), th.copy()
        up[k] += np.pi / 2
        dn[k] -= np.pi / 2
        shifts[k] = (float(fn.value(up)) - float(fn.value(dn))) / 2
    errs = {k: abs(float(grad[k]) - s) for k, s in shifts.items()}
    rec.update(engine=fn.engine, params=fn.num_params, energy=float(val),
               forward_ms=fwd_ms, value_and_grad_ms=ms,
               backward_ms=ms - fwd_ms, peak_gib=peak,
               peak_limit_gib=3 * state_gib + 1.0,
               shift_abs_err={str(k): e for k, e in errs.items()})
    if not (fn.engine == "adjoint" and max(errs.values()) <= ADJ_SHIFT_TOL
            and peak <= 3 * state_gib + 1.0
            and torch.isfinite(grad).all().item()):
        raise AssertionError(f"adjoint 30q: {rec}")
    # sharded_consumers holds its sharded gradient against this one
    one_grad = (n, ms, float(val), grad.detach().cpu())
    del fn, theta, grad
    _free(torch)
    auto = {}
    for nq in (ADJ_SMALL_QUBITS, n):
        r = AD.grad_record(hea_circuit(nq, 2), device=CARD)
        auto[str(nq)] = {"engine": r["engine"], "params": r["params"],
                         "taped": r["taped"], "adjoint": r["adjoint"]}
    rec["auto"] = auto
    ns = ADJ_SMALL_QUBITS
    adj, (th20,) = vqe_entry(CARD, num_qubits=ns, engine="adjoint")
    tap = vqe_entry(CARD, num_qubits=ns, engine="taped")[0]
    ams, (va, ga) = _wall(torch, lambda: adj(th20))
    tms, (vt, gt) = _wall(torch, lambda: tap(th20))
    verr, gerr = abs(float(va) - float(vt)), (ga - gt).abs().max().item()
    rec["small"] = {"n": ns, "adjoint_ms": ams, "taped_ms": tms,
                    "value_abs_err": verr, "grad_max_abs_err": gerr}
    if not (verr <= ADJ_VALUE_TOL and gerr <= ADJ_GRAD_TOL):
        raise AssertionError(f"adjoint 20q: {rec['small']}")
    nd = ADJ_DENSITY_QUBITS
    codes, coeffs = tfim_sum(nd)
    c = hea_circuit(nd, 2)
    sv = AD.value_and_grad(c, codes, coeffs=coeffs, engine="adjoint",
                           device=CARD)
    dm = AD.value_and_grad(c, codes, coeffs=coeffs, engine="adjoint",
                           density=True, device=CARD)
    thd = torch.as_tensor(sv.initial_params, dtype=torch.float32,
                          device=CARD)
    dms, (vd, gd) = _wall(torch, lambda: dm(thd))
    vs, gs = sv(thd)
    derr = (gd - gs).abs().max().item()
    rec["density"] = {"n": nd, "state_qubits": 2 * nd, "ms": dms,
                      "value_abs_err": abs(float(vd) - float(vs)),
                      "grad_max_abs_err": derr}
    if not (derr <= ADJ_DENSITY_TOL
            and rec["density"]["value_abs_err"] <= ADJ_DENSITY_TOL):
        raise AssertionError(f"adjoint density: {rec['density']}")
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec, one_grad


# ---------------------------------------------------------------------------
# The front ends on the card (no kernel is added: QASM in and out,
# the transpiler, the plan IR and its autotuner, the QuEST API)
# ---------------------------------------------------------------------------

FRONTEND_QUBITS = 28
FRONTEND_REPS = 1
FRONTEND_TOL = 1e-4           # transpiled vs raw, x max|amp|; norms
GHZ_UNIFORMS = (0.1, 0.4, 0.6, 0.9)
RANK_QUBITS = 24
RANK_CLASSES = ("qft", "rcs")
API_QUBITS = 28
API_LAYERS = 9                # 22 calls a layer: ~200 calls
API_SEED = 13
TUTORIAL_TOL = 1e-6


def _zero_planes(n: int):
    from quest_tpu_torch.state import basis_planes
    return basis_planes(0, n=n, device=CARD)


def _ghz_bits(torch, circ, n: int):
    """Outcomes of the gallery ghz circuit's prefix up to its measurement
    followed by a measurement of every qubit, one shot per uniform of
    GHZ_UNIFORMS (the later draws 0.5): (shots, n) bits."""
    from quest_tpu_torch.circuit import Circuit
    cut = next(i for i, op in enumerate(circ.ops) if op.kind == "measure")
    c = Circuit(n)
    c.ops = list(circ.ops[:cut])
    for q in range(n):
        c.measure(q)
    prog = c.compiled_measured(n, device=CARD)
    shots = []
    for u in GHZ_UNIFORMS:
        _, outs = prog.given(_zero_planes(n), [u] + [0.5] * (n - 1))
        shots.append(outs.tolist())
    return shots


def _frontend_ghz(torch, raw, tc, n: int) -> dict:
    """The ghz class on its measured program: raw and transpiled, equal
    outcomes given the same uniforms and planes within FRONTEND_TOL; the
    GHZ prefix measured on every qubit gives equal bits in each shot."""
    r = {}
    for label, c in (("raw", raw), ("transpiled", tc)):
        prog = c.compiled_measured(n, device=CARD)
        outs, planes = [], []
        for u in GHZ_UNIFORMS:
            amps, o = prog.given(_zero_planes(n), [u])
            outs.append(o.tolist())
            planes.append(amps)
        r[label] = {"outcomes": outs}
        r[label + "_planes"] = planes
        gen = torch.Generator().manual_seed(0)
        ms, _ = host_ms(torch, lambda: prog(_zero_planes(n), gen))
        r[label]["shot_ms"] = ms
    errs = [plane_err(a, b) for a, b in zip(r.pop("raw_planes"),
                                            r.pop("transpiled_planes"))]
    bits = _ghz_bits(torch, raw, n)
    r.update(max_abs_err=max(errs), all_bits=[sorted(set(s)) for s in bits])
    if not (r["raw"]["outcomes"] == r["transpiled"]["outcomes"]
            and max(errs) <= FRONTEND_TOL
            and all(len(set(s)) == 1 for s in bits)):
        raise AssertionError(f"frontends ghz: {r}")
    return r


def _frontend_streams(torch, S, raw, tc, n: int) -> dict:
    """The raw and the transpiled stream through compiled_fused on |0>:
    K1 launches of the first call (the counts set to 0 just before it,
    read just after; at least one), the warm step ms (median of
    FRONTEND_REPS, CUDA events), the planes within FRONTEND_TOL of each
    other and each norm within FRONTEND_TOL of 1."""
    r, outs = {}, {}
    for label, c in (("raw", raw), ("transpiled", tc)):
        build_ms, prog = host_ms(torch, lambda: c.compiled_fused(n,
                                                                device=CARD))
        amps = _zero_planes(n)
        S.segment_sweep.launches = 0
        prog(amps)
        torch.cuda.synchronize()
        launches = S.segment_sweep.launches
        if launches < 1 or launches != prog.launches_per_call:
            raise AssertionError(f"frontends {label}: {launches} launches "
                                 f"for {prog.launches_per_call} segments")
        outs[label] = amps
        scratch = _zero_planes(n)
        r[label] = {"k1_launches": launches, "build_ms": build_ms,
                    "step_ms": time_ms(torch, lambda: prog(scratch),
                                       FRONTEND_REPS),
                    "norm": norm_of(amps)}
        del scratch
    scale = outs["raw"].abs().max().item()
    r["max_abs_err"] = plane_err(outs["transpiled"], outs["raw"])
    r["rel_err"] = r["max_abs_err"] / scale
    if not (r["rel_err"] <= FRONTEND_TOL
            and all(abs(1.0 - r[k]["norm"]) <= FRONTEND_TOL
                    for k in ("raw", "transpiled"))):
        raise AssertionError(f"frontends streams: {r}")
    return r


def _rank_engines(torch, c, n: int) -> dict:
    """Every selectable engine of `c` (transpile axis off) at n qubits:
    priced against measured ms (median of FRONTEND_REPS on |0>), the
    planes of each within FRONTEND_TOL of the fused engine's."""
    from quest_tpu_torch import plan as P
    with env_knob("QUEST_TRANSPILE", "0"):
        plan = P.autotune(c, device=CARD, persist=False)
        r = {"pick": plan.engine, "engines": {}}
        outs = {}
        for name in ("pergate", "banded", "fused"):
            cand = plan.candidates.get(name)
            if cand is None or not cand["selectable"]:
                continue
            prog = {"pergate": c.compiled, "banded": c.compiled_banded,
                    "fused": c.compiled_fused}[name](n, device=CARD)
            outs[name] = prog(_zero_planes(n))
            scratch = _zero_planes(n)
            ms = time_ms(torch, lambda: prog(scratch), FRONTEND_REPS)
            del scratch
            r["engines"][name] = {"priced_ms": cand["total_ms"],
                                  "measured_ms": ms}
    eng = r["engines"]
    r["priced_rank"] = sorted(eng, key=lambda k: eng[k]["priced_ms"])
    r["measured_rank"] = sorted(eng, key=lambda k: eng[k]["measured_ms"])
    r["pick_was_fastest"] = r["pick"] == r["measured_rank"][0]
    ref = outs["fused"]
    scale = ref.abs().max().item()
    r["max_rel_err"] = max(plane_err(o, ref) / scale for o in outs.values())
    if r["max_rel_err"] > FRONTEND_TOL:
        raise AssertionError(f"frontends ranking: {r}")
    return r


def frontends_host(n: int) -> dict:
    """The host half of phase_frontends, no kernel and no launch (run on
    a host thread while nvcc builds, the plan cache the fresh directory
    start_during_build named): each gallery class at n qubits imported
    from QASM, transpiled cold and warm and, ghz aside, its plan searched
    cold and warm (the warm search a hit of the plan cache), on the
    host's clock. {class: (raw, transpiled, record)}."""
    from quest_tpu_torch import plan as P
    from quest_tpu_torch import transpile as T
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.entry import GALLERY_CLASSES, gallery_qasm
    out = {}
    texts = gallery_qasm(n)
    for cls in GALLERY_CLASSES:
        t_import = time.perf_counter()
        raw = Circuit.from_qasm(texts[cls], transpile=False)
        r = {"import_ms": (time.perf_counter() - t_import) * 1e3}
        t_tr = time.perf_counter()
        tc, rep = T.transpile_cached(raw)
        r["transpile_cold_ms"] = (time.perf_counter() - t_tr) * 1e3
        t_tr = time.perf_counter()
        T.transpile_cached(raw)
        r["transpile_warm_ms"] = (time.perf_counter() - t_tr) * 1e3
        r.update(ops_raw=len(raw.ops), ops_transpiled=len(tc.ops),
                 sweeps_raw=T.stream_cost(raw)[0],
                 sweeps_transpiled=T.stream_cost(tc)[0],
                 passes={k: v for k, v in rep["passes"].items() if v})
        if cls != "ghz":
            P.reset_cache_stats()
            t_at = time.perf_counter()
            plan = P.autotune(raw, device=CARD)
            r["autotune_cold_ms"] = (time.perf_counter() - t_at) * 1e3
            t_at = time.perf_counter()
            warm = P.autotune(raw, device=CARD)
            r["autotune_warm_ms"] = (time.perf_counter() - t_at) * 1e3
            st = P.cache_stats()
            if not (st["searches"] == 1 and st["hits"] == 1
                    and warm.engine == plan.engine):
                raise AssertionError(f"frontends {cls}: plan cache {st}")
            r.update(engine=plan.engine, priced_ms=plan.cost["total_ms"],
                     incumbent=plan.incumbent, device_kind=plan.device_kind)
        out[cls] = (raw, tc, r)
    return out


def phase_frontends(torch):
    """The gallery at FRONTEND_QUBITS through the front ends (module
    docstring, phase 34): frontends_host's records (taken while nvcc
    built, or here), then each class on the card; then the engine
    ranking at RANK_QUBITS."""
    from quest_tpu_torch.ops import segment as S
    t0 = time.perf_counter()
    n = FRONTEND_QUBITS
    rec = {"phase": "frontends", "n": n, "classes": {}}
    host = DURING_BUILD.pop("frontends", None)
    cache = (DURING_BUILD.pop("plans_dir", None)
             or tempfile.mkdtemp(prefix="quest_plans_"))
    try:
        with env_knob("QUEST_PLAN_CACHE_DIR", cache):
            gallery = host.result() if host is not None else frontends_host(n)
            rec["host_during_build"] = host is not None
            for cls in list(gallery):
                raw, tc, r = gallery.pop(cls)
                if cls == "ghz":
                    r.update(_frontend_ghz(torch, raw, tc, n))
                else:
                    r.update(_frontend_streams(torch, S, raw, tc, n))
                rec["classes"][cls] = r
                del raw, tc
                _free(torch)
            rec["gallery_seconds"] = time.perf_counter() - t0
            rank_engines(torch, rec)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


def rank_engines(torch, rec) -> None:
    """The engine ranking at RANK_QUBITS into rec["ranking"]."""
    from quest_tpu_torch import transpile as T
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.entry import gallery_qasm
    texts = gallery_qasm(RANK_QUBITS)
    rank = {}
    for cls in RANK_CLASSES:
        c = Circuit.from_qasm(texts[cls], transpile=False)
        if cls == "qft":
            c = T.transpile_cached(c)[0]
        rank[cls] = _rank_engines(torch, c, RANK_QUBITS)
        _free(torch)
    rec["ranking"] = {"n": RANK_QUBITS, **rank}


def _api_script(api, q, n: int):
    """The ~200-call QuEST-style script on handle q through `api` (the
    QuEST API module, or an adapter with the same names): API_LAYERS
    layers of 22 gate calls and a calcProbOfOutcome, then one seeded
    measure. Returns (per-call host ms, probabilities, outcome)."""
    rng = np.random.default_rng(API_SEED)
    u = np.linalg.qr(rng.standard_normal((2, 2))
                     + 1j * rng.standard_normal((2, 2)))[0]
    calls = []
    for layer in range(API_LAYERS):
        a = [float(x) for x in rng.uniform(-np.pi, np.pi, 8)]
        t = [int(x) for x in rng.permutation(n)[:8]]
        calls += [
            lambda: api.hadamard(q, t[0]),
            lambda: api.controlledNot(q, t[0], t[1]),
            lambda: api.rotateX(q, t[2], a[0]),
            lambda: api.rotateY(q, t[3], a[1]),
            lambda: api.rotateZ(q, t[4], a[2]),
            lambda: api.phaseShift(q, t[5], a[3]),
            lambda: api.controlledPhaseShift(q, t[5], t[6], a[4]),
            lambda: api.tGate(q, t[7]),
            lambda: api.sGate(q, t[0]),
            lambda: api.pauliX(q, t[1]),
            lambda: api.pauliY(q, t[2]),
            lambda: api.pauliZ(q, t[3]),
            lambda: api.swapGate(q, t[4], t[6]),
            lambda: api.controlledPhaseFlip(q, t[1], t[7]),
            lambda: api.multiRotateZ(q, [t[0], t[2], t[5]], a[5]),
            lambda: api.unitary(q, t[6], u),
            lambda: api.compactUnitary(q, t[7], u[0, 0], u[1, 0]),
            lambda: api.controlledRotateY(q, t[3], t[0], a[6]),
            lambda: api.rotateAroundAxis(q, t[1], a[7], (1.0, 0.5, 0.2)),
            lambda: api.multiControlledPhaseFlip(q, [t[2], t[4], t[6]]),
            lambda: api.controlledUnitary(q, t[5], t[2], u),
            lambda: api.sqrtSwapGate(q, t[3], t[7]),
            lambda: api.calcProbOfOutcome(q, t[layer % 8], 1),
        ]
    ms, probs = [], []
    for call in calls:
        start = time.perf_counter()
        out = call()
        torch_sync()
        ms.append((time.perf_counter() - start) * 1e3)
        if isinstance(out, float):          # calcProbOfOutcome
            probs.append(out)
    api.seedQuEST([API_SEED])
    start = time.perf_counter()
    outcome = api.measure(q, 0)
    torch_sync()
    ms.append((time.perf_counter() - start) * 1e3)
    return ms, probs, outcome


def torch_sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _GatesAPI:
    """The api script's calls mapped onto quest_tpu_torch.ops.gates (the
    eager layer under the API): the same arguments, no handle, no QASM."""

    def __init__(self):
        from quest_tpu_torch import measurement as MS
        from quest_tpu_torch import random_ as R
        from quest_tpu_torch.ops import gates as G
        self.G, self.MS, self.R = G, MS, R

    def __getattr__(self, name):
        import re
        fn = getattr(self.G, re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower())
        return lambda q, *args: fn(q.state, *args)

    def calcProbOfOutcome(self, q, qubit, outcome):
        return self.MS.calc_prob_of_outcome(q.state, qubit, outcome)

    def seedQuEST(self, seeds):
        self.R.seed_quest(list(seeds))

    def measure(self, q, qubit):
        return self.MS.measure(q.state, qubit)[1]


def _tutorial(api, env):
    q = api.createQureg(3, env)
    api.startRecordingQASM(q)
    api.hadamard(q, 0)
    api.controlledNot(q, 0, 1)
    api.rotateY(q, 2, 0.1)
    api.multiControlledPhaseFlip(q, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    api.unitary(q, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    api.compactUnitary(q, 1, a, b)
    api.rotateAroundAxis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    api.controlledCompactUnitary(q, 0, 1, a, b)
    api.multiControlledUnitary(q, [0, 1], 2, u)
    toff = api.createComplexMatrixN(3)
    toff[6, 7] = toff[7, 6] = 1
    for i in range(6):
        toff[i, i] = 1
    api.multiQubitUnitary(q, [0, 1, 2], toff)
    return (api.getProbAmp(q, 7), api.calcProbOfOutcome(q, 2, 1),
            q.qasm.recorded())


def phase_api(torch):
    """The tutorial through quest_tpu_torch.api on the card and on the
    CPU, then the ~200-call script at API_QUBITS through the API and
    through ops.gates (module docstring, phase 35)."""
    from quest_tpu_torch import api as Q
    t0 = time.perf_counter()
    rec = {"phase": "api"}
    p7, p2, text = _tutorial(Q, Q.createQuESTEnv(devices=CARD))
    cpu_text = _tutorial(Q, Q.createQuESTEnv(devices="cpu"))[2]
    rec["tutorial"] = {"prob_amp_7": p7, "prob_qubit2_1": p2,
                       "qasm_bytes": len(text),
                       "qasm_equal_cpu": text == cpu_text}
    if not (abs(p7 - 0.112422) <= TUTORIAL_TOL
            and abs(p2 - 0.749178) <= TUTORIAL_TOL and text == cpu_text):
        raise AssertionError(f"api tutorial: {rec['tutorial']}")
    n = API_QUBITS
    env = Q.createQuESTEnv(devices=CARD)
    qa, qg = Q.createQureg(n, env), Q.createQureg(n, env)
    for q in (qa, qg):
        Q.initPlusState(q)
    Q.startRecordingQASM(qa)
    api_ms, api_probs, api_out = _api_script(Q, qa, n)
    gates_ms, gates_probs, gates_out = _api_script(_GatesAPI(), qg, n)
    same = torch.equal(qa.state.amps, qg.state.amps)
    over = [a - g for a, g in zip(api_ms, gates_ms)]
    rec["script"] = {
        "n": n, "calls": len(api_ms),
        "api_ms_per_call": statistics.median(api_ms),
        "gates_ms_per_call": statistics.median(gates_ms),
        "overhead_ms_per_call": statistics.median(over),
        "api_total_ms": sum(api_ms), "gates_total_ms": sum(gates_ms),
        "qasm_lines": qa.qasm.recorded().count("\n"),
        "outcome": api_out, "planes_bit_equal": same,
        "probs_equal": api_probs == gates_probs}
    if not (same and api_out == gates_out and api_probs == gates_probs):
        raise AssertionError(f"api script: {rec['script']}")
    del qa, qg
    _free(torch)
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


# ---------------------------------------------------------------------------
# the scan and the sharded engines (ROADMAP A4.4, A10)
# ---------------------------------------------------------------------------

SCAN_QUBITS = 28
SCAN_ITERS = 8                # diag layer x 8: one scan group of 8 sweeps
SHARDS = 4                    # a mesh of 4 shards of the one card
SHARDED_QUBITS = 28
SHARDED_BASELINE = (30, 20)   # qubits, depth: the 30q d20 step
SHARDED_BATCH = (24, 64)      # qubits, states
SHARD_COPIES = "device-local copies: every shard of the mesh is on one card"


def _counted(torch, fn, *args):
    """fn(*args) with the segment counters set to 0 just before and the
    mesh recorders' issued exchanges read just after: (result, launches,
    launches per stage kind)."""
    from quest_tpu_torch.ops import segment as S
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    S.segment_sweep.driver_launches = {}
    out = fn(*args)
    torch.cuda.synchronize()
    return out, S.segment_sweep.launches, dict(S.segment_sweep.stage_launches)


def phase_scan(torch):
    """QUEST_FUSED_SCAN at 0 and 1 on the 28q QFT and on the 28q diagonal
    layer run 8 times in one program (entry.diag_layer_circuit, iters 8:
    eight sweeps of one structure, one group of the reference's scan
    partition): planes bit for bit, launches, build s and warm ms of
    each. The knob is keyed, so each flag builds its own program; both
    prepare every segment and launch each once."""
    from quest_tpu_torch.circuit import SCAN_MIN, _scan_partition, qft_circuit
    from quest_tpu_torch.entry import diag_layer_circuit
    from quest_tpu_torch.state import fused_state_shape
    n = SCAN_QUBITS
    _, inputs = seeded_planes(11, fused_state_shape(n), 2)
    rec = {"phase": "scan", "n": n, "cases": {}}
    diag = f"diag_layer{n}x{SCAN_ITERS}"
    for name, circ, iters in ((f"qft{n}", qft_circuit(n), 1),
                              (diag, diag_layer_circuit(n), SCAN_ITERS)):
        parts, _ = circ.fused_parts(n, iters)
        case = {"scan_groups": sum(1 for g in _scan_partition(parts, SCAN_MIN)
                                   if g[0] == "scan")}
        x0 = torch.from_numpy(inputs.pop(0)).to(CARD)
        x0 /= x0.double().pow(2).sum().sqrt().float()
        outs = {}
        for flag in ("0", "1"):
            with env_knob("QUEST_FUSED_SCAN", flag):
                t0 = time.perf_counter()
                fn = circ.compiled_fused(n, iters=iters, device=CARD)
                build_s = time.perf_counter() - t0
            amps = x0.clone()
            _, launches, _ = _counted(torch, fn, amps)
            if launches != fn.launches_per_call or not launches:
                raise AssertionError(f"scan {name}/{flag}: {launches} "
                                     f"launches, {fn.launches_per_call} "
                                     f"planned")
            outs[flag] = amps
            y = x0.clone()
            case[f"scan{flag}"] = {
                "launches": launches, "segments": len(fn.segments),
                "build_s": build_s,
                "warm_ms": time_ms(torch, lambda: fn(y), 1)}
            del fn, y
        if not torch.equal(outs["0"], outs["1"]):
            raise AssertionError(f"scan {name}: planes differ")
        case["bit_equal"] = True
        rec["cases"][name] = case
        del outs, x0
        torch.cuda.empty_cache()
    if not rec["cases"][diag]["scan_groups"]:
        raise AssertionError("scan: the repeated diagonal layer formed no "
                             "scan group")
    emit_card(rec)
    return rec


def _issued_predicted(torch, mesh, circ, n, engine):
    """(issued, predicted): the mesh recorder's counts of the run just
    made and introspect's record of the same program (comm_stats'
    prediction, the dry walk's issued counts); raises unless all three
    agree."""
    from quest_tpu_torch.parallel import introspect as I
    issued = mesh.recorder.stats(mesh.size)
    rec = I.sharded_schedule(circ.ops, n, False, mesh, engine=engine)
    keys = ("collective_permutes", "all_to_alls", "collective_exchanges",
            "ici_bytes_per_device")
    if not rec["comm_matches_hlo"] or any(issued[k] != rec[k] for k in keys):
        raise AssertionError(f"sharded {engine}: issued {issued}, predicted "
                             f"{rec}")
    return issued, rec


def _exchange_ms(torch, mesh, n):
    """ms of one full-chunk pair permute (device bit 0) and of one relabel
    all-to-all on the mesh's shards of an n-qubit f32 state, the copies
    alone (CUDA events); the recorder is reset after."""
    from quest_tpu_torch.parallel import sharded as SH
    local_n = n - mesh.global_qubits
    xs = [torch.zeros((1, 2, 1 << local_n), device=d) for d in mesh.devices]
    out = {
        "pair_permute_ms": time_ms(torch, lambda: mesh.permute(xs, 0), 3),
        "all_to_all_ms": time_ms(torch, lambda: SH._relabel_op(
            xs, mesh, local_n, tuple(range(mesh.global_qubits))), 3),
        "chunk_bytes": 2 * 4 << local_n, "copies": SHARD_COPIES}
    mesh.recorder.reset()
    del xs
    torch.cuda.empty_cache()
    return out


def phase_sharded(torch):
    """The 28q flagship over a mesh of 4 shards of the one card through
    compiled_sharded_fused (K1 on every shard), compiled_sharded_banded
    and compiled_sharded: each within 1e-4 x max|amp| of entry()'s
    single-register K1 step, norm within 1e-4, the recorder's issued
    exchanges equal to comm_stats' prediction; warm step ms, K1 launches
    per shard, exchange count and bytes, and one exchange's ms (device-
    local copies on one card). Then 30q d20 over 4 shards through the
    fused engine with the default comm plan, one warm step, the same
    gates against the single-register K1 step."""
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import entry, flagship_circuit, sharded_entry
    from quest_tpu_torch.parallel import ShardedAmps, make_amp_mesh
    n = SHARDED_QUBITS
    ref_fn, (ref,) = entry(device=CARD, num_qubits=n)
    ref_fn(ref)
    ref = ref.reshape(2, -1)
    scale = ref.abs().max().item()
    rec = {"phase": "sharded", "n": n, "shards": SHARDS, "engines": {}}
    for engine, reps in (("fused", 5), ("banded", 3), ("pergate", 1)):
        fn, (x,) = sharded_entry(device=CARD, num_qubits=n, shards=SHARDS,
                                 engine=engine)
        x.mesh.recorder.reset()
        _, launches, stages = _counted(torch, fn, x)
        if launches != fn.launches_per_call or (engine == "fused"
                                                and not launches):
            raise AssertionError(f"sharded {engine}: {launches} launches, "
                                 f"{fn.launches_per_call} planned")
        issued, pred = _issued_predicted(torch, x.mesh, flagship_circuit(n),
                                         n, engine)
        got = x.gather()
        err, norm = plane_err(got, ref), norm_of(got)
        del got
        if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL):
            raise AssertionError(f"sharded {engine}: max|diff| {err} vs K1 "
                                 f"(max|amp| {scale}), norm {norm}")
        rec["engines"][engine] = {
            "max_abs_err": err, "rel_err": err / scale, "norm": norm,
            "launches": launches, "launches_per_shard": launches // SHARDS,
            "stage_launches": stages, "strategy": fn.strategy,
            "exchanges": issued["collective_exchanges"],
            "pair_permutes": issued["collective_permutes"],
            "all_to_alls": issued["all_to_alls"],
            "exchange_bytes_per_shard": issued["ici_bytes_per_device"],
            "predicted_bytes": pred["comm_bytes"],
            "warm_ms": time_ms(torch, lambda: fn(x), reps)}
        mesh = x.mesh
        del fn, x
        torch.cuda.empty_cache()
    rec["exchange"] = _exchange_ms(torch, mesh, n)
    del ref_fn, ref
    torch.cuda.empty_cache()
    # 30q d20: the BASELINE circuit over 4 shards, default plan
    nb, depth = SHARDED_BASELINE
    circ = random_circuit(nb, depth, seed=7, entangler="cz")  # phase_baseline's
    single = circ.compiled_fused(nb, device=CARD)
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    want = basis_planes(0, n=nb, device=CARD, shape=fused_state_shape(nb))
    single(want)
    want = want.reshape(2, -1)
    mesh = make_amp_mesh(SHARDS, devices=[torch.device(CARD)] * SHARDS)
    fn = circ.compiled_sharded_fused(nb, False, mesh)
    local = nb - mesh.global_qubits
    shards = [torch.zeros((2, 1 << local), device=CARD)
              for _ in range(SHARDS)]
    shards[0][0, 0] = 1.0
    x = ShardedAmps(shards, mesh, nb)
    t0 = time.perf_counter()
    fn(x)                                  # cold: first launches
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    for s in shards:
        s.zero_()
    shards[0][0, 0] = 1.0
    mesh.recorder.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, launches, _ = _counted(torch, fn, x)
    end.record()
    end.synchronize()
    warm_ms = start.elapsed_time(end)
    issued, pred = _issued_predicted(torch, mesh, circ, nb, "fused")
    if launches != fn.launches_per_call or not launches:
        raise AssertionError(f"sharded 30q d20: {launches} launches")
    bscale = want.abs().max().item()
    err = max(plane_err(s, want[:, i << local:(i + 1) << local])
              for i, s in enumerate(shards))
    norm = sum(norm_of(s) for s in shards)
    if not (err <= PATH_TOL * bscale and abs(1.0 - norm) <= PATH_TOL):
        raise AssertionError(f"sharded 30q d20: max|diff| {err} (max|amp| "
                             f"{bscale}), norm {norm}")
    rec["baseline_30q_d20"] = {
        "max_abs_err": err, "rel_err": err / bscale, "norm": norm,
        "launches": launches, "launches_per_shard": launches // SHARDS,
        "strategy": fn.strategy,
        "relabel_events": issued["all_to_alls"],
        "exchanges": issued["collective_exchanges"],
        "exchange_bytes_per_shard": issued["ici_bytes_per_device"],
        "predicted_bytes": pred["comm_bytes"], "cold_s": cold_s,
        "warm_ms": warm_ms, "single_register_launches":
            single.launches_per_call}
    emit_card(rec)
    del fn, x, shards, want, single
    torch.cuda.empty_cache()
    return rec


def phase_sharded_batched(torch):
    """24q x 64 states over 4 shards through compiled_sharded_batched
    against compiled_batched within 1e-4 x max|amp|: K1 launches per shard
    (one per swept segment for all 64 states), warm ms."""
    from quest_tpu_torch.entry import flagship_circuit, random_states
    from quest_tpu_torch.parallel import make_amp_mesh, shard_planes
    n, b = SHARDED_BATCH
    circ = flagship_circuit(n)
    states = random_states(b, n, device=CARD)
    want = circ.compiled_batched(b, device=CARD)(states.clone()).reshape(
        b, 2, -1)
    mesh = make_amp_mesh(SHARDS, devices=[torch.device(CARD)] * SHARDS)
    fn = circ.compiled_sharded_batched(b, mesh)
    x = shard_planes(states, mesh, n)
    del states
    torch.cuda.empty_cache()
    mesh.recorder.reset()
    _, launches, _ = _counted(torch, fn, x)
    if launches != fn.launches_per_call or not launches:
        raise AssertionError(f"sharded_batched: {launches} launches, "
                             f"{fn.launches_per_call} planned")
    local = n - mesh.global_qubits
    scale = want.abs().max().item()
    err = max(plane_err(s, want[..., i << local:(i + 1) << local])
              for i, s in enumerate(x.shards))
    if not err <= PATH_TOL * scale:
        raise AssertionError(f"sharded_batched: max|diff| {err} (max|amp| "
                             f"{scale})")
    issued = mesh.recorder.stats(SHARDS)
    rec = {"phase": "sharded_batched", "n": n, "batch": b,
           "shards": SHARDS, "max_abs_err": err, "rel_err": err / scale,
           "launches": launches, "launches_per_shard": launches // SHARDS,
           "strategy": fn.strategy,
           "exchanges": issued["collective_exchanges"],
           "exchange_bytes_per_shard": issued["ici_bytes_per_device"],
           "warm_ms": time_ms(torch, lambda: fn(x), 3),
           "copies": SHARD_COPIES}
    emit_card(rec)
    del fn, x, want
    torch.cuda.empty_cache()
    return rec


def phase_sharded_measured(torch):
    """entry.repetition_code_circuit() (30 qubits, 8 GiB) over 4 shards
    through compiled_sharded_measured(engine='fused'), fed the uniforms
    the single-register measured program (engine 'banded') draws from
    the entry's seeded generator, the first replaced by the largest f32
    below 1: the first syndrome then reads 1, so the classically
    controlled flips fire, the ancilla reset among them on a global
    qubit. Equal outcomes, planes within 1e-4 x max|amp|, the recorder's
    exchanges equal to the schedule priced on this run's outcomes (and
    more than the all-zero outcomes' schedule: the feedback issued
    exchanges); ms per cycle of each (wall: each measurement reads its
    outcome on the host)."""
    from quest_tpu_torch import measurement as MS
    from quest_tpu_torch.entry import (MEASURED_ROUNDS, MEASURED_SEED,
                                       measured_entry)
    from quest_tpu_torch.parallel import (introspect as I, make_amp_mesh,
                                          shard_planes)
    fn, (amps, _) = measured_entry(device=CARD)
    n = fn.n
    gen = torch.Generator().manual_seed(MEASURED_SEED)
    us = [MS.draw_uniform(gen, torch.float32)
          for _ in range(fn.circuit._measure_count())]
    us[0] = float(np.nextafter(np.float32(1), np.float32(0)))
    mesh = make_amp_mesh(SHARDS, devices=[torch.device(CARD)] * SHARDS)
    prog = fn.circuit.compiled_sharded_measured(n, False, mesh,
                                                engine="fused")
    x = shard_planes(amps, mesh, n)
    single_ms, (want, wouts) = host_ms(torch, lambda: fn.given(amps, us))
    mesh.recorder.reset()
    from quest_tpu_torch.ops import segment as S
    S.segment_sweep.launches = 0
    sharded_ms, (x, outs) = host_ms(torch, lambda: prog.given(x, us))
    launches = S.segment_sweep.launches
    if not torch.equal(outs, wouts):
        raise AssertionError(f"sharded_measured: outcomes {outs.tolist()} "
                             f"vs {wouts.tolist()}")
    want = want.reshape(2, -1)
    local = n - mesh.global_qubits
    scale = want.abs().max().item()
    err = max(plane_err(s, want[:, i << local:(i + 1) << local])
              for i, s in enumerate(x.shards))
    if not err <= PATH_TOL * scale or not launches:
        raise AssertionError(f"sharded_measured: max|diff| {err} (max|amp| "
                             f"{scale}), {launches} launches")
    issued = mesh.recorder.stats(SHARDS)
    ops = fn.circuit.ops
    pred = I.sharded_measured_schedule(ops, n, False, SHARDS, engine="fused",
                                       outcomes=outs.tolist())
    quiet = I.sharded_measured_schedule(ops, n, False, SHARDS,
                                        engine="fused",
                                        outcomes=[0] * len(outs))
    keys = ("collective_permutes", "all_to_alls", "collective_exchanges",
            "ici_bytes_per_device", "all_reduces")
    if not pred["comm_matches_hlo"] or any(issued[k] != pred[k]
                                           for k in keys):
        raise AssertionError(f"sharded_measured: issued {issued}, "
                             f"predicted on this run's outcomes {pred}")
    if not (outs[0] == 1 and pred["collective_exchanges"]
            > quiet["collective_exchanges"]):
        raise AssertionError(f"sharded_measured: outcomes {outs.tolist()}, "
                             f"the feedback issued no exchange")
    rec = {"phase": "sharded_measured", "n": n, "shards": SHARDS,
           "rounds": MEASURED_ROUNDS, "outcomes": outs.tolist(),
           "max_abs_err": err, "rel_err": err / scale, "launches": launches,
           "kernel_parts": prog.kernel_parts,
           "reductions": issued["all_reduces"],
           "exchanges": issued["collective_exchanges"],
           "predicted_exchanges": pred["collective_exchanges"],
           "all_zero_outcome_exchanges": quiet["collective_exchanges"],
           "exchange_bytes_per_shard": issued["ici_bytes_per_device"],
           "single_ms_per_cycle": single_ms / MEASURED_ROUNDS,
           "sharded_ms_per_cycle": sharded_ms / MEASURED_ROUNDS,
           "copies": SHARD_COPIES}
    emit_card(rec)
    del fn, prog, x, want, amps
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# The sharded consumers and durable execution (no kernel is added)
# ---------------------------------------------------------------------------

CONSUMER_QUBITS = 30          # 8 GiB of f32 planes over 4 shards
SAMPLE_SHOTS = 1 << 20
MARGINAL_QUBITS = 20
CONSUMER_TOL = 1e-5           # probabilities, relative energies
GRAD_TOL = 1e-4
CDF_MISS_TOL = 2.0 ** -20     # an f32 CDF's rounding, against f64
TV_SLACK = 1.2                # x the multinomial noise expected
DURABLE_QUBITS = 28           # 2 GiB of planes
DURABLE_DEPTH = 20
DURABLE_SEED = 20261018


def _shard_err(torch, shards, want) -> float:
    """max|shard - want's slice| over the shards of a (2, 2^n) state."""
    m = shards[0].reshape(2, -1).shape[1]
    return max(plane_err(s.reshape(2, -1), want[:, i * m:(i + 1) * m])
               for i, s in enumerate(shards))


def _cdf_miss(torch, planes, idx, u) -> float:
    """How far the picks `idx` of the uniforms `u` sit from a correct
    inverse-CDF pick in f64: max over shots of how much u * total falls
    outside [F(i - 1), F(i)), F the f64 cumulative sum of |amp|^2 (a
    chunk at a time, only the picked entries kept)."""
    flat = planes.reshape(2, -1)
    n_amps = flat.shape[1]
    lo = torch.zeros(idx.numel(), dtype=torch.float64, device=idx.device)
    hi = torch.zeros_like(lo)
    carry = torch.zeros((), dtype=torch.float64, device=flat.device)
    step = 1 << 26
    for s in range(0, n_amps, step):
        re = flat[0, s:s + step].double()
        im = flat[1, s:s + step].double()
        cdf = torch.cumsum(re * re + im * im, 0) + carry
        mine = (idx >= s) & (idx < s + cdf.numel())
        k = idx[mine] - s
        hi[mine] = cdf[k]
        lo[mine] = torch.where(k > 0, cdf[(k - 1).clamp(min=0)],
                               cdf[0] - (re[0] * re[0] + im[0] * im[0]))
        carry = cdf[-1]
        del cdf, re, im
    target = u.double() * carry
    return max((lo - target).max().item(), (target - hi).max().item(), 0.0)


def _marginal_tv(torch, planes, samples, k: int):
    """(total-variation distance of the samples' histogram on the low k
    qubits to the exact marginal of |amp|^2, the distance expected from
    multinomial noise alone: sum_i sqrt(p_i (1 - p_i) / (2 pi N)))."""
    flat = planes.reshape(2, -1)
    p = torch.zeros(1 << k, dtype=torch.float64, device=flat.device)
    step = 1 << k
    for s in range(0, flat.shape[1], max(step, 1 << 26)):
        re = flat[0, s:s + max(step, 1 << 26)].double()
        im = flat[1, s:s + max(step, 1 << 26)].double()
        p += (re * re + im * im).reshape(-1, step).sum(0)
    p /= p.sum()
    nshots = samples.numel()
    hist = torch.bincount(samples & (step - 1), minlength=step).double()
    tv = 0.5 * (hist / nshots - p).abs().sum().item()
    expected = torch.sqrt(p * (1 - p) / (2 * np.pi * nshots)).sum().item()
    return tv, expected


def phase_sharded_consumers(torch, one_grad):
    """The consumers of a sharded register at CONSUMER_QUBITS over 4
    shards of the card, each against the same call on one register (see
    the module docstring, phase 40). `one_grad`: phase_adjoint's
    (qubits, ms, energy, gradient) of the one-register gradient the
    sharded one is held against."""
    from quest_tpu_torch import adjoint as AD
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch import evolution as EV
    from quest_tpu_torch import measurement as MS
    from quest_tpu_torch import plan as P
    from quest_tpu_torch import random_ as RNG
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import (VQE_LAYERS, VQE_QUBITS,
                                       flagship_circuit, hea_circuit,
                                       tfim_sum)
    from quest_tpu_torch.ops import expec as E
    from quest_tpu_torch.parallel import make_amp_mesh, shard_planes
    from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape
    t0 = time.perf_counter()
    n = CONSUMER_QUBITS
    mesh = make_amp_mesh(SHARDS, devices=[torch.device(CARD)] * SHARDS)
    rec = {"phase": "sharded_consumers", "n": n, "shards": SHARDS,
           "copies": SHARD_COPIES}
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=CARD)
    random_circuit(n, HAM_STATE_DEPTH, seed=7, entangler="cz").compiled_fused(
        n, device=CARD)(amps)
    one = Qureg(amps=amps.reshape(2, -1), num_qubits=n)
    sq = Qureg(amps=shard_planes(one.amps, mesh, n), num_qubits=n)
    scale = one.amps.abs().max().item()
    eager = {}

    def pair(name, f, tol=CONSUMER_TOL):
        ms1, a = _wall(torch, lambda: f(one))
        ms2, b = _wall(torch, lambda: f(sq))
        err = abs(a - b)
        eager[name] = {"one": a, "sharded": b, "abs_err": err,
                       "one_ms": ms1, "sharded_ms": ms2}
        if not err <= tol:
            raise AssertionError(f"sharded_consumers {name}: {b} vs {a}")

    pair("calc_total_prob", K.calc_total_prob)
    pair("prob_local_q3", lambda q: MS.calc_prob_of_outcome(q, 3, 1))
    pair(f"prob_global_q{n - 1}",
         lambda q: MS.calc_prob_of_outcome(q, n - 1, 1))
    # sampling: the same uniforms through both samplers
    gen = torch.Generator(device=CARD).manual_seed(5)
    u = torch.rand(SAMPLE_SHOTS, generator=gen, dtype=torch.float32,
                   device=CARD)
    ms1, a = _wall(torch, lambda: MS._sample_given_uniforms(
        one.amps, u, n=n, density=False))
    ms2, b = _wall(torch, lambda: MS._sample_sharded_given_uniforms(sq, u))
    b = b.to(a.device)
    # f32 CDFs: where neighbouring indices share one f32 CDF value the two
    # samplers may pick different members of that run (a shard's CDF is
    # finer, its values smaller); each pick is held to the f64 CDF instead
    miss_one = _cdf_miss(torch, one.amps, a, u)
    miss_sharded = _cdf_miss(torch, one.amps, b, u)
    tv, tv_noise = _marginal_tv(torch, one.amps, b, MARGINAL_QUBITS)
    rec["sample"] = {"shots": SAMPLE_SHOTS,
                     "equal_share": (a == b).double().mean().item(),
                     "max_index_distance": int((a - b).abs().max().item()),
                     "cdf_miss_one": miss_one,
                     "cdf_miss_sharded": miss_sharded,
                     "one_ms": ms1, "sharded_ms": ms2,
                     "tv_marginal": tv, "tv_expected_noise": tv_noise,
                     "marginal_qubits": MARGINAL_QUBITS}
    if not (max(miss_one, miss_sharded) <= CDF_MISS_TOL
            and tv <= TV_SLACK * tv_noise):
        raise AssertionError(f"sharded_consumers sample: {rec['sample']}")
    del a, b, u
    # the grouped expectation: one exchange per distinct global flip mask
    codes, coeffs = tfim_sum(n)
    mesh.recorder.reset()
    ms1, ea = _wall(torch, lambda: K.calc_expec_pauli_sum(one, codes,
                                                          coeffs))
    ms2, eb = _wall(torch, lambda: K.calc_expec_pauli_sum(sq, codes,
                                                          coeffs))
    plan = E.plan_expec(E.parse_pauli_sum(codes, n), n, density=False)
    masks = E.global_flip_masks(plan, n - mesh.global_qubits)
    issued = mesh.recorder.stats(SHARDS)
    rel = abs(ea - eb) / max(abs(ea), 1.0)
    rec["expec_tfim"] = {"one": ea, "sharded": eb, "rel_err": rel,
                         "one_ms": ms1, "sharded_ms": ms2,
                         "exchanges": issued["collective_permutes"],
                         "predicted_exchanges": len(masks)}
    if not (rel <= CONSUMER_TOL
            and issued["collective_permutes"] == len(masks)):
        raise AssertionError(f"sharded_consumers expec: "
                             f"{rec['expec_tfim']}")
    # collapse on a global qubit, then a seeded measure
    ms1, (_, pa) = _wall(torch, lambda: MS.collapse_to_outcome(one, n - 1,
                                                               0))
    ms2, (_, pb) = _wall(torch, lambda: MS.collapse_to_outcome(sq, n - 1,
                                                               0))
    cerr = _shard_err(torch, sq.amps.shards, one.amps)
    RNG.seed_quest([11])
    ms3, (_, oa) = _wall(torch, lambda: MS.measure(one, 2))
    RNG.seed_quest([11])
    ms4, (_, ob) = _wall(torch, lambda: MS.measure(sq, 2))
    merr = _shard_err(torch, sq.amps.shards, one.amps)
    eager["collapse_global"] = {"prob_one": pa, "prob_sharded": pb,
                                "max_abs_err": cerr, "one_ms": ms1,
                                "sharded_ms": ms2}
    eager["measure_seeded"] = {"outcome_one": oa, "outcome_sharded": ob,
                               "max_abs_err": merr, "one_ms": ms3,
                               "sharded_ms": ms4}
    if not (abs(pa - pb) <= CONSUMER_TOL and oa == ob
            and max(cerr, merr) <= PATH_TOL * 2 * scale):
        raise AssertionError(f"sharded_consumers collapse/measure: {eager}")
    rec["eager"] = eager
    del one, sq, amps
    _free(torch)
    # gradients on the mesh
    nv = VQE_QUBITS
    circ = hea_circuit(nv, VQE_LAYERS)
    vcodes, vcoeffs = tfim_sum(nv)
    fn2 = AD.value_and_grad(circ, vcodes, coeffs=vcoeffs, mesh=mesh)
    theta = torch.as_tensor(fn2.initial_params, dtype=torch.float32,
                            device=CARD)
    n1, ms1, v1, g1 = one_grad
    if n1 != nv:
        raise AssertionError(f"sharded_consumers: the one-register "
                             f"gradient is at {n1} qubits, not {nv}")
    g1 = g1.to(CARD)
    mesh.recorder.reset()
    base = _reset_peak(torch)
    ms2, (v2, g2) = _wall(torch, lambda: fn2(theta))
    peak = _peak_gib(torch, base)
    issued = mesh.recorder.stats(SHARDS)
    pred = fn2.comm_record
    verr = abs(float(v1) - float(v2)) / max(abs(float(v1)), 1.0)
    gerr = (g1 - g2).abs().max().item()
    rec["value_and_grad"] = {
        "n": nv, "params": fn2.num_params, "energy_one": float(v1),
        "energy_sharded": float(v2), "energy_rel_err": verr,
        "grad_max_abs_err": gerr, "one_ms": ms1, "sharded_ms": ms2,
        "sharded_peak_gib": peak,
        "exchanges": issued["collective_permutes"],
        "predicted_exchanges": pred["collective_permutes"],
        "reductions": issued["all_reduces"]}
    if not (verr <= CONSUMER_TOL and gerr <= GRAD_TOL
            and issued["collective_permutes"] == pred["collective_permutes"]
            and issued["all_to_alls"] == pred["all_to_alls"]
            and issued["all_reduces"] == pred["all_reduces"]):
        raise AssertionError(f"sharded_consumers value_and_grad: "
                             f"{rec['value_and_grad']}")
    del fn2, g1, g2, theta
    _free(torch)
    # the sharded quench: K1 on every shard
    q0 = Qureg(amps=basis_planes(0, n=n, device=CARD), num_qubits=n)
    ms1, r1 = _wall(torch, lambda: EV.run_evolution(
        (codes, coeffs), 0.05, EVOLUTION_STEPS, state=q0))
    want = r1.state.amps.reshape(2, -1)
    (ms2, r2), launches, _ = _counted(torch, lambda: _wall(
        torch, lambda: EV.run_evolution((codes, coeffs), 0.05,
                                        EVOLUTION_STEPS, state=q0,
                                        mesh=mesh, engine="fused")))
    err = _shard_err(torch, r2.state.amps.shards, want)
    escale = want.abs().max().item()
    erel = (np.abs(r1.energies - r2.energies).max()
            / max(np.abs(r1.energies).max(), 1.0))
    rec["evolution"] = {"steps": EVOLUTION_STEPS, "engine":
                        r2.stats["engine"], "max_abs_err": err,
                        "energy_rel_err": float(erel), "one_ms": ms1,
                        "sharded_ms": ms2, "launches": launches,
                        "launches_per_shard": launches // SHARDS}
    if not (err <= PATH_TOL * escale and erel <= CONSUMER_TOL
            and launches and r2.stats["engine"] == "sharded-fused"):
        raise AssertionError(f"sharded_consumers evolution: "
                             f"{rec['evolution']}")
    del r1, r2, q0, want
    _free(torch)
    # the priced sharded search
    c28 = flagship_circuit(SHARDED_QUBITS)
    ms, plan = _wall(torch, lambda: P.autotune(c28, devices=SHARDS,
                                               persist=False))
    rec["autotune"] = {"n": SHARDED_QUBITS, "devices": SHARDS,
                       "engine": plan.engine, "incumbent": plan.incumbent,
                       "priced_ms": plan.cost["total_ms"],
                       "comm_ms": plan.cost["comm_ms"],
                       "candidates": len(plan.candidates), "search_ms": ms}
    if not plan.engine.startswith("sharded-"):
        raise AssertionError(f"sharded_consumers autotune: {plan.engine}")
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


def _durable_run(torch, run, expect_fault=None):
    """(wall ms, K1 launches, result) of one run_durable call with the
    segment counters set to 0 just before it; `expect_fault` the
    FaultPlan that must preempt it."""
    from quest_tpu_torch.resilience import faults
    from quest_tpu_torch.ops import segment as S
    S.segment_sweep.launches = 0
    _sync(torch)
    t0 = time.perf_counter()
    out = None
    if expect_fault is None:
        out = run()
    else:
        with faults.active(expect_fault):
            try:
                run()
            except faults.InjectedFault:
                pass
            else:
                raise AssertionError("durable: the preemption never fired")
    _sync(torch)
    return (time.perf_counter() - t0) * 1e3, S.segment_sweep.launches, out


def _durable_case(torch, circ, n, mesh, root, name):
    """One engine's preempt + resume cycle (phase 41)."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.resilience import FaultPlan
    from quest_tpu_torch.resilience import durable as D
    from quest_tpu_torch.serve import metrics
    from quest_tpu_torch.state import create_qureg
    engine = "sharded" if mesh is not None else "fused"
    q0 = create_qureg(n, device=CARD)
    steps, info = D._build_steps(circ, n, False, engine, mesh,
                                 torch.device(CARD), True)
    nsteps = len(steps)
    if nsteps < 2:
        raise AssertionError(f"durable {name}: {nsteps} step, no cut")
    every = max(1, -(-nsteps // 2))      # one checkpoint before the kill
    # the kill lands on a step after the first checkpoint: a seeded hit
    # of durable.preempt in [every, nsteps)
    after = int(np.random.default_rng(DURABLE_SEED).integers(every,
                                                             nsteps))
    ref_ms, ref_launches, ref = _durable_run(torch, lambda: D.run_durable(
        circ, q0, os.path.join(root, f"{name}-ref"), every=nsteps + 1,
        engine=None if mesh else "fused", mesh=mesh))
    d = os.path.join(root, name)
    plan = FaultPlan().inject("durable.preempt", after_n=after, times=1)
    reg = metrics.Registry()
    pre_ms, pre_launches, _ = _durable_run(torch, lambda: D.run_durable(
        circ, q0, d, every=every, engine=None if mesh else "fused",
        mesh=mesh, registry=reg), expect_fault=plan)
    chain = ckpt.step_dirs(d)
    if not chain:
        raise AssertionError(f"durable {name}: no checkpoint before the kill")
    elastic_copy = None
    if mesh is not None:
        elastic_copy = os.path.join(root, f"{name}-elastic")
        shutil.copytree(d, elastic_copy)
    res_ms, res_launches, out = _durable_run(torch, lambda: D.run_durable(
        circ, q0, d, every=every, engine=None if mesh else "fused",
        mesh=mesh, registry=reg))
    cuts = reg.snapshot()["histograms"]["durable_checkpoint_s"]
    if mesh is None:
        whole = circ.compiled_fused(n, device=CARD)
        want = create_qureg(n, device=CARD).amps
        whole(want)
        same = (torch.equal(out.amps.reshape(2, -1), ref.amps.reshape(2, -1))
                and torch.equal(out.amps.reshape(2, -1), want.reshape(2, -1)))
        planned = whole.launches_per_call
    else:
        from quest_tpu_torch.parallel import shard_planes
        whole = circ.compiled_sharded_fused(n, False, mesh)
        x = shard_planes(create_qureg(n, device=CARD).amps, mesh, n)
        whole(x)
        same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                   zip(out.amps.shards, ref.amps.shards, x.shards))
        planned = whole.launches_per_call
        want = x
    if not (same and ref_launches == planned and ref_launches
            and res_launches):
        raise AssertionError(f"durable {name}: bit-identical {same}, "
                             f"launches {ref_launches} / {res_launches}, "
                             f"planned {planned}")
    rec = {"engine": engine, "steps": nsteps, "every": every,
           "preempted_at_step": after, "checkpoints_in_chain":
           [s for s, _ in chain], "resumed_from_step": chain[-1][0],
           "k1_launches_uninterrupted": ref_launches,
           "k1_launches_preempted": pre_launches,
           "k1_launches_resumed": res_launches,
           "bit_identical": True,
           "checkpoint_gib": 2 * 4 * (1 << n) / GIB,
           "uninterrupted_ms": ref_ms, "preempted_ms": pre_ms,
           "resumed_ms": res_ms,
           "checkpoints_taken": cuts["count"],
           "checkpoint_take_ms_mean": cuts["mean"] * 1e3,
           "resume_extra_ms": pre_ms + res_ms - ref_ms}
    return rec, out, want, elastic_copy


def phase_durable(torch):
    """Durable execution through K1 at DURABLE_QUBITS (phase 41)."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.parallel import make_amp_mesh
    from quest_tpu_torch.resilience import durable as D
    from quest_tpu_torch.serve import metrics
    from quest_tpu_torch.state import create_qureg
    t0 = time.perf_counter()
    n = DURABLE_QUBITS
    circ = random_circuit(n, DURABLE_DEPTH, seed=7, entangler="cz")
    rec = {"phase": "durable", "n": n, "depth": DURABLE_DEPTH}
    root = tempfile.mkdtemp(prefix="quest_durable_")
    try:
        rec["fused"], out1, want1, _ = _durable_case(torch, circ, n, None,
                                                     root, "fused")
        # the hash's share of a checkpoint, measured alone on the final
        # planes (the chains' own checkpoints time the whole write, the
        # resumes the load)
        planes = ckpt._host_planes(out1.amps)
        t1 = time.perf_counter()
        ckpt._plane_digests({"planes": planes})
        rec["checkpoint"] = {"gib": planes.nbytes / GIB,
                             "hash_ms": (time.perf_counter() - t1) * 1e3}
        del want1, out1, planes
        _free(torch)
        mesh = make_amp_mesh(SHARDS, devices=[torch.device(CARD)] * SHARDS)
        rec["sharded"], out, _, chain = _durable_case(torch, circ, n, mesh,
                                                      root, "sharded")
        rec["sharded"]["shards"] = SHARDS
        # the 4-shard chain re-entered on one register
        reg = metrics.Registry()
        ms, launches, el = _durable_run(torch, lambda: D.run_durable(
            circ, create_qureg(n, device=CARD), chain, engine="fused",
            every=10 ** 6, elastic=True, registry=reg))
        single = create_qureg(n, device=CARD).amps
        circ.compiled_fused(n, device=CARD)(single)
        single = single.reshape(2, -1)
        err = plane_err(el.amps.reshape(2, -1), single)
        scale = single.abs().max().item()
        snap = reg.snapshot()["counters"]
        rec["elastic_to_one_register"] = {
            "max_abs_err": err, "rel_err": err / scale, "ms": ms,
            "k1_launches": launches,
            "elastic_resumes": snap.get("durable_elastic_resumes", 0),
            "steps_run": snap.get("durable_steps_run", 0),
            "skipped_to_op0": not snap.get("durable_resumes", 0)}
        if not (err <= PATH_TOL * scale and launches):
            raise AssertionError(f"durable elastic: "
                                 f"{rec['elastic_to_one_register']}")
        del el, single
        _free(torch)
        # an asynchronous sharded save while the register keeps evolving
        snap_planes = [s.clone() for s in out.amps.shards]
        step = circ.compiled_sharded_fused(n, False, mesh)
        t1 = time.perf_counter()
        pending = ckpt.save_sharded(out, os.path.join(root, "async"),
                                    block=False)
        return_ms = (time.perf_counter() - t1) * 1e3
        ms_evolve, _ = _wall(torch, lambda: step(out.amps))
        t1 = time.perf_counter()
        pending.wait()
        wait_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        back = ckpt.load_sharded(os.path.join(root, "async"), mesh=mesh)
        load_ms = (time.perf_counter() - t1) * 1e3
        same = all(torch.equal(a.reshape(2, -1), b.reshape(2, -1))
                   for a, b in zip(back.amps.shards, snap_planes))
        moved = not all(torch.equal(a.reshape(2, -1), b.reshape(2, -1))
                        for a, b in zip(out.amps.shards, snap_planes))
        rec["async_save_sharded"] = {
            "return_ms": return_ms, "evolve_while_writing_ms": ms_evolve,
            "wait_ms": wait_ms, "load_ms": load_ms,
            "restored_equals_snapshot": same, "register_moved_on": moved,
            "gib": 2 * 4 * (1 << n) / GIB}
        if not (same and moved):
            raise AssertionError(f"durable async save: "
                                 f"{rec['async_save_sharded']}")
        del out, back, snap_planes, step
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free(torch)
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    return rec


SERVE_TRAJ_QUBITS = 24        # entry.noisy_rcs_circuit(24, 3): 8 GiB chunks
SERVE_TRAJ_DEPTH = 3
SERVE_TRAJ_SHOTS = 64
SERVE_TRAJ_SEEDS = (0, 1, 2, 3)
SERVE_OBS_STATES = 64
SERVE_LADDER_QUBITS = 12
SERVE_LADDER_REQUESTS = 8
SERVE_COOLDOWN_S = 2.0
OBS_REL_TOL = 1e-5


def cpu_name() -> str:
    """The host CPU's model name and logical cores (/proc/cpuinfo)."""
    model = "unknown CPU"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} logical cores"


def _serve_run(torch, eng, circ, states, reg, warm=None):
    """Submit every state at once (after `warm`, one request a program
    family whose build is not timed) and wait: (requests/s, wall s,
    outputs, K1 launches), the counters set to 0 just before the
    submits. `circ` is a circuit or a tuple of program families, which
    the states take in turn."""
    from quest_tpu_torch.ops import segment as S
    circs = circ if isinstance(circ, tuple) else (circ,)
    if warm is not None:
        for c in circs:
            eng.submit(c, state=warm).result(timeout=600)
    _sync(torch)
    S.segment_sweep.launches = 0
    t0 = time.perf_counter()
    futs = [eng.submit(circs[i % len(circs)], state=s)
            for i, s in enumerate(states)]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    return len(states) / wall, wall, outs, S.segment_sweep.launches


def _alone_err(torch, fn, states, outs, batch=64):
    """max |served - alone| and max|amp| over every state, each state
    alone through `fn` (compiled_fused) on the card, `batch` at a time
    for the comparison."""
    err = scale = 0.0
    for lo in range(0, len(states), batch):
        want = []
        for s in states[lo:lo + batch]:
            x = torch.from_numpy(s).to(CARD)
            fn(x)
            want.append(x)
        want = torch.stack(want)
        got = torch.stack(outs[lo:lo + batch]).to(CARD)
        err = max(err, (got - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        del want, got
    return err, scale


def _stage_kinds(segments):
    """The stage kinds a plan's segments hold (the kernels it launches)."""
    return sorted({label for seg in segments for label in seg.labels})


def _stream(rec, name, r):
    """Keep one stream's record in the phase's and print it at once, so
    a failing gate after it leaves its numbers in the output."""
    rec[name] = r
    emit_card({"phase": "serve", "stream": name, **r})


def _latency(reg, snap=None):
    """p50 / p99 end-to-end latency and mean batch occupancy from `reg`
    (or from a snapshot, e.g. the merge of a process fleet's workers')."""
    h = (reg.snapshot() if snap is None else snap)["histograms"]
    lat = h.get("serve_e2e_latency_s", {})
    occ = h.get("serve_batch_occupancy", {})
    return {"p50_ms": lat.get("p50", 0.0) * 1e3,
            "p99_ms": lat.get("p99", 0.0) * 1e3,
            "mean_occupancy": occ.get("mean", 0.0)}


# the bench's 512 serving states (4 GiB), drawn on a host thread from the
# start of the run: numpy fills them without the GIL while the kernels
# build and the earlier phases run
SERVE_STATES = {}


def prefetch_serve_states() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from quest_tpu_torch import entry as E
    pool = ThreadPoolExecutor(1)
    SERVE_STATES["future"] = pool.submit(E.serve_states, E.SERVE_QUBITS,
                                         E.SERVE_STATES)
    pool.shutdown(wait=False)


def _serve_apply(torch, rec):
    """The bench's serving workload at saturation and without
    coalescing; returns the apply kernel row's numbers."""
    from quest_tpu_torch import entry as E
    from quest_tpu_torch.serve import ServeEngine, metrics
    n, mb = E.SERVE_QUBITS, E.SERVE_MAX_BATCH
    circ = E.serve_circuit(n)
    t0 = time.perf_counter()
    states = SERVE_STATES.pop("future").result()
    rec["states_s"] = time.perf_counter() - t0     # the wait for them
    fn = circ.compiled_fused(n, device=CARD)
    out = {}
    for mode, wait in (("saturation", E.SERVE_WAIT_MS), ("no_coalescing", 0)):
        reg = metrics.Registry()
        with ServeEngine(device=CARD, max_wait_ms=wait, max_batch=mb,
                         registry=reg) as eng:
            rps, wall, outs, launches = _serve_run(
                torch, eng, circ, states, reg,
                warm=states[0] if mode == "saturation" else None)
            health = eng.health()
        snap = reg.snapshot()["counters"]
        err, scale = _alone_err(torch, fn, states, outs)
        r = {"requests_per_s": rps, "wall_s": wall,
             "batches": snap.get("serve_batches_dispatched", 0),
             "k1_launches": launches,
             "degraded_dispatches": snap.get("serve_degraded_dispatches", 0),
             "max_abs_err": err, "rel_err": err / scale, **_latency(reg)}
        out[mode] = r
        del outs
        _free(torch)
        _stream(rec, f"apply_{mode}", r)
        if not (err <= PATH_TOL * scale and r["degraded_dispatches"] == 0
                and health["open_breakers"] == 0 and launches > 0):
            raise AssertionError(f"serve {mode}: {r}")
    sat = out["saturation"]
    limit = -(-E.SERVE_STATES // mb) + 1
    if sat["batches"] > limit:
        raise AssertionError(f"serve saturation: {sat['batches']} batches "
                             f"> {limit}")
    out["speedup"] = (sat["requests_per_s"]
                      / out["no_coalescing"]["requests_per_s"])
    out["stage_kinds"] = _stage_kinds(fn.segments)
    rec["apply"] = out
    out["stage_kinds"] = _stage_kinds(fn.segments)
    # the kernel row: one full batch of the stream through K1 and through
    # its plain version, on the same inputs
    batch = torch.from_numpy(states[:mb]).to(CARD)
    x = batch.clone()
    fn(x)
    want = fn.plain(batch)
    err = (x - want).abs().max().item()
    row = {"launches": sat["k1_launches"], "max_abs_err": err,
           "ms": time_ms(torch, lambda: fn(x), 5),
           "plain_ms": time_ms(torch, lambda: fn.plain(batch), 1)}
    # the least the function needs: its gates' flops and one read and
    # one write of the batch (the plan's bands do more of both)
    row["bound_ms"], row["bound_by"] = gate_bound(circ, mb)
    row["plan_bound_ms"], row["plan_bound_by"] = bound_of(fn.segments,
                                                          batch=mb)
    if not err <= PATH_TOL * want.abs().max().item():
        raise AssertionError(f"serve apply kernel vs plain: {err}")
    del batch, x, want
    _free(torch)
    return circ, states, row


def _serve_observable(torch, rec, circ, states):
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.entry import tfim_sum
    from quest_tpu_torch.ops.expec import PauliSum
    from quest_tpu_torch.serve import ServeEngine, metrics
    from quest_tpu_torch.state import Qureg
    n = circ.num_qubits
    codes, coeffs = tfim_sum(n)
    spec = PauliSum.of(codes, coeffs, n)
    picks = states[:SERVE_OBS_STATES]
    reg = metrics.Registry()
    with ServeEngine(device=CARD, max_wait_ms=5, registry=reg) as eng:
        t0 = time.perf_counter()
        futs = [eng.submit(circ, state=s, observable=spec) for s in picks]
        vals = [float(f.result(timeout=600)) for f in futs]
        wall = time.perf_counter() - t0
    fn = circ.compiled_fused(n, device=CARD)
    worst = 0.0
    for s, v in zip(picks, vals):
        x = torch.from_numpy(s).to(CARD)
        fn(x)
        want = K.calc_expec_pauli_sum(Qureg(amps=x, num_qubits=n), codes,
                                      coeffs)
        worst = max(worst, abs(v - want) / max(abs(want), 1.0))
    r = {"requests": len(picks), "wall_s": wall,
         "requests_per_s": len(picks) / wall, "max_rel_err": worst,
         "batches": reg.counter("serve_batches_dispatched").value,
         "degraded_dispatches": reg.counter(
             "serve_degraded_dispatches").value, **_latency(reg)}
    _stream(rec, "observable", r)
    if not (worst <= OBS_REL_TOL and r["degraded_dispatches"] == 0):
        raise AssertionError(f"serve observable: {r}")


def _serve_trajectories(torch, rec):
    """Four coalesced trajectory requests against run_batched; returns
    the trajectory kernel row's numbers."""
    from quest_tpu_torch import entry as E
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.serve import ServeEngine, metrics
    n, k = SERVE_TRAJ_QUBITS, SERVE_TRAJ_SHOTS
    circ = E.noisy_rcs_circuit(n, SERVE_TRAJ_DEPTH)
    prog = T._compiled_traj(circ, n, CARD)
    warm = torch.rand((8, prog.num_channels), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(99))
    prog(warm)
    reg = metrics.Registry()
    with ServeEngine(device=CARD, max_wait_ms=10_000, max_batch=k,
                     registry=reg) as eng:
        _sync(torch)
        S.segment_sweep.launches = 0
        S.segment_sweep.stage_launches = {}
        t0 = time.perf_counter()
        futs = [eng.submit(circ, shots=k, seed=s, observable=E.z_top)
                for s in SERVE_TRAJ_SEEDS]
        eng.drain(timeout_s=1200)
        got = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = S.segment_sweep.launches
        stage_launches = dict(S.segment_sweep.stage_launches)
    chunks = reg.counter("serve_batches_dispatched").value
    draws_equal, err = True, 0.0
    for s, (vals, draws) in zip(SERVE_TRAJ_SEEDS, got):
        wv, wd = T.run_batched(circ, k, generator=torch.Generator()
                               .manual_seed(s), observable=E.z_top,
                               device=CARD)
        draws_equal = draws_equal and torch.equal(draws, wd.cpu())
        err = max(err, (vals - wv.cpu()).abs().max().item())
    u = torch.rand((k, prog.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    chunk_ms = time_ms(torch, lambda: prog(u), 3)
    r = {"n": n, "requests": len(SERVE_TRAJ_SEEDS), "shots": k,
         "chunks": chunks, "wall_s": wall,
         "ms_per_request": wall * 1e3 / len(SERVE_TRAJ_SEEDS),
         "ms_per_chunk_served": wall * 1e3 / max(chunks, 1),
         "chunk_ms": chunk_ms, "k1_launches": launches,
         "stage_launches": stage_launches,
         "planned_per_chunk": prog.launches_per_call,
         "stage_kinds": _stage_kinds(prog.segments),
         "draws_equal": draws_equal, "max_abs_err": err,
         "degraded_dispatches": reg.counter(
             "serve_degraded_dispatches").value}
    _stream(rec, "trajectories", r)
    if not (draws_equal and err <= PATH_TOL
            and launches == prog.launches_per_call * chunks
            and stage_launches.get("batchsel", 0) > 0
            and r["degraded_dispatches"] == 0):
        raise AssertionError(f"serve trajectories: {r}")
    # the kernel row: 8 shots of the stream through K1 and the plain path
    u8 = u[:PLAIN_CHECK_SHOTS]
    pk, dk = prog(u8)
    pp, dp = prog.plain(u8)
    kerr = (pk - pp).abs().max().item()
    row = {"launches": stage_launches.get("batchsel", 0),
           "max_abs_err": kerr,
           "ms": time_ms(torch, lambda: prog(u8), 3),
           "plain_ms": time_ms(torch, lambda: prog.plain(u8), 1)}
    row["bound_ms"], row["bound_by"] = gate_bound(
        circ, PLAIN_CHECK_SHOTS, dk.cpu(), prog.channel_info)
    row["plan_bound_ms"], row["plan_bound_by"] = trajectory_bound(
        prog, PLAIN_CHECK_SHOTS)
    if not (torch.equal(dk, dp) and kerr <= PATH_TOL * pp.abs().max().item()):
        raise AssertionError(f"serve trajectory kernel vs plain: {kerr}")
    del pk, pp, dk, dp
    _free(torch)
    return circ, row


def _serve_ladder(torch, rec):
    """fused -> banded -> host by injected build failures, and back. The
    rung each request took is read from the counters around it: a
    degraded dispatch whose banded build was failed ran on host."""
    from quest_tpu_torch.entry import flagship_circuit, serve_states
    from quest_tpu_torch.resilience import FaultPlan, faults
    from quest_tpu_torch.serve import ServeEngine, metrics
    n = SERVE_LADDER_QUBITS
    circ = flagship_circuit(n)
    states = serve_states(n, SERVE_LADDER_REQUESTS, 3)
    fn = circ.compiled_fused(n, device=CARD)
    reg = metrics.Registry()
    degraded = reg.counter("serve_degraded_dispatches")
    fused_fails = FaultPlan().inject(
        "serve.compile", error=RuntimeError("injected fused build failure"),
        times=2, match=lambda ctx: ctx["rung"] == "fused")
    banded_fails = FaultPlan().inject(
        "serve.compile", error=RuntimeError("injected banded build failure"),
        times=2, match=lambda ctx: ctx["rung"] == "banded")
    outs, rungs = [], []
    with ServeEngine(device=CARD, max_wait_ms=0, breaker_threshold=2,
                     breaker_cooldown_s=SERVE_COOLDOWN_S,
                     registry=reg) as eng:
        def one(i, plan):
            d0, b0 = degraded.value, banded_fails.fired()
            with faults.active(plan):
                fut = eng.submit(circ, state=states[i])
                try:
                    got = fut.result(timeout=600)
                except RuntimeError as e:
                    # a closed breaker fails the request with its build's
                    # error instead of stepping down the ladder
                    if "injected fused build failure" not in str(e):
                        raise
                    rungs.append("failed")
                    return
            outs.append((i, got))
            rungs.append("fused" if degraded.value == d0 else
                         "host" if banded_fails.fired() > b0 else "banded")
        for i in range(4):      # 2 failures fail theirs and open the breaker
            one(i, fused_fails)
        opened = eng.health()["open_breakers"]
        for i in range(4, 6):              # open, and banded fails too
            one(i, banded_fails)
        time.sleep(SERVE_COOLDOWN_S * 1.1)
        for i in range(6, SERVE_LADDER_REQUESTS):
            one(i, None)                   # the probe, then fused
        health = eng.health()
    snap = reg.snapshot()["counters"]
    err = scale = 0.0
    for i, got in outs:
        x = torch.from_numpy(states[i]).to(CARD)
        fn(x)
        err = max(err, (got - x.reshape(2, -1).cpu()).abs().max().item())
        scale = max(scale, x.abs().max().item())
    expected = (["failed"] * 2 + ["banded"] * 2 + ["host"] * 2
                + ["fused"] * (SERVE_LADDER_REQUESTS - 6))
    r = {"n": n, "requests": len(states), "rungs": rungs,
         "stage_kinds": _stage_kinds(fn.segments),
         "degraded_dispatches": snap.get("serve_degraded_dispatches", 0),
         "breaker_opens": snap.get("serve_breaker_opens", 0),
         "breaker_probes": snap.get("serve_breaker_probes", 0),
         "breaker_closes": snap.get("serve_breaker_closes", 0),
         "faults_injected": snap.get("serve_faults_injected", 0),
         "open_after_failures": opened, "open_at_end":
         health["open_breakers"], "max_abs_err": err, "rel_err": err / scale}
    _stream(rec, "ladder", r)
    if not (rungs == expected
            and r["degraded_dispatches"] == sum(x in ("banded", "host")
                                                for x in rungs)
            and opened == 1 and r["breaker_closes"] == 1
            and r["open_at_end"] == 0 and r["faults_injected"] == 4
            and err <= PATH_TOL * scale):
        raise AssertionError(f"serve ladder: {r}")


def _serve_host(torch, rec, rot, traj):
    """compiled_host against K1: the rotation circuit and the trajectory
    circuit's first unitary stretch."""
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.entry import serve_states
    stretch = Circuit(traj.num_qubits)
    for op in traj.ops:
        if op.kind == "superop":
            break
        stretch.ops.append(op)
    r = {"cpu": cpu_name(), **rec["native_library"]}
    for name, circ in (("rotations", rot), ("traj_stretch", stretch)):
        n = circ.num_qubits
        s = serve_states(n, 1, 5)[0]
        t0 = time.perf_counter()
        step = circ.compiled_host(n, False)
        prep_s = time.perf_counter() - t0
        h = torch.from_numpy(s.copy())
        t0 = time.perf_counter()
        step(h)
        host_ms = (time.perf_counter() - t0) * 1e3
        fn = circ.compiled_fused(n, device=CARD)
        x = torch.from_numpy(s).to(CARD)
        xk = x.clone()
        fn(xk)
        err = (h - xk.cpu()).abs().max().item()
        scale = xk.abs().max().item()
        k1_ms = time_ms(torch, lambda: fn(x), 5)
        reps = [host_ms]
        for _ in range(2):
            t0 = time.perf_counter()
            step(h)
            reps.append((time.perf_counter() - t0) * 1e3)
        r[name] = {"n": n, "ops": len(circ.ops), "prep_s": prep_s,
                   "host_ms_per_state": statistics.median(reps),
                   "k1_ms_per_state": k1_ms, "max_abs_err": err,
                   "rel_err": err / scale}
        if not err <= PATH_TOL * scale:
            raise AssertionError(f"serve host {name}: {r[name]}")
        del x, xk, h
    _stream(rec, "host", r)


def phase_serve(torch):
    """ServeEngine on the card over the batched K1, with the native host
    engine as the ladder's floor (phase 42); returns the kernel rows of
    the apply and trajectory streams."""
    from quest_tpu_torch import native
    t0 = time.perf_counter()
    rec = {"phase": "serve"}
    # the ladder's floor is built first, apart from every timed run
    prebuilt = native.library_path().exists()
    rec["native_library"] = {"library_prebuilt": prebuilt,
                             "build_s": native.build()}
    rot, states, apply_row = _serve_apply(torch, rec)
    _serve_observable(torch, rec, rot, states)
    # the fleet phase reuses a slice of the drawn states (a copy: a view
    # would keep all of them alive)
    fleet_states = states[:FLEET_STATES].copy()
    del states
    traj, traj_row = _serve_trajectories(torch, rec)
    _serve_ladder(torch, rec)
    _serve_host(torch, rec, rot, traj)
    rec["kernel_rows"] = {"serve": apply_row, "serve_traj": traj_row}
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    _free(torch)
    return apply_row, traj_row, (rot, fleet_states)


FLEET_STATES = 128            # the serve phase's first 128 states
FLEET_HEARTBEAT_S = 1.0       # a worker is lost after 4 s of silence
FLEET_TRAJ_QUBITS = 20
FLEET_TRAJ_SHOTS = 32
FLEET_HELD = 48               # requests held in flight for the SIGKILL
FLEET_QUEUE = 64              # max_queue of the autoscaled fleet


def _fresh_heartbeats(fleet, after: float, timeout: float = 30.0):
    """Each live worker's first heartbeat that arrived after `after`
    (time.monotonic())."""
    deadline = time.monotonic() + timeout
    beats = []
    for e in fleet._engines:
        if e.state != "running":
            continue
        while e.heartbeat().get("rx_t", 0.0) <= after:
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: no heartbeat from {e.name}")
            time.sleep(0.05)
        beats.append(e.heartbeat())
    return beats


def _worker_launches(fleet):
    """K1 launches each live worker counted, from a fresh heartbeat."""
    return [hb.get("kernels", {}).get("launches", 0)
            for hb in _fresh_heartbeats(fleet, time.monotonic())]


def _fleet_run(torch, fleet, circ, states, reg):
    """_serve_run through a process fleet: K1 launches are read from
    the workers' heartbeats just before and just after the submits. The
    warm requests go one at a time, so each new family of `circ` is
    pinned to the next idle replica in turn."""
    for c in circ:
        fleet.submit(c, state=states[0]).result(timeout=600)
    before = _worker_launches(fleet)
    rps, wall, outs, _ = _serve_run(torch, fleet, circ, states, reg)
    after = _worker_launches(fleet)
    return rps, wall, outs, [b - a for a, b in zip(before, after)]


def phase_fleet(torch, served=None):
    """The serving fleet on the card (phase 43): thread and process
    replicas, the SIGKILL respawn and the autoscaler over the serve
    phase's circuit and first FLEET_STATES states (`served`; drawn here
    when the phase runs alone)."""
    import signal

    from quest_tpu_torch import entry as E
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.ops.expec import PauliSum, resolve_observable
    from quest_tpu_torch.serve import (Autoscaler, ServeEngine, ServeFleet,
                                       metrics)
    t0 = time.perf_counter()
    rec = {"phase": "fleet", "states": FLEET_STATES}
    n, mb = E.SERVE_QUBITS, E.SERVE_MAX_BATCH
    if served is None:
        circ, states = E.serve_circuit(n), E.serve_states(n, FLEET_STATES)
    else:
        circ, states = served
    # two program families of one circuit (equal ops, two objects): the
    # fleet pins each to its own replica, so both workers serve batches
    # at once; every stream below interleaves them
    fams = (circ, E.serve_circuit(n))
    kw = dict(device=CARD, max_wait_ms=E.SERVE_WAIT_MS, max_batch=mb)
    card = CARD == "cuda"

    # one engine in this process: the outputs every fleet is held to
    reg = metrics.Registry()
    with ServeEngine(registry=reg, **kw) as eng:
        rps, wall, want, launches = _serve_run(torch, eng, fams, states,
                                               reg, warm=states[0])
    rec["one_engine"] = {"requests_per_s": rps, "wall_s": wall,
                         "k1_launches": launches, **_latency(reg)}
    _free(torch)
    reg = metrics.Registry()
    with ServeFleet(replicas=2, process=False, registry=reg, **kw) as fl:
        rps, wall, outs, launches = _serve_run(torch, fl, fams, states,
                                               reg, warm=states[0])
    rec["thread_fleet"] = {
        "requests_per_s": rps, "wall_s": wall, "k1_launches": launches,
        "identical": all(torch.equal(a, b) for a, b in zip(outs, want)),
        **_latency(reg)}
    del outs
    _free(torch)

    # (a) two worker processes on the card, each with its own context
    free0 = torch.cuda.mem_get_info()[0] if card else None
    reg = metrics.Registry()
    tb = time.perf_counter()
    fl = ServeFleet(replicas=2, process=True, registry=reg,
                    heartbeat_s=FLEET_HEARTBEAT_S, **kw)
    try:
        boot = {"wall_s": time.perf_counter() - tb,
                "cold_s": [e.hello()["boot_s"] for e in fl._engines]}
        if card:
            free1 = torch.cuda.mem_get_info()[0]
            boot["context_bytes_per_worker"] = (free0 - free1) / 2
            boot["worker_view_at_hello"] = [e.hello()["cuda"]
                                            for e in fl._engines]
        rps, wall, outs, per_worker = _fleet_run(torch, fl, fams, states,
                                                 reg)
        same = all(torch.equal(a, b) for a, b in zip(outs, want))
        beats = _fresh_heartbeats(fl, time.monotonic())
        served_by = [hb["snapshot"]["counters"].get(
            "serve_requests_served", 0) for hb in beats]
        # latency from the workers' registries (the warm request
        # included; quantiles: the worst worker's)
        merged = metrics.merge_snapshots([hb["snapshot"] for hb in beats])
        a = {"requests_per_s": rps, "wall_s": wall, "identical": same,
             "k1_launches_per_worker": per_worker,
             "requests_per_worker": served_by,
             "spills": reg.counter("fleet_affinity_spills").value,
             **_latency(None, merged)}
        if card:
            a["worker_card_memory"] = [hb.get("cuda") for hb in beats]
        rec["boot"], rec["process_fleet"] = boot, a
        emit_card({"phase": "fleet", "stream": "process_fleet", **a})
        del outs
        if not same:
            raise AssertionError(f"fleet (a): outputs differ: {a}")
        # both workers served and launched K1 in the timed stream
        if not (len(served_by) == 2 and all(r > 0 for r in served_by)
                and (not card or all(k > 0 for k in per_worker))):
            raise AssertionError(f"fleet (a): not both workers: {a}")

        # (c) trajectory draws through the process fleet
        nq = FLEET_TRAJ_QUBITS
        tcirc = E.noisy_rcs_circuit(nq, SERVE_TRAJ_DEPTH)
        spec = PauliSum.of([[0] * (nq - 1) + [3]], [1.0], nq)
        g = torch.Generator().manual_seed(17)
        ref = [T.run_batched(tcirc, FLEET_TRAJ_SHOTS, generator=g,
                             observable=resolve_observable(spec, nq),
                             device=CARD) for _ in range(2)]
        gen = torch.Generator().manual_seed(17)
        tt = time.perf_counter()
        futs = [fl.submit(tcirc, shots=FLEET_TRAJ_SHOTS, generator=gen,
                          observable=spec) for _ in range(2)]
        got = [f.result(timeout=600) for f in futs]
        c_rec = {"wall_s": time.perf_counter() - tt,
                 "draws_equal": all(torch.equal(gd, rd.cpu()) for (_, gd),
                                    (_, rd) in zip(got, ref)),
                 "generator_equal": torch.equal(gen.get_state(),
                                                g.get_state()),
                 "max_abs_err": max((gv - rv.cpu()).abs().max().item()
                                    for (gv, _), (rv, _) in zip(got, ref))}
        rec["trajectories"] = c_rec
        if not (c_rec["draws_equal"] and c_rec["generator_equal"]
                and c_rec["max_abs_err"] <= PATH_TOL):
            raise AssertionError(f"fleet (c): {c_rec}")
    finally:
        fl.close(timeout_s=120)
    _free(torch)

    # (b) + (d): one card worker with a held backlog; the autoscaler
    # grows the fleet to 2, the first worker is SIGKILLed with the
    # backlog in flight, and the drained fleet shrinks back to 1
    reg = metrics.Registry()
    fb = ServeFleet(replicas=1, process=True, registry=reg, device=CARD,
                    max_wait_ms=600_000, max_batch=mb, max_queue=FLEET_QUEUE,
                    heartbeat_s=FLEET_HEARTBEAT_S)
    try:
        auto = Autoscaler(fb, min_replicas=1, max_replicas=2, up_ticks=2,
                          down_ticks=2, cooldown_ticks=1, high_water=0.5,
                          low_water=0.1)
        held = states[:FLEET_HELD]
        futs = [fb.submit(circ, state=s) for s in held]
        seen = [fb.replicas]
        for _ in range(3):
            auto.tick()
            seen.append(fb.replicas)
        grown = max(seen)
        victim = fb._engines[0]
        in_flight = victim._pending
        tk = time.perf_counter()
        os.kill(victim.worker_pid(), signal.SIGKILL)
        fb.drain(timeout_s=600)
        outs = [f.result(timeout=600) for f in futs]
        recovery = time.perf_counter() - tk
        snap = reg.snapshot()["counters"]
        b = {"in_flight_at_kill": in_flight, "recovery_s": recovery,
             "identical": all(torch.equal(x, y)
                              for x, y in zip(outs, want[:FLEET_HELD])),
             "losses": snap.get("ipc_worker_losses", 0),
             "respawns": snap.get("ipc_worker_respawns", 0),
             "resubmits": snap.get("ipc_resubmits", 0),
             "respawn_boot_s": victim.hello()["boot_s"]}
        del outs
        for _ in range(8):
            if fb.replicas == 1:
                break
            auto.tick()
            seen.append(fb.replicas)
        d = {"replicas_seen": seen, "actions": auto.stats()["actions"],
             "scale_ups": snap.get("fleet_scale_ups", 0),
             "added_boot_s": (fb._engines[1].hello().get("boot_s")
                              if len(fb._engines) > 1 else None)}
        rec["sigkill"], rec["autoscaler"] = b, d
        rec["boot"]["warm_s"] = [b["respawn_boot_s"], d["added_boot_s"]]
        # exactly the loss this phase caused: a worker streaming its
        # results back is alive, never lost for a late heartbeat
        if not (in_flight >= 32 and b["identical"] and b["losses"] == 1
                and b["respawns"] == 1 and b["resubmits"] == in_flight):
            raise AssertionError(f"fleet (b): {b}")
        if not (grown == 2 and seen[-1] == 1
                and all(1 <= r <= 2 for r in seen)):
            raise AssertionError(f"fleet (d): {d}")
    finally:
        fb.close(timeout_s=120)
    rec["seconds"] = time.perf_counter() - t0
    emit_card(rec)
    _free(torch)
    return rec



TRACE_TOL = 0.10              # kernels' summed device time vs the step
STAGE_REPORT_QUBITS = 30      # where the H100 cost model is scaled to
STAGE_REPORT_REPS = 5
STAGE_REPORT_TOL = 1e-4       # x max|amp|, and |1 - norm|
# K1's instantiations, ring_kernel<T, true>, as the trace names them
# (demangled: "void (anonymous namespace)::ring_kernel<0, true>(...)")
K1_NAME = ("ring_kernel<", ", true>")


def smoke_dir(*parts) -> str:
    """A path under smoke_out/ beside this script (git-ignored)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "smoke_out", *parts)


def phase_profiling(torch):
    """The profiling surface on the card: (a) the flagship step once
    inside profiling.trace and profiling.annotate("flagship"): the
    device kernels the region launched (read back from the trace's
    JSON) must be exactly the program's planned K1 launches, their
    summed device time within TRACE_TOL of the same call's CUDA-event
    time; the traced step beside the untraced one (the profiler's
    cost); (b) profiling.op_metrics of the flagship (one counted call)
    equal to program_bound's count of the same program; (c)
    profiling.stage_report at 30 qubits, every case held against its
    plain version (STAGE_REPORT_TOL), each case's ms, the cost model's
    band and the verdict (a DRIFT is a finding, not a failure)."""
    from quest_tpu_torch import profiling as P
    from quest_tpu_torch.entry import entry
    t0 = time.perf_counter()
    fn, (amps,) = entry()
    fn(amps)
    torch.cuda.synchronize()
    untraced_ms = time_ms(torch, lambda: fn(amps), 5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with P.trace(smoke_dir("trace")) as tr:
        with P.annotate("flagship"):
            start.record()
            fn(amps)
            end.record()
            torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    kernels = P.annotated_kernels(tr.path, "flagship")
    names = sorted({k["name"] for k in kernels})
    kernel_ms = sum(k["dur"] for k in kernels) / 1e3
    planned = fn.launches_per_call
    rec = {"phase": "profiling", "trace": os.path.relpath(
        tr.path, smoke_dir()), "trace_bytes": os.path.getsize(tr.path),
        "planned_launches": planned, "traced_kernels": len(kernels),
        "kernel_names": names, "kernel_ms": kernel_ms, "step_ms": step_ms,
        "untraced_step_ms": untraced_ms,
        "trace_overhead": step_ms / untraced_ms - 1.0}
    if len(kernels) != planned or not all(
            all(part in name for part in K1_NAME) for name in names):
        emit(rec)
        raise AssertionError(f"profiling: the trace holds {len(kernels)} "
                             f"kernels {names} in 'flagship', the program "
                             f"plans {planned} K1 launches")
    if abs(kernel_ms - step_ms) > TRACE_TOL * step_ms:
        emit(rec)
        raise AssertionError(f"profiling: traced kernels {kernel_ms} ms "
                             f"against the step's {step_ms} ms")
    metrics = P.op_metrics(fn, amps)
    want = program_bound(fn)
    rec["op_metrics"] = metrics
    rec["program_bound"] = list(want)
    if ((metrics["bound_ms"], metrics["bound_by"]) != want
            or metrics["segment_launches"] != planned):
        emit(rec)
        raise AssertionError(f"profiling: op_metrics {metrics} against "
                             f"program_bound {want}")
    del fn, amps
    torch.cuda.empty_cache()
    report = P.stage_report(n=STAGE_REPORT_QUBITS, reps=STAGE_REPORT_REPS,
                            out=sys.stdout, check=True)
    rec["stage_report"] = report
    bad = {k: (r["max_abs_err"], r["max_amp"], r["norm"])
           for k, r in report.items()
           if not (r["max_abs_err"] <= STAGE_REPORT_TOL * r["max_amp"]
                   and abs(1.0 - r["norm"]) <= STAGE_REPORT_TOL)}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if bad:
        raise AssertionError(f"stage_report against the plain version: "
                             f"{bad}")
    return rec


def phase_audit(torch):
    """The runtime audits on the card (analysis/audit.py), at the fused
    engine's smallest width (10 qubits): golden_retrace_check (a second
    pass over the golden set builds no program and loads no library)
    and audit_knob_flips over every keyed knob (a same-value rerun
    builds nothing, every flip misses the per-gate, banded and fused
    caches); the driver and tier flips must launch the kernel under the
    flipped driver (K2, K3) and build at the flipped tier."""
    from quest_tpu_torch.analysis import audit as A
    from quest_tpu_torch.env import KNOBS
    from quest_tpu_torch.ops import segment as S
    t0 = time.perf_counter()
    golden = A.golden_retrace_check(device="cuda")
    S.segment_sweep.launches = 0
    S.segment_sweep.driver_launches = {}
    report = A.audit_knob_flips(device="cuda")
    torch.cuda.synchronize()
    by_knob = {r["knob"]: r for r in report}
    keyed = {k.name for k in KNOBS.values() if k.scope == "keyed"}
    rec = {"phase": "audit", "golden_builds": golden.traces,
           "knobs": report, "launches": S.segment_sweep.launches,
           "driver_launches": dict(S.segment_sweep.driver_launches),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if set(by_knob) != keyed:
        raise AssertionError(f"audit: audited {sorted(by_knob)}, keyed "
                             f"{sorted(keyed)}")
    flipped = (by_knob["QUEST_FUSED_DRIVER"]["fused_driver"],
               by_knob["QUEST_FUSED_PIPELINE"]["fused_driver"],
               by_knob["QUEST_MATMUL_PRECISION"]["fused_tier"])
    if flipped != ("grid", "inplace", "high") or set(
            rec["driver_launches"]) != {"decoupled", "inplace", "grid"}:
        raise AssertionError(f"audit: flipped programs {flipped}, launches "
                             f"by driver {rec['driver_launches']}")
    return rec


MP_RANKS = 2                  # processes of the multiprocess phase
MP_SHARDS_PER_RANK = 2        # a 4-shard process mesh
MP_QUBITS = 28                # the flagship (and the Bell pair) over it
MP_DURABLE = (26, 20)         # qubits, depth: 512 MiB planes, 256 MiB a rank
MP_BELL_SEEDS = (0, 1)
MP_STEP_REPS = 3
MP_TAPED_QUBITS = 24          # (e): auto picks the taped engine there
MP_GRAD_TOL = 1e-5            # relative, (d) and (e)
MP_TIMEOUT_S = 120.0          # a rank's bound on its group and each collective
MP_WAIT_S = 240.0             # the parent's bound on the rank processes


def phase_multiprocess(torch):
    """Two rank processes on the one card over a gloo process mesh (phase
    46): the parent builds both libraries under the build lock, writes the
    ranks' configuration, exec-spawns them and gates what they report.
    Returns the phase record; rec["k1"] is the kernels line's row."""
    from quest_tpu_torch import native
    from quest_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    native.build()
    _free(torch)
    root = tempfile.mkdtemp(prefix="quest_mp_")
    cfg = {"card": CARD, "n": MP_QUBITS, "durable": list(MP_DURABLE),
           "seeds": list(MP_BELL_SEEDS), "reps": MP_STEP_REPS,
           "taped_n": MP_TAPED_QUBITS, "timeout": MP_TIMEOUT_S}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    # one BLAS / OpenMP thread a rank: the ranks' host planning would
    # otherwise spin a thread pool each on the shared cores
    env = dict(os.environ, WORLD_SIZE=str(MP_RANKS), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("QUEST_COMM_TOPOLOGY", None)        # the ranks derive it
    me = os.path.abspath(__file__)
    procs, logs = [], []
    try:
        for r in range(MP_RANKS):
            log = open(os.path.join(root, f"rank-{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, me, "--mp-rank", str(r), "--mp-dir", root],
                env=dict(env, RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MP_WAIT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    try:
        ranks, tails = [], []
        for r, p in enumerate(procs):
            with open(os.path.join(root, f"rank-{r}.log")) as f:
                tails.append(f.read()[-3000:])
            path = os.path.join(root, f"rank-{r}.json")
            if p.returncode != 0 or not os.path.exists(path):
                raise AssertionError(
                    f"multiprocess: rank {r} exited {p.returncode}:\n"
                    + "\n".join(f"-- rank {q}:\n{t}"
                                for q, t in enumerate(tails)))
            with open(path) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0, r1 = ranks
    if r0["bell"]["outcomes"] != r1["bell"]["outcomes"]:
        raise AssertionError(f"multiprocess bell: outcomes differ "
                             f"{r0['bell']} / {r1['bell']}")
    for key in ("strategy", "topology", "issued", "launches_per_rank"):
        if r0["flagship"][key] != r1["flagship"][key]:
            raise AssertionError(f"multiprocess flagship {key}: "
                                 f"{r0['flagship'][key]} / "
                                 f"{r1['flagship'][key]}")
    b0, b1 = r0["flagship"]["banded"], r1["flagship"]["banded"]
    if (b0["issued"], b0["strategy"]) != (b1["issued"], b1["strategy"]):
        raise AssertionError(f"multiprocess banded: ranks differ {b0} / {b1}")
    _mp_gate_consumers(r0, r1)
    rec = {"phase": "multiprocess", "ranks": MP_RANKS,
           "shards": MP_RANKS * MP_SHARDS_PER_RANK, "n": MP_QUBITS,
           "durable_n": MP_DURABLE[0], "durable_depth": MP_DURABLE[1],
           "flagship": [r["flagship"] for r in ranks],
           "bell": r0["bell"], "durable": [r["durable"] for r in ranks],
           "join_s": [r["join_s"] for r in ranks],
           "gradients": [r["gradients"] for r in ranks],
           "autotune": [r["autotune"] for r in ranks],
           "sharded_checkpoint": [r["sharded_checkpoint"] for r in ranks],
           "rank_seconds": [r["seconds"] for r in ranks],
           "k1": r0["k1"], "seconds": time.perf_counter() - t0}
    emit_card(rec)
    return rec


def _mp_gate_consumers(r0, r1) -> None:
    """The parent's gates on (d)-(g): what the two ranks must agree on,
    and rank 0's comparisons with the one-process mesh."""
    g0, g1 = r0["gradients"], r1["gradients"]
    for key in ("adjoint", "taped"):
        a, b = g0[key], g1[key]
        if not (a["equal_ranks"] and b["equal_ranks"]
                and a["rel_err"] <= MP_GRAD_TOL):
            raise AssertionError(f"multiprocess gradients ({key}): {a} / "
                                 f"{b}")
    if g0["adjoint"]["issued"] != g1["adjoint"]["issued"]:
        raise AssertionError("multiprocess gradients: ranks issued "
                             "different exchanges")
    a0, a1 = r0["autotune"], r1["autotune"]
    if not (a0["plan_sha"] == a1["plan_sha"] == a0["one_process_sha"]):
        raise AssertionError(f"multiprocess autotune: {a0} / {a1}")
    for r in (r0, r1):
        if not r["sharded_checkpoint"]["bit_equal_one_process"]:
            raise AssertionError("multiprocess sharded checkpoint: "
                                 f"{r['sharded_checkpoint']}")


def mp_ansatz(n: int, layers: int = 2, seed: int = 29):
    """A hardware-efficient ansatz: per layer one rx or ry a qubit
    (alternating, seeded angles) and a cz ring; 2 n parameters."""
    from quest_tpu_torch.circuit import Circuit
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for layer in range(layers):
        for q in range(n):
            (c.rx if (q + layer) % 2 else c.ry)(
                q, float(rng.uniform(-np.pi, np.pi)))
        for q in range(n):
            c.cz(q, (q + 1) % n)
    return c


def _mp_vg(torch, mesh, fn, theta) -> dict:
    """One value_and_grad call on the process mesh: (record, [E, grad]
    on the host), the record holding ms, a rank's peak GiB, the issued
    exchanges, the cross-process wire split, and whether every rank
    holds the same energy and gradient."""
    base = _reset_peak(torch)
    mesh.recorder.reset()
    w0 = dict(mesh.wire)
    mesh.barrier()
    ms, (v, g) = _wall(torch, lambda: fn(theta))
    vg = torch.cat([v.double().reshape(1), g.double()]).cpu()
    seen = mesh.host_all_gather(vg)
    w1 = mesh.wire
    return {"ms": ms, "peak_gib": _peak_gib(torch, base),
            "issued": mesh.recorder.stats(mesh.size),
            "predicted": fn.comm_record, "engine": fn.engine,
            "equal_ranks": all(torch.equal(x, seen[0]) for x in seen),
            "wire": {"copy_out_ms": (w1["copy_out_s"] - w0["copy_out_s"])
                     * 1e3,
                     "gloo_ms": (w1["gloo_s"] - w0["gloo_s"]) * 1e3,
                     "copy_in_ms": (w1["copy_in_s"] - w0["copy_in_s"]) * 1e3,
                     "bytes_out": w1["bytes_out"] - w0["bytes_out"],
                     "calls": w1["calls"] - w0["calls"]}}, vg


def _rel_err(a, b) -> float:
    """max of |dE| / |E| and max|d grad| / max|grad| of two [E, grad]
    vectors."""
    return max(abs(float(a[0] - b[0])) / abs(float(b[0])),
               float((a[1:] - b[1:]).abs().max() / b[1:].abs().max()))


def _mp_gradients(torch, mesh, cfg, dev, rank) -> dict:
    """(d) the adjoint walk over the process mesh at the phase's width
    against the one-process mesh, (e) the taped engine where auto picks
    it, against the adjoint walk there."""
    from quest_tpu_torch import adjoint as AD
    from quest_tpu_torch.entry import tfim_sum
    from quest_tpu_torch.parallel.mesh import make_amp_mesh
    t0 = time.perf_counter()
    n = cfg["n"]
    codes, coeffs = tfim_sum(n)
    c = mp_ansatz(n)
    fn = AD.value_and_grad(c, codes, coeffs=coeffs, mesh=mesh,
                           engine="adjoint")
    theta = torch.as_tensor(fn.initial_params, dtype=torch.float32,
                            device=dev)
    adj, vg = _mp_vg(torch, mesh, fn, theta)
    pred, issued = adj["predicted"], adj["issued"]
    if any(issued[k] != pred[k] for k in ("collective_permutes",
                                          "all_to_alls", "all_reduces")):
        raise AssertionError(f"multiprocess gradients: issued {issued}, "
                             f"predicted {pred}")
    adj.update(n=n, params=int(fn.num_params), rel_err=0.0)
    del fn
    _free(torch)
    mesh.barrier()
    if rank == 0:           # the one-process 4-shard mesh, rank 0 alone
        one = make_amp_mesh(mesh.size, devices=[dev] * mesh.size)
        f1 = AD.value_and_grad(c, codes, coeffs=coeffs, mesh=one,
                               engine="adjoint")
        adj["one_process_ms"], (v1, g1) = _wall(torch, lambda: f1(theta))
        ref = torch.cat([v1.double().reshape(1), g1.double()]).cpu()
        adj["rel_err"] = _rel_err(vg, ref)
        adj["energy"] = float(vg[0])
        del f1, one
        _free(torch)
    mesh.barrier()
    # (e): auto resolves the taped engine on the mesh at taped_n
    nt = cfg["taped_n"]
    widest = max(k for k in range(8, 40) if AD.capacity_stats(
        k, 2 * k, 0, np.float32, dev)["taped_fits"])
    codes_t, coeffs_t = tfim_sum(nt)
    ct = mp_ansatz(nt)
    with env_knob("QUEST_ADJOINT", "auto"):
        ft = AD.value_and_grad(ct, codes_t, coeffs=coeffs_t, mesh=mesh)
    if ft.engine != "taped":
        raise AssertionError(f"multiprocess gradients: auto picked "
                             f"{ft.engine} at {nt} qubits")
    th = torch.as_tensor(ft.initial_params, dtype=torch.float32, device=dev)
    tap, vt = _mp_vg(torch, mesh, ft, th)
    fa = AD.value_and_grad(ct, codes_t, coeffs=coeffs_t, mesh=mesh,
                           engine="adjoint")
    adj_t, va = _mp_vg(torch, mesh, fa, th)
    tap.update(n=nt, params=int(ft.num_params), widest_taped_qubits=widest,
               rel_err=_rel_err(vt, va), adjoint_ms=adj_t["ms"],
               adjoint_peak_gib=adj_t["peak_gib"])
    del ft, fa
    _free(torch)
    return {"adjoint": adj, "taped": tap,
            "seconds": time.perf_counter() - t0}


def _mp_autotune(torch, mesh, cfg, dev, rank) -> dict:
    """(f) plan.autotune(mesh=) of the ansatz at the phase's width on each
    rank, and on rank 0 the one-process autotune(devices=) under the
    mesh's topology: sha256 of each plan's fields."""
    import hashlib
    from quest_tpu_torch import plan as PL
    from quest_tpu_torch.parallel import comm as CM

    def sha(p):
        return hashlib.sha256(json.dumps(
            dataclasses.asdict(p), sort_keys=True,
            default=str).encode()).hexdigest()
    c = mp_ansatz(cfg["n"])
    ms, p = _wall(torch, lambda: PL.autotune(c, mesh=mesh, persist=False))
    rec = {"ms": ms, "engine": p.engine, "plan_sha": sha(p),
           "topology": CM.topology(mesh.size, mesh).describe(mesh.size)}
    if rank == 0:
        rec["one_process_sha"] = sha(PL.autotune(
            c, devices=mesh.size, topology=CM.topology(mesh.size, mesh),
            persist=False, device=dev))
    return rec


def _mp_sharded_checkpoint(torch, mesh, cfg, dev, root) -> dict:
    """(g) save_sharded of a 28q register over the process mesh, each
    rank its own shards, then load_sharded onto a one-process 4-shard
    mesh on each rank: its shards bit for bit this rank's."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.parallel.mesh import ShardedAmps, make_amp_mesh
    from quest_tpu_torch.state import Qureg
    n = cfg["n"]
    m = 1 << (n - mesh.global_qubits)
    shards = [None] * mesh.size
    for d in mesh.local_ids:
        gen = torch.Generator(device=dev).manual_seed(100 + d)
        shards[d] = torch.rand((2, m), generator=gen, device=dev)
    q = Qureg(amps=ShardedAmps(shards, mesh, n), num_qubits=n)
    path = os.path.join(root, "sharded-ckpt")
    mesh.barrier()
    save_ms, _ = _wall(torch, lambda: ckpt.save_sharded(q, path))
    mesh.barrier()
    one = make_amp_mesh(mesh.size, devices=[dev] * mesh.size)
    load_ms, back = _wall(torch, lambda: ckpt.load_sharded(path, mesh=one))
    equal = all(torch.equal(back.amps.shards[d], shards[d])
                for d in mesh.local_ids)
    rec = {"save_ms": save_ms, "load_one_process_ms": load_ms,
           "bytes_a_rank": 2 * m * 4 * len(mesh.local_ids),
           "bit_equal_one_process": equal,
           "files": sorted(os.listdir(path))}
    del back, q, shards
    mesh.barrier()
    if mesh.rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    _free(torch)
    return rec


def _mp_ms(torch, fn, reps: int) -> float:
    """Median ms of fn over reps: CUDA events on the card, the host's
    clock on the CPU rehearsal."""
    if CARD == "cuda":
        return time_ms(torch, fn, reps)
    return statistics.median(_wall(torch, fn)[0] for _ in range(reps))


def _mp_fresh(torch, mesh, n):
    """|0...0> over the process mesh: this rank's shards only."""
    from quest_tpu_torch.parallel.mesh import ShardedAmps
    local_n = n - mesh.global_qubits
    shards = [None] * mesh.size
    for d in mesh.local_ids:
        shards[d] = torch.zeros((2, 1 << local_n), device=mesh.devices[d])
    if shards[0] is not None:
        shards[0][0, 0] = 1.0
    return ShardedAmps(shards, mesh, n)


def _mp_flagship(torch, mesh, cfg, dev, rank) -> dict:
    """(a): the flagship over the process mesh, its gates and timings."""
    from quest_tpu_torch.entry import entry, flagship_circuit
    from quest_tpu_torch.ops import segment as SEG
    from quest_tpu_torch.parallel import comm as CM
    from quest_tpu_torch.parallel import introspect as I
    from quest_tpu_torch.parallel import sharded as SH
    from quest_tpu_torch.parallel.mesh import ShardedAmps, make_amp_mesh
    n, reps = cfg["n"], cfg["reps"]
    circ = flagship_circuit(n)
    topo = CM.topology(mesh.size, mesh)      # QUEST_COMM_TOPOLOGY unset
    if not (topo.hierarchical and topo.hosts == mesh.world):
        raise AssertionError(f"multiprocess: topology {topo} not derived "
                             f"from the group")
    t0 = time.perf_counter()
    fn = circ.compiled_sharded_fused(n, False, mesh)
    build_s = time.perf_counter() - t0
    x = _mp_fresh(torch, mesh, n)
    mesh.recorder.reset()
    SEG.segment_sweep.launches = 0
    SEG.segment_sweep.driver_launches = {}
    fn(x)
    _sync(torch)
    launches = SEG.segment_sweep.launches
    drivers = dict(SEG.segment_sweep.driver_launches)
    # (the counter counts card launches: a CPU rehearsal reads 0)
    if CARD == "cuda" and (launches != fn.launches_per_call or not launches
                           or drivers != {"decoupled": launches}):
        raise AssertionError(f"multiprocess: {launches} K1 launches "
                             f"({drivers}), {fn.launches_per_call} planned")
    issued = mesh.recorder.stats(mesh.size)
    pred = I.sharded_schedule(circ.ops, n, False, mesh, engine="fused")
    keys = ("collective_permutes", "all_to_alls", "collective_exchanges",
            "ici_bytes_per_device")
    if not pred["comm_matches_hlo"] or any(issued[k] != pred[k]
                                           for k in keys):
        raise AssertionError(f"multiprocess: issued {issued}, predicted "
                             f"{pred}")
    # the one-process 4-shard mesh on the same card, priced alike: one
    # host a process, set by the knob (a one-process mesh derives flat)
    def alike():
        return env_knob("QUEST_COMM_TOPOLOGY", f"hosts={mesh.world}")
    one = make_amp_mesh(mesh.size, devices=[dev] * mesh.size)
    local_n = n - mesh.global_qubits
    m = 1 << local_n

    def one_fresh():
        shards = [torch.zeros((2, m), device=dev) for _ in range(mesh.size)]
        shards[0][0, 0] = 1.0
        return ShardedAmps(shards, one, n)
    with alike():
        fone = circ.compiled_sharded_fused(n, False, one)
        y = one_fresh()
        fone(y)
        _sync(torch)
    if fone.strategy != fn.strategy or not all(
            torch.equal(x.shards[d], y.shards[d]) for d in mesh.local_ids):
        raise AssertionError("multiprocess: shards differ from the "
                             "one-process mesh's")
    ref_fn, (ref,) = entry(device=dev, num_qubits=n)
    ref_fn(ref)
    ref = ref.reshape(2, -1)
    scale = ref.abs().max().item()
    err = max(plane_err(x.shards[d], ref[:, d * m:(d + 1) * m])
              for d in mesh.local_ids)
    norm = float(mesh.reduce([None if s is None else s.double().pow(2).sum()
                              for s in x.shards]))
    if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL):
        raise AssertionError(f"multiprocess: max|diff| {err} vs K1 (max|amp|"
                             f" {scale}), norm {norm}")
    # the one-process mesh's step, rank 0 alone on the card
    mesh.barrier()
    one_ms = None
    if rank == 0:
        with alike():
            one_ms = statistics.median(_wall(torch, lambda: fone(y))[0]
                                       for _ in range(reps))
    mesh.barrier()
    del y, fone
    _free(torch)
    banded = _mp_banded(torch, mesh, circ, n, one, one_fresh, alike, ref,
                        scale)
    del ref_fn, ref, one
    _free(torch)
    # the process mesh's warm step, both ranks at once
    mesh.barrier()
    step_ms = []
    for _ in range(reps):
        step_ms.append(_wall(torch, lambda: fn(x))[0])
    # one cross-process all-to-all: the relabel of every global bit
    xs = [None if d is None else torch.zeros((1, 2, m), device=d)
          for d in mesh.devices]
    splits = []
    for _ in range(3):
        mesh.barrier()
        w0 = dict(mesh.wire)
        ms, _ = _wall(torch, lambda: SH._relabel_op(
            xs, mesh, local_n, tuple(range(mesh.global_qubits))))
        w1 = mesh.wire
        nb = w1["bytes_out"] - w0["bytes_out"]
        splits.append({
            "ms": ms, "bytes_out": nb, "bytes_in": w1["bytes_in"]
            - w0["bytes_in"],
            "copy_out_ms": (w1["copy_out_s"] - w0["copy_out_s"]) * 1e3,
            "gloo_ms": (w1["gloo_s"] - w0["gloo_s"]) * 1e3,
            "copy_in_ms": (w1["copy_in_s"] - w0["copy_in_s"]) * 1e3,
            "gb_per_s": nb / ms / 1e6})
    mesh.recorder.reset()
    del xs
    _free(torch)
    a2a = sorted(splits, key=lambda s: s["ms"])[1]
    # K1 on rank 0's shards alone (rank 1 waiting): the kernels line
    mesh.barrier()
    k1 = _mp_k1(torch, fn, x, mesh) if rank == 0 else None
    mesh.barrier()
    return {"flagship": {
        "launches_per_rank": launches, "strategy": fn.strategy,
        "topology": topo.describe(mesh.size), "issued": issued,
        "predicted_bytes": pred["comm_bytes"],
        "predicted_dci_bytes": pred["comm_dci_bytes"],
        "max_abs_err": err, "rel_err": err / scale, "norm": norm,
        "bit_equal_one_process": True, "build_s": build_s,
        "step_ms": statistics.median(step_ms), "step_ms_runs": step_ms,
        "one_process_step_ms": one_ms, "all_to_all": a2a,
        "all_to_all_runs": splits, "banded": banded}, "k1": k1}


def _mp_banded(torch, mesh, circ, n, one, one_fresh, alike, ref,
               scale) -> dict:
    """The flagship once through compiled_sharded_banded on the process
    mesh: bit for bit the one-process mesh's banded run (priced alike),
    within 1e-4 x max|amp| of the K1 step `ref`, issued exchanges equal
    to the dry walk's prediction; its ms beside the one-process run's
    (both ranks run theirs at once on the card)."""
    from quest_tpu_torch.parallel import introspect as I
    m = 1 << (n - mesh.global_qubits)
    fb = circ.compiled_sharded_banded(n, False, mesh)
    x = _mp_fresh(torch, mesh, n)
    mesh.recorder.reset()
    mesh.barrier()
    ms, _ = _wall(torch, lambda: fb(x))
    issued = mesh.recorder.stats(mesh.size)
    pred = I.sharded_schedule(circ.ops, n, False, mesh, engine="banded")
    keys = ("collective_permutes", "all_to_alls", "collective_exchanges",
            "ici_bytes_per_device")
    if not pred["comm_matches_hlo"] or any(issued[k] != pred[k]
                                           for k in keys):
        raise AssertionError(f"multiprocess banded: issued {issued}, "
                             f"predicted {pred}")
    err = max(plane_err(x.shards[d], ref[:, d * m:(d + 1) * m])
              for d in mesh.local_ids)
    if not err <= PATH_TOL * scale:
        raise AssertionError(f"multiprocess banded: max|diff| {err} vs K1 "
                             f"(max|amp| {scale})")
    with alike():
        fone = circ.compiled_sharded_banded(n, False, one)
        y = one_fresh()
        one_ms, _ = _wall(torch, lambda: fone(y))
    if fone.strategy != fb.strategy or not all(
            torch.equal(x.shards[d], y.shards[d]) for d in mesh.local_ids):
        raise AssertionError("multiprocess banded: shards differ from the "
                             "one-process mesh's")
    rec = {"ms": ms, "one_process_ms_concurrent": one_ms,
           "strategy": fb.strategy,
           "issued": issued, "max_abs_err": err,
           "bit_equal_one_process": True}
    del x, y, fb, fone
    _free(torch)
    return rec


def _mp_k1(torch, fn, x, mesh) -> dict:
    """K1 alone on this rank's shards: every kernel part of the program
    on each local shard, against the same parts through the plain
    version on the same input (max|diff| within 1e-4 x max|amp|), ms
    beside plain ms and the bound of those launches."""
    from quest_tpu_torch.ops.segment import (segment_sweep,
                                             segment_sweep_reference)
    ids = [i for i, p in enumerate(fn.parts) if p[0] == "segment"]
    mine = list(mesh.local_ids)
    segs = {(i, d): fn.segments[(i, str(mesh.devices[d]))]
            for i in ids for d in mine}

    def kernel(sh):
        for i in ids:
            for d in mine:
                segment_sweep(sh[d], segs[(i, d)])

    def plain(sh):
        for i in ids:
            for d in mine:
                seg = segs[(i, d)]
                out = segment_sweep_reference(sh[d], seg.stages,
                                              seg.operands, fn.local_n,
                                              tier=seg.tier)
                sh[d].copy_(out.reshape(sh[d].shape))
    a = {d: x.shards[d].clone() for d in mine}
    b = {d: x.shards[d].clone() for d in mine}
    kernel(a)
    plain(b)
    _sync(torch)
    err = max(plane_err(a[d], b[d]) for d in mine)
    scale = max(b[d].abs().max().item() for d in mine)
    if not err <= PATH_TOL * scale:
        raise AssertionError(f"multiprocess K1: max|diff| {err} vs the "
                             f"plain version (max|amp| {scale})")
    ms = _mp_ms(torch, lambda: kernel(a), MP_STEP_REPS)
    plain_ms = _mp_ms(torch, lambda: plain(b), 1)
    bound_ms_, bound_by = bound_of(list(segs.values()))
    return {"launches_timed": len(segs), "max_abs_err": err,
            "rel_err": err / scale, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms_, "bound_by": bound_by}


def _mp_bell(torch, mesh, cfg) -> dict:
    """(b): the reference worker's Bell pair with feedback
    (tests/_multihost_worker.py:85-103) over the process mesh."""
    from quest_tpu_torch.circuit import Circuit
    n = cfg["n"]
    dc = Circuit(n).h(0).cnot(0, n - 1).measure(n - 1).x_if(0, (0, 1))
    dc.measure(0)
    fn = dc.compiled_sharded_measured(n, False, mesh)
    outs, ms = [], []
    for seed in cfg["seeds"]:
        x = _mp_fresh(torch, mesh, n)
        t, (_, oc) = _wall(torch, lambda: fn(
            x, torch.Generator().manual_seed(seed)))
        ms.append(t)
        outs.append(oc.tolist())
        del x
    if any(o[1] != 0 for o in outs):
        raise AssertionError(f"multiprocess bell: outcomes {outs}")
    seen = mesh.host_all_gather(torch.tensor(outs, dtype=torch.int64))
    if not all(torch.equal(s, seen[0]) for s in seen):
        raise AssertionError(f"multiprocess bell: ranks read {seen}")
    _free(torch)
    return {"outcomes": outs, "ms": ms}


def _mp_durable(torch, mesh, cfg, dev, rank, root) -> dict:
    """(c): gang durable runs over the process mesh: uninterrupted,
    preempted and resumed, and the mid-save kill of
    tests/_gang_worker.py scenario 4; then one gang save, hash and load
    timed."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.ops import segment as SEG
    from quest_tpu_torch.resilience import FaultPlan, faults
    from quest_tpu_torch.resilience import durable as D
    from quest_tpu_torch.state import Qureg
    n, depth = cfg["durable"]
    circ = random_circuit(n, depth, seed=7, entangler="cz")
    steps, _ = D._build_steps(circ, n, False, "sharded", mesh, dev, True)
    nsteps = len(steps)
    every = max(1, nsteps // 4)

    def fresh():
        return Qureg(amps=_mp_fresh(torch, mesh, n), num_qubits=n)

    def run(d, plan=None):
        SEG.segment_sweep.launches = 0
        mesh.barrier()
        if plan is None:
            ms, out = _wall(torch, lambda: D.run_durable(
                circ, fresh(), d, every=every, mesh=mesh))
            return ms, SEG.segment_sweep.launches, out
        with faults.active(plan):
            try:
                D.run_durable(circ, fresh(), d, every=every, mesh=mesh)
            except faults.InjectedFault:
                return None, SEG.segment_sweep.launches, None
        raise AssertionError("multiprocess durable: the fault never fired")

    def same(a, b):
        return all(torch.equal(a.amps.shards[d], b.amps.shards[d])
                   for d in mesh.local_ids)
    rec = {"steps": nsteps, "every": every}
    dir_a, dir_b, dir_c = (os.path.join(root, f"durable-{k}")
                           for k in "abc")
    rec["uninterrupted_ms"], rec["k1_launches"], out_a = run(dir_a)
    if ckpt.step_dirs(dir_a):
        raise AssertionError("multiprocess durable: the chain survived")
    run(dir_b, FaultPlan().inject("durable.preempt", after_n=2 * every + 1,
                                  times=1))
    mesh.barrier()
    rec["chain_at_preempt"] = [s for s, _ in ckpt.step_dirs(dir_b)]
    rec["resumed_ms"], rec["k1_launches_resumed"], out_b = run(dir_b)
    if not rec["chain_at_preempt"] or not same(out_a, out_b):
        raise AssertionError(f"multiprocess durable resume: {rec}")
    del out_b
    plan = FaultPlan()
    if rank == 1:
        plan.inject("checkpoint.save", after_n=1, times=1)
    else:
        plan.inject("durable.preempt", after_n=2 * every, times=1)
    run(dir_c, plan)
    mesh.barrier()
    tmp = ckpt.step_path(dir_c, 2 * every) + ".tmp-gang"
    rec["chain_after_kill"] = [s for s, _ in ckpt.step_dirs(dir_c)]
    stamps = sorted(f for f in os.listdir(tmp) if f.startswith("prepared"))
    if rec["chain_after_kill"] != [every] or "prepared-1" in stamps:
        raise AssertionError(f"multiprocess mid-save kill committed: "
                             f"{rec['chain_after_kill']}, {stamps}")
    rec["midsave_ms"], _, out_c = run(dir_c)
    if not same(out_a, out_c) or ckpt.step_dirs(dir_c) or os.path.isdir(tmp):
        raise AssertionError("multiprocess mid-save resume diverged")
    rec["bit_identical"] = True
    del out_c
    # one gang save, hash and load of the final state
    meta, arrays = ckpt._gang_shard_meta(out_a, mesh.rank, mesh.world, None)
    t0 = time.perf_counter()
    ckpt._plane_digests(arrays)
    rec["hash_ms"] = (time.perf_counter() - t0) * 1e3
    rec["slice_bytes"] = int(arrays["planes"].nbytes)
    del arrays
    probe = os.path.join(root, "durable-probe")
    mesh.barrier()
    t0 = time.perf_counter()
    ckpt.save_step_gang(probe, 1, qureg=out_a,
                        extra={"kind": "state", "step": 1})
    rec["save_ms"] = (time.perf_counter() - t0) * 1e3
    mesh.barrier()
    t0 = time.perf_counter()
    ckpt.load_step_gang(ckpt.step_path(probe, 1))
    rec["load_ms"] = (time.perf_counter() - t0) * 1e3
    mesh.barrier()
    del out_a
    _free(torch)
    return rec


def mp_rank(torch, rank: int, root: str) -> int:
    """One rank of the multiprocess phase: its own CUDA context on cuda:0
    (or the CPU of a rehearsal), joined to the group through a FileStore
    under `root`; it builds nothing (the parent built both libraries).
    Writes rank-<r>.json under root; any failure exits non-zero (the
    peer's next collective then fails too)."""
    global CARD
    import traceback
    t_start = time.perf_counter()
    with open(os.path.join(root, "config.json")) as f:
        cfg = json.load(f)
    CARD = cfg["card"]
    if CARD == "cuda" and not torch.cuda.is_available():
        print(f"rank {rank}: no CUDA device", flush=True)
        return 2
    from quest_tpu_torch import native
    from quest_tpu_torch.env import QuESTEnv
    from quest_tpu_torch.ops import _build
    _build.BUILD_ALLOWED = False
    native.BUILD_ALLOWED = False
    if CARD == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    try:
        t0 = time.perf_counter()
        env = QuESTEnv([dev] * MP_SHARDS_PER_RANK, True,
                       init_method="file://" + os.path.join(root, "store"),
                       timeout=cfg["timeout"])
        mesh = env.mesh
        rec = {"rank": rank, "join_s": time.perf_counter() - t0}
        if env.rank != rank or mesh.size != MP_RANKS * MP_SHARDS_PER_RANK:
            raise AssertionError(f"rank {rank}: joined as {env.rank}, mesh "
                                 f"of {mesh.size}")
        rec.update(_mp_flagship(torch, mesh, cfg, dev, rank))
        print(f"rank {rank}: flagship ok", flush=True)
        rec["bell"] = _mp_bell(torch, mesh, cfg)
        print(f"rank {rank}: bell ok", flush=True)
        rec["durable"] = _mp_durable(torch, mesh, cfg, dev, rank, root)
        print(f"rank {rank}: durable ok", flush=True)
        rec["gradients"] = _mp_gradients(torch, mesh, cfg, dev, rank)
        print(f"rank {rank}: gradients ok", flush=True)
        t0 = time.perf_counter()
        rec["autotune"] = _mp_autotune(torch, mesh, cfg, dev, rank)
        rec["autotune"]["seconds"] = time.perf_counter() - t0
        print(f"rank {rank}: autotune ok", flush=True)
        t0 = time.perf_counter()
        rec["sharded_checkpoint"] = _mp_sharded_checkpoint(torch, mesh, cfg,
                                                           dev, root)
        rec["sharded_checkpoint"]["seconds"] = time.perf_counter() - t0
        print(f"rank {rank}: sharded checkpoint ok", flush=True)
        rec["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(root, f"rank-{rank}.json"), "w") as f:
            json.dump(rec, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def ham_profile(torch):
    """torch.profiler tables (top kernels by device time) of the
    Hamiltonian layers at 30 qubits: the grouped expectation of TFIM-30
    and of the random-support sum, apply_pauli_sum, the Trotter step
    (and each of its launches alone, CUDA events) and the adjoint
    forward; one JSON line, the tables in smoke_out/ham_profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch import evolution as EV
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import (EVOLUTION_DT, random_support_sum,
                                       tfim_sum, vqe_entry)
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape
    n = HAM_QUBITS
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    random_circuit(n, HAM_STATE_DEPTH, seed=7, entangler="cz").compiled_fused(
        n, device="cuda")(amps)
    q = Qureg(amps=amps, num_qubits=n)
    tables, rec = [], {"phase": "ham_profile", "n": n}

    def run(name, fn):
        fn()
        _sync(torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms, _ = _wall(torch, fn)
        rec[name] = {"profiled_wall_ms": ms}
        tables.append(f"=== {name}\n" + prof.key_averages().table(
            sort_by="cuda_time_total", row_limit=14))
    tf, rs = tfim_sum(n), random_support_sum(n, RANDOM_SUM_TERMS)
    run("expec_tfim", lambda: K.calc_expec_pauli_sum(q, *tf))
    run("expec_random_support", lambda: K.calc_expec_pauli_sum(q, *rs))
    run("apply_pauli_sum_tfim", lambda: K.apply_pauli_sum(q, *tf))
    prog = EV.trotter_circuit(EV.as_pauli_sum(tf), EVOLUTION_DT, order=2,
                              steps=1).compiled_fused(n, device="cuda")
    rec["trotter_launch_ms"] = [time_ms(torch, lambda: S.segment_sweep(
        amps, seg), 3) for seg in prog.segments]
    rec["trotter_step_ms"] = time_ms(torch, lambda: prog(amps), 3)
    run("trotter_step", lambda: prog(amps))
    del q, amps
    _free(torch)
    fn, (theta,) = vqe_entry("cuda", num_qubits=ADJ_QUBITS)
    run("adjoint_forward", lambda: fn.value(theta))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ham_profile.txt"), "w") as f:
        f.write("\n".join(tables))
    rec["card"] = smi_line()
    return rec


@contextlib.contextmanager
def driver_knobs(cfg):
    """Programs compiled inside run under configuration `cfg` of
    DRIVER_CONFIGS (the three knobs set, then restored)."""
    driver, nbuf = DRIVER_CONFIGS[cfg]
    env = ({"QUEST_FUSED_DRIVER": "grid"} if driver == "grid" else
           {"QUEST_FUSED_DRIVER": "pipelined",
            "QUEST_FUSED_PIPELINE": "1" if driver == "decoupled" else "0",
            "QUEST_FUSED_NBUF": str(nbuf)})
    saved = {k: os.environ.get(k) for k in DRIVER_KNOBS}
    for k in DRIVER_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ring_cases(rng):
    """(name, n, batch, stages, arrays): segments whose blocks each walk
    many steps (the persistent drivers' rings wrap many times): the
    stage-free copy, phase stages that launch only the tiles with row bit
    15 set, and a chain at 26 qubits; phase stages that skip tiles in a
    batch of 16 states of 20 qubits; an sc stage on row bit 3 (11-bit
    tiles, where the in-place driver holds 8 plane slots) at 24, and S9
    in a batch of 16 states of 20 qubits."""
    chain = [mat_op(rng, "b0", 128), phase_op(rng, 0b10, 0b10, 0b100, 0b100),
             parity_op(rng, 0b11, 0b11001), mat_op(rng, "b1", 32),
             pair_op(rng, "sub", 2, 12)]
    sel = [batchsel_op(16, 0), mat_op(rng, "b0", 128), batchsel_op(3, 1, False)]
    sc = mat_op(rng, "sc", 2, bit=3)
    skip = [phase_op(rng, 0b1, 0b1, (1 << 15) | (1 << 2), 1 << 15),
            phase_op(rng, 0, 0, (1 << 15) | (1 << 10), 1 << 15)]
    skip_b = [phase_op(rng, 0b100, 0b100, 1 << 10, 1 << 10),
              phase_op(rng, 0, 0, (1 << 10) | (1 << 8), 1 << 10)]
    return [("copy_26", 26, 0, [], []),
            ("phase_skip_26", 26, 0, [s for s, _ in skip],
             [a for _, a in skip]),
            ("phase_skip_20x16", 20, 16, [s for s, _ in skip_b],
             [a for _, a in skip_b]),
            ("chain_26", 26, 0, [s for s, _ in chain], [a for _, a in chain]),
            ("sc_tile11_24", 24, 0, [sc[0]], [sc[1]]),
            ("batchsel_20x16", 20, 16, [s for s, _ in sel],
             [a for _, a in sel])]


def probe_drivers(torch):
    """The first launches of every driver, meant to run in a subprocess
    with a timeout (a slip of an mbarrier's phase or of a bulk-group count
    hangs a block): every stage case and batched case of the stages phase,
    every ring case, the scattered-row geometries of tma_cases (several
    tensor-map requests and store groups per plane) and S7 at 1, 2, 8 and
    64 terms (multiphase_cases), under K1, K2 at 2, 3 and 8 slots and K3,
    each bit-identical to K3 (max|diff| == 0) and K3 within the stage
    tolerance of the plain version on the ring, tensor-map and multiphase
    cases."""
    from quest_tpu_torch.ops import segment as S
    rng = np.random.default_rng(20261017)
    configs = dict(DRIVER_CONFIGS, **{"K2/8": ("inplace", 8)})
    cases = [(nm, n, 0, st, ar) for nm, n, st, ar in stage_cases(rng)]
    cases += [(nm, n, b, st, ar)
              for nm, n, b, st, ar, _ in batch_stage_cases(rng)]
    results = []
    plain_checked = (ring_cases(rng) + [c[:5] for c in tma_cases(rng)]
                     + [(nm, n, 0, st, ar)
                        for nm, n, st, ar in multiphase_cases(rng)])
    for (name, n, batch, stages, arrays), ring in (
            [(c, False) for c in cases] + [(c, True) for c in plain_checked]):
        shape = (batch, 2, 1 << n) if batch else (2, 1 << n)
        planes = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        sel = (torch.from_numpy(sel_table(rng, 2, max(1, batch))).cuda()
               if any(type(s).__name__ == "BatchSelStage" for s in stages)
               else None)
        outs, slots = {}, {}
        for cfg, (driver, nbuf) in configs.items():
            seg = S.prepare_segment(stages, arrays, n, "cuda", driver=driver,
                                    nbuf=nbuf)
            amps = planes.clone()
            S.segment_sweep(amps, seg, sel)
            torch.cuda.synchronize()
            outs[cfg] = amps
            slots[cfg] = S.smem_layout(seg.geometry.tile_bits,
                                       seg.tiles * max(1, batch),
                                       driver, nbuf)["slots"]
        diffs = {cfg: (o - outs["K3"]).abs().max().item()
                 for cfg, o in outs.items()}
        rec = {"case": name, "n": n, "batch": batch, "slots": slots,
               "max_abs_diff_vs_K3": diffs}
        if ring:
            want = S.segment_sweep_reference(planes, stages, arrays, n, sel)
            err = (outs["K3"].reshape(-1) - want.reshape(-1)).abs().max()
            rec["rel_err_vs_plain"] = (err / want.abs().max()).item()
            if not rec["rel_err_vs_plain"] <= STAGE_TOL:
                raise AssertionError(f"probe {name}: {rec}")
        results.append(rec)
        if any(d != 0.0 for d in diffs.values()):
            raise AssertionError(f"probe {name}: drivers differ: {rec}")
        del outs, planes
    return results


def phase_probe(torch):
    """probe_drivers in a subprocess (started while nvcc builds) with
    PROBE_TIMEOUT_S from the build's end: a timeout (a hung ring) or any
    failure fails the run."""
    t0 = time.perf_counter()
    rc, text = _finish(*(DURING_BUILD.pop("probe", None)
                         or _spawn_self("--probe")), PROBE_TIMEOUT_S)
    if rc is None:
        raise AssertionError(f"probe: the first driver launches did not "
                             f"finish in {PROBE_TIMEOUT_S} s")
    if rc != 0:
        raise AssertionError(f"probe failed (exit {rc}):\n{text[-8000:]}")
    rec = json.loads(text.strip().splitlines()[-1])
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def _timed(torch, fn):
    """(fn(), device ms) with CUDA events around the call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _same(a, b) -> bool:
    """Bit-identical outputs: tensors, or tuples of tensors."""
    import torch
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def driver_workloads(torch):
    """(name, tier, compile(), fresh input or None, call(fn, x)) of this
    slice's path: the flagship at HIGHEST, HIGH and DEFAULT, 30q d20, the
    density step, the batched step and the first trajectory chunk (64
    shots of the run's uniforms)."""
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import (TRAJ_CHUNK, TRAJ_SEED, batched_entry,
                                       density_entry, entry,
                                       noisy_rcs_circuit, random_states)
    from quest_tpu_torch.state import basis_planes, fused_state_shape

    def zero(n):
        return lambda: basis_planes(0, n=n, shape=fused_state_shape(n),
                                    device="cuda")

    def at_tier(tier, make):
        def compiled():
            with session_tier(tier):
                return make()
        return compiled

    def apply(fn, x):
        return fn(x)
    traj = noisy_rcs_circuit(24, 3)
    out = [("flagship", t, at_tier(t, lambda: entry()[0]), zero(28), apply)
           for t in ("highest", "high", "default")]
    out += [("baseline_30q_d20", "highest",
             lambda: random_circuit(30, 20, seed=7, entangler="cz"
                                    ).compiled_fused(30, device="cuda"),
             zero(30), apply),
            ("density", "highest", lambda: density_entry()[0], zero(28),
             apply),
            ("batched", "highest", lambda: batched_entry()[0],
             lambda: random_states(64, 24), apply)]
    prog0 = T._compiled_traj(traj, 24, "cuda")
    u = torch.rand((TRAJ_CHUNK, prog0.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(TRAJ_SEED))
    out.append(("trajectory_chunk", "highest",
                lambda: T._compiled_traj(traj, 24, "cuda"), lambda: u,
                lambda prog, x: prog(x)))
    return out


def phase_drivers(torch):
    """This slice's path under every driver (driver_workloads), each
    compiled under K1 (run K1_RUNS times), K2 at 2 and 3 plane slots and
    K3 and run from the same input: planes (and draws) bit-identical
    across drivers and across K1's runs; every launch of a run on its
    driver (counts set to 0 before the first run, read after); device ms
    of each run and the median per configuration (3 more runs where one
    takes under half a second). The flagship's plain path once per tier,
    for each driver-tier instantiation's error and plain time."""
    from quest_tpu_torch.ops import segment as S
    records, inst = [], {}
    for name, tier, compiled, fresh, call in driver_workloads(torch):
        ref = first = None
        per_cfg = {}
        for cfg, (driver, _) in DRIVER_CONFIGS.items():
            with driver_knobs(cfg):
                fn = compiled()
            if fn.driver != driver:
                raise AssertionError(f"drivers/{name}: {cfg} compiled the "
                                     f"{fn.driver} driver")
            planned = fn.launches_per_call
            ms = []
            for r in range(K1_RUNS if cfg == "K1" else 1):
                x = fresh()
                S.segment_sweep.driver_launches = {}
                out, t = _timed(torch, lambda: call(fn, x))
                counted = dict(S.segment_sweep.driver_launches)
                if counted != {driver: planned}:
                    raise AssertionError(f"drivers/{name}: {cfg} launched "
                                         f"{counted}, planned {planned}")
                if ref is None:
                    ref, first = out, fn
                elif not _same(out, ref):
                    raise AssertionError(f"drivers/{name}: {cfg} run {r} is "
                                         f"not bit-identical to K1's first")
                ms.append(t)
                del out, x
            if ms[0] < 500.0:
                x = fresh()
                ms += [_timed(torch, lambda: call(fn, x))[1]
                       for _ in range(3)]
                del x
            inst[(driver, tier)] = inst.get((driver, tier), 0) + planned
            per_cfg[cfg] = {"launches": planned, "ms": ms,
                            "median_ms": statistics.median(ms)}
            del fn
            torch.cuda.empty_cache()
        rec = {"phase": "drivers", "workload": name, "tier": tier,
               "bit_identical": True, "k1_runs_identical": True,
               "configs": per_cfg}
        if name == "flagship":
            # every driver's planes equal K1's: the plain path's distance
            # from them is each driver-tier instantiation's error
            want, rec["plain_ms"] = _timed(torch, lambda: first.plain(fresh()))
            rec["max_abs_err"] = (ref - want).abs().max().item()
            rec["bound_ms"], rec["bound_by"] = program_bound(first)
            del want
        emit(rec)
        records.append(rec)
        del ref, first
        torch.cuda.empty_cache()
    return records, inst


def scattered_copy(torch, S, op, n, driver, nbuf):
    """The stage-free segment on the tiles of matrix stage `op` ((stage,
    operand)): its geometry, scattered row bits and all, with no stage."""
    seg = S.prepare_segment([op[0]], [op[1]], n, "cuda", driver=driver,
                            nbuf=nbuf)
    if len(seg.geometry.scat) != 7:
        raise AssertionError(f"scattered copy: geometry {seg.geometry}")
    return dataclasses.replace(seg, stages=(), arrays=(), operands=(),
                               desc=seg.desc[:0], labels=frozenset(),
                               slots=(), ops=torch.zeros(4, device="cuda"))


# The stage-free launch before each driver's copies were last redesigned:
# ms at 28 qubits on an NVIDIA H100 80GB HBM3 at 700 W, this script's
# dma_floor phase on the tree of that time (PERF.md), printed beside the
# new times. K1 and K2 on scattered-row tiles before their tensor-map
# copies (one 512-byte bulk copy per row from warp 0's lanes); K3 on
# inner-row and scattered-row tiles before its tensor-map copies (16-byte
# loads and stores by every thread).
STAGE_FREE_BEFORE_MS = {"K1": {"scattered": 2.542},
                        "K2/2": {"scattered": 2.597},
                        "K2/3": {"scattered": 2.531},
                        "K3": {"inner": 2.767, "scattered": 2.877}}
# copy units compared on the card: (parts per plane, rows per box; None:
# the most the geometry takes). "plane" is the kernel's default; the
# parts refill a slot part by part.
COPY_UNITS = {"rows_512B": (1, 1), "plane": (1, None), "parts_2": (2, None),
              "parts_4": (4, None)}
ENCODE_REPS = 2000


def copy_unit_timing(torch, S, cases, planes, reps=5):
    """Each (name, segment) of `cases` under every COPY_UNITS unit, in two
    rounds (the second in reverse order): its requests per plane and the
    median ms of each round; the planes must come out the same under
    every unit."""
    out = {}
    for name, seg in cases:
        rec = {}
        want = None
        for rnd, order in enumerate((list(COPY_UNITS), list(COPY_UNITS)[::-1])):
            for unit in order:
                cu = COPY_UNITS[unit]
                amps = planes.clone()
                S.segment_sweep(amps, seg, copy_unit=cu)
                torch.cuda.synchronize()
                if want is None:
                    want = amps.clone()     # the timing below runs in place
                elif not torch.equal(amps, want):
                    raise AssertionError(f"dma_floor {name}: unit {unit} "
                                         f"changed the planes")
                ms = time_ms(torch, lambda: S.segment_sweep(
                    amps, seg, copy_unit=cu), reps)
                r = rec.setdefault(unit, {
                    "requests_per_plane": S.tma_unit(seg, 1, cu)[
                        "requests_per_plane"], "ms": []})
                r["ms"].append(ms)
                del amps
        for r in rec.values():
            r["median_ms"] = statistics.median(r["ms"])
        out[name] = rec
        del want
        torch.cuda.empty_cache()
    return out


def tma_encode_us(torch, S, seg, planes):
    """Host microseconds of one tensor-map encoding (each launch encodes
    one), over ENCODE_REPS encodings."""
    geo = seg.geometry
    lib = S._lib()
    boxes = S.tma_unit(seg, 1)
    t0 = time.perf_counter()
    rc = lib.quest_segment_tma_encode(
        planes.data_ptr(), seg.n, geo.tile_bits, geo.inner_bits,
        seg.scat_mask, 1, boxes["parts"], boxes["box_rows"], ENCODE_REPS)
    us = (time.perf_counter() - t0) / ENCODE_REPS * 1e6
    if rc != 0:
        raise AssertionError(f"dma_floor: tensor-map encoding failed: {rc}")
    return us


def phase_dma_floor(torch):
    """The copy floor and the pass under every driver at 28 qubits:
    profiling.sweep_dma_report (the stage-free launch and each flagship
    sweep's total and compute adder), the stage-free launch on a
    scattered-row geometry (scb-128's tiles: 7 scattered row bits) beside
    its time before the tensor-map copies, the tensor-map requests per
    plane, and single-stage launches of byte-bound kinds (phase, parity,
    a Kraus pair) and b0, per configuration, beside the bound (the state
    read and written once) and the yardstick: a torch copy_ of the planes
    into a second buffer (never called by the port), and K3's stage-free
    launches (inner-row and scattered-row tiles) beside them.
    Under K1, the copy units of COPY_UNITS on the scattered and the
    inner-row stage-free launches and on scb-128 and b0 at DEFAULT
    (copy_unit_timing), and the host time of one tensor-map encoding."""
    from quest_tpu_torch import profiling
    from quest_tpu_torch.ops import segment as S
    n = TIMING_QUBITS
    rng, (host,) = seeded_planes(5, (2, 1 << n))
    planes = torch.from_numpy(host).cuda()
    del host
    planes /= planes.double().pow(2).sum().sqrt().float()
    other = torch.empty_like(planes)
    copy_ms = time_ms(torch, lambda: other.copy_(planes), 5)
    del other
    cases = [("phase", phase_op(rng, 0b1, 0b1, 1 << 20, 1 << 20)),
             ("parity", parity_op(rng, 0b11, 1 << 20)),
             ("pair_sc_scat", pair_op(rng, "sc", 6, 20)),
             ("b0", mat_op(rng, "b0", 128))]
    scb = mat_op(rng, "scb", 128, bit=7)
    drivers = {}
    for cfg, (driver, nbuf) in DRIVER_CONFIGS.items():
        rep = profiling.sweep_dma_report(n=n, reps=3, driver=driver,
                                         nbuf=nbuf, device="cuda")
        single = {}
        for name, (st, arr) in cases:
            seg = S.prepare_segment([st], [arr], n, "cuda", driver=driver,
                                    nbuf=nbuf)
            single[name] = time_ms(torch, lambda: S.segment_sweep(planes, seg),
                                   5)
        # the copy floor of a scattered-row geometry (7 scattered row
        # bits): an scb-128 segment's tiles with its stage taken out
        seg = scattered_copy(torch, S, scb, n, driver, nbuf)
        before = planes.clone()
        S.segment_sweep(planes, seg)
        torch.cuda.synchronize()
        if not torch.equal(planes, before):
            raise AssertionError(f"dma_floor {cfg}: the scattered-row copy "
                                 f"changed the state")
        del before
        single["stage_free_scattered"] = time_ms(
            torch, lambda: S.segment_sweep(planes, seg), 5)
        drivers[cfg] = {"stage_free_ms": rep["dma_ms"], "slots": rep["slots"],
                        "single_stage_ms": single,
                        "stage_free_before_redesign_ms":
                            STAGE_FREE_BEFORE_MS[cfg],
                        "requests_per_plane":
                            S.tma_unit(seg, 1)["requests_per_plane"],
                        "sweeps": [{k: s[k] for k in ("stages", "total_ms",
                                                      "compute_adder_ms")}
                                   for s in rep["sweeps"]
                                   if s["kind"] == "kernel"]}
    scat_seg = scattered_copy(torch, S, scb, n, "decoupled", 3)
    units = copy_unit_timing(torch, S, [
        ("stage_free_scattered", scat_seg),
        ("stage_free_inner", S.prepare_segment([], [], n, "cuda",
                                               driver="decoupled")),
        ("scb128@default", S.prepare_segment([scb[0]], [scb[1]], n, "cuda",
                                             tier="default",
                                             driver="decoupled")),
        ("b0@default", S.prepare_segment([cases[3][1][0]], [cases[3][1][1]],
                                         n, "cuda", tier="default",
                                         driver="decoupled"))], planes)
    encode_us = tma_encode_us(torch, S, scat_seg, planes)
    bound = 2 * 2 * 4 * (1 << n) / HBM_BYTES_PER_S * 1e3
    # K3's stage-free launch beside copy_ and the bound
    k3 = {"stage_free_inner_ms": drivers["K3"]["stage_free_ms"],
          "stage_free_scattered_ms":
              drivers["K3"]["single_stage_ms"]["stage_free_scattered"],
          "before_redesign_ms": STAGE_FREE_BEFORE_MS["K3"],
          "copy_ms": copy_ms, "bound_ms": bound}
    rec = {"phase": "dma_floor", "n": n, "bound_ms": bound,
           "copy_ms": copy_ms, "drivers": drivers, "k3": k3,
           "copy_units_k1": units, "tma_encode_us": encode_us}
    emit(rec)
    del planes
    torch.cuda.empty_cache()
    return rec


def sanitize_case(torch):
    """One SANITIZE_QUBITS-qubit segment (a phase, a Kraus pair, a parity
    stage) under each driver; run under compute-sanitizer. Prints
    SANITIZE_UP once the device answers and SANITIZE_DONE after the
    last launch, so the phase can tell a tool that cannot run the card
    from a kernel that fails under it."""
    from quest_tpu_torch.ops import segment as S
    rng = np.random.default_rng(3)
    n = SANITIZE_QUBITS
    ops = [phase_op(rng, 0b1, 0b1, 0b10, 0b10), pair_op(rng, "sub", 2, 9),
           parity_op(rng, 0b11, 0b101)]
    planes = torch.from_numpy(rng.standard_normal((2, 1 << n)).astype(
        np.float32)).cuda()
    torch.cuda.synchronize()
    print(SANITIZE_UP, flush=True)
    for driver, nbuf in DRIVER_CONFIGS.values():
        seg = S.prepare_segment([s for s, _ in ops], [a for _, a in ops], n,
                                "cuda", driver=driver, nbuf=nbuf)
        S.segment_sweep(planes.clone(), seg)
    torch.cuda.synchronize()
    print(SANITIZE_DONE, flush=True)


def sanitize_checks():
    """compute-sanitizer memcheck and racecheck on sanitize_case, in a
    subprocess each (memcheck started while nvcc builds, its timeout
    counted from the build's end): (record, failure message or None).
    Where the case reached the device under the tool, memcheck must
    report no error and the case must finish; where the tool is missing,
    times out or cannot bring the device up (the case never printed
    SANITIZE_UP), its message is recorded instead, and racecheck is not
    tried where memcheck could not reach the device."""
    tool = (shutil.which("compute-sanitizer")
            or "/usr/local/cuda/bin/compute-sanitizer")
    t0 = time.perf_counter()
    rec = {"phase": "sanitize", "n": SANITIZE_QUBITS}
    for check in ("memcheck", "racecheck"):
        if check == "racecheck" and not rec["memcheck"].get("ran"):
            # the tool could not bring the card up under memcheck: it
            # cannot under racecheck either
            rec[check] = {"ran": False, "message": "not tried: memcheck "
                          "did not reach the device"}
            continue
        if DURING_BUILD.get("stopped"):
            rec[check] = {"ran": False, "message": "not tried: the build "
                          "failed"}
            continue
        try:
            DURING_BUILD["sanitize_proc"] = _spawn_self(
                "--sanitize-case", (tool, "--tool", check))
        except FileNotFoundError as e:
            rec[check] = {"ran": False, "message": str(e)}
            continue
        rc, text = _finish(*DURING_BUILD["sanitize_proc"],
                           SANITIZE_TIMEOUT_S)
        del DURING_BUILD["sanitize_proc"]
        if rc is None:
            rec[check] = {"ran": False, "message": f"timed out after "
                          f"{SANITIZE_TIMEOUT_S} s"}
            continue
        summary = [ln.strip() for ln in text.splitlines()
                   if "ERROR SUMMARY" in ln or "RACECHECK SUMMARY" in ln]
        errors = sum(int(w) for ln in summary
                     for w in ln.replace(":", " ").split()[3:4]
                     if w.isdigit())
        issues = [ln.strip() for ln in text.splitlines()
                  if ln.startswith("========= ") and (
                      "Error" in ln or "error" in ln or "Hazard" in ln)][:8]
        rec[check] = {"ran": SANITIZE_UP in text,
                      "finished": SANITIZE_DONE in text,
                      "exit": rc, "summary": summary,
                      "errors": errors, "first_issues": issues}
        if not rec[check]["ran"]:
            rec[check]["message"] = (
                "the device did not come up under the tool: "
                + " | ".join(issues or text.strip().splitlines()[-3:]))
        elif check == "memcheck" and (errors or not rec[check]["finished"]):
            rec["checks_s"] = time.perf_counter() - t0
            return rec, (f"sanitize: memcheck on the segment drivers: "
                         f"{summary} {issues}")
    rec["checks_s"] = time.perf_counter() - t0
    return rec, None


def phase_sanitize(torch):
    """sanitize_checks' record (run while nvcc built, or here)."""
    fut = DURING_BUILD.pop("sanitize", None)
    rec, failed = fut.result() if fut is not None else sanitize_checks()
    emit(rec)
    if failed:
        raise AssertionError(failed)
    return rec

REPLACES = {
    "segment_sweep": "quest_tpu/ops/pallas_band.py:1715",
    "b0": "quest_tpu/ops/pallas_band.py:1135",
    "b1": "quest_tpu/ops/pallas_band.py:1139",
    "scb128": "quest_tpu/ops/pallas_band.py:1156",
    "sc": "quest_tpu/ops/pallas_band.py:1213",
    "phase": "quest_tpu/ops/pallas_band.py:1256",
    "parity": "quest_tpu/ops/pallas_band.py:1273",
    "multiphase": "quest_tpu/ops/pallas_band.py:1289",
    "pair": "quest_tpu/ops/pallas_band.py:1435",
    "diagvec": "quest_tpu/ops/pallas_band.py:1324",
    "batchsel": "quest_tpu/ops/pallas_band.py:1371",
}
# S11: the tier bodies of the b0/b1/scb stages
TIER_REPLACES = "quest_tpu/ops/pallas_band.py:1039 (_mxu_dot_general {})"
# the stage_timing record that stands for each stage kind in the kernels
# line: a Kraus pair by its most frequent form on the density path, a
# channel stage by its most frequent position on the trajectory path, S7
# by the main paths' two all-ones terms
KERNEL_RECORD = {"pair": "pair_lane_scat", "batchsel": "batchsel_scat",
                 "multiphase": "multiphase_aa"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--upto", choices=PHASES, default=PHASES[-1],
                    help="stop after this phase (default: run all)")
    # the probe and sanitize phases run these in subprocesses
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--sanitize-case", action="store_true",
                    help=argparse.SUPPRESS)
    # the multiprocess phase runs its ranks through these
    ap.add_argument("--mp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ham-profile", action="store_true",
                    help="build the kernel and print torch.profiler "
                    "tables of the Hamiltonian layers at 30 qubits "
                    "(ham_profile), one JSON line")
    ap.add_argument("--diag-runs", action="store_true",
                    help="build the kernel and time diag_run_cases alone "
                    "(K1, 28 qubits) and the flagship step at each tier, "
                    "one JSON line; it uses only prepare_segment, "
                    "segment_sweep and entry(), so it also times an "
                    "earlier tree's package beside this script")
    args = ap.parse_args(argv)
    import torch
    if args.mp_rank is not None:
        return mp_rank(torch, args.mp_rank, args.mp_dir)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.probe:
        print(json.dumps({"phase": "probe", "cases": probe_drivers(torch)}),
              flush=True)
        return 0
    if args.sanitize_case:
        sanitize_case(torch)
        return 0
    if args.ham_profile:
        from quest_tpu_torch.ops import _build
        _build.build()
        print(json.dumps(ham_profile(torch)), flush=True)
        return 0
    if args.diag_runs:
        from quest_tpu_torch.ops import _build
        _build.build()
        rng = np.random.default_rng(7)
        planes = torch.from_numpy(rng.standard_normal(
            (2, 1 << TIMING_QUBITS)).astype(np.float32)).cuda()
        planes /= planes.double().pow(2).sum().sqrt().float()
        cases = diag_run_timing(torch, planes)
        del planes
        torch.cuda.empty_cache()
        print(json.dumps({"phase": "diag_runs", "nvidia_smi": smi_line(),
                          "cases": cases,
                          "flagship_ms": flagship_tier_ms(torch)}),
              flush=True)
        return 0
    # the port must be importable before anything is printed: run from a
    # directory without it, the script fails here and prints no result
    import quest_tpu_torch  # noqa: F401
    last = PHASES.index(args.upto)

    def want(phase):
        return last >= PHASES.index(phase)
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    if want("serve"):
        prefetch_serve_states()
    start_during_build(want)
    run_phase("build", phase_build)
    if want("probe"):
        run_phase("probe", phase_probe, torch)
    if want("stages"):
        run_phase("stages", phase_stages, torch)
    if want("diag_layer"):
        run_phase("diag_layer", phase_diag_layer, torch)
    if want("big_batch"):
        run_phase("big_batch", phase_big_batch, torch)
    if want("high_target"):
        run_phase("high_target", phase_high_target, torch)
    kernels = []
    if want("drivers"):
        drv_records, drv_launches = run_phase("drivers", phase_drivers, torch)
        flag = {r["tier"]: r for r in drv_records if r["workload"] == "flagship"}
        timed = {"decoupled": "K1", "inplace": "K2/3", "grid": "K3"}
        for (driver, tier), launches in sorted(drv_launches.items()):
            if tier not in flag:
                continue
            fr = flag[tier]
            kernels.append({
                "name": f"segment_sweep<{driver},{tier}>", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": DRIVER_REPLACES[driver],
                "launches": launches, "max_abs_err": fr["max_abs_err"],
                "ms": fr["configs"][timed[driver]]["median_ms"],
                "plain_ms": fr["plain_ms"], "bound_ms": fr["bound_ms"],
                "bound_by": fr["bound_by"], "library_ms": None})
    if want("dma_floor"):
        run_phase("dma_floor", phase_dma_floor, torch)
    if want("sanitize"):
        run_phase("sanitize", phase_sanitize, torch)
    # launches per stage kind on each path, read around that path's run:
    # the statevector kinds from the flagship step, Kraus pairs from the
    # density step, diagonals from the Clifford+T density step
    path_launches = {}
    if want("flagship"):
        fl = run_phase("flagship", phase_flagship, torch)
        path_launches.update(fl["stage_launches"])
        kernels.append({
            "name": "segment_sweep", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES["segment_sweep"], "launches": fl["launches"],
            "max_abs_err": fl["max_abs_err"], "ms": fl["median_ms"],
            "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
            "bound_by": fl["bound_by"], "library_ms": None})
    if want("baseline"):
        run_phase("baseline", phase_baseline, torch)
    if want("density"):
        dens = run_phase("density", phase_density, torch)
        path_launches["pair"] = dens["stage_launches"]["pair"]
    if want("density_bench"):
        run_phase("density_bench", phase_density_bench, torch)
    if want("clifford_t_density"):
        ct = run_phase("clifford_t_density", phase_clifford_t_density, torch)
        path_launches["diagvec"] = ct["stage_launches"]["diagvec"]
    if want("batched"):
        bt = run_phase("batched", phase_batched, torch)
        kernels.append({
            "name": "segment_sweep[batched]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES["segment_sweep"],
            "launches": bt["launches"], "max_abs_err": bt["max_abs_err"],
            "ms": bt["ms_per_call"], "plain_ms": bt["plain_ms"],
            "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
            "library_ms": None})
    if want("trajectory_physics"):
        run_phase("trajectory_physics", phase_trajectory_physics, torch)
    if want("trajectories"):
        tr = run_phase("trajectories", phase_trajectories, torch)
        path_launches["batchsel"] = tr["stage_launches"]["batchsel"]
    if want("precision_stages"):
        run_phase("precision_stages", phase_precision_stages, torch)
    tier_plain = None
    if want("precision_flagship"):
        tier_plain = {}
        for tier, rec in run_phase("precision_flagship",
                                   phase_precision_flagship, torch,
                                   fl).items():
            path_launches.update(rec["stage_launches"])
            tier_plain[tier] = (rec["plain_rel_vs_highest"],
                                abs(1.0 - rec["plain_norm"]))
    if want("precision_baseline"):
        run_phase("precision_baseline", phase_precision_baseline, torch)
    if want("precision_density"):
        run_phase("precision_density", phase_precision_density, torch)
    if want("stage_timing"):
        for rec in run_phase("stage_timing", phase_stage_timing, torch):
            label = rec["label"]
            if KERNEL_RECORD.get(label, label) != rec["name"]:
                continue
            launches = path_launches.get(label, 0)
            if not launches:
                continue        # e.g. sc: no width-1 band at 28 qubits
            tier = rec.get("tier", "highest")
            kernels.append({
                "name": f"segment_sweep[{label}]", "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": (REPLACES[label] if tier == "highest"
                             else TIER_REPLACES.format(tier.upper())),
                "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    if want("phase_counters"):
        run_phase("phase_counters", phase_phase_counters, torch)
    if want("pergate"):
        pergate_out = run_phase("pergate", phase_pergate, torch)[1]
    if want("banded"):
        run_phase("banded", phase_banded, torch, pergate_out, tier_plain)
    if want("pergate"):
        del pergate_out
        torch.cuda.empty_cache()
    if want("f64"):
        run_phase("f64", phase_f64, torch)
    if want("wide_gates"):
        run_phase("wide_gates", phase_wide_gates, torch)
    if want("small_registers"):
        run_phase("small_registers", phase_small_registers, torch)
    if want("batched_banded"):
        run_phase("batched_banded", phase_batched_banded, torch)
    if want("trajectories_banded"):
        run_phase("trajectories_banded", phase_trajectories_banded, torch)
    if want("program_cache"):
        run_phase("program_cache", phase_program_cache, torch)
    if want("measurement"):
        run_phase("measurement", phase_measurement, torch)
    if want("xeb"):
        run_phase("xeb", phase_xeb, torch)
    if want("dynamic"):
        run_phase("dynamic", phase_dynamic, torch)
    if want("calculations"):
        run_phase("calculations", phase_calculations, torch)
    if want("eager"):
        run_phase("eager", phase_eager, torch)
    if want("expec"):
        run_phase("expec", phase_expec, torch)
    if want("evolution"):
        run_phase("evolution", phase_evolution, torch)
    if want("variational"):
        run_phase("variational", phase_variational, torch)
    if want("adjoint"):
        one_grad = run_phase("adjoint", phase_adjoint, torch)[1]
    if want("frontends"):
        run_phase("frontends", phase_frontends, torch)
    if want("api"):
        run_phase("api", phase_api, torch)
    if want("scan"):
        run_phase("scan", phase_scan, torch)
    if want("sharded"):
        run_phase("sharded", phase_sharded, torch)
    if want("sharded_batched"):
        run_phase("sharded_batched", phase_sharded_batched, torch)
    if want("sharded_measured"):
        run_phase("sharded_measured", phase_sharded_measured, torch)
    if want("sharded_consumers"):
        run_phase("sharded_consumers", phase_sharded_consumers, torch,
                  one_grad)
        del one_grad
    if want("durable"):
        run_phase("durable", phase_durable, torch)
    served = None
    if want("serve"):
        apply_row, traj_row, served = run_phase("serve", phase_serve, torch)
        for label, row in (("serve", apply_row), ("serve_traj", traj_row)):
            kernels.append({
                "name": f"segment_sweep[{label}]", "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES["segment_sweep" if label == "serve"
                                     else "batchsel"],
                "launches": row["launches"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None})
    if want("fleet"):
        run_phase("fleet", phase_fleet, torch, served)
        del served
    if want("profiling"):
        run_phase("profiling", phase_profiling, torch)
    if want("audit"):
        run_phase("audit", phase_audit, torch)
    if want("multiprocess"):
        mp = run_phase("multiprocess", phase_multiprocess, torch)
        kernels.append({
            "name": "segment_sweep[multiprocess]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES["segment_sweep"],
            "launches": mp["flagship"][0]["launches_per_rank"],
            "max_abs_err": mp["k1"]["max_abs_err"], "ms": mp["k1"]["ms"],
            "plain_ms": mp["k1"]["plain_ms"],
            "bound_ms": mp["k1"]["bound_ms"],
            "bound_by": mp["k1"]["bound_by"], "library_ms": None})
    emit({"phase": "seconds", "phases": dict(PHASE_SECONDS),
          "total": time.perf_counter() - T_START})
    if kernels:
        emit({"kernels": kernels})
    print(smi, flush=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
