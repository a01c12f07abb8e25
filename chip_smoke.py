#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch + CUDA port (``jaybenne_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (``python3
chip_smoke.py``, no arguments). It builds the port's CUDA kernels from ``csrc/``,
holds each against its plain PyTorch version, drives the port's paths through
``driver.run_file`` on the GPU (the stepdiff gates with IMC and DDMC; the inf and
inf_stiff equilibrium gates; a 2D and the 64^3 matter-coupled feedback
configurations; the 64^3 DDMC mesh; the refined-mesh decks up to the 128x64
hybrid forest; EPBremss at spread photon energies in 1D, at 64^3 and on the
shipped SMR forest; the Su-Olson deck with its external source; a tabulated
opacity; both decompositions at 8 shards in this process, the card's one
backend; checkpoint/restart, debug_checks and --profile-dir; the float64 census,
precision = f64, of every instantiation and its gates), and checks each
result by the repository's own gates. Every phase raises on failure; the last line of
standard output is the JSON result, printed only when every phase passed. It exits
non-zero without a GPU. Nothing here imports jax.

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc time of the kernel library; every instantiation's registers,
     stack frame and spills (``-Xptxas -v``) and resident blocks a SM (the phase
     fails where a float64 route of ``F64_RESIDENT_FLOOR`` spills or holds fewer
     blocks than its floor, printed beside it), and the local-memory
     instructions (LDL/STL) of each one with a stack frame; the SASS
     instructions of the event loop's paths (``loop_paths``: the common path, a
     scatter in the lane's cell; a crossing; any outcome but a wall; the whole
     loop) of transport_1d, transport_2d_abs, transport_2d_smr and
     transport_3d_abs; the counting variant of the kernel (``path_mix_library``)
     built beside the library; the native mesh builder's g++ seconds and its
     forests of stepdiff_smr_hybrid and stepdiff_3d against the Python builder's
     (bitwise, each timed: ``native_build_line``);
  3. K2: the CUDA raw_bits hash is bit-identical to the PyTorch hash;
  4. K1(a): the CUDA census kernel against its plain version on one ledger
     (2^17 particles, gate mesh, sigma_s = 1024): after 8 iterations integer state
     identical and floats within FLOAT_RTOL; after a full census every live slot at
     tau = 1, event totals within 2 %, mean and std of x within the CPU tests'
     tolerances;
  5. main path: stepdiff at 128 cells, 100k particles, 10 steps through the kernel
     (launch count 10), weighted-mean erf error <= 0.05, radiation energy conserved
     to 1e-5; event total, wall time per step and events/s; two steps of the
     plain version (use_pallas = off) for comparison, eager (no graph) and with
     no census launch; the kernel and its plain version
     timed on the main path's own ledger; the event loop's reading (registers,
     spills, common path, slot-order warp efficiency and issue share) there; its
     warp path mix (``path_mix_line``: the counting variant on the same ledger,
     the share of warp-events in which a lane scattered, crossed, reached a wall,
     gathers its cell anew or reached census, and from it and the loop's paths
     the instructions a warp issues an event and the warp issue share, and how
     the lane-events spread over the SMs, read by %smid); K2
     alone: the census's words drawn by the census_words probe, against its plain
     version and its bound;
  6. determinism: the main path again with the same seed gives bitwise-identical
     tallies;
  7. the absorbing census kernel against its plain version in 3D (2^17 particles
     on a 16^3 periodic mesh in 8^3 blocks, sigma_s = 768, f sigma_a = 256, so
     p_abs = 0.25) and in 2D: after 8 iterations integer state, alive and absorbed
     identical and floats within FLOAT_RTOL; after a full census of the last 1 %
     of a step every live slot at tau = 1, events within 2 %, absorbed counts
     within 4 binomial sd;
  8. the inf gate: inputs/inf.in with tst/inf.py's overrides (tlim 2e-11, 2000
     particles, seed 42), 20 steps through the 3D absorbing kernel; the mean
     fractional error of the tally against a T0^4 (tst/regression_test.py's
     "mean" comparison) <= 0.1; then a 2D matter-coupled path (128^2 cells,
     emission and feedback, 3 steps) through the 2D absorbing kernel, and on its
     ledger transport_2d_abs's event loop line, how its live lanes and events
     spread over blocks of 256 slots (``block_spread_line``) and its warp path
     mix, with its lane-events by SM;
  9. the full-width path: bench.py's big_mesh_feedback configuration (64^3 cells
     in 8^3 blocks, 200k particles, emission and feedback, sigma_a = 3 on
     sigma_s = 1e3), 3 steps through the 3D absorbing kernel (3 launches): total
     energy conserved to 1e-2 of the radiation energy, nothing dropped, every
     census complete, events within 5 % of the JAX package's count; events, step
     time, events/s and peak device memory; the kernel and its plain version timed
     on the path's own ledger;
 10. determinism of phase 9: a second run gives bitwise-identical tallies and u;
 11. K1(c): all twelve census instantiations (IMC and DDMC, 1D/2D/3D, with and
     without absorption) against their plain versions on a hybrid ledger (2^17
     particles; x-slabs of cells alternate thin, sigma_t = 64, and thick,
     sigma_t = 1024, so that IMC arrivals at DDMC faces pass or fail the albedo
     test, DDMC lanes leak into IMC cells and walls, reach census and are
     absorbed): after 8 iterations integer state, alive, absorbed and face
     identical and floats within FLOAT_RTOL; after a full census of the last
     10 % of a step events within 2 % and absorbed counts within 4 binomial sd
     (the 3D DDMC ones held as after 8 iterations, with the same events;
     phase 15 holds their SMR twins so);
 12. the DDMC main path: inputs/stepdiff_ddmc.in with bench.py's ddmc overrides
     (128 cells, 100k particles), 10 steps through transport_1d_ddmc (10
     launches): werr <= 0.05, radiation energy conserved to 1e-5, a bitwise
     rerun, events within 5 % of the JAX package's 11939980 and below a quarter of
     phase 5's IMC total; on the last census the call split and the table kernel
     bitwise against its plain version (the 1D DDMC record);
 13. the stiff gate: inputs/inf_stiff.in with tst/inf_stiff.py's overrides
     (400000 particles, seed 42), 10 steps through transport_1d_abs_ddmc: mean
     fractional error of the tally against a T0^4 <= 0.15; the call split;
 14. full width in 3D, K3's DDMC function: bench.py's big_mesh configuration
     (64^3 cells in 8^3 blocks, 200k particles) with use_ddmc, 10 steps through
     transport_3d_ddmc (10 launches), every cell on the DDMC branch: the
     volume-weighted x-profile in 64 bins against the erf solution <= 0.1
     (tst/regression_test.py::profile_comparison), the solution scaled by the
     share of a T^4 that the thermal source put in (0.76 at 0.76 particles a
     cell), sum(tally dV) conserved to 1e-5, every census complete, a bitwise
     rerun; on the last census's inputs the call split (``call_split_line``: the
     cell table, the forest tables, the counters, the launch), a full census
     whose kernel folds the ledger's collapse to one block and its expansion back
     into its reads and writes against the plain collapse, census and expansion,
     every column bitwise (``fold_check``), and the census table kernel
     (csrc/table_kernel.cu, one launch a census) against its plain version,
     bitwise, timed beside its
     bound (``table_check``); phase 30 holds the table so on big_mesh_spatial's
     eight coefficient sets and the fold on its joined ledger, and every counted
     path lists the table kernel's launches in its entry (``note_table``); then
     the 2D and the absorbing 2D/3D DDMC instantiations, which no path runs, timed
     on phase 11's ledger;
 15. K1(d): all twelve SMR instantiations against their plain versions on a
     level-1 forest per dimension (2^17 particles; x-slabs of four coarse cells
     alternate thin and thick, so that IMC crossings change level both ways and
     coarse-to-fine DDMC leaks resample onto fine subfaces): after 8 iterations
     integers, blocks, alive, absorbed and face identical and floats within
     FLOAT_RTOL; after a full census events within 2 % and absorbed counts within
     4 binomial sd; the resamples of the first event counted (> 0 in 2D/3D DDMC);
 16-21. SMR decks through ``driver.run_file``, 10 steps each, every one with one
     launch a step of its SMR instantiation, every census complete short of the
     iteration cap, sum(tally dV) conserved to 1e-5 and a bitwise rerun, its lane
     split (IMC/DDMC blocks) printed: 16 stepdiff_smr (tst/stepdiff_smr.py's 64x32
     cells in 16^2 blocks, 100k particles; per-cell werr <= 0.3); 17 the same with
     stepdiff_smr_ddmc.in (<= 0.3); 18 the hybrid gate (bench.py:395-439: tau_ddmc
     = 10; <= 0.3, events within 5 % of the JAX package's 848178320); 19
     stepdiff_smr2 (levels 0/1/2): the x-profile <= 0.1 with IMC and with DDMC at
     tau_ddmc = 2.5, then per-cell werr <= 0.3 at 400k particles; 20 stepdiff_3d
     (32x16x16 in 8^3 blocks, 500k particles, DDMC; <= 0.3); 21 full width:
     stepdiff_smr_hybrid.in at its own 128x64 cells in 32^2 blocks, x-profile
     <= 0.1, per-cell werr printed, events within 5 % of the JAX package's
     951619492.

 22. the NONGRAY instantiations: all twelve (uniform 1D/2D/3D and level-1 SMR
     forests, IMC and DDMC) against their plain versions on hybrid ledgers of 2^17
     particles with EPBremss per cell (rho, T and fleck spread) at spread photon
     energies, so that a cell's lanes are thin and thick alike: after 8
     iterations and after a full census of the last 10 % of a step integers,
     blocks, alive, absorbed and face codes identical, floats within 1e-6;
 23. non-gray K1(e): inputs/stepdiff.in at tst/stepdiff.py's 128 cells and 100k
     particles with the ep_bremss overrides of tests/test_pallas.py:1402-1416, one
     step through transport_1d_abs_ng: w_live + absorbed = w0 to 1e-4, the
     survivors harden, and their count and mean energy agree with the JAX
     package's run of the same configuration (within 4 sqrt(n) and 0.3); on the
     census's inputs the call split;
 24. K3's non-gray function: bench.py's big_mesh_feedback geometry (64^3 cells in
     8^3 blocks, 200k particles, emission and feedback) with EPBremss and the other
     ep_bremss overrides, 3 steps of 1e-12 s through transport_3d_abs_ng: energy
     conserved to 1e-2 of the radiation energy, nothing dropped, a bitwise rerun,
     events within 5 % of the JAX package's; on the last census the call split,
     the table kernel and the fold, bitwise against their plain versions;
 25. K4's non-gray function: inputs/stepdiff_smr.in as shipped (128x64 cells, 100k
     particles) with the overrides of tests/test_pallas.py:1531-1546, one step
     through transport_2d_abs_smr_ng: the gates and the call split of phase 23;
 26. the Su-Olson gate: inputs/suolson.in as shipped (64 cells, 40 steps, 8000 +
     8000 particles) with tst/suolson.py's overrides: the external source, the
     power-law-cv EOS and the 1D absorbing kernel; E_matter + E_radiation - E(0)
     within 1e-2 of q V_src min(t, tmax), nothing dropped, a bitwise rerun;
 27. the tabulated opacity: the table of tests/test_pallas.py:1354-1358 written to
     a temporary .npz, at the stepdiff gate's size for one step: absorbed > 0,
     w_live + absorbed = w0 to 1e-4.

 28. K3s, the owned-range kernel on a z-slab: bench.py's big mesh (64^3 in 8^3
     blocks, periodic y and z) split in 8 shards of one z-plane of blocks, 2^17
     particles on shard 3's slab and then on the seam shard 7's, one round each:
     the kernel and its plain version identical in every column (floats
     bitwise), every paused lane outside the shard's z cells (across the
     periodic z seam too), every lane inside at census or absorbed; then all 8
     shards' slices of one ledger (4 times the card's resident threads) in one
     launch against the plain per-shard calls in order, bitwise;
 29. K4s, the owned-range kernel over blocks: the 32x16 stepdiff_smr_ddmc forest
     in 8x8 blocks (tests/test_spatial.py:463-467) with phase 15's thin and thick
     slabs, shards 0 and 1 of 2, 2^17 particles each, one round: as phase 28, and
     shard 0 writes pending leak codes (into shard 1's finer blocks; shard 1
     holds fine blocks only), identical between kernel and plain; then 8 shards
     of 3 blocks (4 padding blocks) in one launch at 4 times the resident
     threads against the plain per-shard calls, bitwise, leak codes written;
 30. big_mesh_spatial (bench.py:291-313: 64^3, 8^3 blocks, 200k particles, 3
     steps, spatial) at 1 and 8 shards: events within 5 % of the JAX package's
     658342636, sum(tally dV) equal to the live weight to 1e-5, every census
     complete, one census launch a round queued (the rounds of a batch, its
     no-op rounds too; launches a step printed; the steps after the first run as
     CUDA graphs) and at 8 shards one pass of the migration kernel (two
     launches), at 1 none; migration
     rounds, migrated particles, step times and events/s printed; one count
     kernel launch a round queued and one a step's tail; K3s timed on
     the first round (one launch over the 8 shards, with the fold: every column of
     the joined ledger bitwise the plain version's), with the slot order's warp
     efficiency; the table kernel on the first step's eight coefficient sets;
 31. stepdiff through the spatial decomposition at 8 shards
     (tst/launch_ci_runner.py:72-74: 128 cells in 16-cell blocks, 100k particles,
     capacity_factor 4; then the CI's row :66-71, 32 cells in 2-cell blocks, 16k
     particles): werr <= 0.05 each;
 32. the 8-device SMR rows of tst/launch_ci_runner.py (:33, :35, :37, :42) under
     the particle decomposition, 10 steps each with one census launch a step over
     the 8 shards' slices and a bitwise rerun as CUDA graph replays (with the
     eager run's history): stepdiff_smr, stepdiff_smr_ddmc and the hybrid at
     tau_ddmc = 10 werr <= 0.3, stepdiff_smr2 x-profile <= 0.1; each row's
     recorded last census as one launch (device seeds, ``own`` None) bitwise the
     plain call over the list and the launches shard by shard
     (``particle_census_check``); then each row's replayed step by
     ``profile.read_steps`` (``particle_step_line``: device ms a
     step, the census kernel's, the other hand-written kernels' and the
     replicas' plain PyTorch work, the step wall);
 33. spatial + SMR + DDMC at 8 shards (tests/test_spatial.py:546-586: 32x16 in
     8x8 blocks, 96k particles, 2 steps): the tally equal to the live weight,
     pending leaks resolved by their owners (counted) and none left, the
     weighted difference from a one-device run < 0.10; K4s (its shards' slot
     groups interleaved over the first wave) timed on the first and the second
     round, each bitwise its plain version, its mean round as the driver runs
     the deck to 6e-11, and each recorded round's busiest SM against the mean
     (the counting variant's lane-events by %smid);
 34. determinism: phase 30 at 8 shards again gives bitwise-identical tallies
     (phase 32's rows were each rerun);
 35. phase 25's path (stepdiff_smr with ep_bremss, 100k particles, one step) at
     seeds 1-4: the mean survivors against the JAX package's at the same seeds
     within 4 sd of the difference of the means;
 36. the regrouping schedule at scale: the twelve DDMC instantiations (uniform and
     SMR, gray) on hybrid ledgers of 4 times the card's resident threads, so that
     blocks run in several waves, a full census of the last 10 % of a step,
     kernel and plain identical in every column (phases 28-29 hold both
     owned-range routes at that size);
 37. checkpoint/restart on the main path: stepdiff at 128 cells and 100k
     particles, 5 steps, ``checkpoint_tree`` through ``np.savez``/``np.load``, a
     new ``Simulation(restart=tree)`` (what ``-r`` builds after reading a file), 5
     more steps: tally, u and every ledger column bitwise the 10-step run's, one
     ``transport_1d`` launch a step; the tree's bytes and the ms to build and to
     restore it;
 38. restart under the spatial decomposition on phase 31's full row: a resume at
     8 shards bitwise the straight run; at 4 shards after re-homing every census
     complete and the radiation energy conserved to 1e-5; a 1-shard tree at 8
     shards: only the misplaced slots move (counted), every other slot
     byte-identical;
 39. ``jaybenne/debug_checks`` on stepdiff_smr (phase 16's deck), 10 steps: every
     cycle validated, the ms ``validate_state`` adds a step, the run bitwise the
     unchecked one;
 40. ``driver.main`` with ``--profile-dir``, 3 steps of stepdiff: the Chrome trace
     holds the transport_1d kernel (``profile.device_time_by_name``) and
     ``history.json`` 3 cycles with the JAX package's keys. The card's machine has
     no h5py: the HDF5 writers and readers are held to the JAX package's on the
     CPU (``tests/test_torch_io.py``);
 41. the double draw of the float64 census (precision = f64; ``Draw<double>`` of
     csrc/kernel_rng.cuh): its u53, spare u53, exp, cos and sin bitwise the plain
     float64 pool's (``kernel_rng.draws_f64_plain``) on raw_bits's words;
 42. every one of the 36 float64 instantiations (csrc/transport_kernel_f64.cu)
     bitwise its float64 plain version on phase 11's, 15's and 22's ledgers made
     float64, after 8 iterations and after a full census, every column and the
     events identical, only ``_f64`` launches; one K3s and one K4s round (phases
     28-29) in float64 so too;
 43. the float64 gates through ``driver.run_file``, each launching float64 kernels
     alone: stepdiff at 128 cells and 100k particles, 10 steps (10
     ``transport_1d_f64`` launches, werr <= 0.05, the radiation energy conserved
     to the fixed-point tally's bound, ``tally.conservation_rtol``), stepdiff_ddmc
     (<= 0.05; the float64 table kernel bitwise its plain version),
     stepdiff_smr (<= 0.3), one EPBremss step on stepdiff_smr (phase 25's gate),
     stepdiff at 8 spatial shards (<= 0.05); each route's kernel and plain
     version timed on its last census (the spatial one on its first round, and
     the mean round's device time beside it, ``mean_round_line``); each
     redesigned route's census time beside its time before the redesign
     (``F64_REDESIGNED``, PERF.md's figures) and its ``redesigned`` entry in the
     ``kernels`` line;
 44. the float64 census against the float32 one on the same inputs, in turns,
     median of 5 with its range, on stepdiff's, the 2D feedback path's, the
     64^3 feedback row's and stepdiff_smr's last census; the float64 bound
     (8-byte floats over 3.35 TB/s, operations from the float64 probes' SASS over
     34 TFLOP/s FP64);
 45. the step without the host: a CUDA graph's replay after manual_seed draws
     what the eager draw does (``CUDAGraph.register_generator_state``); each of
     ``GRAPH_PATHS`` (stepdiff, stepdiff_ddmc, the 64^3 DDMC and feedback rows,
     stepdiff_smr, stepdiff_smr at 8 particle shards (one graph over the shards'
     states), stepdiff with ep_bremss, stepdiff at precision = f64, a 2D
     feedback path whose ledger grows mid-run, so that it is captured again,
     Su-Olson across tmax, and graphs of the spatial step's head, batches of
     rounds and tail: big_mesh_spatial at 8 and at 1 shard, phase 33's SMR+DDMC
     deck at 8 shards, and Su-Olson at 2 shards across tmax, its ledger growing
     so that its graphs are captured again) run step by step with
     the eager step and with the graph (``run_file(..., graph=False)`` and as the
     driver runs it), every field, ledger column, counter, ``overflow`` and the
     launches bitwise equal after every step, then one more replay under
     ``torch.cuda.set_sync_debug_mode("error")``, a spatial batch's exit read
     alone let through and counted (one a batch); the
     insert kernel (csrc/insert_kernel.cu: destinations by scans, then the
     writes, three launches a pass) bitwise its plain version on the 64^3
     feedback row, its destinations the parent's stable sort's, timed beside its
     bound and the parent's destinations part by part (its launches are phase
     9's: the initial radiation's births and one pass a step), and bitwise its
     plain version on the inserts the main paths make (``insert_paths_check``:
     stepdiff's initial source, a grid with broadcast columns; the 8-shard
     spatial step's migration arrivals, every shard in one pass with
     ``reserved``, timed against the parent's destinations a shard at a time;
     stepdiff's initial source at precision = f64); the migration kernel
     (csrc/migrate_kernel.cu: each local shard's in-transit slots ranked by
     destination by a single-pass scan with a decoupled look-back and packed into
     rows, the valid flags apart, every local shard in one launch a round) bitwise
     its plain version (rows, flags, sent, alive) on big_mesh_spatial's first
     two rounds at 8 shards and on the float64 stepdiff's first, each again with
     go false (``migration_check``), and its first rounds read apart against the
     parent's PyTorch migrate (``migration_reading``), beside them the round's
     bookkeeping on the device before the count kernel (the z route's kept
     clones and their ``torch.where``, the gated counters, each shard's
     unfinished sum) and after it (one ``round_counts`` launch), its device ms and
     device operations a round (``round_bookkeeping``); the
     8-shard big_mesh_spatial step, eager and replayed, under the same mode but
     for each batch's exit read (counted: one a batch) and the step's packed read;
     the host's synchronisations a step (``profile.host_syncs``) on stepdiff, the
     64^3 feedback row, Su-Olson (0 a step, or the phase fails) and the 8-shard
     spatial row; the step wall times, eager against graph replays, of stepdiff,
     the 64^3 DDMC and feedback rows, stepdiff_smr, Su-Olson and the spatial
     rows;
 46. the tally kernel (csrc/tally_kernel.cu: every local shard's slots in one
     pass of three launches, the deposit and the tally together) bitwise its
     plain version on every pass of a step's run (the initial radiation's and the
     first step's) of stepdiff (128 cells, 201152 slots), the 64^3 feedback row
     (deposit and tally), the 64^3 DDMC row, the float64 stepdiff, stepdiff_smr
     at 8 particle shards and big_mesh_spatial's 8-shard tail; the DDMC face
     kernel (csrc/faces_kernel.cu: every local shard's faces in one launch, from
     a side map built once per mesh) bitwise its plain version on the 64^3 DDMC
     row (3D, periodic y and z) and stepdiff_ddmc (1D), each in float32 and
     float64, the native hybrid's and stepdiff_smr_ddmc's refined forests (the
     latter in float64 too) and the 8-shard spatial head from the all-gathered
     surfaces; each read apart on the path's first step (``kernel_reading``:
     device ms by launch from torch.profiler, with how many launches the trace
     holds; the event window after a device sleep; the plain version's; the
     bytes bound); then profile.py on the 64^3 DDMC row as a graph and eagerly
     (its spans), stepdiff and the 64^3 feedback row. Their ``kernels`` entries
     take their launches from phase 14's run, with every counted path's beside;
 47. the round's gate and counts: on the first two recorded rounds of each
     spatial route (transport_3d@z on big_mesh_spatial, transport_1d_smr@blocks
     and transport_1d_smr_f64@blocks on stepdiff, transport_2d_ddmc_smr@blocks on
     phase 33's deck, each at 8 shards) the census kernel with go false leaves
     every column bitwise as it was and counts nothing, and with go true is
     bitwise the ungated launch (``census_gate_bitwise``); the count kernel
     (csrc/count_kernel.cu: every local shard's live and unfinished counts in one
     launch, a spatial round's counters folded in) bitwise its plain version on
     the first rounds and every step's or tail's call of those four runs and of
     stepdiff, the 64^3 DDMC and feedback rows and stepdiff_smr at 8 particle
     shards (``counts_bitwise``), and read apart on big_mesh_spatial's and the
     float64 stepdiff's first round and tail and the 64^3 DDMC row's step
     (``kernel_reading``, the plain version's device ms beside it). Its
     ``kernels`` entry takes its launches from phase 30's 8-shard run (one a round
     queued and one a step's tail, which phase 30 checks), every counted path's
     beside;
 48. the host between a spatial step's batches, by part (``host_gap_phase``): on
     big_mesh_spatial and the float64 stepdiff at 8 shards as CUDA graphs, with
     no batch queued ahead of an exit read and with one (the step's ``ahead``),
     in turns, every run's migration rounds and events equal: the step wall less its
     device time, the rounds queued a step, and the host ms a step of the exit
     reads, the round prologues and the batch replays (their spans).

The recorded runs of phases 12-14, 16-21 and 23-25 and of ``census_bench.py``
run the eager step (``graph=False``): a CUDA graph's replay calls no Python, so
``CensusRecorder`` could not see its census; each of those phases' reruns runs
as the driver runs it, a graph on one device, and is held bitwise to it.

Phase 21 also prints the slot order's warp efficiency of the native hybrid's last
census (``transport_kernel.warp_efficiency`` of the plain version's per-slot
events): the share of a one-thread-per-slot warp's issued events that are real,
the yardstick of what the regrouping schedule can win.

For phases 12-14, 16, 20, 21 and 23-25 the kernel and its plain version are timed
on the inputs of the path's last census, recorded as the path ran; for phases 30
and 33 on the first round (one launch over every shard, with the step's census
set-up). A kernel's time is the median of CENSUS_REPEATS censuses on fresh copies
of the same inputs, printed with their range; the plain version's is one census.
Phases 8, 9 and 16 print the event loop's reading as phase 5 does.

For each kernel the JSON line gives its bound: the larger of the bytes the census
must move over 3.35 TB/s and its operations over 67 TFLOP/s (float32 outside the
tensor cores; 34 TFLOP/s FP64 for a float64 route), from this run's events (see
``census_bound``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import typing

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F64 = torch.float64
# the float64 routes redesigned (csrc/transport_kernel.cuh: the lean lane, kLean, on
# the two forests; the resident grid in rounds, kRounds, on the uniform 1D mesh,
# whose grid is as many blocks as the card holds): the resident blocks of 256 a SM
# each holds on an H100 with no spill bytes (phase 2 fails without them)
F64_RESIDENT_FLOOR = {"transport_2d_smr_f64": 3, "transport_1d_smr_f64": 4,
                      "transport_1d_f64": 4, "transport_1d_ddmc_f64": 4,
                      "transport_2d_abs_smr_ng_f64": 3}
DECK = os.path.join(ROOT, "inputs", "stepdiff.in")
GATE = {
    "parthenon/mesh/nx1": 128,
    "parthenon/meshblock/nx1": 128,
    "jaybenne/num_particles": 100000,
    "parthenon/output0/file_type": "none",
}
N_STEPS = 10
PLAIN_STEPS = 2  # phase 5: steps of the plain version (use_pallas = off)
WERR_TOL = 0.05
ENERGY_RTOL = 1e-5
# kernel vs plain after 8 iterations: both run the same IEEE float32 operations
# (the kernel is built without fast math or FMA contraction), so any difference
# is a 1-ulp difference of a math-library call carried through a few events
FLOAT_RTOL = 1e-5
EVENTS_RTOL = 0.02
MEAN_ATOL = 0.01  # the CPU tests' tolerances (tests/test_pallas.py)
STD_RTOL = 0.10
N_SIGMA_BINOMIAL = 4.0
# kernel vs plain in 2D/3D: the relative error of a float is taken against this
# floor, so a position or velocity component near 0 does not inflate it
FLOAT_FLOOR = {"x": 1e-3, "y": 1e-3, "z": 1e-3, "tau": 1e-3,
               "vx": 1e-3 * 2.99792458e10, "vy": 1e-3 * 2.99792458e10,
               "vz": 1e-3 * 2.99792458e10}

INF_DECK = os.path.join(ROOT, "inputs", "inf.in")
INF = {  # tst/inf.py's overrides
    "parthenon/time/tlim": "2.e-11",
    "jaybenne/num_particles": 2000,
    "jaybenne/seed": 42,
    "parthenon/output0/file_type": "none",
}
INF_STEPS = 20
INF_TOL = 0.1
# bench.py's big_mesh_feedback row (bench.py:333-364; its specific_heat key is read
# by neither package, which take the specific heat from mcblock/cv)
FEEDBACK = {
    "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64, "parthenon/mesh/nx3": 64,
    "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
    "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
    "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
    "parthenon/meshblock/nx3": 8,
    "jaybenne/num_particles": 200000,
    "jaybenne/do_emission": "true",
    "jaybenne/do_feedback": "true",
    "mcblock/opacity_model": "constant",
    "mcblock/opacity_constant_value": 3.0,
    "mcblock/specific_heat": 30.3,
    "jaybenne/capacity_factor": 3,
    "parthenon/output0/file_type": "none",
}
FEEDBACK_STEPS = 3
FEEDBACK_ENERGY_TOL = 1e-2  # bench.py:379-391
# the JAX package's 3-step event total for the same configuration
# (BENCH_r05.json, big_mesh_feedback.events_total): a count of the physics
FEEDBACK_JAX_EVENTS = 871578029
FEEDBACK_EVENTS_RTOL = 0.05
# a 2D matter-coupled path: the feedback configuration on a 128^2 mesh in 32^2
# blocks with 50k particles
FEEDBACK_2D = {
    **{k: v for k, v in FEEDBACK.items() if "nx3" not in k and "x3_bc" not in k},
    "parthenon/mesh/nx1": 128, "parthenon/mesh/nx2": 128,
    "parthenon/meshblock/nx1": 32, "parthenon/meshblock/nx2": 32,
    "jaybenne/num_particles": 50000,
}
FEEDBACK_2D_STEPS = 3
# phase 11: thin (IMC) and thick (DDMC) x-slabs; fleck sigma_a when absorbing
HYBRID_SIGMA = (64.0, 1024.0)
HYBRID_SIGMA_A = 2.0
HYBRID_N = 1 << 17
DDMC_DECK = os.path.join(ROOT, "inputs", "stepdiff_ddmc.in")
DDMC_GATE = {  # bench.py's ddmc row (bench.py:235-243)
    "parthenon/mesh/nx1": 128,
    "parthenon/meshblock/nx1": 128,
    "jaybenne/num_particles": 100000,
    "parthenon/output0/file_type": "none",
}
# the JAX package's 10-step event total of the ddmc row (BENCH_r05.json, ddmc
# events_total): a count of the physics
DDMC_JAX_EVENTS = 11939980
DDMC_EVENTS_RTOL = 0.05
DDMC_IMC_EVENTS_RATIO = 0.25  # tests/test_ddmc.py:80
STIFF_DECK = os.path.join(ROOT, "inputs", "inf_stiff.in")
STIFF = {  # tst/inf_stiff.py's overrides
    "jaybenne/num_particles": 400000,
    "jaybenne/seed": 42,
    "parthenon/output0/file_type": "none",
}
STIFF_STEPS = 10
STIFF_TOL = 0.15
BIG_DDMC = {  # bench.py's big_mesh row (bench.py:265-279) with DDMC
    "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64, "parthenon/mesh/nx3": 64,
    "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
    "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
    "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
    "parthenon/meshblock/nx3": 8,
    "jaybenne/num_particles": 200000,
    "jaybenne/use_ddmc": "true",
    "parthenon/output0/file_type": "none",
}
# SMR (phases 15-21): the gate decks of tst/ and bench.py on refined forests
SMR_DECK = os.path.join(ROOT, "inputs", "stepdiff_smr.in")
SMR_DDMC_DECK = os.path.join(ROOT, "inputs", "stepdiff_smr_ddmc.in")
SMR2_DECK = os.path.join(ROOT, "inputs", "stepdiff_smr2.in")
HYBRID_DECK = os.path.join(ROOT, "inputs", "stepdiff_smr_hybrid.in")
SMR3D_DECK = os.path.join(ROOT, "inputs", "stepdiff_3d_smr_ddmc.in")
SMR_GATE = {  # tst/stepdiff_smr.py's mesh overrides (and tst/stepdiff_smr2.py's)
    "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 32,
    "parthenon/meshblock/nx1": 16, "parthenon/meshblock/nx2": 16,
    "parthenon/output0/file_type": "none",
}
SMR_TOL = 0.3  # tst/stepdiff_smr.py, tst/stepdiff_3d.py
PATH_STEPS = 10  # phases 12, 14 and 16-21
HYBRID_GATE = {**SMR_GATE, "jaybenne/tau_ddmc": 10.0,  # bench.py:402-439
               "jaybenne/num_particles": 100000}
# the JAX package's 10-step event totals (a count of the physics): the hybrid
# gate (BENCH_r05.json, hybrid.events_total) and the native 128x64 hybrid deck
# (tst/logs/r5_hybrid.json)
HYBRID_JAX_EVENTS = 848178320
NATIVE_HYBRID_JAX_EVENTS = 951619492
SMR_EVENTS_RTOL = 0.05
SMR2_DDMC = {**SMR_GATE, "jaybenne/use_ddmc": "true",  # tst/launch_ci_runner.py:43-45
             "jaybenne/tau_ddmc": 2.5}
SMR2_PER_CELL = {**SMR_GATE, "jaybenne/num_particles": 400000}  # :49-50
SMR3D = {"jaybenne/num_particles": 500000,  # tst/stepdiff_3d.py
         "parthenon/output0/file_type": "none"}
NATIVE_HYBRID = {"parthenon/output0/file_type": "none"}
# phase 15: a level-1 forest per dimension, x-slabs of four coarse cells
# alternating thin and thick sigma_t by cell centre (HYBRID_SIGMA: IMC and DDMC on
# both levels in 2D/3D)
SMR_FORESTS = {
    1: (DECK, {"parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 16,
               "parthenon/mesh/refinement": "static",
               "parthenon/static_refinement1/level": 1,
               "parthenon/static_refinement1/x1min": -0.25,
               "parthenon/static_refinement1/x1max": 0.25}),
    2: (SMR_DECK, dict(SMR_GATE)),
    3: (SMR3D_DECK, {}),
}
# non-gray (phases 22-27): the ep_bremss overrides of tests/test_pallas.py:1402-1416
# (and :1531-1546); cv = 1e8 keeps the Fleck factor near 1, without which a soft
# photon in a cold cell scatters at sigma ~ 1e20 and no census completes
EPB = {
    "mcblock/opacity_model": "ep_bremss",
    "mcblock/initial_temperature": "1.0e6",
    "mcblock/cv": "1.0e8",
    "mcblock/scattering_constant_value": "1.0e2",
    "jaybenne/do_emission": "false",
    "jaybenne/do_feedback": "false",
    "jaybenne/dt": "1.e-12",
    "parthenon/time/tlim": "1.e-12",
}
NG_GATE = {**GATE, **EPB}
NG_BIG = {**FEEDBACK, **EPB, "jaybenne/do_emission": "true", "jaybenne/do_feedback": "true",
          "parthenon/time/tlim": "3.e-12"}
NG_SMR = {**EPB, "jaybenne/use_ddmc": "false", "parthenon/output0/file_type": "none"}
NG_RTOL = 1e-6  # phase 22: kernel vs plain, floats
NG_ENERGY_RTOL = 1e-4  # w_live + absorbed = w0 (tests/test_pallas.py:1430)
NG_SIGMA_COUNT = 4.0  # survivors within 4 sqrt(n) of the JAX package's
NG_MEAN_E_RTOL = 0.3  # their mean photon energy within 0.3
# the JAX package's numbers for the same configurations, from its XLA event loop
# on the CPU (jax_reference.py): (survivors, their mean photon energy) after the
# step of phases 23 and 25, and the 3-step event total of phase 24
NG_GATE_JAX = (2815, 443.0566841735298)
NG_SMR_JAX = (2730, 442.2889385852185)
NG_BIG_JAX_EVENTS = 1355348
SUOLSON_DECK = os.path.join(ROOT, "inputs", "suolson.in")
SUOLSON_GRAPH_STEPS = 22  # phase 45: past the step in which the source window closes
SUOLSON = {  # tst/suolson.py's overrides: a closed slab
    "parthenon/swarm/ix1_bc": "jaybenne_reflecting",
    "parthenon/swarm/ox1_bc": "jaybenne_reflecting",
    "parthenon/output0/file_type": "none",
}
SUOLSON_TOL = 1e-2
SUOLSON_STEPS = 40
TABLE = {  # tests/test_pallas.py:1354-1371: kappa = 2 cm^2/g on a 3 x 3 table
    "rho": np.array([0.1, 1.0, 10.0]), "T": np.array([1.0e3, 1.0e5, 1.0e7]),
    "kappa": np.outer([1.0, 1.0, 1.0], [2.0, 2.0, 2.0]),
}
TABLE_GATE = {**GATE, "mcblock/opacity_model": "table", "jaybenne/do_emission": "false",
              "jaybenne/do_feedback": "false"}
# the decompositions (phases 28-35)
SPATIAL = {"jaybenne/decomposition": "spatial"}
BIG_MESH = {k: v for k, v in BIG_DDMC.items() if k != "jaybenne/use_ddmc"}  # bench.py:291-313
# phase 28: bench.py's big mesh, shard 3 of 8 (z cells [24, 32)), sigma_t = 64 with
# f sigma_a = 2, so a lane crosses a cell or two before its first collision
Z_SHARD, Z_SHARDS = 3, 8
# phase 29: the forest of tests/test_spatial.py:463-467, x-slabs thin and thick as
# in phase 15, so that coarse thick cells leak into the other shard's fine blocks
SMR_SPATIAL_FOREST = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                      "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
                      "parthenon/output0/file_type": "none"}
# the JAX package's 3-step event total of bench.py's big_mesh_spatial row
# (BENCH_r05.json; its single-device big_mesh read 658238761): a count of the physics
BIG_SPATIAL_JAX_EVENTS = 658342636
BIG_SPATIAL_STEPS = 3
# phase 31: tst/launch_ci_runner.py:72-74 (the full-size row) and :66-71 (the CI's)
STEPDIFF_SPATIAL = {**GATE, **SPATIAL, "jaybenne/n_devices": 8,
                    "parthenon/meshblock/nx1": 16, "jaybenne/capacity_factor": 4}
STEPDIFF_SPATIAL_CI = {**STEPDIFF_SPATIAL, "parthenon/mesh/nx1": 32,
                       "parthenon/meshblock/nx1": 2, "jaybenne/num_particles": 16000}
# phase 32: the 8-device SMR rows of tst/launch_ci_runner.py:33, :35, :37, :42, the
# hybrid at bench.py's tau_ddmc = 10
EIGHT = {"jaybenne/n_devices": 8}
# phase 33: tests/test_spatial.py:546-586
SMR_SPATIAL = {**SMR_SPATIAL_FOREST, "jaybenne/num_particles": 96000,
               "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "2.e-11"}
SMR_SPATIAL_STEPS = 2
# phase 32's rows (what, deck, overrides, launch: "s2" transport_2d_smr, "sd2"
# transport_2d_ddmc_smr) and the steps of each that ``particle_step_line`` reads
PARTICLE_ROWS = (
    ("stepdiff_smr", SMR_DECK, {**SMR_GATE, **EIGHT}, "s2"),
    ("stepdiff_smr_ddmc", SMR_DDMC_DECK, {**SMR_GATE, **EIGHT}, "sd2"),
    ("the hybrid", HYBRID_DECK, {**HYBRID_GATE, **EIGHT}, "sd2"),
    ("stepdiff_smr2", SMR2_DECK, {**SMR_GATE, **EIGHT}, "s2"),
)
PARTICLE_READ_STEPS = 3
# the hand-written kernels, by the names a profiler trace gives their launches
HAND_KERNELS = re.compile(r"\b(transport|table|round_counts|count|list|write|migrate|"
                          r"migrate_count|migrate_pack|tally_exponent|tally_sum|tally_cell|"
                          r"face_probs)_kernel\b")
# phase 48: the spatial steps whose host time between batches is read by part,
# with no batch queued ahead of an exit read and with one (the step's ``ahead``)
HOST_GAP_PATHS = (
    ("big_mesh_spatial at 8 shards", DECK, {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8}),
    ("stepdiff at 8 spatial shards in float64", DECK,
     {**STEPDIFF_SPATIAL, "jaybenne/precision": "f64"}),
)
HOST_GAP_STEPS = 3
HOST_SPANS = ("spatial.exit_read", "spatial.round_prologue", "spatial.replay")
SMR_SPATIAL_TOL = 0.10
# phase 35: phase 25's path at seeds 1-4 against the JAX package's survivors at the
# same seeds (jax_reference.py k4 --seed N)
NG_SMR_JAX_SEEDS = {1: 2769, 2: 2738, 3: 2859, 4: 2723}
# phases 37-38: checkpoint/restart; the steps before the checkpoint and after it
RESTART_STEPS = 5
SPATIAL_RESTART_STEPS = 2
# the keys of the JAX package's history.json (jaybenne_tpu/driver.py:283-296, :366-371)
HISTORY_KEYS = ["cycles", "problem_id", "total_events", "walltime_s"]
HISTORY_CYCLE_KEYS = ["alive", "cycle", "dropped", "dt", "events", "iterations",
                      "migrated", "migration_rounds", "time", "unfinished"]
PROFILE_STEPS = 3  # phase 40
# phase 45: the paths run with the eager step and with the CUDA graph, step by
# step, every state bitwise; (what, deck, overrides, steps)
GRAPH_PATHS = (
    ("stepdiff", DECK, GATE, N_STEPS),
    ("stepdiff_ddmc", DDMC_DECK, DDMC_GATE, PATH_STEPS),
    ("the 64^3 DDMC row", DECK, BIG_DDMC, PATH_STEPS),
    ("the 64^3 feedback row", DECK, FEEDBACK, 5),
    ("stepdiff_smr", SMR_DECK, SMR_GATE, PATH_STEPS),
    # the particle decomposition: one graph over the 8 shards' states
    ("stepdiff_smr at 8 particle shards", SMR_DECK, {**SMR_GATE, **EIGHT}, PATH_STEPS),
    ("stepdiff with ep_bremss", DECK, {**NG_GATE, "parthenon/time/tlim": "3.e-12"}, 3),
    ("stepdiff at precision = f64", DECK, {**GATE, "jaybenne/precision": "f64"}, N_STEPS),
    # births outrun absorption (a thin opacity), so the ledger grows mid-run
    ("the 2D feedback path with a growing ledger", DECK,
     {**FEEDBACK_2D, "jaybenne/num_particles": 20000, "jaybenne/capacity_factor": 1,
      "mcblock/opacity_constant_value": 1e-3}, 8),
    # an external source: the window at tmax = 2e-11 closes in step 20 (dt 1e-12)
    ("Su-Olson across tmax", SUOLSON_DECK, SUOLSON, SUOLSON_GRAPH_STEPS),
    # the spatial step: graphs of its head, its batches of rounds and its tail
    ("big_mesh_spatial at 8 shards", DECK, {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8},
     BIG_SPATIAL_STEPS + 1),
    ("big_mesh_spatial at 1 shard", DECK, {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 1},
     BIG_SPATIAL_STEPS + 3),
    # phase 33's deck: the block route (K4s), the fixup generators of every
    # (shard, batch slot) and the pending coarse-to-fine leaks they resolve
    ("stepdiff_smr_ddmc spatial at 8 shards", SMR_DDMC_DECK,
     {**SMR_SPATIAL, **SPATIAL, "jaybenne/n_devices": 8, "parthenon/time/tlim": "5.e-11"},
     SMR_SPATIAL_STEPS + 2),
    # the spatial step's external source (each shard's source cells, the window
    # buffer) across its cutoff, and its graphs captured again after the ledger grew
    ("Su-Olson at 2 spatial shards across tmax with a growing ledger", SUOLSON_DECK,
     {**SUOLSON, **SPATIAL, "jaybenne/n_devices": 2, "parthenon/meshblock/nx1": 32,
      "mcblock/opacity_constant_value": 1.0, "jaybenne/capacity_factor": 1,
      "jaybenne/external_source_tmax": "4.5e-12"}, 7),
)
# the rows whose step wall times phase 45 prints, eager against graph
GRAPH_TIMED = ("stepdiff", "the 64^3 DDMC row", "the 64^3 feedback row", "stepdiff_smr",
               "stepdiff_smr at 8 particle shards", "Su-Olson across tmax",
               "big_mesh_spatial at 8 shards", "big_mesh_spatial at 1 shard")
# the 8-shard spatial step's host synchronisations before this port's step ran
# without them (profile.py, one H100): a step, a migration round
SPATIAL_SYNCS_BEFORE = (12254, 161)
SYNC_STEPS = 3  # phase 45: steps counted by profile.host_syncs
PROFILE_TOL = 0.1  # tst/stepdiff_smr2.py's tolerance for the x-profile gate
PROFILE_BINS = 64
# the step-diffusion solution of tst/stepdiff_common.py, copied: diffusion time
# [s], the hot side's a T^4 [erg/cm^3], the interface's offset from x = -0.5
ERF_TAU = 1.000692e-7
ERF_UR0 = 7.5646e5
ERF_SHIFT = 0.5
# published H100 SXM peaks (NVIDIA's H100 data sheet): float32 and float64 outside
# the tensor cores (FP64 is half the FP32 rate), and the memory rate
PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12
# instructions a SM issues a clock: four schedulers, one warp instruction each
ISSUE_PER_SM_CLOCK = 128
CENSUS_REPEATS = 5  # a kernel census's time is the median of this many
K2_CHECK_LANES = 2048  # lanes of the census-words probe held to its plain version
# the routes whose event loop is read (registers, common path, issue share)
EVENT_LOOP_ROUTES = ("transport_1d", "transport_2d_abs", "transport_2d_smr", "transport_3d_abs")


PHASE = [""]  # the number of the phase that runs


def native_build_line() -> None:
    """Phase 2's native mesh builder: g++'s seconds, and on stepdiff_smr_hybrid's
    and stepdiff_3d's forests the native builder's ms against the Python
    builder's, every tensor bitwise."""
    from jaybenne_tpu_torch import config as config_mod
    from jaybenne_tpu_torch import native
    from jaybenne_tpu_torch.mesh import build_mesh
    from jaybenne_tpu_torch.utils.deck import Deck

    mb = native.load_mesh_builder()
    line = (f"native mesh builder: g++ {mb.build_seconds!r} s ({mb.path.name}, "
            f"{' '.join(native.GXX_FLAGS)})")
    for deck in (HYBRID_DECK, SMR3D_DECK):
        cfg = config_mod.from_deck(Deck.from_file(deck)).mesh
        ms = {}
        for use in (True, False):
            t0 = time.perf_counter()
            mesh = build_mesh(cfg, use_native=use)
            ms[use] = (time.perf_counter() - t0) * 1e3
            ms[(use, "mesh")] = mesh
        a, b = ms[(True, "mesh")], ms[(False, "mesh")]
        for key in ("block_origin", "block_dx", "block_level", "lookup"):
            if not bitwise_equal(getattr(a, key), getattr(b, key)):
                raise AssertionError(f"native mesh builder: {key} differs on {deck}")
        line += (f"; {os.path.basename(deck)} ({a.n_blocks} blocks): native {ms[True]!r} ms, "
                 f"Python {ms[False]!r} ms, bitwise equal")
    print(line, flush=True)


def phase(name):
    PHASE[0] = name.split()[0]
    print(f"--- phase: {name}", flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gate_ledger(dev, n=1 << 17, seed=7):
    """n particles spread over the gate mesh with isotropic directions."""
    from jaybenne_tpu_torch.particles import empty_ledger
    from jaybenne_tpu_torch.utils.constants import CC

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p = empty_ledger(n, torch.float32, dev)
    dx = 1.0 / 128
    cell = torch.randint(0, 128, (n,), generator=g, device=dev, dtype=torch.int32)
    p.i.copy_(cell)
    p.x.copy_((cell.float() + torch.rand(n, generator=g, device=dev)) * dx)
    mu = 1.0 - 2.0 * torch.rand(n, generator=g, device=dev)
    p.vx.copy_(CC * mu)
    p.vy.copy_(CC * torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0)))
    p.alive.fill_(True)
    p.weight.fill_(1.0)
    return p


def gate_setup(dev, sigma_s):
    return deck_setup(dev, DECK, GATE, 0.0, sigma_s)


def erf_profile(t, x):
    """Radiation energy density of step diffusion at time t (the top-hat of height
    ERF_UR0 on x < 0 spreading as the difference of two error functions)."""
    from scipy.special import erf

    s = 2.0 * np.sqrt(t / ERF_TAU)
    xs = x + ERF_SHIFT
    return 0.5 * ERF_UR0 * (erf((xs + 0.5) / s) - erf((xs - 0.5) / s))


def weighted_erf_error(sim) -> float:
    """Weighted-mean fractional error of the tally against the erf solution, as
    tst/regression_test.py::analytic_comparison computes it, with bench.py's guard
    (:426-432): a cell where the solution and the tally are both 0 (far into the
    cold side of a refined far field) adds 0, not 0/0."""
    var = sim.state.fields.energy_tally.double().cpu().numpy()
    xc = sim.mesh.cell_centers()[0].double().cpu().numpy()
    sol = erf_profile(sim.t, xc)
    den = np.fabs((sol + var) / 2.0)
    frac = np.where(den > 0.0, np.fabs(sol - var) / np.where(den > 0.0, den, 1.0), 0.0)
    return float((frac * sol).sum() / sol.sum())


def radiation_energy(sim) -> float:
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    return float((sim.state.fields.energy_tally.double() * dv).sum())


def time_census(fn, p0, args, dev, repeats):
    """(ms per census call (CUDA events), sorted, one per call; events of the last
    call), each call on a fresh copy of ``p0``. A device sleep queued before the
    start event keeps the card busy while the host prepares the call, so the
    interval holds the call's device work (its table set-up and the census) and not
    the host's latency."""
    times = []
    for _ in range(repeats):
        p = p0.clone()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms at 1980 MHz
        start.record()
        _, _, events = fn(p, *args)
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop))
    return sorted(times), int(events)


def spread(times) -> str:
    """The median of ``times`` (ms) and their range, as printed beside a census."""
    return (f"median {statistics.median(times)!r} ms of {len(times)} "
            f"(min {times[0]!r}, max {times[-1]!r})")


def smi_value(field) -> float:
    """One numeric field of ``nvidia-smi --query-gpu`` for card 0 (clocks in MHz)."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def max_float_err(a, b, names=("x", "vx", "vy", "vz", "tau"), floors=None):
    err, rel = 0.0, 0.0
    for name in names:
        ta, tb = getattr(a, name), getattr(b, name)
        d = (ta - tb).abs()
        err = max(err, float(d.max()))
        floor = 1e-30 if floors is None else floors[name]
        rel = max(rel, float((d / tb.abs().clamp_min(floor)).max()))
    return err, rel


def sass_listing(lib_path) -> dict:
    """Per kernel function of the library, from ``cuobjdump -sass``: its SASS
    instructions as (address, text), NOPs left out."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    listing, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            listing[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None and not m.group(2).startswith("NOP"):
            listing[name].append((int(m.group(1), 16), m.group(2)))
    return listing


def sass_counts(listing) -> dict:
    """Per kernel function: the SASS instructions up to and including its first
    EXIT, which is the straight-line path a call takes; the rarely taken slow
    paths of logf and the divide (special operands) are subroutines placed after
    it."""
    counts = {}
    for name, code in listing.items():
        counts[name] = 0
        for _, text in code:
            counts[name] += 1
            if re.search(r"\bEXIT\b", text):
                break
    return counts


def loop_body(code) -> int:
    """The SASS instructions of a function's widest loop without a barrier, from
    the target of the widest backward branch before its first unpredicated EXIT
    to that branch whose span holds no BAR (in a census instantiation, its event
    loop, inside the rounds of one that runs in rounds, kRounds; blocks after the
    EXIT are subroutines), less the blocks inside it that a forward branch skips
    and that hold a call or a loop of their own: the math library's slow paths
    (cosf's long argument reduction, the divide's and sqrtf's special operands)."""
    branches = []
    for addr, text in code:
        if text.startswith("EXIT"):
            break
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", text)
        if m:
            branches.append((addr, int(m.group(1), 16)))
    bars = [addr for addr, text in code if re.match(r"(@!?U?P\d+\s+)?BAR\b", text)]
    back = [(src - dst, dst, src) for src, dst in branches
            if dst < src and not any(dst <= a <= src for a in bars)]
    if not back:
        return 0
    _, lo, hi = max(back)
    inner = {dst for src, dst in branches if lo <= dst < src < hi}
    calls = {addr for addr, text in code if lo <= addr <= hi and text.startswith("CALL")}
    forward = [(src, dst) for src, dst in branches if lo <= src < dst <= hi]
    cold = set()
    for x in inner | calls:  # the innermost forward branch around it skips it
        around = [(dst - src, src, dst) for src, dst in forward if src < x < dst]
        if around:
            _, src, dst = min(around)
            cold.update(addr for addr, _ in code if src < addr < dst)
    return sum(1 for addr, _ in code if lo <= addr <= hi and addr not in cold)


KERNEL_ARGS = re.compile(
    r"transport_kernelILi(\d)ELb([01])ELb([01])ELb([01])ELb([01])E(?:([fd])E)?")
# the census kernel's body, which the reading edits (LOOP_PATHS, PATH_MIX); its
# float32 and float64 instantiations are the two sources that include it
KERNEL_BODY = "transport_kernel.cuh"


def census_route(fn, transport_kernel):
    """The ``launch_name`` of a census instantiation's mangled name ``fn``, None for
    any other function."""
    m = KERNEL_ARGS.search(fn)
    if not m:
        return None
    ndim, *bits = (int(x) for x in m.groups()[:5])
    dtype = torch.float64 if m.group(6) == "d" else torch.float32
    return transport_kernel.launch_name(ndim, *map(bool, bits), dtype=dtype)
# The event loop's paths, each the event's outcomes held to some: any other outcome
# traps, so the compiler keeps the tests that decide the outcome and drops the code
# of every other one. Each entry puts its line in front of the line of
# csrc/transport_kernel.cuh that it names, which the kernel must hold once, or at
# most once where the third field is False (a kernel without a cell cache has no
# test of a move):
#   scatter: a scatter in the lane's cell (the common path);
#   cross: a crossing into the next cell, no collision, census or wall;
#   no_wall: any outcome but a wall (scatter, absorption, crossing, census);
#   full: every outcome (the loop as built).
#   dd_leak, dd_step, dd_any: a DDMC lane's event inside the block that leaks, or
#     leaks or reaches census (no IMC event, albedo test, absorption or block
#     face), or any DDMC event, read on the DDMC routes (DDMC_ROUTES) by
#     census_bench.py's DDMC reading. A census
#     ends a lane's history, so a loop of census events alone compiles to no loop:
#     the census's code is read as dd_step less dd_leak.
#   no_opacity: the whole loop with EPBremss returning at once (its first line), so
#     that on a non-gray route the loop as built less this one is the opacity's
#     code (census_bench.py's non-gray reading).
_NO_WALL = ("  if (any_out) {", "  if (any_out) __trap();\n", True)
_DD_NO_IMC = ("    constexpr bool kInPlace = DDMC || NONGRAY;", "    __trap();\n", True)
_DD_NO_REJECT = ("  if (rejected) {  // bounce back", "  if (rejected) __trap();\n", True)
_DD_NO_ABSORB = ("    if (ABSORB && xi < ea) {", "    if (ABSORB && xi < ea) __trap();\n", True)
_DD_NO_CENSUS = ("  // census: uniform position in the cell", "  __trap();\n", True)
LOOP_PATHS = {
    "scatter": (("    const bool census = !coll",
                 "    if (!scatter) __trap();\n    if (cr[0]) __trap();\n    if (cr[1]) __trap();\n"
                 "    if (cr[2]) __trap();\n", True),
                _NO_WALL,
                ("    if (kKeep && moved)", "    if (moved) __trap();\n", False)),
    "cross": (("    const bool census = !coll", "    if (coll) __trap();\n", True),
              ("    const Real d = coll ? d_coll : d_push;", "    if (census) __trap();\n", True),
              _NO_WALL),
    "no_wall": (_NO_WALL,),
    "dd_leak": (_DD_NO_IMC, _DD_NO_REJECT, _DD_NO_ABSORB, _DD_NO_CENSUS, _NO_WALL),
    "dd_step": (_DD_NO_IMC, _DD_NO_REJECT, _DD_NO_ABSORB, _NO_WALL),
    "dd_any": (_DD_NO_IMC,),
    "no_opacity": (("  const Real r = rho * g.ng_rho_scale;", "  return rho;\n", True),),
    "full": (),
}
# the routes whose DDMC event is read (loop paths, path mix, issue share)
DDMC_ROUTES = ("transport_3d_ddmc", "transport_3d_ddmc_smr", "transport_1d_ddmc",
               "transport_1d_abs_ddmc", "transport_1d_ddmc_f64")


def patched(src, edits, what) -> str:
    """``src`` with each (anchor, text, required) of ``edits`` applied: ``text`` put
    in front of ``anchor``, which must occur once (at most once where ``required``
    is False)."""
    for anchor, line, required in edits:
        if src.count(anchor) not in ((1,) if required else (0, 1)):
            raise AssertionError(f"{what}: {anchor!r} is not one line of the kernel")
        src = src.replace(anchor, line + anchor)
    return src


def loop_paths(csrc, names, transport_kernel, paths=tuple(LOOP_PATHS)) -> dict:
    """The SASS instructions of the event loop's ``paths`` (LOOP_PATHS) of the
    census instantiations ``names``, as {path: {name: count}}: for each path the
    float32 instantiations (``csrc``/transport_kernel.cu) and, where ``names``
    holds a float64 one, the float64 instantiations (transport_kernel_f64.cu),
    compiled with the library's flags and the path's traps in the kernel's body
    (KERNEL_BODY; one nvcc a path and source, all started together), so that the
    compiler drops the code of every other outcome, and ``loop_body`` of each
    instantiation's SASS (cuobjdump). ``csrc`` may be another tree's sources of
    the same kernel."""
    from jaybenne_tpu_torch.ops import cuda_lib

    with open(os.path.join(csrc, KERNEL_BODY)) as f:
        src = f.read()
    entries = [e for e, want in (("transport_kernel", not all(n.endswith("_f64") for n in names)),
                                 ("transport_kernel_f64", any(n.endswith("_f64") for n in names)))
               if want]
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    out = {path: {} for path in paths}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for path in paths:
            body = os.path.join(tmp, f"{path}.cuh")
            with open(body, "w") as f:
                f.write(patched(src, LOOP_PATHS[path], f"loop path {path}"))
            for stem in entries:
                with open(os.path.join(csrc, f"{stem}.cu")) as f:
                    entry = f.read()
                cu = os.path.join(tmp, f"{path}_{stem}.cu")
                cubin = os.path.join(tmp, f"{path}_{stem}.cubin")
                with open(cu, "w") as f:
                    f.write(entry.replace(f'#include "{KERNEL_BODY}"', f'#include "{path}.cuh"'))
                procs.append((path, cubin, subprocess.Popen(
                    [cuda_lib.nvcc(), *flags, "-I", csrc, "-cubin", "-o", cubin, cu],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for path, cubin, proc in procs:
            log = proc.communicate(timeout=900)[0]
            if proc.returncode != 0:
                raise RuntimeError(f"loop path {path}: nvcc failed:\n{log[-3000:]}")
            for fn, code in sass_listing(cubin).items():
                name = census_route(fn, transport_kernel)
                if name in names:
                    out[path][name] = loop_body(code)
    return out


def common_paths(csrc, names, transport_kernel) -> dict:
    """The SASS instructions of the event loop's common path, a scatter in the
    lane's cell (no absorption, crossing, census or wall), of the census
    instantiations ``names`` (``loop_paths``)."""
    return loop_paths(csrc, names, transport_kernel, ("scatter",))["scatter"]


# The counting variant of the census kernel (``path_mix``): per warp and event,
# whether any lane of the warp scattered, crossed into another cell, reached a wall
# (any_out), moved and runs on (so gathers its cell anew), or reached census; and
# the lanes that did; and the lane-events of each SM (%smid). The warp's active
# lanes are the ones that ran the event (``__activemask`` where the event ends).
# With DDMC, per warp and event, whether any lane was on the DDMC branch, leaked,
# reached census from it, was rejected or accepted at the albedo test of a face,
# was absorbed from it, or did anything else than a DDMC leak or census inside the
# block (an albedo test, absorption, an IMC event, a block face or wall: "dd_other"),
# and the lanes that did.
PATH_MIX_KEYS = ("warp_events", "lane_events", "scatter", "cross", "wall", "regather", "census",
                 "lane_scatters", "lane_crossings", "lane_walls",
                 "ddmc", "dd_leak", "dd_census", "dd_rejected", "dd_accepted", "dd_absorbed",
                 "dd_other", "lane_ddmc", "lane_leaks", "lane_dd_census", "lane_rejected",
                 "lane_accepted", "lane_dd_absorbed")
PATH_MIX_SMS = 1024  # SM ids the variant counts
PATH_MIX = (
    ("constexpr int kThreads = 256;\n",
     f"__device__ unsigned long long jb_path_mix[{len(PATH_MIX_KEYS)}];\n"
     f"__device__ unsigned long long jb_path_mix_sm[{PATH_MIX_SMS}];\n", True),
    ("  int leak = 0;\n  if (DDMC && is_ddmc) {",
     "  bool pm_scatter = false, pm_cross = false, pm_census = false;\n"
     "  bool pm_dd = false, pm_leak = false, pm_dd_census = false, pm_rej = false;\n"
     "  bool pm_acc = false, pm_abs = false;\n"
     "  const int pm_face = pface;\n", True),
    ("    const Real d = coll ? d_coll : d_push;",
     "    pm_scatter = scatter;\n    pm_cross = cr[0] || cr[1] || cr[2];\n"
     "    pm_census = census;\n", True),
    ("  } else {\n    constexpr bool kInPlace = DDMC || NONGRAY;",
     "    pm_dd = true;\n    pm_leak = leak != 0;\n    pm_abs = !palive;\n"
     "    pm_dd_census = ptau == 1.0f;\n"
     "    pm_rej = pm_face != 0 && !pm_leak && !pm_abs && !pm_dd_census;\n"
     "    pm_acc = pm_face != 0 && !pm_rej;\n", True),
    ("  pface = nface;\n",
     "  {\n"
     "    const unsigned m = __activemask();\n"
     "    const unsigned bs = __ballot_sync(m, pm_scatter), bx = __ballot_sync(m, pm_cross);\n"
     "    const unsigned bw = __ballot_sync(m, any_out);\n"
     "    const unsigned bg = __ballot_sync(m, moved && palive && ptau < 1.0f);\n"
     "    const unsigned bc = __ballot_sync(m, pm_census);\n"
     "    const unsigned d[7] = {__ballot_sync(m, pm_dd), __ballot_sync(m, pm_leak),\n"
     "                           __ballot_sync(m, pm_dd_census), __ballot_sync(m, pm_rej),\n"
     "                           __ballot_sync(m, pm_acc), __ballot_sync(m, pm_dd && pm_abs),\n"
     "                           __ballot_sync(m, !pm_dd || pm_face != 0 || pm_abs || any_out)};\n"
     "    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {\n"
     "      const unsigned b[5] = {bs, bx, bw, bg, bc};\n"
     "      unsigned sm;\n"
     "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     f"      atomicAdd(&jb_path_mix_sm[sm % {PATH_MIX_SMS}u], (unsigned long long)__popc(m));\n"
     "      atomicAdd(&jb_path_mix[0], 1ull);\n"
     "      atomicAdd(&jb_path_mix[1], (unsigned long long)__popc(m));\n"
     "      for (int k = 0; k < 5; ++k) atomicAdd(&jb_path_mix[2 + k], b[k] ? 1ull : 0ull);\n"
     "      for (int k = 0; k < 3; ++k)\n"
     "        atomicAdd(&jb_path_mix[7 + k], (unsigned long long)__popc(b[k]));\n"
     "      for (int k = 0; k < 7; ++k) atomicAdd(&jb_path_mix[10 + k], d[k] ? 1ull : 0ull);\n"
     "      for (int k = 0; k < 6; ++k)\n"
     "        atomicAdd(&jb_path_mix[17 + k], (unsigned long long)__popc(d[k]));\n"
     "    }\n"
     "  }\n", True),
)
PATH_MIX_READ = f"""
// the counting variant's totals and its lane-events by SM, copied out and zeroed
extern "C" int jb_path_mix_read(unsigned long long* out, unsigned long long* by_sm) {{
  static const unsigned long long zero[{PATH_MIX_SMS}] = {{}};
  int err = (int)cudaMemcpyFromSymbol(out, jb_path_mix, sizeof(jb_path_mix));
  if (err == 0) err = (int)cudaMemcpyFromSymbol(by_sm, jb_path_mix_sm, sizeof(jb_path_mix_sm));
  if (err == 0) err = (int)cudaMemcpyToSymbol(jb_path_mix, zero, sizeof(jb_path_mix));
  if (err == 0) err = (int)cudaMemcpyToSymbol(jb_path_mix_sm, zero, sizeof(jb_path_mix_sm));
  return err;
}}
"""
# the float64 census's counters (its source's own) read by their own entry
PATH_MIX_READ_F64 = PATH_MIX_READ.replace("jb_path_mix_read(", "jb_path_mix_read_f64(")


def path_mix_library(csrc=None, out_dir=None):
    """The counting variant (PATH_MIX) of the kernel library of the sources in
    ``csrc`` (this tree's by default), built into ``out_dir`` (by default
    ``path_mix`` under the build directory, which ``.gitignore`` lists): every source
    compiled, the kernel's body (KERNEL_BODY) with PATH_MIX's counters, each
    source's own (the anonymous namespace holds them), transport_kernel.cu with
    the reader of the float32 census's and transport_kernel_f64.cu with that of
    the float64 census's, so that it loads as a ``cuda_lib.CudaLibrary`` of that
    tree and takes its launches."""
    import ctypes
    from pathlib import Path

    from jaybenne_tpu_torch.ops import cuda_lib

    csrc = Path(csrc or cuda_lib.SRC_DIR)
    out_dir = Path(out_dir or cuda_lib.BUILD_DIR / "path_mix")
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, objs = [], []
    (out_dir / KERNEL_BODY).write_text(patched((csrc / KERNEL_BODY).read_text(), PATH_MIX,
                                               "path mix"))
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        text += {"transport_kernel.cu": PATH_MIX_READ,
                 "transport_kernel_f64.cu": PATH_MIX_READ_F64}.get(src.name, "")
        cu, obj = out_dir / src.name, out_dir / f"{src.stem}.o"
        cu.write_text(text)
        objs.append(str(obj))
        procs.append(subprocess.Popen([cuda_lib.nvcc(), *flags, "-I", str(csrc), "-c", "-o",
                                       str(obj), str(cu)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate(timeout=900)[0] for proc in procs]
    if any(proc.returncode != 0 for proc in procs):
        raise RuntimeError("path mix: nvcc failed:\n" + "".join(logs)[-3000:])
    so = out_dir / "libjbtorch_path_mix.so"
    subprocess.run([cuda_lib.nvcc(), *flags[:2], "-shared", "-o", str(so), *objs], check=True,
                   capture_output=True, timeout=300)
    lib = cuda_lib.CudaLibrary(so, 0.0, "")
    for read in ("jb_path_mix_read", "jb_path_mix_read_f64"):
        getattr(lib._dll, read).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib._dll, read).restype = ctypes.c_int
    return lib


def path_mix(transport_kernel, lib, inputs, n=1) -> dict:
    """The counting variant ``lib`` (``path_mix_library``) run on a census's
    ``inputs`` ((ledger, args) of ``transport``, over ``n`` shards' slices) through
    ``transport_kernel``'s own launch, with the variant in place of the kernel
    library for the call (its launch not counted): its PATH_MIX_KEYS totals (of
    the census's precision) and ``by_sm``, the lane-events of each SM that ran
    any."""
    import ctypes

    from jaybenne_tpu_torch.ops import cuda_lib

    p, args = inputs
    buf = (ctypes.c_ulonglong * len(PATH_MIX_KEYS))()
    by_sm = (ctypes.c_ulonglong * PATH_MIX_SMS)()
    entry = "jb_path_mix_read" + ("_f64" if p.x.dtype == F64 else "")
    read = (entry, ctypes.addressof(buf), ctypes.addressof(by_sm))
    lib.call(*read)  # zeroes the counters
    own, launches = cuda_lib.library, dict(cuda_lib.LAUNCHES)
    cuda_lib.library = lambda: lib
    census = sliced(transport_kernel.transport, n) if n > 1 else transport_kernel.transport
    try:
        census(p.clone(), *args)
        torch.cuda.synchronize()
    finally:
        cuda_lib.library = own
        cuda_lib.LAUNCHES.clear()
        cuda_lib.LAUNCHES.update(launches)
    lib.call(*read)
    return {**dict(zip(PATH_MIX_KEYS, (int(x) for x in buf))),
            "by_sm": [int(x) for x in by_sm if x]}


def path_mix_line(name, mix, paths, ms, events, dev) -> dict:
    """Prints the warp path mix of the route ``name`` (``path_mix``), checked against
    the census's ``events``, and the instructions a warp issues an event modelled
    from it and the loop's paths (``loop_paths`` of the route, {path: count}): the
    code the scatter, crossing and no-wall paths share (scatter + cross - no_wall),
    plus the scatter's code (no_wall - cross) where any lane scattered, the
    crossing's (no_wall - scatter) where any lane crossed and the wall's (full -
    no_wall) where any lane reached a wall. The warp issue share is those
    instructions x warp-events over ms x SMs x 4 warp instructions a SM clock x the
    SM clock (nvidia-smi, read just after). Last, how the lane-events spread over
    the SMs (%smid): the SMs that ran lanes, and the busiest SM's against the mean
    over every SM of the card. Returns the mix with the model's numbers."""
    if mix["lane_events"] != events:
        raise AssertionError(f"{name} path mix: {mix['lane_events']} lane-events, census {events}")
    we, by_sm = mix["warp_events"], mix["by_sm"]
    share = {k: mix[k] / we for k in ("scatter", "cross", "wall", "regather", "census")}
    s, x, sx, full = (paths[k] for k in ("scatter", "cross", "no_wall", "full"))
    shared = s + x - sx
    per_warp = (shared + share["scatter"] * (sx - x) + share["cross"] * (sx - s)
                + share["wall"] * (full - sx))
    clock = smi_value("clocks.sm")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    issue = per_warp * we / (ms * 1e-3 * sms * (ISSUE_PER_SM_CLOCK // 32) * clock * 1e6)
    print(f"{name} warp path mix: {we} warp-events for {mix['lane_events']} lane-events (SIMT "
          f"efficiency {mix['lane_events'] / (32 * we)!r}); share of warp-events with a lane "
          f"that scattered {share['scatter']!r}, crossed {share['cross']!r}, reached a wall "
          f"{share['wall']!r}, gathers its cell anew {share['regather']!r}, reached census "
          f"{share['census']!r}; a lane-event scatters "
          f"{mix['lane_scatters'] / mix['lane_events']!r}, crosses "
          f"{mix['lane_crossings'] / mix['lane_events']!r}, reaches a wall "
          f"{mix['lane_walls'] / mix['lane_events']!r}; loop paths (SASS) scatter {s}, cross {x}, "
          f"no wall {sx}, full {full}: shared {shared}, scatter +{sx - x}, crossing +{sx - s}, "
          f"wall +{full - sx}; modelled {per_warp!r} instructions a warp-event; SM clock "
          f"{clock!r} MHz; warp issue share {issue!r} ({ms!r} ms); lane-events a SM "
          f"(%smid): {len(by_sm)} of {sms} SMs ran lanes, max/mean over the {sms} "
          f"{max(by_sm) * sms / sum(by_sm)!r}", flush=True)
    return {**mix, "instructions_per_warp_event": per_warp, "warp_issue_share": issue}


class CallSplit:
    """While active, puts CUDA events around the parts of each census call of a
    tree's ``transport_kernel`` (any tree of the same layout): ``setup``, the
    census set-up (``_prepare``), and inside it ``table``, the cell table kernel
    (``_table_cuda``; what else the set-up runs on the device is the forest
    tables); ``kernel``, the kernel with its counters (``_census_cuda``);
    ``launch``, the census kernel's launch alone (``jb_transport_launch``); and
    ``gap``, an empty window (two events recorded back to back) before each
    kernel window. ``ms()`` sums each part's windows since its last call, and
    derives ``forest`` (the set-up less the cell table) and ``counters`` (the
    kernel with its counters less its launch), each less the gaps that the
    windows' events add to it: an empty window reads one gap, so a window with
    nothing inside holds one, and one with a window inside it two more. Each event
    recorded takes the queue a few microseconds, so a call timed inside these
    windows runs longer than one timed alone: time the call without them."""

    PARTS = {"_prepare": "setup", "_table_cuda": "table", "_census_cuda": "kernel"}

    def __init__(self, tk, lib):
        self.tk, self.lib, self.events, self.saved = tk, lib, [], {}

    def _window(self, part, fn):
        def timed(*args, **kw):
            if part == "kernel":
                empty = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                for e in empty:
                    e.record()
                self.events.append(("gap", *empty))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            self.events.append((part, start, stop))
            return out
        return timed

    def __enter__(self):
        for attr, part in self.PARTS.items():
            self.saved[attr] = getattr(self.tk, attr)
            setattr(self.tk, attr, self._window(part, self.saved[attr]))
        call = self.lib.call
        launch = self._window("launch", call)
        self.lib.call = lambda name, *a: (
            launch if name in ("jb_transport_launch", "jb_transport_launch_f64") else call)(
            name, *a)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.tk, attr, fn)
        del self.lib.call

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = dict.fromkeys(("setup", "table", "kernel", "launch", "gap"), 0.0)
        for part, a, b in self.events:
            out[part] += a.elapsed_time(b)
        self.events = []
        # a window's own events take one gap, and each window inside it two more
        inner = 2 if out["table"] else 1
        out["forest"] = out["setup"] - out["table"] - inner * out["gap"] if out["setup"] else 0.0
        out["counters"] = out["kernel"] - out["launch"] - 2 * out["gap"]
        return out


def launch_floor(dev, blocks=1, threads=256) -> float:
    """The floor of a launch window: the median ms of CENSUS_REPEATS empty kernels
    of ``blocks`` blocks (``jb_empty_launch``), each between two CUDA events after a
    device sleep."""
    from jaybenne_tpu_torch.ops import cuda_lib

    lib, times = cuda_lib.library(), []
    for _ in range(CENSUS_REPEATS):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        lib.call("jb_empty_launch", blocks, 1, threads, cuda_lib.stream_handle(dev))
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def call_split_line(transport_kernel, dev, inputs, name) -> dict:
    """Prints the parts of a census call of the route ``name`` on a census's
    ``inputs`` ((ledger, args) of ``transport``), each the median of
    CENSUS_REPEATS calls on fresh copies after a device sleep (``CallSplit``): the
    cell table, the forest tables (the rest of the set-up), the counters (the
    kernel with its counters less its launch: the memset of the launch entry, none
    where the call launches a table, whose launch zeroes them), the census launch,
    and the gap that an event recorded adds, taken off the two parts derived; and
    the floor of a launch window (``launch_floor``). Returns the medians."""
    from jaybenne_tpu_torch.ops import cuda_lib

    p0, args = inputs
    parts = []
    with CallSplit(transport_kernel, cuda_lib.library()) as win:
        for _ in range(CENSUS_REPEATS):
            p = p0.clone()
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(50_000_000)
            transport_kernel.transport(p, *args)
            parts.append(win.ms())
    med = {k: statistics.median(d[k] for d in parts) for k in parts[0]}
    med["floor"] = launch_floor(dev)
    print(f"{name} call split (medians of {CENSUS_REPEATS} calls, ms): cell table "
          f"{med['table']!r}, forest tables {med['forest']!r}, counters {med['counters']!r}, "
          f"census launch {med['launch']!r} (gap an event adds {med['gap']!r}); an empty "
          f"launch's window {med['floor']!r}", flush=True)
    return med


TABLE_ENTRIES = ("jb_table_launch", "jb_table_launch_f64")


def table_grid(transport_kernel, args) -> tuple:
    """(blocks along x, blocks along y, threads) of the launch that a call of the
    census table's C entry with ``args`` makes, in a tree of this repository: its
    plan's (``table_plan``: ``blocks`` and the ranges) where the tree has one, else
    the one-row-a-thread kernel's (256 threads, a row a thread over the longest
    range)."""
    if hasattr(transport_kernel, "TABLE_THREADS"):
        return args[10], args[4], transport_kernel.TABLE_THREADS
    n, ranges = args[3], args[5]
    most = max(ranges[2 * k] for k in range(n))
    return max(-(-most // 256), 1), n, 256


class TableEntry:
    """While active, every call of the census table's C entry of ``lib`` (a tree's
    ``cuda_lib.CudaLibrary``) goes to ``fn(name, *args)`` instead; its launches
    are counted as before. ``empty_table`` makes one ``fn``."""

    def __init__(self, lib, fn):
        self.lib, self.fn = lib, fn

    def __enter__(self):
        call = self.lib.call
        self.lib.call = lambda name, *a: (self.fn if name in TABLE_ENTRIES else call)(name, *a)
        return self

    def __exit__(self, *exc):
        del self.lib.call


def empty_table(transport_kernel, empty):
    """A stand-in for the census table's C entry that launches ``empty`` (with
    ``jb_empty_launch``'s arguments) on the grid the entry would launch
    (``table_grid``) on its stream: the floor of the table's launch, in its place."""
    def launch(name, *args):
        err = empty(*table_grid(transport_kernel, args), args[-1])
        if err != 0:
            raise RuntimeError(f"empty launch in place of {name}: CUDA error {err}")
    return launch


def table_bytes(transport_kernel, cset, g, cell) -> int:
    """The bytes a census table must move: every coefficient column its record
    reads once, and the table written once."""
    return (sum(getattr(c, k).numel() * getattr(c, k).element_size() for c in cset
                for k in transport_kernel.table_columns(g)) + cell.numel() * cell.element_size())


def table_check(transport_kernel, dev, coefs, mesh, prm, dt, own, what):
    """The census table kernel (the set-up of ``prepare`` on the card, which
    launches nothing else on a uniform mesh) against its plain version
    (``_pair_table``) on the same coefficients: the tables bitwise; the kernel's
    time, the median of CENSUS_REPEATS set-ups after a device sleep, beside one
    plain set-up and its bound: every coefficient the record reads once and the
    table written once, over the memory rate; and the floor of its launch, the
    set-up with an empty kernel of the table's grid in its place (``empty_table``).
    Returns (ms, plain_ms, bound_ms, floor_ms)."""
    from jaybenne_tpu_torch.ops import cuda_lib

    def timed(kernel, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            census = transport_kernel._prepare(coefs, mesh, prm, dt, own, kernel)
            stop.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(stop))
        return sorted(times), census.tabs.cell, census.g

    times, cell, g = timed(True, CENSUS_REPEATS)
    lib = cuda_lib.library()
    with TableEntry(lib, empty_table(transport_kernel, lib._dll.jb_empty_launch)):
        floor = timed(True, CENSUS_REPEATS)[0]
    plain_ms, plain, _ = timed(False, 1)
    if not torch.equal(cell.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError(f"census table on {what}: the kernel's rows differ from the plain "
                             "version's")
    cset = list(coefs) if own is not None and not isinstance(
        own, transport_kernel.OwnedRange) else [coefs]
    nbytes = table_bytes(transport_kernel, cset, g, cell)
    bound = nbytes / PEAK_BYTES * 1e3
    ms = statistics.median(times)
    print(f"census_table on {what} ({cell.shape[0]} rows of {cell.shape[1]} floats, "
          f"{len(cset)} coefficient sets): kernel {spread(times)}, plain {plain_ms[0]!r} ms, "
          f"bound {bound!r} ms ({nbytes} bytes), kernel at {bound / ms:.3f} of it; an empty "
          f"launch of its grid in its place {spread(floor)}; bitwise the plain version's",
          flush=True)
    return ms, plain_ms[0], bound, statistics.median(floor)


def fold_check(transport_kernel, inputs, what):
    """A full census of the kernel on a uniform mesh of several blocks, with the
    collapse to one block and the expansion folded into its reads and writes,
    against the plain collapse, census and expansion on the same inputs ((ledger,
    args) of ``transport``): every column identical, float32 as bits, the dead
    and finished slots too."""
    p0, args = inputs
    k, q = p0.clone(), p0.clone()
    transport_kernel.transport(k, *args)
    transport_kernel.transport_plain(q, *args)
    same_columns(k, q, f"the folded census on {what}")
    print(f"the census with the fold on {what} ({p0.capacity} slots, {int(p0.alive.sum())} "
          "alive): every column bitwise the plain collapse, census and expansion", flush=True)


def local_memory(code) -> int:
    """The local-memory instructions (LDL, STL) of a function's SASS: a lane's
    arrays that the compiler could not keep in registers (an index known only at
    run time), and the math library's slow paths (cosf's argument reduction)."""
    return sum(1 for _, text in code if re.match(r"(@!?U?P\d+\s+)?(LDL|STL)\b", text))


# (path, its launches of the census table kernel) of every counted path run
# (``note_table``), and of the count kernel
TABLE_PATHS = []
COUNT_PATHS_RUN = []


def note_table(what, launches) -> None:
    """Keeps the census table kernel's and the count kernel's ``launches`` in the
    counted run of the path ``what`` (its counts set to 0 just before it and read
    just after), for their entries of the ``kernels`` line."""
    TABLE_PATHS.append((f"phase {PHASE[0]}: {what}", launches.get("census_table", 0)))
    COUNT_PATHS_RUN.append((f"phase {PHASE[0]}: {what}", launches.get("round_counts", 0)))


def kernel_resources(build_log, transport_kernel) -> dict:
    """Per census instantiation (by launch name), from nvcc's ``-Xptxas -v``
    output: registers a thread, stack frame, spill stores and loads (bytes)."""
    entry, props, res = None, None, {}
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = props = m.group(1)
            res.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and props in res:
            res[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in res:
            res[entry]["registers"] = int(m.group(1))
    out = {}
    for fn, r in res.items():
        name = census_route(fn, transport_kernel)
        if name is not None:
            out[name] = r
    return out


def census_blocks(transport_kernel, p, args) -> int:
    """Resident blocks a SM of the instantiation that a census of the ledger ``p``
    with ``args`` (of ``transport``) launches."""
    prm, g = args[3], getattr(args[0], "g", None)  # a recorded round's set-up has its geometry
    flags = (bool(prm.has_absorption), bool(prm.use_ddmc),
             g.smr if g is not None else args[1].max_level > 0,
             g.nongray if g is not None else not getattr(args[0], "is_gray", True))
    return transport_kernel.resident_blocks(prm.ndim, *flags, dtype=p.x.dtype)


def event_loop_line(transport_kernel, dev, name, inputs, ms, events, res, common, n=1):
    """Prints, for the route ``name`` on a census's ``inputs`` ((ledger, args) of
    ``transport``, over ``n`` shards' slices) timed at ``ms`` for ``events``:
    registers, stack and spills
    (``res``), resident blocks a SM, live lanes against the card's resident
    threads, the SASS instructions of the event loop's common path (``common``),
    the slot order's warp efficiency (the plain version's per-slot events) and the
    issue share, common-path instructions x events over ms x SMs x
    ISSUE_PER_SM_CLOCK x the SM clock (nvidia-smi, read just after). Returns the
    per-slot events."""
    p, args = inputs
    blocks = census_blocks(transport_kernel, p, args)
    clock = smi_value("clocks.sm")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    live = int((p.alive & (p.tau < 1.0)).sum())
    lanes = torch.zeros(p.capacity, dtype=torch.int32, device=p.x.device)
    plain = (sliced(transport_kernel.transport_plain, n) if n > 1
             else transport_kernel.transport_plain)
    plain(p.clone(), *args, lane_events=lanes)
    eff = transport_kernel.warp_efficiency(lanes)
    issue = common * events / (ms * 1e-3 * sms * ISSUE_PER_SM_CLOCK * clock * 1e6)
    print(f"{name} event loop: {res.get('registers', 'not read')} registers, stack "
          f"{res.get('stack', 'not read')} bytes, spills {res.get('spill_stores', 'not read')}"
          f"/{res.get('spill_loads', 'not read')} bytes; {blocks} resident blocks of 256 a SM; "
          f"{live} live lanes for {sms * blocks * 256} resident threads; common path "
          f"{common} SASS instructions an event; slot-order warp efficiency {eff!r}; SM clock "
          f"{clock!r} MHz; issue share {issue!r} ({events} events in {ms!r} ms)", flush=True)
    return lanes


def block_spread_line(name, lanes, p, blocks, dev):
    """Prints how the live lanes and the events (``lanes``, the plain version's per
    slot) of a census of the route ``name`` on the ledger ``p`` spread over blocks
    of 256 consecutive slots, against the card's ``blocks`` resident a SM. (How
    they spread over the SMs the counting variant reads: ``path_mix_line``.)"""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pad = (-p.capacity) % 256
    zero = torch.zeros(pad, dtype=torch.int64, device=p.x.device)
    live = torch.cat([(p.alive & (p.tau < 1.0)).to(torch.int64), zero]).view(-1, 256).sum(1)
    ev = torch.cat([lanes.to(torch.int64), zero]).view(-1, 256).sum(1)
    nb = live.numel()
    lv = live.sort().values
    print(f"{name} blocks: {nb} blocks of 256 slots ({int((live > 0).sum())} with live lanes) "
          f"on {sms} SMs x {blocks} resident: {nb / sms!r} a SM, {nb / (sms * blocks)!r} "
          f"waves; live lanes a block min {int(lv[0])} median {int(lv[nb // 2])} max "
          f"{int(lv[-1])}; events a block max/mean {float(ev.max() / ev.float().mean())!r}",
          flush=True)


def probe_costs(counts, f64=False) -> dict:
    """Instructions of logf, the IEEE divide and the K2 hash, from the probes of
    csrc/sass_probes.cu: each probe's count less its baseline's (the same loads
    and stores with one FADD). With ``f64`` the float64 census's under the same
    keys, from the ``_f64`` probes (one DADD in the baseline): the double log,
    divide, exp and sqrt, and as the hash the double draw (two hash words made
    one 53-bit uniform, ``jb_probe_u53``)."""
    if f64:
        return {
            "logf": counts["jb_probe_log_f64"] - counts["jb_probe_load1_f64"],
            "div": counts["jb_probe_div_f64"] - counts["jb_probe_load2_f64"] + 1,
            "hash": counts["jb_probe_u53"] - counts["jb_probe_load2_f64"] + 1,
            "expf": counts["jb_probe_exp_f64"] - counts["jb_probe_load1_f64"],
            "sqrtf": counts["jb_probe_sqrt_f64"] - counts["jb_probe_load1_f64"],
        }
    return {
        "logf": counts["jb_probe_logf"] - counts["jb_probe_load1"],
        "div": counts["jb_probe_div"] - counts["jb_probe_load2"] + 1,
        "hash": counts["jb_probe_hash"] - counts["jb_probe_load2"] + 1,
        "expf": counts["jb_probe_expf"] - counts["jb_probe_load1"],
        "sqrtf": counts["jb_probe_sqrtf"] - counts["jb_probe_load1"],
    }


def ops_per_event(ndim, absorb, cost) -> int:
    """Operations every census event executes, counted from csrc/transport_kernel.cuh
    (each float or integer arithmetic, compare, min, select and conversion is one;
    logf, the divide and the hash count as the instructions cuobjdump shows):

      common: exp23's u23 (3) + fmax (1) + negation (1) + x inv_sigt (1)
        + d_end (2) + d_geom (1) + coll test (1) + census test (1) + d select (1)
        + tau update (3) + step (1) + loop test (3) + it++ (1) = 20;
      per axis: face (I2F, f dx, f + 1, (f + 1) dx: 4) + v != 0, v > 0, select,
        subtract, x c, BIG select (6) + position (multiply, add, crossing select:
        3) + out-of-range tests (2) = 15, plus one divide;
      mins for d_push: ndim; crossing tests: 1, 3, 6 in 1D, 2D, 3D; cell index:
        ndim - 1;
      absorption: the u23 branch draw (3) + its test (1) and one more hash;
      one hash (exp23) and one logf.

    The scatter branch (u16, sqrt, the circle's cosf), wall hits and the gather
    are left out, so the count, and the bound from it, is low."""
    n = 20 + 15 * ndim + ndim + {1: 1, 2: 3, 3: 6}[ndim] + (ndim - 1)
    n += cost["logf"] + ndim * cost["div"] + cost["hash"]
    if absorb:
        n += 4 + cost["hash"]
    return n


def ops_per_ddmc_event(ndim, absorb, cost) -> int:
    """Operations every DDMC event executes (a lane on the DDMC branch that is not
    at a face), counted from csrc/transport_kernel.cuh as ``ops_per_event`` counts:

      common: is_ddmc (dmin sigma_t and the compare: 2) + face test (1) + exp23's
        u23 (3) + fmax (1) + negation (1) + c cdf (1) + cdf's tiny (1) + dt_rem
        (2) + event test (1) + loop test (3) + it++ (1) = 17;
      per axis: face (I2F, f dx, f + 1, (f + 1) dx: 4) + the two leak rates (2)
        + the leak total (2, one fewer overall) + out-of-range tests (2) = 10;
      cell index: ndim - 1;
      absorption: ea + es (1) + ea + leak_tot (1);
      one hash each for the exp23 and the leak/census word, one logf, one divide.

    The outcome (absorption, the leak choice and placement, the census resample,
    the albedo test at a face) and the table gather are left out, so the count, and
    the bound from it, is low."""
    n = 17 + 10 * ndim - 1 + (ndim - 1) + (2 if absorb else 0)
    return n + cost["logf"] + cost["div"] + 2 * cost["hash"]


def ops_smr_per_event(ndim) -> int:
    """Operations SMR adds to every event (csrc/transport_kernel.cuh): the block
    record's address (2), dmin over the active axes (ndim - 1) and the block term
    of the cell index (2). With DDMC the reciprocal cell sizes are the block
    table's column, so no event divides for them."""
    return 2 + (ndim - 1) + 2


def ops_per_crossing(ndim, cost) -> int:
    """Operations of one re-homing by the lookup grid (``rehome``): per axis the
    probe's sign (3), its nudge (compare, select, two multiplies, add: 5), the tile
    bin (subtract, floor, convert, clamp: 5) and the rebase into the new block
    (subtract, floor, convert, clamp: 5), the bin and the rebase each with an IEEE
    divide; the tile index (2 per axis past the first) and three loads. The
    subface resample is left out."""
    return ndim * (18 + 2 * cost["div"]) + 2 * (ndim - 1) + 3


def ops_nongray_per_event(cost) -> int:
    """Operations the per-event opacity (``epbremss`` and the rates after it in
    csrc/transport_kernel.cuh) adds to every event: 13 multiplies (the scales, sb T,
    kb T twice, x kb T, nu h, rho^2, g^3, the stimulated factor, the length
    scale), the two clamps (compare and select: 4), the negation and 1 - exp (2),
    ea, 1 - fleck, its product, + sigma_s and + ea (5): 24, plus five IEEE divides,
    one expf and one sqrtf."""
    return 24 + 5 * cost["div"] + cost["expf"] + cost["sqrtf"]


def census_bound(p, ndim, absorb, n_cells, events, cost, ddmc=False, smr=None,
                 nongray=False):
    """(bound_ms, bound_by) of one census: the larger of its operations over the
    card's float32 peak (float64 peak for a float64 ledger, whose floats count 8
    bytes each and whose ``cost`` are the float64 probes') and of its bytes over
    the memory rate. Bytes: each live
    particle's state read once and written once (position and cell index on the
    active axes, velocity, tau, alive, absorbed written when absorbing, and the
    face code with DDMC), one alive byte of each other slot, the cell table read
    once (8 bytes a cell, 32 with DDMC). With DDMC every event is counted at the
    cheaper of the IMC and the DDMC event, so the bound stays a lower bound where
    both branches run. ``smr`` is (mesh, block crossings) on a refined forest: the
    block column is read and written, the block table (32 bytes a block, 64 in
    float64), the levels and the lookup grid read once, every event pays
    ``ops_smr_per_event`` and every crossing ``ops_per_crossing``. ``nongray``: the
    energy column read
    once, a 16-byte cell record (48 with DDMC) and ``ops_nongray_per_event`` on
    every event."""
    live = int(p.alive.sum())
    fb = p.x.element_size()  # bytes a float: 4, or 8 in float64
    per_particle = 2 * (fb * ndim + 3 * fb + fb + 4 * ndim + 1) + (1 if absorb else 0)
    per_particle += 8 if ddmc else 0
    per_particle += fb if nongray else 0
    record = fb // 4 * ((48 if ddmc else 16) if nongray else (32 if ddmc else 8))
    nbytes = live * per_particle + (p.capacity - live) + record * n_cells
    per_event = ops_per_event(ndim, absorb, cost)
    if ddmc:
        per_event = min(per_event, ops_per_ddmc_event(ndim, absorb, cost))
    if nongray:
        per_event += ops_nongray_per_event(cost)
    n_ops = events * per_event
    if smr is not None:
        mesh, crossings = smr
        nt = mesh.tile_shape
        nbytes += 8 * live + (8 * fb + 4) * mesh.n_blocks + 4 * nt[0] * nt[1] * nt[2]
        n_ops += events * ops_smr_per_event(ndim)
        n_ops += crossings * ops_per_crossing(ndim, cost)
    t_ops = n_ops / (PEAK_F64_OPS if fb == 8 else PEAK_F32_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def deck_setup(dev, deck, mods, sigma_a, sigma_s):
    """(cfg, mesh, prm, coefs) of a deck with constant coefficients."""
    from jaybenne_tpu_torch import config as cm
    from jaybenne_tpu_torch.mesh import build_mesh
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.step import make_transport_params
    from jaybenne_tpu_torch.utils.deck import Deck

    cfg = cm.from_deck(Deck.from_file(deck).update(mods))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    nc = mesh.total_cells
    coefs = TransportCoefs(
        sigma_a=torch.full((nc,), sigma_a, device=dev),
        sigma_s=torch.full((nc,), sigma_s, device=dev),
        fleck=torch.ones(nc, device=dev),
    )
    return cfg, mesh, prm, coefs


def binomial_gate(k_a, k_b, n, what):
    pbar = 0.5 * (k_a + k_b) / n
    sd = (2.0 * n * pbar * (1.0 - pbar)) ** 0.5
    if abs(k_a - k_b) > N_SIGMA_BINOMIAL * sd + 1:
        raise AssertionError(f"{what}: absorbed {k_a} vs {k_b} (sd {sd:.1f})")


def compare_absorbing(transport_kernel, dev, ndim, mods, seed):
    """Phase 7 on one mesh: the absorbing kernel against its plain version.
    Returns the 8-iteration max_abs_err."""
    from jaybenne_tpu_torch.particles import uniform_ledger
    from jaybenne_tpu_torch.utils.constants import CC

    names = ("x", "y", "z", "vx", "vy", "vz", "tau")
    cfg, mesh, prm, coefs = deck_setup(dev, DECK, mods, 256.0, 768.0)
    if mesh.ndim != ndim or mesh.n_blocks < 2 or not prm.has_absorption:
        raise AssertionError(f"phase 7 setup: ndim {mesh.ndim}, {mesh.n_blocks} blocks")
    dt = cfg.jaybenne.dt
    p0 = uniform_ledger(mesh, 1 << 17, torch.Generator(device=dev).manual_seed(seed), CC)
    prm8 = dataclasses.replace(prm, max_iters=8)
    pk, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm8, dt)
    pp, it_p, ev_p = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm8, dt)
    torch.cuda.synchronize()
    for name in ("i", "j", "k", "block", "alive", "absorbed"):
        if not torch.equal(getattr(pk, name), getattr(pp, name)):
            raise AssertionError(f"{ndim}D absorbing, 8 iterations: {name} differs")
    if int(ev_k) != int(ev_p) or int(it_k) != int(it_p):
        raise AssertionError(f"{ndim}D absorbing, 8 iterations: stats {ev_k} {ev_p}")
    err8, rel8 = max_float_err(pk, pp, names, FLOAT_FLOOR)
    if rel8 > FLOAT_RTOL:
        raise AssertionError(f"{ndim}D absorbing, 8 iterations: float rel err {rel8}")
    ev8 = int(ev_k)
    # the full census starts in the last 1 % of the step (c dt (1 - tau) <= 0.01 cm,
    # ~5 collisions): from tau = 0 all but ~0.75^1000 of the particles are absorbed
    pf = p0.clone()
    pf.tau.copy_(0.99 + 0.01 * torch.rand(pf.capacity, device=dev,
                                          generator=torch.Generator(dev).manual_seed(seed)))
    pk, _, ev_k = transport_kernel.transport(pf.clone(), coefs, mesh, seed, prm, dt)
    pp, _, ev_p = transport_kernel.transport_plain(pf.clone(), coefs, mesh, seed, prm, dt)
    for out, name in ((pk, "kernel"), (pp, "plain")):
        if bool((out.tau[out.alive] < 1.0).any()) or bool((out.alive & out.absorbed).any()):
            raise AssertionError(f"{ndim}D absorbing census ({name}): short of census")
    ev_k, ev_p = int(ev_k), int(ev_p)
    if abs(ev_k - ev_p) > EVENTS_RTOL * ev_p:
        raise AssertionError(f"{ndim}D absorbing census: events {ev_k} vs {ev_p}")
    ka, kp = int(pk.absorbed.sum()), int(pp.absorbed.sum())
    binomial_gate(ka, kp, p0.capacity, f"{ndim}D absorbing census")
    if not 0.05 * p0.capacity < ka < 0.95 * p0.capacity:
        raise AssertionError(f"{ndim}D absorbing census: {ka} absorbed of {p0.capacity}")
    print(f"{ndim}D absorbing, {mesh.total_cells} cells in {mesh.n_blocks} blocks: "
          f"8 iterations: identical integers, {ev8} events, "
          f"max_abs_err {err8:.3e} max_rel_err {rel8:.3e}; full census events kernel "
          f"{ev_k} plain {ev_p}, absorbed {ka} / {kp} of {p0.capacity}, "
          f"bitwise equal: {torch.equal(pk.x, pp.x) and torch.equal(pk.i, pp.i)}",
          flush=True)
    return err8


def total_energy(sim):
    """(sum u dV + sum of live weights, sum of live weights), float64."""
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    p = sim.state.particles
    er = float(p.weight.double()[p.alive].sum())
    return float((sim.state.fields.u.double() * dv).sum()) + er, er


def path_census(sim, transport_kernel, dev, seed=12345):
    """The kernel and its plain version on a path's own ledger after its last step:
    (kernel ms, plain ms, census events, 8-iteration max_abs_err, the census's
    inputs), as ``census_compare`` times them."""
    from jaybenne_tpu_torch.ops import transport as transport_ops
    from jaybenne_tpu_torch.step import make_transport_params

    cfg, mesh = sim.cfg, sim.mesh
    prm = make_transport_params(cfg, torch.float32)
    m = cfg.mcblock
    coefs = transport_ops.precompute_coefs(
        sim.state.fields, mesh, m.build_eos(), m.build_opacity(), m.build_scattering(),
        False, torch.float32,
    )
    inputs = (sim.state.particles.clone(), (coefs, mesh, seed, prm, cfg.jaybenne.dt))
    return (*census_compare(transport_kernel, dev, *inputs), inputs)


def census_compare(transport_kernel, dev, p0, args):
    """The kernel and its plain version on one census's inputs ``p0`` and ``args``
    (coefs, mesh, seed, prm, dt): (kernel ms, plain ms, census events, 8-iteration
    max_abs_err). One warm-up each, then the kernel's median of CENSUS_REPEATS
    censuses (printed with their range) and one timed census of the plain
    version."""
    coefs, mesh, seed, prm, dt = args
    transport_kernel.transport(p0.clone(), *args)  # warm-up
    times, events = time_census(transport_kernel.transport, p0, args, dev, CENSUS_REPEATS)
    ms = statistics.median(times)
    print(f"census kernel on {p0.capacity} slots: {spread(times)}", flush=True)
    a8 = (coefs, mesh, seed, dataclasses.replace(prm, max_iters=8), dt)
    transport_kernel.transport_plain(p0.clone(), *a8)  # warm-up
    plain_ms = time_census(transport_kernel.transport_plain, p0, args, dev, 1)[0][0]
    qk = transport_kernel.transport(p0.clone(), *a8)[0]
    qp = transport_kernel.transport_plain(p0.clone(), *a8)[0]
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        if not torch.equal(getattr(qk, name), getattr(qp, name)):
            raise AssertionError(f"kernel on the path's ledger: {name} differs")
    err, rel = max_float_err(qk, qp, ("x", "y", "z", "vx", "vy", "vz", "tau"), FLOAT_FLOOR)
    if rel > FLOAT_RTOL:
        raise AssertionError(f"kernel on the path's ledger: float rel err {rel}")
    return ms, plain_ms, events, err


def hybrid_setup(dev, ndim, absorb, ddmc, seed, n=HYBRID_N):
    """Phase 11's configuration: x-slabs of four cells alternate thin (IMC) and
    thick (DDMC) sigma_t, reflecting in x, periodic in y, outflow in z, with ``n``
    (2^17) particles at uniform positions, a quarter of them on a face of their
    cell with the face-arrival code set. Returns (dt, mesh, prm, ledger, coefs,
    gi), gi the global x index of each cell in block order."""
    from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.particles import place_on_faces, uniform_ledger
    from jaybenne_tpu_torch.utils.constants import CC

    cells = {1: (128, 1, 1), 2: (64, 64, 1), 3: (16, 16, 16)}[ndim]
    blocks = {1: (32, 1, 1), 2: (32, 32, 1), 3: (8, 8, 8)}[ndim]
    mods = {"jaybenne/use_ddmc": "true" if ddmc else "false",
            "mcblock/opacity_model": "constant" if absorb else "none",
            "parthenon/swarm/ix3_bc": "outflow", "parthenon/swarm/ox3_bc": "outflow"}
    for a, k in enumerate("123"):
        mods[f"parthenon/mesh/nx{k}"] = cells[a]
        mods[f"parthenon/meshblock/nx{k}"] = blocks[a]
    cfg, mesh, prm, _ = deck_setup(dev, DECK, mods, 0.0, 0.0)
    if mesh.ndim != ndim or mesh.n_blocks < 2 or prm.has_absorption != absorb:
        raise AssertionError(f"phase 11 setup: ndim {mesh.ndim}, {mesh.n_blocks} blocks")
    nrbx = mesh.root_grid[2]
    gi = ((torch.arange(mesh.n_blocks, device=dev) % nrbx)[:, None, None, None] * mesh.nx
          + torch.arange(mesh.nx, device=dev)).expand(mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx)
    thin, thick = HYBRID_SIGMA
    sig = torch.where((gi // 4) % 2 == 1, thick, thin)
    sa = torch.full_like(sig, HYBRID_SIGMA_A if absorb else 0.0)
    px, py, pz = ddmc_face_probs(mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags,
                                 torch.float32)
    coefs = TransportCoefs(sigma_a=sa.reshape(-1), sigma_s=(sig - sa).reshape(-1),
                           fleck=torch.ones(mesh.total_cells, device=dev), px=px, py=py, pz=pz)
    g = torch.Generator(device=dev).manual_seed(seed)
    p0 = uniform_ledger(mesh, n, g, CC)
    place_on_faces(p0, mesh, torch.rand(p0.capacity, generator=g, device=dev) < 0.25, g)
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))  # some reach census soon
    return cfg.jaybenne.dt, mesh, prm, p0, coefs, gi.reshape(-1)


def ddmc_outcomes(p0, p1, mesh, gi, absorb):
    """Counts of what the first event did on the DDMC branch, from the ledger before
    and after it: albedo rejections and acceptances at a face, leaks into IMC cells
    and into walls, census and absorption."""
    nrbx = mesh.root_grid[2]

    def gx_index(p):
        return (p.block % nrbx) * mesh.nx + p.i

    def cell_of(p):
        return (p.block.long() * mesh.nz + p.k) * mesh.ny * mesh.nx + p.j * mesh.nx + p.i

    thick0 = (gx_index(p0) // 4) % 2 == 1
    dd = p0.alive & thick0
    at_face = dd & (p0.face != 0)
    moved = cell_of(p1) != cell_of(p0)
    rejected = at_face & p1.alive & moved & (p1.tau == p0.tau)
    steps = dd & ~rejected & (p1.tau > p0.tau)
    leak = steps & (p1.tau < 1.0) & ~p1.absorbed
    into_imc = leak & p1.alive & moved & ((gx_index(p1) // 4) % 2 == 0)
    nrby = mesh.root_grid[1]

    def gy_index(p):
        return ((p.block // nrbx) % nrby) * mesh.ny + p.j

    wall = ~p1.alive | ((gy_index(p1) - gy_index(p0)).abs() > 1)
    gx = (p1.block % nrbx).float() / nrbx - 0.5 + p1.x
    wall = wall | (0.5 - gx.abs() < 2e-2 / (nrbx * mesh.nx))
    counts = {"rejected": rejected, "accepted": at_face & ~rejected,
              "leak into IMC": into_imc, "leak into a wall": leak & wall,
              "census": steps & (p1.tau == 1.0)}
    if absorb:
        counts["absorbed"] = dd & p1.absorbed
    return {k: int(v.sum()) for k, v in counts.items()}


def same_state(pk, pp, what, rtol):
    """Raises unless two ledgers hold identical integers, blocks, alive, absorbed
    and face codes and floats within ``rtol`` (relative, on FLOAT_FLOOR); returns
    (max_abs_err, max_rel_err)."""
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        if not torch.equal(getattr(pk, name), getattr(pp, name)):
            bad = int((getattr(pk, name) != getattr(pp, name)).sum())
            raise AssertionError(f"{what}: {name} differs in {bad} slots")
    err, rel = max_float_err(pk, pp, ("x", "y", "z", "vx", "vy", "vz", "tau"), FLOAT_FLOOR)
    if rel > rtol:
        raise AssertionError(f"{what}: float rel err {rel}")
    return err, rel


def kernel_vs_plain(transport_kernel, dev, what, p0, coefs, mesh, prm, dt, seed, seen="",
                    rtol=FLOAT_RTOL, exact_census=False):
    """One instantiation against its plain version on the ledger ``p0``: after 8
    iterations integer state, blocks, alive, absorbed and face codes identical and
    floats within ``rtol``; after a full census of the last 10 % of a step every
    live slot at census, events within EVENTS_RTOL and absorbed counts within
    N_SIGMA_BINOMIAL sd, with ``exact_census`` the 8-iteration check again. Prints
    one line (``seen`` appended). Returns (max_abs_err, slots the kernel absorbed in
    the full census)."""
    prm8 = dataclasses.replace(prm, max_iters=8)
    pk, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm8, dt)
    pp, it_p, ev_p = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm8, dt)
    torch.cuda.synchronize()
    err8, rel8 = same_state(pk, pp, f"{what}, 8 iterations", rtol)
    if int(ev_k) != int(ev_p) or int(it_k) != int(it_p):
        raise AssertionError(f"{what}, 8 iterations: stats {ev_k} {ev_p}")
    ev8 = int(ev_k)
    pf = p0.clone()
    pf.tau.copy_(0.9 + 0.1 * torch.rand(pf.capacity, device=dev,
                                        generator=torch.Generator(dev).manual_seed(seed)))
    pk, _, ev_k = transport_kernel.transport(pf.clone(), coefs, mesh, seed, prm, dt)
    pp, _, ev_p = transport_kernel.transport_plain(pf.clone(), coefs, mesh, seed, prm, dt)
    for out, name in ((pk, "kernel"), (pp, "plain")):
        if bool((out.tau[out.alive] < 1.0).any()) or bool((out.alive & out.absorbed).any()):
            raise AssertionError(f"{what} census ({name}): short of census")
    ev_k, ev_p = int(ev_k), int(ev_p)
    if abs(ev_k - ev_p) > EVENTS_RTOL * ev_p:
        raise AssertionError(f"{what} census: events {ev_k} vs {ev_p}")
    ka, kp = int(pk.absorbed.sum()), int(pp.absorbed.sum())
    binomial_gate(ka, kp, p0.capacity, f"{what} census")
    if exact_census:
        err8 = max(err8, same_state(pk, pp, f"{what}, full census", rtol)[0])
        if ev_k != ev_p:
            raise AssertionError(f"{what}, full census: events {ev_k} vs {ev_p}")
    same = all(torch.equal(getattr(pk, n), getattr(pp, n)) for n in ("x", "i", "block"))
    print(f"{what}: 8 iterations: identical integers, blocks and face codes, {ev8} events, "
          f"max_abs_err {err8:.3e} max_rel_err {rel8:.3e}; full census events kernel "
          f"{ev_k} plain {ev_p}, absorbed {ka} / {kp}, bitwise equal: {same}{seen}",
          flush=True)
    return err8, ka


def compare_hybrid(transport_kernel, dev, ndim, absorb, ddmc, seed):
    """Phase 11 on one instantiation: the kernel against its plain version on the
    hybrid ledger. Returns the 8-iteration max_abs_err."""
    dt, mesh, prm, p0, coefs, gi = hybrid_setup(dev, ndim, absorb, ddmc, seed)
    what = transport_kernel.launch_name(ndim, absorb, ddmc)
    seen = ""
    if ddmc:
        p1 = transport_kernel.transport(p0.clone(), coefs, mesh, seed,
                                        dataclasses.replace(prm, max_iters=1), dt)[0]
        counts = ddmc_outcomes(p0, p1, mesh, gi, absorb)
        if min(counts.values()) == 0:
            raise AssertionError(f"{what}: a DDMC outcome did not occur: {counts}")
        seen = f"; first event {counts}"
    # the 3D DDMC instantiations (the 64^3 DDMC row's and its absorbing twin) are
    # held bitwise after the full census too
    err8, ka = kernel_vs_plain(transport_kernel, dev, what, p0, coefs, mesh, prm, dt, seed,
                               seen, exact_census=ddmc and ndim == 3)
    if absorb and not ka > 0.01 * p0.capacity:
        raise AssertionError(f"{what} census: {ka} absorbed of {p0.capacity}")
    return err8


def hybrid_census_timing(transport_kernel, dev, ndim, absorb, seed, cost):
    """The DDMC kernel and its plain version timed on phase 11's full-census ledger
    (the last 10 % of a step): (ms, plain_ms, events, bound_ms, bound_by)."""
    dt, mesh, prm, p0, coefs, _ = hybrid_setup(dev, ndim, absorb, True, seed)
    p0.tau.copy_(0.9 + 0.1 * torch.rand(p0.capacity, device=dev,
                                        generator=torch.Generator(dev).manual_seed(seed)))
    ms, plain_ms, ev, _ = census_compare(transport_kernel, dev, p0,
                                         (coefs, mesh, seed, prm, dt))
    bound, by = census_bound(p0, ndim, absorb, mesh.total_cells, ev, cost, ddmc=True)
    return ms, plain_ms, ev, bound, by


def smr_setup(dev, ndim, absorb, ddmc, seed, n=HYBRID_N):
    """Phase 15's configuration on the level-1 forest of ``ndim``: x-slabs of four
    coarse cells alternate thin (IMC) and thick (DDMC) sigma_t by cell centre,
    with ``n`` (2^17) particles uniform over the forest's cells, a quarter of them
    on a face of their cell with the face-arrival code set. Returns (dt, mesh,
    prm, ledger, coefs, thick [NC])."""
    from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.particles import forest_ledger, place_on_faces
    from jaybenne_tpu_torch.utils.constants import CC

    deck, base = SMR_FORESTS[ndim]
    mods = {**base, "jaybenne/use_ddmc": "true" if ddmc else "false",
            "jaybenne/tau_ddmc": 5.0, "mcblock/opacity_model": "constant" if absorb else "none",
            "parthenon/output0/file_type": "none"}
    cfg, mesh, prm, _ = deck_setup(dev, deck, mods, 0.0, 0.0)
    if mesh.ndim != ndim or mesh.max_level != 1 or prm.has_absorption != absorb:
        raise AssertionError(f"phase 15 setup: ndim {mesh.ndim}, max_level {mesh.max_level}")
    xc = mesh.cell_centers()[0]
    width = 4.0 * float(mesh.block_dx[:, 0].max())
    thick = torch.floor((xc - mesh.bounds[0]) / width).long() % 2 == 1
    thin_sig, thick_sig = HYBRID_SIGMA
    sig = torch.where(thick, thick_sig, thin_sig)
    sa = torch.full_like(sig, HYBRID_SIGMA_A if absorb else 0.0)
    faces = {}
    if ddmc:
        faces = dict(zip(("px", "py", "pz"), ddmc_face_probs(
            mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)))
    coefs = TransportCoefs(sigma_a=sa.reshape(-1), sigma_s=(sig - sa).reshape(-1),
                           fleck=torch.ones(mesh.total_cells, device=dev), **faces)
    g = torch.Generator(device=dev).manual_seed(seed)
    p0 = forest_ledger(mesh, n, g, CC)
    place_on_faces(p0, mesh, torch.rand(p0.capacity, generator=g, device=dev) < 0.25, g)
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))
    return cfg.jaybenne.dt, mesh, prm, p0, coefs, thick.reshape(-1)


def smr_outcomes(p0, p1, mesh, thick):
    """What one event did across blocks, from the ledger before and after it:
    level-up and level-down block transitions, and DDMC leaks from a thick cell
    into a finer block (each one a subface resample: off-face, tau advanced short
    of census)."""
    lvl = mesh.block_level
    live = p0.alive & p1.alive
    moved = live & (p1.block != p0.block)
    l0, l1 = lvl[p0.block.long()], lvl[p1.block.long()]
    cell0 = mesh.flat_cell(p0.block.long(), p0.k.long(), p0.j.long(), p0.i.long())
    up = moved & (l1 > l0)
    resample = up & thick[cell0] & (p1.face == 0) & (p1.tau > p0.tau) & (p1.tau < 1.0)
    return {"level up": int(up.sum()), "level down": int((moved & (l1 < l0)).sum()),
            "resamples": int(resample.sum())}


def compare_smr(transport_kernel, dev, ndim, absorb, ddmc, seed):
    """Phase 15 on one SMR instantiation: the kernel against its plain version on
    the forest's hybrid ledger. Returns (8-iteration max_abs_err, subface
    resamples in the first event)."""
    dt, mesh, prm, p0, coefs, thick = smr_setup(dev, ndim, absorb, ddmc, seed)
    what = transport_kernel.launch_name(ndim, absorb, ddmc, True)
    p1 = transport_kernel.transport(p0.clone(), coefs, mesh, seed,
                                    dataclasses.replace(prm, max_iters=1), dt)[0]
    seen = smr_outcomes(p0, p1, mesh, thick)
    if seen["level up"] == 0 or seen["level down"] == 0:
        raise AssertionError(f"{what}: no block transition of a level: {seen}")
    if not (ddmc and ndim >= 2):  # only a 2D/3D DDMC leak is resampled
        seen.pop("resamples")
    elif seen["resamples"] == 0:
        raise AssertionError(f"{what}: no subface resample: {seen}")
    err8, _ = kernel_vs_plain(transport_kernel, dev, what, p0, coefs, mesh, prm, dt, seed,
                              f"; {mesh.n_blocks} blocks, {mesh.total_cells} cells; "
                              f"first event {seen}", exact_census=ddmc and ndim == 3)
    return err8, seen.get("resamples", 0)


def block_crossings(transport_kernel, p0, args, events, iters=8):
    """Block crossings of a census, estimated from its first ``iters`` events
    (one-iteration kernel calls on a copy): the share of events that changed a
    particle's block, times the census's ``events``. A re-homing that ends in
    the same block (a reflection at a domain wall) is left out."""
    coefs, mesh, seed, prm, dt = args
    p = p0.clone()
    one = dataclasses.replace(prm, max_iters=1)
    moved = active = 0
    for k in range(iters):
        before = p.block.clone()
        live = p.alive & (p.tau < 1.0)
        p = transport_kernel.transport(p, coefs, mesh, seed + k, one, dt)[0]
        active += int(live.sum())
        moved += int((live & (p.block != before)).sum())
    return int(round(events * moved / max(active, 1)))


def lane_split(sim) -> dict:
    """Blocks on each branch, as tst/ddmc_bench.py:84-96 reports them: a block is
    on DDMC when its smallest cell size times sigma exceeds tau_ddmc."""
    mesh, cfg = sim.mesh, sim.cfg
    dmin = mesh.block_dx[:, : mesh.ndim].min(dim=1).values.double()
    tau = dmin * float(cfg.mcblock.scattering_constant_value)
    ddmc = int((tau > cfg.jaybenne.tau_ddmc).sum()) if cfg.jaybenne.use_ddmc else 0
    return {"ddmc_blocks": ddmc, "imc_blocks": mesh.n_blocks - ddmc}


def run_path(deck, mods, launch, steps=PATH_STEPS, conserves_tally=True, per_step=1,
             energy_rtol=ENERGY_RTOL, graph_rerun=False):
    """A deck through ``driver.run_file`` on the GPU for ``steps`` steps: the
    radiation energy before the first step; the run, with the launch counts set
    to 0 just before it and read just after, the eager step (``graph=False``) so
    that the inputs of its last census are recorded; its peak device memory; a
    rerun with the same seed, as the driver runs it (a CUDA graph on one device,
    an external source's step too). Raises unless ``launch`` ran
    ``per_step`` times a step (once, or once a shard), every census completed
    short of the iteration cap, nothing was dropped, sum(tally dV) was conserved
    to ``energy_rtol`` (a number, or a function of the run; unless not
    ``conserves_tally``: matter absorbs or emits)
    and the rerun's tally and u are bitwise identical (with ``graph_rerun``, the
    rerun must be CUDA graph replays with the eager run's history). Returns
    (sim, launches, (ledger, args) of the last census, the radiation energy before
    the first step)."""
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.ops import cuda_lib, transport_kernel

    with tempfile.TemporaryDirectory() as outdir:
        sim0 = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=0,
                        device="cuda")
        e0 = radiation_energy(sim0)
        del sim0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with CensusRecorder(transport_kernel, steps) as rec:
            cuda_lib.LAUNCHES.clear()
            sim = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True,
                           nlim=steps, device="cuda", graph=False)
            launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        again = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True,
                         nlim=steps, device="cuda")
    what = os.path.basename(deck)
    note_table(f"{what}, {launch}", launches)
    if launches.get(launch, 0) != per_step * steps or sim.cycle != steps:
        raise AssertionError(f"{what}: launches {launches}, cycles {sim.cycle}")
    max_iters = sim.cfg.jaybenne.max_transport_iterations
    if any(h["dropped"] or h["unfinished"] or h["iterations"] >= max_iters
           for h in sim.history) or sim.state.overflow:
        raise AssertionError(f"{what}: dropped, unfinished or capped: {sim.history}")
    tally = sim.state.fields.energy_tally
    if not bool(torch.isfinite(tally).all()):
        raise AssertionError(f"{what}: tally not finite")
    e1 = radiation_energy(sim)
    if callable(energy_rtol):
        energy_rtol = energy_rtol(sim)
    if conserves_tally and abs(e1 - e0) > energy_rtol * e0:
        raise AssertionError(f"{what}: energy {e0} -> {e1}")
    if not (torch.equal(again.state.fields.energy_tally, tally)
            and torch.equal(again.state.fields.u, sim.state.fields.u)):
        raise AssertionError(f"{what}: a rerun with the same seed differs")
    if graph_rerun and not (again.graphed and again.step_fn.captures >= 1
                            and again.history == [dict(h, step_seconds=g["step_seconds"])
                                                  for h, g in zip(sim.history, again.history)]):
        raise AssertionError(f"{what}: the rerun is not CUDA graph replays of the eager steps "
                             f"(graphed {again.graphed})")
    step_s = [h["step_seconds"] for h in sim.history]
    print(f"{what} {sim.mesh.n_blocks} blocks (levels "
          f"{sorted(set(sim.mesh.block_level.tolist()))}), {sim.mesh.total_cells} cells, "
          f"lane split {lane_split(sim)}: {launches.get(launch, 0)} launches of {launch}, "
          f"events {sim.total_events}, radiation energy {e0!r} -> {e1!r}, iterations "
          f"{[h['iterations'] for h in sim.history]}; the recorded run eager, its rerun "
          f"({'a CUDA graph' if again.graphed else 'eager'}) bitwise identical", flush=True)
    print(f"{what}: step seconds {step_s}; median {statistics.median(step_s) * 1e3!r} ms; "
          f"{sim.total_events / sum(step_s)!r} events/s; peak device memory {peak} bytes",
          flush=True)
    return sim, launches, rec.inputs, e0


def particle_step_line(deck, mods, what, smi) -> dict:
    """A phase 32 row as the driver runs it (the particle decomposition's step as a
    CUDA graph over the shards' states: step 1 eager, step 2 captured), read by
    ``profile.read_steps`` over PARTICLE_READ_STEPS replayed steps: the device ms
    a step (the census kernel's, the other hand-written kernels', and the rest:
    the replicas' plain PyTorch work, once a shard), the unprofiled step wall.
    Raises unless each step replayed (no capture) with one census launch."""
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.profile import read_steps

    n = PARTICLE_READ_STEPS
    with tempfile.TemporaryDirectory() as outdir:
        sim = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=2,
                       device="cuda")
        captures = sim.step_fn.captures if sim.graphed else 0
        r = read_steps(sim, n)
    census = sum(v for k, v in r["launches"].items() if k.startswith("transport_"))
    if not sim.graphed or captures != 1 or sim.step_fn.captures != 1 or census != n:
        raise AssertionError(f"{what}: graphed {sim.graphed}, captures {captures} -> "
                             f"{sim.step_fn.captures}, {census} census launches in {n} steps")
    by = r["by_name"]
    total = sum(by.values()) / n / 1e3
    kernel = sum(us for k, us in by.items() if "transport_kernel" in k) / n / 1e3
    hand = sum(us for k, us in by.items() if HAND_KERNELS.search(k)) / n / 1e3
    wall = statistics.median(r["wall_s"]) * 1e3
    out = {"device_ms": total, "census_ms": kernel, "hand_ms": hand, "plain_ms": total - hand,
           "wall_ms": wall}
    print(f"{what} ({smi}), CUDA graph replays, {n} steps: device {total!r} ms a step, of it "
          f"the census kernel {kernel!r} ms in one launch, the other hand-written kernels "
          f"{hand - kernel!r}, the plain PyTorch work (the replicas' Fleck factor, "
          f"coefficients, sourcing, tally outputs and feedback, a shard at a time; copies and "
          f"memsets) {total - hand!r}; step wall median {wall!r} ms (device idle share "
          f"{1.0 - total / wall!r}); host synchronisations {r['syncs'] / n!r} a step",
          flush=True)
    return out


def particle_census_check(transport_kernel, inputs, what) -> None:
    """The particle decomposition's census on a phase 32 row's recorded inputs
    (``run_path``: the shards' slices of one ledger, and the coefficients, mesh,
    seeds, params and dt of its last step): the kernel's one launch over every
    slice, with ``own`` None (each shard owns the whole mesh, every shard row
    reads row 0 of the one table) and the seeds read from an int32 tensor on the
    device as the step passes them, against its plain version over the same
    list and against the kernel's calls shard by shard (the parent's eight
    launches), each on a clone: every column identical, floats as bits, and the
    same iterations and events per shard. The plain calls shard by shard are the
    CPU tests' (``tests/test_torch_particle_launch.py``): eight plain censuses of
    a row would take minutes here (the hybrid's plain census 28 s)."""
    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.parallel.sharding import split_ledger
    from jaybenne_tpu_torch.particles import join_slices

    slices, (coefs, mesh, seed, prm, dt) = inputs
    n, (whole, _) = len(slices), join_slices(slices)

    def fresh():
        p = whole.clone()
        return p, split_ledger(p, n)

    (pk, k), (pq, q), (pr, r) = fresh(), fresh(), fresh()
    before = sum(v for key, v in cuda_lib.LAUNCHES.items() if key.startswith("transport_"))
    _, it_k, ev_k = transport_kernel.transport(
        k, coefs, mesh, torch.tensor(seed, dtype=torch.int32, device=whole.x.device), prm, dt)
    launched = sum(v for key, v in cuda_lib.LAUNCHES.items()
                   if key.startswith("transport_")) - before
    if launched != 1:
        raise AssertionError(f"{what}: {launched} census launches over {n} slices, not one")
    _, it_q, ev_q = transport_kernel.transport_plain(q, coefs, mesh, seed, prm, dt)
    its, evs = [], []
    for ledger, sd in zip(r, seed):
        _, it, ev = transport_kernel.transport(ledger, coefs, mesh, sd, prm, dt)
        its.append(int(it))
        evs.append(int(ev))
    same_columns(pk, pq, f"{what}: the one launch against the plain call over the list")
    same_columns(pk, pr, f"{what}: the one launch against the launches shard by shard")
    counts = [(it_k.tolist(), ev_k.tolist()), (it_q.tolist(), ev_q.tolist()), (its, evs)]
    if counts[0] != counts[1] or counts[0] != counts[2]:
        raise AssertionError(f"{what}: iterations and events (one launch, plain list, "
                             f"launches by shard) {counts}")
    print(f"{what}: the last step's census, one launch over the {n} shards' slices "
          f"({whole.capacity} slots, {int(whole.alive.sum())} live before it; seeds read on "
          f"the device, every shard row on row 0 of the one table), bitwise the plain call "
          f"over the list and the launches shard by shard: every column, iterations "
          f"{counts[0][0]}, events {counts[0][1]}", flush=True)


def host_gap_phase(smi) -> None:
    """Phase 48: the host between a spatial step's batches, by part, on
    HOST_GAP_PATHS as CUDA graphs, with no batch queued ahead of an exit read and
    with one (the step's ``ahead``), in turns (none, ahead, ahead, none), each by
    ``profile.read_steps`` over HOST_GAP_STEPS steps after two (eager, captured):
    the step's wall less its device time, and the host ms a step of the exit
    reads' waits, the round prologues and the batch replays' launches (their
    ``record_function`` spans in the profiled steps). Raises unless every run's
    migration rounds and events are the same."""
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.profile import read_steps

    phase("48 the spatial host between batches, by part: no batch queued ahead of an exit "
          "read against one, in turns, every step's rounds unchanged")
    n = HOST_GAP_STEPS
    for what, deck, mods in HOST_GAP_PATHS:
        seen = None
        for ahead in (False, True, True, False):
            with tempfile.TemporaryDirectory() as outdir:
                sim = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=0,
                               device="cuda")
                core = spatial_core(sim)
                core.ahead = ahead
                sim.run(nlim=2)
                q0 = core.rounds_run
                r = read_steps(sim, n)
                queued = (core.rounds_run - q0) / (3 * n)  # timed, profiled, counted
            if seen is None:
                seen = (r["rounds"], r["events"])
            elif (r["rounds"], r["events"]) != seen:
                raise AssertionError(f"{what}: rounds and events {r['rounds']}, {r['events']} "
                                     f"with ahead {ahead}, {seen} before")
            host, dev, count = r["spans"]
            total = sum(r["by_name"].values()) / n / 1e3
            wall = statistics.median(r["wall_s"]) * 1e3
            parts = "; ".join(f"{s} {host.get(s, 0.0) / n!r} ms in {count.get(s, 0) / n!r}"
                              for s in HOST_SPANS)
            print(f"{what} ({smi}), {int(ahead)} batch(es) queued ahead of an exit read: "
                  f"step wall median {wall!r} ms, device {total!r} ms a step, wall less device "
                  f"{wall - total!r} ms; rounds {r['rounds']} ({queued!r} queued a step in "
                  f"batches of {core.rounds_per_batch}); host ms a step in spans (profiled): "
                  f"{parts}", flush=True)
            del sim
            torch.cuda.empty_cache()


def gate(value, tol, what):
    """Raises unless ``value`` is finite and within ``tol``; prints it."""
    if not np.isfinite(value) or value > tol:
        raise AssertionError(f"{what}: {value} > {tol}")
    print(f"{what}: {value!r} (tol {tol})", flush=True)
    return value


def events_gate(events, want, what):
    """Raises unless ``events`` is within SMR_EVENTS_RTOL of the JAX package's."""
    if abs(events - want) > SMR_EVENTS_RTOL * want:
        raise AssertionError(f"{what}: events {events} vs the JAX package's {want}")
    print(f"{what}: events {events} (JAX package {want}, {events / want - 1.0:+.4f})",
          flush=True)


def path_kernel(transport_kernel, dev, sim, inputs, name, cost):
    """The kernel ``name`` and its plain version on the inputs of a path's last
    census, with its bound (on a refined forest with the block crossings of
    ``block_crossings``): (ms, plain_ms, events, 8-iteration max_abs_err,
    bound_ms, bound_by)."""
    p, args = inputs
    ms, plain_ms, ev, err = census_compare(transport_kernel, dev, p, args)
    coefs, prm, mesh = args[0], args[3], sim.mesh
    smr = (mesh, block_crossings(transport_kernel, p, args, ev)) if mesh.max_level > 0 else None
    bound, by = census_bound(p, prm.ndim, bool(prm.has_absorption), mesh.total_cells, ev,
                             cost, ddmc=bool(prm.use_ddmc), smr=smr, nongray=not coefs.is_gray)
    print(f"{name} on the last census's inputs ({p.capacity} slots, {int(p.alive.sum())} "
          f"live): kernel {ms!r} ms, plain {plain_ms!r} ms, {ev} events"
          + (f", ~{smr[1]} block crossings" if smr else "")
          + f"; bound {bound!r} ms ({by}), kernel at {bound / ms:.3f} of it; "
          f"8-iteration max_abs_err {err:.3e}", flush=True)
    return ms, plain_ms, ev, err, bound, by


class CensusRecorder:
    """While active, wraps ``transport_kernel.transport`` so that the steps built
    meanwhile call it through the wrapper, and keeps a copy of the inputs of its
    ``keep``-th call (the ledger, or the local shards' slices, cloned before the
    census changes them; the seed as a host int, or a list of one a shard, where
    the step passes its device seed buffer, which a later step rewrites; one
    device's call, which passes a list of one ledger, as one ledger and its seed).
    A CUDA graph's replay calls no Python, and its capture
    holds no values yet, so the recorded run must run the eager step
    (``run_file(..., graph=False)``): a call made while a graph is being captured
    raises."""

    def __init__(self, transport_kernel, keep):
        self.tk, self.keep, self.calls, self.inputs = transport_kernel, keep, 0, None
        self.real = transport_kernel.transport

    def __enter__(self):
        self.tk.transport = self._census
        return self

    def __exit__(self, *exc):
        self.tk.transport = self.real

    def _census(self, particles, *args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("CensusRecorder: a recorded run must run the eager step")
        self.calls += 1
        if self.calls == self.keep:
            coefs, mesh, seed, *rest = args
            if isinstance(seed, torch.Tensor):
                seed = seed.tolist()
            ledgers = particles if isinstance(particles, (list, tuple)) else [particles]
            if len(ledgers) == 1:  # one device: its ledger and its seed
                kept, seed = ledgers[0].clone(), seed[0] if isinstance(seed, list) else seed
            else:  # the local shards' slices
                from jaybenne_tpu_torch.parallel.sharding import split_ledger
                from jaybenne_tpu_torch.particles import join_slices

                kept = split_ledger(join_slices(ledgers)[0].clone(), len(ledgers))
            self.inputs = (kept, (coefs, mesh, seed, *rest))
        return self.real(particles, *args)


def profile_error(sim, nbins=PROFILE_BINS, scale=1.0) -> float:
    """Weighted-mean fractional error of the volume-weighted x-profile of the tally
    in ``nbins`` uniform x-bins against ``scale`` times the erf solution at the bin
    centres, as tst/regression_test.py::profile_comparison computes it."""
    v = sim.state.fields.energy_tally.double().cpu().numpy()
    xc = sim.mesh.cell_centers()[0].double().cpu().numpy() * np.ones_like(v)
    vol = sim.mesh.block_volume.double().cpu().numpy()[:, None, None, None] * np.ones_like(v)
    x1min, x1max = sim.mesh.bounds[0], sim.mesh.bounds[1]
    width = (x1max - x1min) / nbins
    bins = np.clip(((xc - x1min) / width).astype(np.int64), 0, nbins - 1).reshape(-1)
    num = np.bincount(bins, (v * vol).reshape(-1), nbins)
    den = np.bincount(bins, vol.reshape(-1), nbins)
    prof = num / np.maximum(den, 1.0e-300)
    sol = scale * erf_profile(sim.t, x1min + (np.arange(nbins) + 0.5) * width)
    # a bin where both are exactly 0 (far into the cold side at early times)
    # contributes nothing; the harness's 0/0 there would make the error NaN
    both = (sol + prof) > 0.0
    frac = np.fabs(sol - prof) / np.where(both, np.fabs((sol + prof) / 2.0), 1.0)
    return float((frac * sol).sum() / sol.sum())


def smr_phases(transport_kernel, dev, cost, src, resources, common) -> tuple:
    """Phases 15-21 (static mesh refinement). Returns the entries of the
    ``kernels`` line for the SMR instantiations that the paths run, and the
    inputs of stepdiff_smr's last census (phase 44 times it at both
    precisions)."""
    phase("15 K1(d): all twelve SMR instantiations vs plain on level-1 forests, 2^17 particles")
    smr_err, resamples = {}, 0
    for ndim, seed in ((1, 1501), (2, 1502), (3, 1503)):
        for absorb in (False, True):
            for ddmc in (False, True):
                name = transport_kernel.launch_name(ndim, absorb, ddmc, True)
                smr_err[name], n_res = compare_smr(transport_kernel, dev, ndim, absorb, ddmc,
                                                   seed + 10 * absorb)
                resamples += n_res
    print(f"coarse-to-fine subface resamples in the first events: {resamples}", flush=True)

    phase("16 SMR main path: stepdiff_smr, 64x32 cells in 16^2 blocks, 100k particles, "
          "10 steps")
    name_s2 = transport_kernel.launch_name(2, False, False, True)
    s2, s2_launches, s2_in, _ = run_path(SMR_DECK, SMR_GATE, name_s2)
    gate(weighted_erf_error(s2), SMR_TOL, "stepdiff_smr werr")
    k_s2 = path_kernel(transport_kernel, dev, s2, s2_in, name_s2, cost)
    event_loop_line(transport_kernel, dev, name_s2, s2_in, k_s2[0], k_s2[2],
                    resources.get(name_s2, {}), common[name_s2])

    phase("17 SMR with DDMC: stepdiff_smr_ddmc, 64x32 cells, 10 steps")
    name_sd2 = transport_kernel.launch_name(2, False, True, True)
    sd2 = run_path(SMR_DDMC_DECK, SMR_GATE, name_sd2)[0]
    gate(weighted_erf_error(sd2), SMR_TOL, "stepdiff_smr_ddmc werr")

    phase("18 the hybrid gate: stepdiff_smr_hybrid at 64x32, tau_ddmc = 10, 10 steps")
    hy = run_path(HYBRID_DECK, HYBRID_GATE, name_sd2)[0]
    gate(weighted_erf_error(hy), SMR_TOL, "hybrid werr")
    events_gate(hy.total_events, HYBRID_JAX_EVENTS, "hybrid")

    phase("19 levels 0/1/2: stepdiff_smr2 at 64x32, IMC and DDMC profiles, per-cell at 400k")
    s22 = run_path(SMR2_DECK, SMR_GATE, name_s2)[0]
    gate(profile_error(s22), PROFILE_TOL, "stepdiff_smr2 x-profile")
    s22d = run_path(SMR2_DECK, SMR2_DDMC, name_sd2)[0]
    gate(profile_error(s22d), PROFILE_TOL, "stepdiff_smr2 DDMC x-profile")
    s22c = run_path(SMR2_DECK, SMR2_PER_CELL, name_s2)[0]
    gate(weighted_erf_error(s22c), SMR_TOL, "stepdiff_smr2 per-cell werr at 400k particles")

    phase("20 3D SMR with DDMC: stepdiff_3d, 32x16x16 cells in 8^3 blocks, 500k particles")
    name_sd3 = transport_kernel.launch_name(3, False, True, True)
    s3, s3_launches, s3_in, _ = run_path(SMR3D_DECK, SMR3D, name_sd3)
    gate(weighted_erf_error(s3), SMR_TOL, "stepdiff_3d werr")
    k_sd3 = path_kernel(transport_kernel, dev, s3, s3_in, name_sd3, cost)

    phase("21 full width: stepdiff_smr_hybrid at 128x64 in 32^2 blocks, 100k particles, "
          "10 steps")
    nh, nh_launches, nh_in, _ = run_path(HYBRID_DECK, NATIVE_HYBRID, name_sd2)
    if nh.mesh.n_blocks != 20 or nh.mesh.total_cells != 20 * 32 * 32:
        raise AssertionError(f"native hybrid: {nh.mesh.total_cells} cells, "
                             f"{nh.mesh.n_blocks} blocks")
    gate(profile_error(nh), PROFILE_TOL, "native hybrid x-profile")
    print(f"native hybrid per-cell werr (not gated; the JAX package read 0.5052): "
          f"{weighted_erf_error(nh)!r}", flush=True)
    events_gate(nh.total_events, NATIVE_HYBRID_JAX_EVENTS, "native hybrid")
    k_sd2 = path_kernel(transport_kernel, dev, nh, nh_in, name_sd2, cost)
    warp_efficiency_line(transport_kernel, nh_in, f"{name_sd2} on the native hybrid's last "
                         "census", k_sd2[0], "3.045")

    k1 = "jaybenne_tpu/ops/pallas_transport.py:382"
    k4 = "jaybenne_tpu/ops/pallas_bucketed.py:221"
    kernels = []
    for name, what, replaces, launches_smr, (ms_k, plain_k, _, err_k, bound_k, by_k) in (
            (name_s2, "K1(d) SMR; stepdiff_smr", k1, s2_launches, k_s2),
            (name_sd2, "K1(d) SMR with DDMC; K4's gray function at the native 128x64 hybrid",
             f"{k1}; {k4}", nh_launches, k_sd2),
            (name_sd3, "K1(d) SMR with DDMC in 3D; K4's gray function on stepdiff_3d",
             f"{k1}; {k4}", s3_launches, k_sd3)):
        kernels.append({
            "name": f"{name} ({what})", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches_smr.get(name, 0), "max_abs_err": max(smr_err[name], err_k),
            "ms": ms_k, "plain_ms": plain_k, "bound_ms": bound_k, "bound_by": by_k,
            "library_ms": None,
        })
    return kernels, s2_in


def nongray_setup(dev, ndim, ddmc, smr, seed):
    """Phase 22's configuration: EPBremss on phase 11's uniform mesh or phase 15's
    level-1 forest of ``ndim``, per cell rho in [0.5, 2], T log-uniform in [5e5,
    5e6], fleck in [0.3, 1] and sigma_s = 10; 2^17 particles uniform over the
    forest's cells, a quarter on a face of their cell with the face-arrival code
    set, at photon energies x sb T of their cell with x log-uniform in [0.05, 30].
    Returns (dt, mesh, prm, ledger, coefs, lanes on the DDMC branch at the start,
    cells holding lanes of both branches)."""
    from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.particles import forest_ledger, place_on_faces
    from jaybenne_tpu_torch.utils.constants import CC, SB

    if smr:
        deck, mods = SMR_FORESTS[ndim]
    else:
        cells = {1: (128, 1, 1), 2: (64, 64, 1), 3: (16, 16, 16)}[ndim]
        blocks = {1: (32, 1, 1), 2: (32, 32, 1), 3: (8, 8, 8)}[ndim]
        deck, mods = DECK, {"parthenon/swarm/ix3_bc": "outflow",
                            "parthenon/swarm/ox3_bc": "outflow"}
        for a, k in enumerate("123"):
            mods[f"parthenon/mesh/nx{k}"] = cells[a]
            mods[f"parthenon/meshblock/nx{k}"] = blocks[a]
    mods = {**mods, "jaybenne/use_ddmc": "true" if ddmc else "false", "jaybenne/tau_ddmc": 5.0,
            "mcblock/opacity_model": "ep_bremss", "mcblock/scattering_constant_value": 10.0,
            "parthenon/output0/file_type": "none"}
    cfg, mesh, prm, _ = deck_setup(dev, deck, mods, 0.0, 0.0)
    if mesh.ndim != ndim or (mesh.max_level > 0) != smr or not prm.has_absorption:
        raise AssertionError(f"phase 22 setup: ndim {mesh.ndim}, max_level {mesh.max_level}")
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = mesh.total_cells
    rho = 0.5 + 1.5 * torch.rand(nc, generator=g, device=dev)
    temp = torch.exp(np.log(5e5) + np.log(10.0) * torch.rand(nc, generator=g, device=dev))
    ff = 0.3 + 0.7 * torch.rand(nc, generator=g, device=dev)
    opacity, scattering = cfg.mcblock.build_opacity(), cfg.mcblock.build_scattering()
    sa = opacity.absorption_coefficient(rho, temp)  # the Planck mean
    ss = scattering.total_scattering_coefficient(rho, temp)
    faces = {}
    if ddmc:
        shape = (mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx)
        faces = dict(zip(("px", "py", "pz"), ddmc_face_probs(
            mesh, (sa + ss).reshape(shape), prm.tau_ddmc, cfg.mesh.periodic_flags,
            torch.float32)))
    coefs = TransportCoefs(sigma_a=sa, sigma_s=ss, fleck=ff, rho=rho, temp=temp,
                           opacity=opacity, **faces)
    p0 = forest_ledger(mesh, HYBRID_N, g, CC)
    place_on_faces(p0, mesh, torch.rand(p0.capacity, generator=g, device=dev) < 0.25, g)
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))
    cell = mesh.flat_cell(p0.block.long(), p0.k.long(), p0.j.long(), p0.i.long())
    x = torch.exp(np.log(0.05) + np.log(600.0) * torch.rand(p0.capacity, generator=g, device=dev))
    p0.energy.copy_(x * SB * temp[cell])
    # each lane's branch at the start, from its own sigma_t(E)
    sa_e = opacity.absorption_coefficient(rho[cell], temp[cell], p0.energy)
    sig_t = ff[cell] * sa_e + (ss[cell] + (1.0 - ff[cell]) * sa_e)
    dmin = mesh.block_dx[:, :ndim].min(dim=1).values.to(dev)[p0.block.long()]
    dd = dmin * sig_t > prm.tau_ddmc
    both = int(np.intersect1d(cell[dd].cpu().numpy(), cell[~dd].cpu().numpy()).size)
    return cfg.jaybenne.dt, mesh, prm, p0, coefs, int(dd.sum()), both


def compare_nongray(transport_kernel, dev, ndim, ddmc, smr, seed):
    """Phase 22 on one NONGRAY instantiation: the kernel against its plain version,
    exactly after 8 iterations and after a full census. Returns the max_abs_err."""
    dt, mesh, prm, p0, coefs, n_dd, both = nongray_setup(dev, ndim, ddmc, smr, seed)
    what = transport_kernel.launch_name(ndim, True, ddmc, smr, True)
    if ddmc and not (n_dd > 0 and both > 0):
        raise AssertionError(f"{what}: {n_dd} DDMC lanes, {both} cells with both branches")
    err, ka = kernel_vs_plain(transport_kernel, dev, what, p0, coefs, mesh, prm, dt, seed,
                              f"; {mesh.n_blocks} blocks, {mesh.total_cells} cells, {n_dd} lanes "
                              f"thick (dmin sigma_t(E) > tau_ddmc) at the start, {both} cells "
                              "with thick and thin lanes",
                              rtol=NG_RTOL, exact_census=True)
    if not ka > 0.01 * p0.capacity:
        raise AssertionError(f"{what} census: {ka} absorbed of {p0.capacity}")
    return err


def spectral_gate(sim, p0, what, jax_ref):
    """Phases 23 and 25 after a one-step EPBremss run without emission or feedback
    from the initial ledger ``p0``: w_live + absorbed = w0 to NG_ENERGY_RTOL, the
    survivors' mean photon energy above the initial mean, and with ``jax_ref`` =
    (survivors, mean energy) of the JAX package's run of the same configuration
    the survivors within NG_SIGMA_COUNT sqrt(n) and their mean energy within
    NG_MEAN_E_RTOL."""
    p = sim.state.particles
    w0 = float(p0.weight.double()[p0.alive].sum())
    w_live = float(p.weight.double()[p.alive].sum())
    absorbed = float(sim.state.fields.energy_delta.double().sum())
    surv = int(p.alive.sum())
    mean_e0 = float(p0.energy.double()[p0.alive].mean())
    mean_e = float(p.energy.double()[p.alive].mean())
    if absorbed <= 0 or abs(w_live + absorbed - w0) > NG_ENERGY_RTOL * w0:
        raise AssertionError(f"{what}: w_live {w_live} + absorbed {absorbed} vs w0 {w0}")
    if not mean_e > mean_e0:
        raise AssertionError(f"{what}: survivors' mean energy {mean_e} <= {mean_e0}")
    line = (f"{what}: w_live + absorbed - w0 = {(w_live + absorbed - w0) / w0:+.3e} of w0; "
            f"survivors {surv} of {int(p0.alive.sum())}, mean photon energy {mean_e!r} "
            f"(initially {mean_e0!r})")
    if jax_ref is not None:
        surv_j, mean_j = jax_ref
        if abs(surv - surv_j) >= NG_SIGMA_COUNT * np.sqrt(surv + surv_j):
            raise AssertionError(f"{what}: survivors {surv} vs the JAX package's {surv_j}")
        if abs(mean_e - mean_j) >= NG_MEAN_E_RTOL * mean_j:
            raise AssertionError(f"{what}: mean energy {mean_e} vs the JAX package's {mean_j}")
        line += f"; the JAX package: {surv_j} survivors, mean energy {mean_j!r}"
    print(line, flush=True)


def initial_ledger(deck, mods):
    """The ledger a deck starts from (``run_file`` with no step), on the GPU."""
    from jaybenne_tpu_torch.driver import run_file

    with tempfile.TemporaryDirectory() as outdir:
        sim0 = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=0,
                        device="cuda")
    return sim0.state.particles.clone()


def nongray_phases(transport_kernel, dev, cost, src) -> list:
    """Phases 22-27 (frequency-dependent models, the external source, a tabulated
    opacity). Returns the entries of the ``kernels`` line for the NONGRAY
    instantiations that the paths run."""
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.ops import cuda_lib

    phase("22 NONGRAY: all twelve instantiations vs plain, EPBremss at spread energies")
    ng_err = {}
    for ndim, seed in ((1, 2201), (2, 2202), (3, 2203)):
        for smr in (False, True):
            for ddmc in (False, True):
                name = transport_kernel.launch_name(ndim, True, ddmc, smr, True)
                ng_err[name] = compare_nongray(transport_kernel, dev, ndim, ddmc, smr,
                                               seed + 10 * smr)

    phase("23 non-gray K1(e): stepdiff 128 cells, 100k particles, EPBremss, one step")
    name_1 = transport_kernel.launch_name(1, True, False, False, True)
    p0 = initial_ledger(DECK, NG_GATE)
    k1e, k1e_launches, k1e_in, _ = run_path(DECK, NG_GATE, name_1, 1, conserves_tally=False)
    spectral_gate(k1e, p0, "non-gray K1(e)", NG_GATE_JAX)
    k_1 = path_kernel(transport_kernel, dev, k1e, k1e_in, name_1, cost)
    call_split_line(transport_kernel, dev, k1e_in, name_1)

    phase("24 K3 non-gray: 64^3 cells, 200k particles, EPBremss, emission and feedback, "
          "3 steps")
    name_3 = transport_kernel.launch_name(3, True, False, False, True)
    with tempfile.TemporaryDirectory() as outdir:
        e_0, er_0 = total_energy(run_file(DECK, outdir=outdir, modified_inputs=NG_BIG,
                                          quiet=True, nlim=0, device="cuda"))
    big, big_launches, big_in, _ = run_path(DECK, NG_BIG, name_3, FEEDBACK_STEPS,
                                            conserves_tally=False)
    cons = abs(total_energy(big)[0] - e_0) / er_0
    gate(cons, FEEDBACK_ENERGY_TOL, "K3 non-gray energy conservation of the radiation energy")
    if NG_BIG_JAX_EVENTS is None:
        print(f"K3 non-gray: events {big.total_events}; the JAX package's count was not "
              "measured", flush=True)
    else:
        events_gate(big.total_events, NG_BIG_JAX_EVENTS, "K3 non-gray")
    k_3 = path_kernel(transport_kernel, dev, big, big_in, name_3, cost)
    call_split_line(transport_kernel, dev, big_in, name_3)
    table_check(transport_kernel, dev, big_in[1][0], big.mesh, big_in[1][3], big_in[1][4], None,
                "the 64^3 ep_bremss row's last census")
    fold_check(transport_kernel, big_in, "the 64^3 ep_bremss row's last census")

    phase("25 K4 non-gray: stepdiff_smr as shipped (128x64), 100k particles, EPBremss, "
          "one step")
    name_s = transport_kernel.launch_name(2, True, False, True, True)
    p0 = initial_ledger(SMR_DECK, NG_SMR)
    k4, k4_launches, k4_in, _ = run_path(SMR_DECK, NG_SMR, name_s, 1, conserves_tally=False)
    if k4.mesh.n_blocks != 20 or k4.mesh.max_level != 1:
        raise AssertionError(f"stepdiff_smr: {k4.mesh.n_blocks} blocks")
    spectral_gate(k4, p0, "non-gray K4", NG_SMR_JAX)
    k_s = path_kernel(transport_kernel, dev, k4, k4_in, name_s, cost)
    call_split_line(transport_kernel, dev, k4_in, name_s)

    phase("26 Su-Olson: suolson.in as shipped (64 cells, 40 steps, 8000 + 8000 particles)")
    name_a1 = transport_kernel.launch_name(1, True)
    so = run_path(SUOLSON_DECK, SUOLSON, name_a1, SUOLSON_STEPS, conserves_tally=False)[0]
    mc, jb = so.cfg.mcblock, so.cfg.jaybenne
    sie0 = float(mc.build_eos().internal_energy_from_density_temperature(
        mc.initial_density, mc.initial_temperature))
    b = so.mesh.bounds
    e_init = mc.initial_density * sie0 * (b[1] - b[0]) * (b[3] - b[2]) * (b[5] - b[4])
    box = jb.external_source_box
    v_src = (box[1] - box[0]) * (box[3] - box[2]) * (box[5] - box[4])
    injected = jb.external_source_q * v_src * min(so.t, jb.external_source_tmax)
    e_mat, e_rad = total_energy(so)
    e_mat -= e_rad
    print(f"Su-Olson: matter {e_mat!r}, radiation {e_rad!r}, gain {e_mat + e_rad - e_init!r}, "
          f"injected {injected!r}", flush=True)
    gate(abs(e_mat + e_rad - e_init - injected) / injected, SUOLSON_TOL,
         "Su-Olson bookkeeping error")

    phase("27 tabulated opacity: stepdiff 128 cells, 100k particles, kappa(rho, T) from .npz")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tab.npz")
        np.savez(path, **TABLE)
        mods = {**TABLE_GATE, "mcblock/opacity_table_file": path}
        p0 = initial_ledger(DECK, mods)
        tab = run_path(DECK, mods, name_a1, 1, conserves_tally=False)[0]
        gray = tab.cfg.mcblock.build_opacity().is_gray
    p = tab.state.particles
    w0 = float(p0.weight.double()[p0.alive].sum())
    w_live = float(p.weight.double()[p.alive].sum())
    absorbed = float(tab.state.fields.energy_delta.double().sum())
    if not gray or absorbed <= 0:
        raise AssertionError(f"tabulated opacity: absorbed {absorbed}")
    gate(abs(w_live + absorbed - w0) / w0, NG_ENERGY_RTOL,
         f"tabulated opacity: absorbed {absorbed!r} of {w0!r}; w_live + absorbed vs w0")

    kernels = []
    for name, what, replaces, launches, (ms, plain, _, err, bound, by) in (
            (name_1, "non-gray K1(e), 1D; stepdiff with EPBremss",
             "jaybenne_tpu/ops/pallas_transport.py:484", k1e_launches, k_1),
            (name_3, "K3's non-gray function at 64^3; non-gray K1(e) in 3D",
             "jaybenne_tpu/ops/pallas_grid.py:859", big_launches, k_3),
            (name_s, "K4's non-gray function on stepdiff_smr; non-gray K1(d)",
             "jaybenne_tpu/ops/pallas_bucketed.py:355", k4_launches, k_s)):
        kernels.append({
            "name": f"{name} ({what})", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": max(ng_err[name], err),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    return kernels


def sliced(fn, n):
    """``fn`` (the census or its plain version) over the ``n`` equal slices of a
    ledger, one per shard, as one call: ``(ledger, iterations, events)`` summed
    over the shards, so that ``time_census`` can time it."""
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    def run(p, *args, **kw):
        _, it, ev = fn(split_ledger(p, n), *args, **kw)
        return p, it.max(), ev.sum()

    return run


def same_columns(pk, pp, what):
    """Raises unless two ledgers are identical in every column, floats as bits."""
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for f in dataclasses.fields(pk):
        a, b = getattr(pk, f.name), getattr(pp, f.name)
        if a.dtype in bits:  # signed zeros too
            a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {f.name} differs in {int((a != b).sum())} slots")


def owned_vs_plain(transport_kernel, what, p0, args, n=None):
    """One owned-range round (``args`` = coefs, mesh, seed, prm, dt, own; with ``n``
    a census set-up, mesh, seeds, prm, dt over the ``n`` slices of ``p0``) of the
    kernel against its plain version on the ledger ``p0``: every column
    identical, the floats bitwise, and the same events and iterations (per
    shard). Returns (the kernel's ledger, events, max_abs_err of the floats)."""
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    out = []
    for fn in (transport_kernel.transport, transport_kernel.transport_plain):
        q = p0.clone()
        out.append((q, *fn(q if n is None else split_ledger(q, n), *args)[1:]))
    torch.cuda.synchronize()
    (pk, it_k, ev_k), (pp, it_p, ev_p) = out
    same_columns(pk, pp, what)
    if not (torch.equal(ev_k, ev_p) and torch.equal(it_k, it_p)):
        raise AssertionError(f"{what}: stats {ev_k} {it_k} vs {ev_p} {it_p}")
    err, _ = max_float_err(pk, pp, ("x", "y", "z", "vx", "vy", "vz", "tau"))
    return pk, int(ev_k.sum()), err


def ledger_as(p, dtype):
    """A copy of the ledger ``p`` with its float columns in ``dtype``."""
    q = p.clone()
    return dataclasses.replace(q, **{f.name: getattr(q, f.name).to(dtype)
                                     for f in dataclasses.fields(q)
                                     if getattr(q, f.name).is_floating_point()})


def coefs_as(coefs, dtype):
    """The coefficients ``coefs`` with their float tensors in ``dtype``."""
    return dataclasses.replace(coefs, **{
        f.name: getattr(coefs, f.name).to(dtype) for f in dataclasses.fields(coefs)
        if isinstance(getattr(coefs, f.name), torch.Tensor)})


def prm_as(prm, dtype):
    """Transport parameters with the face offsets of ``dtype`` (``default_eps``)."""
    from jaybenne_tpu_torch.ops.transport import default_eps

    return dataclasses.replace(prm, **default_eps(dtype))


def f64_vs_plain(transport_kernel, dev, what, p0, coefs, mesh, prm, dt, seed):
    """The float64 instantiation on a float32 check's inputs made float64 (the
    ledger ``p0``, ``coefs``, ``prm``) against its float64 plain version: after 8
    iterations and after a full census of the last 10 % of a step, every column
    identical, the floats bitwise, the same events and iterations, and only
    ``_f64`` launches. Returns (max_abs_err, full census events, kernel ms of that
    census)."""
    from jaybenne_tpu_torch.ops import cuda_lib

    f64 = torch.float64
    p64, c64, prm64 = ledger_as(p0, f64), coefs_as(coefs, f64), prm_as(prm, f64)
    pf = ledger_as(p0, f64)
    pf.tau.copy_(0.9 + 0.1 * torch.rand(pf.capacity, device=dev, dtype=f64,
                                        generator=torch.Generator(dev).manual_seed(seed)))
    err, out = 0.0, []
    for q0, prm_q in ((p64, dataclasses.replace(prm64, max_iters=8)), (pf, prm64)):
        before = dict(cuda_lib.LAUNCHES)
        pk, it_k, ev_k = transport_kernel.transport(q0.clone(), c64, mesh, seed, prm_q, dt)
        new = {k for k, v in cuda_lib.LAUNCHES.items() if v != before.get(k, 0)}
        pp, it_p, ev_p = transport_kernel.transport_plain(q0.clone(), c64, mesh, seed, prm_q, dt)
        torch.cuda.synchronize()
        if not new or any(not k.split("@")[0].endswith("_f64") for k in new):
            raise AssertionError(f"{what}: the float64 census launched {sorted(new)}")
        same_columns(pk, pp, what)
        if int(ev_k) != int(ev_p) or int(it_k) != int(it_p):
            raise AssertionError(f"{what}: stats {ev_k} {it_k} vs {ev_p} {it_p}")
        err = max(err, max_float_err(pk, pp, ("x", "y", "z", "vx", "vy", "vz", "tau"))[0])
        out.append((int(ev_k), int(pk.absorbed.sum())))
    times, _ = time_census(transport_kernel.transport, pf, (c64, mesh, seed, prm64, dt), dev, 3)
    print(f"{what} f64: bitwise its float64 plain version in every column after 8 iterations "
          f"({out[0][0]} events) and after a full census ({out[1][0]} events, {out[1][1]} "
          f"absorbed); the census {spread(times)}", flush=True)
    return err, out[1][0], statistics.median(times)


def resident_threads(dev) -> int:
    """The most threads the card holds at once."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count * getattr(props, "max_threads_per_multi_processor", 2048)


def shards_vs_plain(transport_kernel, what, p0, coefs, mesh, seeds, prm, dt, owns):
    """One launch of the kernel over the shards' adjacent slices of ``p0`` (one per
    range of ``owns``, each with its coefficients and seed) against the plain
    version's per-shard calls in shard order: every column identical, the floats
    bitwise, the same iterations and events per shard, one launch counted. Returns
    (the kernel's ledger, events, max_abs_err)."""
    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    n = len(owns)
    name = transport_kernel.launch_name(prm.ndim, bool(prm.has_absorption), bool(prm.use_ddmc),
                                        owns[0].kind == "blocks" or mesh.max_level > 0,
                                        route=owns[0].route, dtype=p0.x.dtype)
    pk, pp = p0.clone(), p0.clone()
    before = cuda_lib.LAUNCHES[name]
    _, it_k, ev_k = transport_kernel.transport(split_ledger(pk, n), coefs, mesh, seeds, prm, dt,
                                               owns)
    if cuda_lib.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{what}: {cuda_lib.LAUNCHES[name] - before} launches, not one")
    its, evs = [], []
    for q, c, sd, o in zip(split_ledger(pp, n), coefs, seeds, owns):
        _, it, ev = transport_kernel.transport_plain(q, c, mesh, sd, prm, dt, o)
        its.append(it)
        evs.append(ev)
    torch.cuda.synchronize()
    same_columns(pk, pp, what)
    if not (torch.equal(ev_k, torch.stack(evs)) and torch.equal(it_k, torch.stack(its))):
        raise AssertionError(f"{what}: stats {ev_k} {it_k} vs {evs} {its}")
    err, _ = max_float_err(pk, pp, ("x", "y", "z", "vx", "vy", "vz", "tau"))
    print(f"{what}: one launch over {n} shards' slices ({p0.capacity} slots) and the plain "
          f"per-shard calls in order identical in every column, floats bitwise; events per "
          f"shard {ev_k.tolist()}, iterations {it_k.tolist()}", flush=True)
    return pk, int(ev_k.sum()), err


def z_round(transport_kernel, dev, shard, seed, dtype=torch.float32):
    """Phase 28 on one shard: 2^17 particles on the shard's z-slab of bench.py's
    big mesh, one owned-range round of the kernel and of its plain version, at
    the census precision ``dtype`` (phase 42 runs it in float64). Returns the
    max_abs_err."""
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.parallel.spatial import blocks_per_shard, owned_range
    from jaybenne_tpu_torch.particles import uniform_ledger
    from jaybenne_tpu_torch.utils.constants import CC

    cfg, mesh, prm, _ = deck_setup(dev, DECK, {**BIG_MESH, "mcblock/opacity_model": "constant"},
                                   0.0, 0.0)
    own = owned_range(mesh, prm, Z_SHARDS, shard)
    lo, hi = own.bounds()
    if own.kind != "z" or hi - lo != mesh.nz:
        raise AssertionError(f"phase 28 setup: owned range {own}")
    plane = mesh.root_grid[1] * mesh.root_grid[2]
    nc = blocks_per_shard(mesh, Z_SHARDS) * mesh.ncells_per_block
    coefs = TransportCoefs(sigma_a=torch.full((nc,), 2.0, device=dev),
                           sigma_s=torch.full((nc,), 62.0, device=dev),
                           fleck=torch.ones(nc, device=dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    p0 = uniform_ledger(mesh, 1 << 17, g, CC)
    p0.block.copy_(p0.block % plane + lo // mesh.nz * plane)  # onto the shard's slab
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))
    what = f"K3s shard {shard} of {Z_SHARDS} (z cells [{lo}, {hi}))"
    if dtype != torch.float32:
        p0, coefs, prm = ledger_as(p0, dtype), coefs_as(coefs, dtype), prm_as(prm, dtype)
        what += f" in {dtype}"
    pk, ev, err = owned_vs_plain(transport_kernel, what, p0,
                                 (coefs, mesh, seed, prm, cfg.jaybenne.dt, own))
    gk = (pk.block // plane) * mesh.nz + pk.k
    out = (gk < lo) | (gk >= hi)
    paused = pk.alive & (pk.tau < 1.0)
    if bool((paused & ~out).any()) or not bool(paused.any()):
        raise AssertionError(f"{what}: {int((paused & ~out).sum())} lanes short of census "
                             f"inside the range, {int(paused.sum())} paused")
    nz_all = mesh.root_grid[0] * mesh.nz
    # a lane that crossed the periodic z seam pauses wrapped, at the other end
    seam = paused & (((gk < nz_all // 2) & (hi == nz_all)) | ((gk >= nz_all // 2) & (lo == 0)))
    print(f"{what}: kernel and plain identical in every column, floats bitwise; {ev} "
          f"events; {int(paused.sum())} lanes paused, each outside the range (below "
          f"{int((paused & (gk < lo)).sum())}, above {int((paused & (gk >= hi)).sum())}; "
          f"across the periodic z seam {int(seam.sum())}); {int((pk.alive & ~paused).sum())} "
          f"at census, {int(pk.absorbed.sum())} absorbed", flush=True)
    return err


def forest_round(transport_kernel, dev, seed, dtype=torch.float32):
    """Phase 29: the hybrid slabs of phase 15 with DDMC on the forest of
    tests/test_spatial.py:463-467 at two shards, one owned-range round per shard
    of the kernel and of its plain version on 2^17 particles in the shard's
    blocks. Shard 0 holds the coarse blocks, whose thick cells leak into shard 1's
    finer blocks: those leaks pause with a pending code (shard 1 holds fine blocks
    only and writes none); at the census precision ``dtype`` (phase 42 runs it in
    float64). Returns the max_abs_err."""
    from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.parallel.spatial import owned_range
    from jaybenne_tpu_torch.particles import forest_ledger, place_on_faces
    from jaybenne_tpu_torch.utils.constants import CC

    mods = {**SMR_SPATIAL_FOREST, "jaybenne/tau_ddmc": 5.0}
    cfg, mesh, prm, _ = deck_setup(dev, SMR_DDMC_DECK, mods, 0.0, 0.0)
    if mesh.max_level != 1 or not prm.use_ddmc:
        raise AssertionError(f"phase 29 setup: max_level {mesh.max_level}")
    xc = mesh.cell_centers()[0]
    width = 4.0 * float(mesh.block_dx[:, 0].max())
    thick = torch.floor((xc - mesh.bounds[0]) / width).long() % 2 == 1
    sig = torch.where(thick, HYBRID_SIGMA[1], HYBRID_SIGMA[0])
    faces = ddmc_face_probs(mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)
    ncpb, err, leaks = mesh.ncells_per_block, 0.0, 0
    for shard in (0, 1):
        own = owned_range(mesh, prm, 2, shard)
        lo, hi = own.bounds()
        if own.kind != "blocks":
            raise AssertionError(f"phase 29 setup: owned range {own}")
        local = sig.reshape(-1)[lo * ncpb:hi * ncpb]
        coefs = TransportCoefs(sigma_a=torch.zeros_like(local), sigma_s=local,
                               fleck=torch.ones_like(local),
                               **dict(zip(("px", "py", "pz"), (f[lo:hi] for f in faces))))
        g = torch.Generator(device=dev).manual_seed(seed + shard)
        p0 = forest_ledger(mesh, HYBRID_N, g, CC, blocks=(lo, min(hi, mesh.n_blocks)))
        place_on_faces(p0, mesh, torch.rand(p0.capacity, generator=g, device=dev) < 0.25, g)
        p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))
        what = f"K4s shard {shard} of 2 (blocks [{lo}, {hi}))"
        prm_s = prm
        if dtype != torch.float32:
            p0, coefs, prm_s = ledger_as(p0, dtype), coefs_as(coefs, dtype), prm_as(prm, dtype)
            what += f" in {dtype}"
        pk, ev, e = owned_vs_plain(transport_kernel, what, p0,
                                   (coefs, mesh, seed + shard, prm_s, cfg.jaybenne.dt, own))
        err = max(err, e)
        out = (pk.block < lo) | (pk.block >= hi)
        paused = pk.alive & (pk.tau < 1.0)
        pending = pk.leak != 0
        if bool((paused & ~out).any()) or not bool(paused.any()):
            raise AssertionError(f"{what}: {int((paused & ~out).sum())} lanes short of census "
                                 "inside the range")
        if bool((pending & ~(paused & out)).any()):
            raise AssertionError(f"{what}: a pending leak code on a lane that did not pause")
        leaks += int(pending.sum())
        levels = sorted(set(mesh.block_level[pk.block[pending].long()].tolist()))
        print(f"{what}: kernel and plain identical in every column (leak codes too), floats "
              f"bitwise; {ev} events; {int(paused.sum())} lanes paused outside the range, "
              f"{int(pending.sum())} with a pending leak code (into blocks of level "
              f"{levels}); {int((pk.alive & ~paused).sum())} at census", flush=True)
    if leaks == 0:
        raise AssertionError("phase 29: no pending leak code was written")
    return err


def z_round_all(transport_kernel, dev, seed):
    """Phase 28's 8-shard launch: every shard of bench.py's big mesh with its own
    particles in its adjacent slice of one ledger (4 times the card's resident
    threads in all, a tenth of each slice in the next shard's slab), one round as
    one launch against the plain per-shard calls. Returns the max_abs_err."""
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.parallel.sharding import split_ledger
    from jaybenne_tpu_torch.parallel.spatial import blocks_per_shard, owned_range
    from jaybenne_tpu_torch.particles import empty_ledger, uniform_ledger
    from jaybenne_tpu_torch.utils.constants import CC

    cfg, mesh, prm, _ = deck_setup(dev, DECK, {**BIG_MESH, "mcblock/opacity_model": "constant"},
                                   0.0, 0.0)
    owns = [owned_range(mesh, prm, Z_SHARDS, s) for s in range(Z_SHARDS)]
    plane = mesh.root_grid[1] * mesh.root_grid[2]
    nc = blocks_per_shard(mesh, Z_SHARDS) * mesh.ncells_per_block
    coefs = [TransportCoefs(sigma_a=torch.full((nc,), 2.0, device=dev),
                            sigma_s=torch.full((nc,), 62.0, device=dev),
                            fleck=torch.ones(nc, device=dev)) for _ in owns]
    m = -(-4 * resident_threads(dev) // Z_SHARDS)
    g = torch.Generator(device=dev).manual_seed(seed)
    p0 = empty_ledger(Z_SHARDS * m, torch.float32, dev)
    other = torch.arange(m, device=dev) % 10 == 9
    for s, q in enumerate(split_ledger(p0, Z_SHARDS)):
        src = uniform_ledger(mesh, m, g, CC)
        home = torch.where(other, (s + 1) % Z_SHARDS, s)
        src.block.copy_(src.block % plane + home * plane)
        for f in dataclasses.fields(q):
            getattr(q, f.name).copy_(getattr(src, f.name))
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))
    seeds = [seed + 7 * s for s in range(Z_SHARDS)]
    return shards_vs_plain(transport_kernel, f"K3s, all {Z_SHARDS} shards", p0, coefs, mesh,
                           seeds, prm, cfg.jaybenne.dt, owns)[2]


def forest_round_all(transport_kernel, dev, seed, n_shards=8):
    """Phase 29's 8-shard launch: the forest of phase 29 at 8 shards of 3 blocks
    (the last four padding blocks, the last shard padding only, its slice holding
    shard 0's particles), 4 times the card's resident threads in all, one round as
    one launch against the plain per-shard calls; shards write pending leak codes
    into each other's finer blocks. Returns the max_abs_err."""
    from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.parallel.sharding import split_ledger
    from jaybenne_tpu_torch.parallel.spatial import blocks_per_shard, owned_range
    from jaybenne_tpu_torch.particles import empty_ledger, forest_ledger, place_on_faces
    from jaybenne_tpu_torch.utils.constants import CC

    cfg, mesh, prm, _ = deck_setup(dev, SMR_DDMC_DECK, {**SMR_SPATIAL_FOREST,
                                                        "jaybenne/tau_ddmc": 5.0}, 0.0, 0.0)
    xc = mesh.cell_centers()[0]
    width = 4.0 * float(mesh.block_dx[:, 0].max())
    thick = torch.floor((xc - mesh.bounds[0]) / width).long() % 2 == 1
    sig = torch.where(thick, HYBRID_SIGMA[1], HYBRID_SIGMA[0])
    faces = ddmc_face_probs(mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)
    bl = blocks_per_shard(mesh, n_shards)
    n_pad = n_shards * bl - mesh.n_blocks
    ncpb = mesh.ncells_per_block
    sig = torch.cat([sig.reshape(-1), sig.new_full((n_pad * ncpb,), HYBRID_SIGMA[0])])
    faces = [torch.cat([f, f.new_zeros((n_pad,) + f.shape[1:])]) for f in faces]
    owns = [owned_range(mesh, prm, n_shards, s) for s in range(n_shards)]
    coefs = []
    for s in range(n_shards):
        local = sig[s * bl * ncpb:(s + 1) * bl * ncpb]
        coefs.append(TransportCoefs(sigma_a=torch.zeros_like(local), sigma_s=local,
                                    fleck=torch.ones_like(local),
                                    **dict(zip(("px", "py", "pz"),
                                               (f[s * bl:(s + 1) * bl] for f in faces)))))
    m = -(-4 * resident_threads(dev) // n_shards)
    g = torch.Generator(device=dev).manual_seed(seed)
    p0 = empty_ledger(n_shards * m, torch.float32, dev)
    for s, q in enumerate(split_ledger(p0, n_shards)):
        lo = s * bl if s * bl < mesh.n_blocks else 0
        src = forest_ledger(mesh, m, g, CC, blocks=(lo, min(lo + bl, mesh.n_blocks)))
        place_on_faces(src, mesh, torch.rand(m, generator=g, device=dev) < 0.25, g)
        for f in dataclasses.fields(q):
            getattr(q, f.name).copy_(getattr(src, f.name))
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=dev))
    seeds = [seed + 7 * s for s in range(n_shards)]
    pk, _, err = shards_vs_plain(transport_kernel, f"K4s, all {n_shards} shards", p0, coefs,
                                 mesh, seeds, prm, cfg.jaybenne.dt, owns)
    if not bool((pk.leak != 0).any()):
        raise AssertionError("phase 29, 8 shards: no pending leak code was written")
    print(f"K4s, all {n_shards} shards: {int((pk.leak != 0).sum())} pending leak codes",
          flush=True)
    return err


class RoundRecorder:
    """While active, wraps ``transport_kernel.transport`` (so that the steps built
    meanwhile call it through the wrapper) and keeps a copy of the inputs of the
    first KEEP_ROUNDS rounds run eagerly (``rounds``; each one call over every
    shard's slice: the joined ledger, the shard count and the call's other
    arguments; ``inputs`` the first; ``gos`` each round's ``go`` flag, cloned, or
    None for a round known to have work); keeps the arguments of the first
    census set-up (``prepare``: the shards' coefficient sets, mesh, prm, dt and
    owned ranges); and wraps ``subface_resample`` to count the pending leaks it
    resolves."""

    KEEP_ROUNDS = 2

    def __init__(self, transport_kernel):
        self.tk, self.rounds, self.resolved, self.setup = transport_kernel, [], 0, None
        self.gos = []
        self.real, self.real_fix = transport_kernel.transport, transport_kernel.subface_resample
        self.real_prepare = transport_kernel.prepare

    def __enter__(self):
        self.tk.transport, self.tk.subface_resample = self._census, self._fix
        self.tk.prepare = self._prepare
        return self

    def __exit__(self, *exc):
        self.tk.transport, self.tk.subface_resample = self.real, self.real_fix
        self.tk.prepare = self.real_prepare

    def _prepare(self, *args):
        if self.setup is None:
            self.setup = args
        return self.real_prepare(*args)

    @property
    def inputs(self):
        return self.rounds[0] if self.rounds else None

    def _census(self, particles, *args, go=None):
        if (len(self.rounds) < self.KEEP_ROUNDS and isinstance(particles, list)
                and not torch.cuda.is_current_stream_capturing()):
            from jaybenne_tpu_torch.particles import join_slices

            setup, mesh, seeds, *rest = args
            if isinstance(seeds, torch.Tensor):  # a row of the step's seed buffer
                seeds = seeds.clone()
            self.rounds.append((join_slices(particles)[0].clone(), len(particles),
                                (setup, mesh, seeds, *rest)))
            self.gos.append(None if go is None else go.clone())
        return self.real(particles, *args, go=go)

    def _fix(self, p, faces, mesh, c, gen, offset, n_local, go=None):
        if not torch.cuda.is_current_stream_capturing():  # a replay calls no Python
            need = p.alive & (p.leak != 0) & (p.block >= offset) & (p.block < offset + n_local)
            self.resolved += int((need if go is None else need & go).sum())
        return self.real_fix(p, faces, mesh, c, gen, offset, n_local, go=go)


def spatial_core(sim):
    """A spatial run's step (``build_spatial_step_core``), graphed or not."""
    return sim.step_fn.step if sim.graphed else sim.step_fn


def rounds_queued(sim) -> int:
    """The migration rounds a spatial run queued, the no-op rounds that end a
    batch too (one census launch each)."""
    return spatial_core(sim).rounds_run


def batches_of(sim, rounds: int) -> int:
    """The batches (host reads) of a spatial step that ran ``rounds`` rounds."""
    return -(-rounds // spatial_core(sim).rounds_per_batch)


def spatial_path(deck, mods, steps, what, graph=True):
    """A deck under a decomposition through ``driver.run_file`` on the GPU for
    ``steps`` steps (``None``: to its tlim; ``graph`` as ``run_file``'s), the launch
    counts set to 0 just before and read just after, the first round recorded
    (and the first RoundRecorder.KEEP_ROUNDS run eagerly: ``sim.recorded_rounds``;
    the pending leaks resolved are counted in eager steps only: a replay calls no
    Python). Raises unless every step
    completed its census with nothing dropped, every round made one census launch
    (``launch``), and the tally is finite and equals the live weight (sum(tally
    dV), to ENERGY_RTOL). Returns (sim, launches, the recorded round, pending
    leaks resolved, the first census set-up's arguments)."""
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.ops import cuda_lib, transport_kernel

    with tempfile.TemporaryDirectory() as outdir:
        with RoundRecorder(transport_kernel) as rec:
            cuda_lib.LAUNCHES.clear()
            sim = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=steps,
                           device="cuda", graph=graph)
            launches = dict(cuda_lib.LAUNCHES)
            note_table(what, launches)
    MIGRATE_PATHS.append((f"phase {PHASE[0]}: {what}", launches.get("migrate_pack", 0)))
    sim.recorded_rounds = rec.rounds
    p = sim.state.particles
    if (any(h["dropped"] or h["unfinished"] for h in sim.history) or sim.state.overflow
            or (steps is not None and sim.cycle != steps)):
        raise AssertionError(f"{what}: dropped or unfinished: {sim.history}")
    tally = sim.state.fields.energy_tally
    if not bool(torch.isfinite(tally).all()) or tally.shape[0] != sim.mesh.n_blocks:
        raise AssertionError(f"{what}: tally {tuple(tally.shape)} or not finite")
    w = float(p.weight.double()[p.alive].sum())
    e = radiation_energy(sim)
    if abs(e - w) > ENERGY_RTOL * w:
        raise AssertionError(f"{what}: sum(tally dV) {e} vs live weight {w}")
    step_s = [h["step_seconds"] for h in sim.history]
    rounds = [h["migration_rounds"] for h in sim.history]
    census = {k: v for k, v in launches.items() if k.startswith("transport_")}
    if sum(census.values()) != rounds_queued(sim):
        raise AssertionError(f"{what}: census launches {census} for {rounds_queued(sim)} "
                             "rounds queued")
    print(f"{what}: {sim.mesh.n_blocks} blocks, {sim.mesh.total_cells} cells, "
          f"{sim.cfg.jaybenne.n_devices} shards, {sim.cycle} steps "
          f"({'CUDA graphs' if sim.graphed else 'eager'}): launches {launches}; "
          f"rounds a step {rounds}, {rounds_queued(sim)} rounds queued in batches of "
          f"{spatial_core(sim).rounds_per_batch} (one census launch a round queued); "
          f"events {sim.total_events}; migration rounds "
          f"{[h['migration_rounds'] for h in sim.history]}, migrated "
          f"{[h['migrated'] for h in sim.history]}; sum(tally dV) {e!r} vs live weight "
          f"{w!r}; step seconds {step_s}; median {statistics.median(step_s) * 1e3!r} ms; "
          f"{sim.total_events / sum(step_s)!r} events/s", flush=True)
    return sim, launches, rec.inputs, rec.resolved, rec.setup


def round_kernel(transport_kernel, dev, inputs, name, cost, which="the first round"):
    """The kernel ``name`` and its plain version timed on a recorded round (one
    call over every shard's slice, with the step's census set-up) and held
    against each other (bitwise), with its bound from the round's own events (on
    a forest without the block crossings, so the bound stays a lower one): (ms,
    plain_ms, events, max_abs_err, bound_ms, bound_by)."""
    p, n, args = inputs
    setup, mesh, _, prm, _ = args
    kernel = sliced(transport_kernel.transport, n)
    kernel(p.clone(), *args)  # warm-up
    times, ev = time_census(kernel, p, args, dev, CENSUS_REPEATS)
    ms = statistics.median(times)
    print(f"{name}, one launch over {n} shards: {spread(times)}", flush=True)
    plain_ms = time_census(sliced(transport_kernel.transport_plain, n), p, args, dev, 1)[0][0]
    _, _, err = owned_vs_plain(transport_kernel, f"{name} on a recorded round", p, args, n)
    smr = (mesh, 0) if setup.owns[0].kind == "blocks" else None
    bound, by = census_bound(p, prm.ndim, bool(prm.has_absorption), setup.tabs.cell.shape[0],
                             ev, cost, ddmc=bool(prm.use_ddmc), smr=smr,
                             nongray=setup.g.nongray)
    print(f"{name} on {which}, one launch over {n} shards ({p.capacity} slots, "
          f"{int((p.alive & (p.tau < 1.0)).sum())} unfinished): kernel {ms!r} ms, plain "
          f"{plain_ms!r} ms, {ev} events; bound {bound!r} ms ({by}), kernel at "
          f"{bound / ms:.3f} of it; kernel and plain bitwise equal", flush=True)
    return ms, plain_ms, ev, err, bound, by


def mean_round_line(deck, mods, name, sim, first_ms) -> float:
    """Prints the mean device time of a spatial run's census launches (one a round
    queued, a batch's no-op rounds too) beside the first round's ``first_ms``: the
    deck run as the driver runs it (CUDA graphs) for two steps, then one more step
    under ``torch.profiler``, the census kernel's device time summed over its
    launches in that step; and the rounds a step of ``sim``, the path's own run.
    Returns the mean launch's ms."""
    import collections

    from jaybenne_tpu_torch import config as config_mod
    from jaybenne_tpu_torch.driver import Simulation
    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.profile import device_time_by_name
    from jaybenne_tpu_torch.utils.deck import Deck

    cfg = config_mod.from_deck(Deck.from_file(deck).update(mods))
    with tempfile.TemporaryDirectory() as outdir:
        run = Simulation(cfg, outdir=outdir, quiet=True, device="cuda")
        run.run(nlim=2)  # the first step eager, the second captured
        before = collections.Counter(cuda_lib.LAUNCHES)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run.run(nlim=1)
        launches = sum(v for k, v in (collections.Counter(cuda_lib.LAUNCHES) - before).items()
                       if k.startswith("transport_"))
        trace = os.path.join(outdir, "trace.json")
        prof.export_chrome_trace(trace)
        census_ms = sum(us for k, us in device_time_by_name(trace).items()
                        if "transport_kernel" in k) / 1e3
    mean = census_ms / launches
    print(f"{name}: the mean round {mean!r} ms of device time (torch.profiler on the third "
          f"step, {run.history[-1]['migration_rounds']} rounds run, {launches} census launches "
          f"queued, {census_ms!r} ms in all) against the first round's {first_ms!r} ms; rounds "
          f"a step of the path {[h['migration_rounds'] for h in sim.history]}", flush=True)
    return mean


def warp_efficiency_line(transport_kernel, inputs, name, ms, before_ms, n=None):
    """Prints the slot order's warp efficiency of a recorded census (``inputs`` =
    (ledger, args), or (ledger, shards, args) for a round), from the plain
    version's per-slot events, beside the kernel's time and ``before_ms``, the
    time of the one-thread-per-slot kernel without a regroup (NVIDIA H100 80GB
    HBM3, 700.00 W); returns it."""
    p, args = (inputs[0], inputs[-1])
    lanes = torch.zeros(p.capacity, dtype=torch.int32, device=p.x.device)
    fn = transport_kernel.transport_plain if n is None else sliced(
        transport_kernel.transport_plain, n)
    fn(p.clone(), *args, lane_events=lanes)
    eff = transport_kernel.warp_efficiency(lanes)
    print(f"{name}: slot-order warp efficiency {eff!r} (the share of a one-thread-per-slot "
          f"warp's issued events that are real, {int(lanes.sum())} events); kernel {ms!r} ms; "
          f"without the regroup and the one-launch round {before_ms} ms", flush=True)
    return eff


def weighted_difference(a, b) -> float:
    """sum |a - b| / sum (a + b) over the cells where a + b > 0
    (tests/test_spatial.py:581-583)."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    s = a + b
    m = s > 0
    return float((a - b).abs()[m].sum() / s[m].sum())


def spatial_phases(transport_kernel, dev, cost, src, mix_lib) -> list:
    """Phases 28-35 (both decompositions; backend (b): every shard in this process
    on the one card). Returns the entries of the ``kernels`` line for the
    owned-range routes K3s and K4s."""
    from jaybenne_tpu_torch.driver import run_file

    phase("28 K3s owned-range kernel vs plain: 64^3 in 8^3 blocks, shard 3 of 8 and the "
          "seam shard 7, 2^17 particles on the shard's z-slab, one round; then all 8 "
          "shards in one launch")
    err_z = max(z_round(transport_kernel, dev, Z_SHARD, 2801),
                z_round(transport_kernel, dev, Z_SHARDS - 1, 2807),
                z_round_all(transport_kernel, dev, 2808))

    phase("29 K4s owned-range kernel vs plain: the 32x16 SMR DDMC forest, shards 0 and 1 "
          "of 2, 2^17 particles each, one round; then 8 shards in one launch")
    err_f = max(forest_round(transport_kernel, dev, 2901),
                forest_round_all(transport_kernel, dev, 2908))

    phase("30 big_mesh_spatial: 64^3 in 8^3 blocks, 200k particles, 3 steps, spatial at "
          "1 and 8 shards")
    big = {}
    for n in (1, 8):
        mods = {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": n}
        big[n] = spatial_path(DECK, mods, BIG_SPATIAL_STEPS, f"big_mesh_spatial at {n}")
        events_gate(big[n][0].total_events, BIG_SPATIAL_JAX_EVENTS,
                    f"big_mesh_spatial at {n} shards")
    name_z = transport_kernel.launch_name(3, False, route="@z")
    for n in (1, 8):
        rounds = rounds_queued(big[n][0])
        # the census, one launch a round queued; the migration kernel, one a round
        # queued at 8 shards (none at 1: nothing can migrate); the count kernel, one
        # a round queued and one a step's tail
        if (big[n][1].get(name_z, 0) != rounds
                or big[n][1].get("migrate_pack", 0) != (rounds if n > 1 else 0)
                or big[n][1].get("round_counts", 0) != rounds + big[n][0].cycle):
            raise AssertionError(f"big_mesh_spatial at {n}: launches {big[n][1]}, {rounds} "
                                 "rounds queued")
        print(f"big_mesh_spatial at {n}: {big[n][1]['round_counts']} round_counts launches, "
              f"one a round queued ({rounds}) and one a step's tail ({big[n][0].cycle})",
              flush=True)
    MIGRATE_MAIN[0] = big[8][1]["migrate_pack"]
    COUNTS_MAIN[0] = big[8][1]["round_counts"]
    k_z = round_kernel(transport_kernel, dev, big[8][2], name_z, cost)
    table_check(transport_kernel, dev, *big[8][4], "big_mesh_spatial's first step at 8 shards "
                "(8 coefficient sets)")
    warp_efficiency_line(transport_kernel, big[8][2], f"{name_z}, big_mesh_spatial's first "
                         "round at 8 shards", k_z[0], "1.087 (shard 3's round alone)", n=8)

    phase("31 stepdiff through the spatial decomposition at 8 shards: 128 cells in "
          "16-cell blocks at 100k particles, and the CI's 32 cells in 2-cell blocks at 16k")
    for mods, what in ((STEPDIFF_SPATIAL, "stepdiff spatial, 8 shards"),
                       (STEPDIFF_SPATIAL_CI, "stepdiff spatial, the CI's row, 8 shards")):
        sd = spatial_path(DECK, mods, None, what)[0]
        gate(weighted_erf_error(sd), WERR_TOL, f"{what} werr")

    phase("32 the 8-device SMR rows, particle decomposition: stepdiff_smr, "
          "stepdiff_smr_ddmc, the hybrid at tau_ddmc = 10, stepdiff_smr2; 10 steps each, "
          "one census launch a step over the 8 shards' slices, reruns as CUDA graphs")
    name_s2 = transport_kernel.launch_name(2, False, False, True)
    name_sd2 = transport_kernel.launch_name(2, False, True, True)
    rows, recorded = {}, {}
    for what, deck, mods, name in PARTICLE_ROWS:
        rows[what], _, recorded[what], _ = run_path(deck, mods,
                                                    name_sd2 if name == "sd2" else name_s2,
                                                    per_step=1, graph_rerun=True)
    gate(weighted_erf_error(rows["stepdiff_smr"]), SMR_TOL, "stepdiff_smr at 8 shards werr")
    gate(weighted_erf_error(rows["stepdiff_smr_ddmc"]), SMR_TOL,
         "stepdiff_smr_ddmc at 8 shards werr")
    gate(weighted_erf_error(rows["the hybrid"]), SMR_TOL,
         "hybrid (tau_ddmc = 10) at 8 shards werr")
    gate(profile_error(rows["stepdiff_smr2"]), PROFILE_TOL, "stepdiff_smr2 at 8 shards x-profile")
    del rows
    for what, inputs in recorded.items():
        particle_census_check(transport_kernel, inputs, f"{what} at 8 particle shards")
    del recorded
    torch.cuda.empty_cache()
    smi = device_line()
    for what, deck, mods, _ in PARTICLE_ROWS:
        particle_step_line(deck, mods, f"{what} at 8 particle shards", smi)

    phase("33 spatial + SMR + DDMC at 8 shards: tests/test_spatial.py:546-586's deck, "
          "32x16 in 8x8 blocks, 96k particles, 2 steps")
    # the eager step: every step's resolved leaks are counted (a replay calls no
    # Python); phase 45 holds this deck's graphs against its eager step
    sp8, sp_launches, sp_round, resolved, _ = spatial_path(
        SMR_DDMC_DECK, {**SMR_SPATIAL, **SPATIAL, "jaybenne/n_devices": 8}, SMR_SPATIAL_STEPS,
        "stepdiff_smr_ddmc spatial, 8 shards", graph=False)
    left = int((sp8.state.particles.alive & (sp8.state.particles.leak != 0)).sum())
    if resolved == 0 or left:
        raise AssertionError(f"spatial SMR DDMC: {resolved} pending leaks resolved, {left} left")
    with tempfile.TemporaryDirectory() as outdir:
        one = run_file(SMR_DDMC_DECK, outdir=outdir, modified_inputs=SMR_SPATIAL, quiet=True,
                       nlim=SMR_SPATIAL_STEPS, device="cuda")
    print(f"spatial SMR DDMC: {resolved} pending coarse-to-fine leaks resolved by their "
          f"owners after migration, {left} left at the end of the step", flush=True)
    gate(weighted_difference(sp8.state.fields.energy_tally, one.state.fields.energy_tally),
         SMR_SPATIAL_TOL, "spatial SMR DDMC at 8 shards: weighted difference from one device")
    name_f = transport_kernel.launch_name(2, False, True, True, route="@blocks")
    if sp_launches.get(name_f, 0) != rounds_queued(sp8):
        raise AssertionError(f"spatial SMR DDMC: launches {sp_launches}")
    k_f = round_kernel(transport_kernel, dev, sp_round, name_f, cost)
    # K4s on a later round (the second, recorded eagerly), its mean round as the
    # driver runs the deck to 6e-11, and how each recorded round's lane-events
    # spread over the SMs (the counting variant, %smid)
    round_kernel(transport_kernel, dev, sp8.recorded_rounds[1], name_f, cost,
                 which="the second round")
    mean_round_line(SMR_DDMC_DECK, {**SMR_SPATIAL, **SPATIAL, "jaybenne/n_devices": 8,
                                    "parthenon/time/tlim": "6.e-11"}, name_f, sp8, k_f[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for which, (p, n, args) in zip(("first", "second"), sp8.recorded_rounds):
        by_sm = path_mix(transport_kernel, mix_lib, (p, args), n)["by_sm"]
        print(f"{name_f} on the {which} round: lane-events on {len(by_sm)} SMs, the busiest "
              f"SM {max(by_sm) * sms / sum(by_sm)!r} times the mean SM's", flush=True)

    phase("34 determinism: phase 30 at 8 shards again (phase 32's rows were each rerun)")
    again = spatial_path(DECK, {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8},
                         BIG_SPATIAL_STEPS, "big_mesh_spatial at 8, rerun")[0]
    if not torch.equal(again.state.fields.energy_tally, big[8][0].state.fields.energy_tally):
        raise AssertionError("determinism: big_mesh_spatial at 8 shards differs on a rerun")
    print("big_mesh_spatial at 8 shards, rerun with the same seed: tallies bitwise identical; "
          "stepdiff_smr at 8 shards likewise (phase 32's rerun)", flush=True)

    phase("35 phase 25's path (stepdiff_smr with ep_bremss, 100k particles, one step) at "
          "seeds 1-4")
    surv = {}
    with tempfile.TemporaryDirectory() as outdir:
        for seed in NG_SMR_JAX_SEEDS:
            run = run_file(SMR_DECK, outdir=outdir, quiet=True, nlim=1, device="cuda",
                           modified_inputs={**NG_SMR, "jaybenne/seed": seed})
            p = run.state.particles
            surv[seed] = (int(p.alive.sum()), float(p.energy.double()[p.alive].mean()))
    mine = [v[0] for v in surv.values()]
    theirs = list(NG_SMR_JAX_SEEDS.values())
    diff = statistics.mean(mine) - statistics.mean(theirs)
    sd = float(np.sqrt((statistics.variance(mine) + statistics.variance(theirs)) / 4))
    print(f"ep_bremss stepdiff_smr survivors at seeds 1-4: {surv}; mean "
          f"{statistics.mean(mine)!r} vs the JAX package's {statistics.mean(theirs)!r} "
          f"({theirs}); difference {diff!r}, {diff / sd:+.2f} sd of the difference of the "
          "means", flush=True)
    if abs(diff) > N_SIGMA_BINOMIAL * sd:
        raise AssertionError(f"phase 35: survivors {mine} vs the JAX package's {theirs}")

    kernels = []
    for name, what, replaces, launches, err, (ms, plain, _, err_r, bound, by) in (
            (name_z, "K3s: a shard's round on its z-slab; big_mesh_spatial at 8 shards",
             "jaybenne_tpu/ops/pallas_grid.py:2054", big[8][1], err_z, k_z),
            (name_f, "K4s: a shard's round over its blocks; SMR DDMC spatial at 8 shards",
             "jaybenne_tpu/ops/pallas_bucketed.py:1360", sp_launches, err_f, k_f)):
        kernels.append({
            "name": f"{name} ({what})", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": max(err, err_r),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    return kernels


def schedule_phase(transport_kernel, dev) -> None:
    """Phase 36: the twelve DDMC instantiations (1D/2D/3D, with and without
    absorption, uniform (phase 11's meshes) and SMR (phase 15's forests)) on
    hybrid ledgers of 4 times the card's resident threads, so that blocks run in
    several waves, each regrouping its lanes: a full census of the last
    10 % of a step, kernel and plain identical in every column."""
    n = 4 * resident_threads(dev)
    for ndim in (1, 2, 3):
        for absorb in (False, True):
            for smr in (False, True):
                seed = 3600 + 10 * ndim + 2 * absorb + smr
                dt, mesh, prm, p0, coefs, _ = (smr_setup if smr else hybrid_setup)(
                    dev, ndim, absorb, True, seed, n=n)
                g = torch.Generator(device=dev).manual_seed(seed)
                p0.tau.copy_(0.9 + 0.1 * torch.rand(n, generator=g, device=dev))
                name = transport_kernel.launch_name(ndim, absorb, True, smr)
                pk, ev, _ = owned_vs_plain(transport_kernel, f"{name} at {n} slots", p0,
                                           (coefs, mesh, seed, prm, dt))
                if bool((pk.tau[pk.alive] < 1.0).any()):
                    raise AssertionError(f"{name} at {n} slots: short of census")
                print(f"{name}: full census of {n} slots (4 times the resident threads), "
                      f"{ev} events, {int(pk.absorbed.sum())} absorbed: kernel and plain "
                      "identical in every column", flush=True)


def same_run(a, b, what):
    """Raises unless two runs' tallies, u and every ledger column are bitwise equal."""
    for name in ("energy_tally", "u"):
        if not torch.equal(getattr(a.state.fields, name), getattr(b.state.fields, name)):
            raise AssertionError(f"{what}: {name} differs")
    pa, pb = a.state.particles, b.state.particles
    for f in dataclasses.fields(pa):
        if not torch.equal(getattr(pa, f.name), getattr(pb, f.name)):
            raise AssertionError(f"{what}: ledger column {f.name} differs")


def through_npz(tree, outdir):
    """A checkpoint tree written with np.savez and read back with np.load."""
    path = os.path.join(outdir, "tree.npz")
    np.savez(path, **tree)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restart_phases(dev, smi) -> None:
    """Phases 37-40: checkpoint/restart on the main path and under the spatial
    decomposition, debug_checks, and --profile-dir with history.json. The card's
    machine has no h5py: checkpoints go through their tree and np.savez, and the
    HDF5 writers are held to the JAX package's on the CPU (tests/test_torch_io.py)."""
    import time

    from jaybenne_tpu_torch import config as config_mod
    from jaybenne_tpu_torch import driver as driver_mod
    from jaybenne_tpu_torch import io as io_mod
    from jaybenne_tpu_torch import state as state_mod
    from jaybenne_tpu_torch.driver import Simulation, run_file
    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.parallel import spatial
    from jaybenne_tpu_torch.profile import device_time_by_name
    from jaybenne_tpu_torch.utils.deck import Deck

    def cfg_of(deck, mods):
        return config_mod.from_deck(Deck.from_file(deck).update(dict(mods)))

    def ms_since(t0):
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    phase(f"37 bitwise restart on the main path: stepdiff 128 cells, 100k particles, "
          f"{RESTART_STEPS} steps, a checkpoint tree through np.savez, {RESTART_STEPS} more, "
          f"against {2 * RESTART_STEPS} straight")
    with tempfile.TemporaryDirectory() as outdir:
        straight = run_file(DECK, outdir, GATE, quiet=True, nlim=2 * RESTART_STEPS,
                            device="cuda")
        first = run_file(DECK, outdir, GATE, quiet=True, nlim=RESTART_STEPS, device="cuda")
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tree = first.checkpoint_tree()
        build_ms = ms_since(t0)
        n_bytes = sum(np.asarray(v).nbytes for v in tree.values())
        loaded = through_npz(tree, outdir)
        t0 = time.perf_counter()
        io_mod.state_from_checkpoint_tree(loaded, state_mod.initial_state(
            first.mesh, first.state.particles.capacity, 0))
        restore_ms = ms_since(t0)
        t0 = time.perf_counter()
        resumed = Simulation(cfg_of(DECK, GATE), outdir=outdir, quiet=True, device="cuda",
                             restart=loaded)
        sim_ms = ms_since(t0)
        cuda_lib.LAUNCHES.clear()
        resumed.run(nlim=RESTART_STEPS)
        launches = dict(cuda_lib.LAUNCHES)
        note_table("stepdiff resumed from a checkpoint", launches)
    if resumed.cycle != 2 * RESTART_STEPS or launches.get("transport_1d", 0) != RESTART_STEPS:
        raise AssertionError(f"restart: cycle {resumed.cycle}, launches {launches}")
    same_run(straight, resumed, "restart on the main path")
    if [h["events"] for h in resumed.history] != [h["events"] for h in
                                                  straight.history[RESTART_STEPS:]]:
        raise AssertionError("restart on the main path: events differ")
    print(f"stepdiff resumed at cycle {RESTART_STEPS} from a checkpoint tree through np.savez: "
          f"tally, u and every ledger column bitwise the straight run's after "
          f"{2 * RESTART_STEPS} steps; launches after the restart {launches} (one "
          f"transport_1d a step)", flush=True)
    print(f"checkpoint ({smi}): {len(tree)} entries, {n_bytes} bytes for "
          f"{first.state.particles.capacity} ledger slots and {first.mesh.total_cells} cells; "
          f"checkpoint_tree {build_ms!r} ms; state_from_checkpoint_tree {restore_ms!r} ms; "
          f"Simulation(restart=tree) {sim_ms!r} ms", flush=True)

    phase(f"38 restart under the spatial decomposition: phase 31's full row (8 shards, 128 "
          f"cells in 16-cell blocks, 100k particles), {SPATIAL_RESTART_STEPS} + "
          f"{SPATIAL_RESTART_STEPS} steps; resumes at 8 and 4 shards, and from a 1-shard tree")
    steps = SPATIAL_RESTART_STEPS
    with tempfile.TemporaryDirectory() as outdir:
        straight = run_file(DECK, outdir, STEPDIFF_SPATIAL, quiet=True, nlim=2 * steps,
                            device="cuda")
        first = run_file(DECK, outdir, STEPDIFF_SPATIAL, quiet=True, nlim=steps, device="cuda")
        tree = through_npz(first.checkpoint_tree(), outdir)
        e_ck = radiation_energy(first)
        at8 = Simulation(cfg_of(DECK, STEPDIFF_SPATIAL), outdir=outdir, quiet=True,
                         device="cuda", restart=tree)
        at8.run(nlim=steps)
        same_run(straight, at8, "spatial restart at 8 shards")
        mods4 = {**STEPDIFF_SPATIAL, "jaybenne/n_devices": 4}
        at4 = Simulation(cfg_of(DECK, mods4), outdir=outdir, quiet=True, device="cuda",
                         restart=tree)
        at4.run(nlim=steps)
        e4 = radiation_energy(at4)
        if (any(h["unfinished"] or h["dropped"] for h in at4.history)
                or abs(e4 - e_ck) > ENERGY_RTOL * e_ck):
            raise AssertionError(f"spatial restart at 4 shards: {at4.history}, energy "
                                 f"{e_ck} -> {e4}")
        mods1 = {**STEPDIFF_SPATIAL, "jaybenne/n_devices": 1}
        one = run_file(DECK, outdir, mods1, quiet=True, nlim=steps, device="cuda")
        tree1 = through_npz(one.checkpoint_tree(), outdir)
        from1 = Simulation(cfg_of(DECK, STEPDIFF_SPATIAL), outdir=outdir, quiet=True,
                           device="cuda", restart=tree1)
        # Simulation's re-homing again, on the same ledger at the same capacity
        mesh, cap = one.mesh, from1.state.particles.capacity
        p = io_mod.state_from_checkpoint_tree(
            tree1, state_mod.initial_state(mesh, cap, 0)).particles
        move, _ = spatial.misplaced(p, mesh, 8)
        q = spatial.rehome_restart_ledger(p, mesh, 8)
        changed = torch.zeros(cap, dtype=torch.bool, device=dev)
        for f in dataclasses.fields(p):
            changed |= getattr(p, f.name) != getattr(q, f.name)
        filled = q.alive & ~(p.alive & ~move)
        n_move = int(move.sum())
        if (bool((changed & ~(move | filled)).any()) or int(filled.sum()) != n_move
                or bool(spatial.misplaced(q, mesh, 8)[0].any())):
            raise AssertionError("re-homing moved a slot that was not misplaced")
        same_ledger = all(torch.equal(getattr(q, f.name), getattr(from1.state.particles, f.name))
                          for f in dataclasses.fields(q))
        if not same_ledger:
            raise AssertionError("restart from a 1-shard tree: Simulation's ledger differs")
        from1.run(nlim=1)
        if from1.history[0]["unfinished"] or from1.history[0]["dropped"]:
            raise AssertionError(f"restart from a 1-shard tree at 8: {from1.history}")
    print(f"spatial stepdiff at 8 shards resumed at cycle {steps}: bitwise the straight run "
          f"after {2 * steps} steps (migrated {[h['migrated'] for h in at8.history]}); at 4 "
          f"shards: unfinished {[h['unfinished'] for h in at4.history]}, radiation energy "
          f"{e_ck!r} -> {e4!r} (rel {abs(e4 - e_ck) / e_ck:.3e}); a 1-shard tree at 8 shards: "
          f"{n_move} of {int(p.alive.sum())} live particles misplaced and moved, every other "
          f"of {cap} slots byte-identical, the next step unfinished "
          f"{from1.history[0]['unfinished']}", flush=True)

    phase("39 debug_checks on the card: stepdiff_smr (phase 16's deck), 10 steps")
    checks = []
    validate = driver_mod.validate_state

    def timed(state, mesh, cfg):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        validate(state, mesh, cfg)
        checks.append(ms_since(t0))

    driver_mod.validate_state = timed
    try:
        with tempfile.TemporaryDirectory() as outdir:
            plain = run_file(SMR_DECK, outdir, SMR_GATE, quiet=True, nlim=PATH_STEPS,
                             device="cuda")
            checked = run_file(SMR_DECK, outdir, {**SMR_GATE, "jaybenne/debug_checks": "true"},
                               quiet=True, nlim=PATH_STEPS, device="cuda")
    finally:
        driver_mod.validate_state = validate
    if len(checks) != PATH_STEPS or checked.cycle != PATH_STEPS:
        raise AssertionError(f"debug_checks: {len(checks)} validations in {checked.cycle} "
                             "cycles")
    same_run(plain, checked, "debug_checks")
    step_ms = statistics.median(h["step_seconds"] for h in plain.history) * 1e3
    print(f"debug_checks ({smi}): every one of {PATH_STEPS} cycles validated; validate_state "
          f"{spread(sorted(checks))} a step, against a median step of {step_ms!r} ms; the run "
          "bitwise the unchecked one", flush=True)

    phase(f"40 --profile-dir and history.json: driver.main, stepdiff, {PROFILE_STEPS} steps")
    with tempfile.TemporaryDirectory() as outdir:
        prof_dir = os.path.join(outdir, "prof")
        rc = driver_mod.main(["-i", DECK, "-d", outdir, "-q", "-n", str(PROFILE_STEPS),
                              "--profile-dir", prof_dir,
                              *(f"{k}={v}" for k, v in GATE.items())])
        trace = os.path.join(prof_dir, "trace.json")
        if rc != 0 or not os.path.exists(trace):
            raise AssertionError(f"--profile-dir: rc {rc}, trace {os.listdir(prof_dir)}")
        by_name = device_time_by_name(trace)
        trace_bytes = os.path.getsize(trace)
        with open(os.path.join(outdir, "history.json")) as fh:
            hist = json.load(fh)
    k1 = {k: v for k, v in by_name.items() if "transport_kernel<1, false, false, false, false, float>"
          in k}
    if not k1:
        raise AssertionError(f"--profile-dir: no transport_1d kernel in the trace: "
                             f"{sorted(by_name)[:20]}")
    cycles = hist["cycles"]
    if (sorted(hist) != HISTORY_KEYS or len(cycles) != PROFILE_STEPS
            or any(not set(HISTORY_CYCLE_KEYS) <= set(c) for c in cycles)):
        raise AssertionError(f"history.json: {sorted(hist)}, {cycles}")
    print(f"--profile-dir: a Chrome trace of {trace_bytes} bytes; "
          f"device_time_by_name finds transport_1d: {sum(k1.values()) / 1e3!r} ms over "
          f"{PROFILE_STEPS} steps ({len(by_name)} device names); history.json: "
          f"{len(cycles)} cycles with the JAX package's keys, events "
          f"{[c['events'] for c in cycles]}", flush=True)


# the float64 census (phases 41-44, precision = f64): the deck override, the JAX
# package's counterpart (its XLA event loop) that the float64 rows name, and the
# source of its instantiations
PREC64 = {"jaybenne/precision": "f64"}
F64_REPLACES = "jaybenne_tpu/ops/transport.py:154 (_one_event, XLA, f64)"
F64_SRC = "jaybenne_tpu_torch/csrc/transport_kernel_f64.cu"
# the float64 routes redesigned (csrc/transport_kernel.cuh's head note): how, for
# the ``redesigned`` entry of their ``kernels`` row, and the census ms that
# PERF.md's table gives the route before its redesign (NVIDIA H100 80GB HBM3,
# 700.00 W), which phase 43 prints beside this run's
F64_REDESIGNED = {
    "transport_2d_smr_f64": ("the lean lane: the cell's record alone in registers (kLean)",
                             3.1203),
    "transport_1d_smr_f64@blocks": ("the lean lane, vy and vz after the history (kLean)",
                                    1.7692),
    "transport_1d_f64": ("on the card's resident grid in rounds, each round's slots spread "
                         "over it, where the ledger takes at most two (kRounds); the draws "
                         "one event ahead (kDrawAhead)", 1.4591),
    "transport_1d_ddmc_f64": ("on the card's resident grid in rounds, each round's slots "
                              "spread over it, where the ledger takes at most two (kRounds)",
                              0.0543),
    "transport_2d_abs_smr_ng_f64": ("on the card's resident grid in rounds, each round's "
                                    "slots spread over it, where the ledger takes at most four "
                                    "(kRounds, kRoundsMax)", 0.0598),
}


def only_f64(launches, what):
    """Raises unless a float64 run launched float64 kernels alone (the insert
    kernel, ``ledger_insert``, and the migration kernel, ``migrate_pack``, copy the
    bytes of a column of either width; the tally kernel, ``tally``, the face
    kernel, ``ddmc_face_probs``, and the count kernel, ``round_counts``, count
    either precision's launches under one name)."""
    either = ("ledger_insert", "migrate_pack", "tally", "ddmc_face_probs", "round_counts")
    other = [k for k, n in launches.items() if n and k not in either
             and not k.split("@")[0].endswith("_f64")]
    if other:
        raise AssertionError(f"{what}: the float64 run launched {other}: {launches}")


def tally_rtol(sim) -> float:
    """The float64 run's conservation bound: the fixed-point tally's
    (ops/tally.py: conservation_rtol) at its ledger's capacity."""
    from jaybenne_tpu_torch.ops import tally

    return tally.conservation_rtol(sim.state.particles.capacity)


def f64_row(name, what, launches, errs, timing, src=F64_SRC):
    """One float64 route's entry of the ``kernels`` line from a gate's run and its
    kernel's timing (ms, plain_ms, events, max_abs_err, bound_ms, bound_by); a
    route of F64_REDESIGNED has its ``redesigned`` entry, and its census time is
    printed beside the one before its redesign."""
    ms, plain_ms, _, err, bound, by = timing
    row = {"name": f"{name} (the float64 census; {what})", "route": "cuda", "source": src,
           "replaces": F64_REPLACES, "launches": launches.get(name, 0),
           "max_abs_err": max([err, *errs]), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    if name in F64_REDESIGNED:
        how, before = F64_REDESIGNED[name]
        row["redesigned"] = how
        print(f"{name}: the census {ms!r} ms in this run; {before!r} ms before its redesign "
              f"(PERF.md's table, NVIDIA H100 80GB HBM3, 700.00 W): {ms / before:.3f} of it",
              flush=True)
    return row


def precision_line(transport_kernel, dev, what, inputs, cost64):
    """A census's float32 kernel against its float64 one on the same inputs (the
    float64 census on them made float64), in turns, each the median of
    CENSUS_REPEATS with its range; the float64 census's bound. Returns the
    ratio of the medians."""
    p, args = inputs
    coefs, mesh, seed, prm, dt = args
    p64 = ledger_as(p, F64)
    args64 = (coefs_as(coefs, F64), mesh, seed, prm_as(prm, F64), dt)
    transport_kernel.transport(p.clone(), *args)  # warm-up
    transport_kernel.transport(p64.clone(), *args64)
    t32, t64 = [], []
    for _ in range(CENSUS_REPEATS):
        t32 += time_census(transport_kernel.transport, p, args, dev, 1)[0]
        times, ev64 = time_census(transport_kernel.transport, p64, args64, dev, 1)
        t64 += times
    t32.sort()
    t64.sort()
    ratio = statistics.median(t64) / statistics.median(t32)
    smr = ((mesh, block_crossings(transport_kernel, p64, args64, ev64))
           if mesh.max_level > 0 else None)
    bound, by = census_bound(p64, prm.ndim, bool(prm.has_absorption), mesh.total_cells, ev64,
                             cost64, ddmc=bool(prm.use_ddmc), smr=smr,
                             nongray=not coefs.is_gray)
    print(f"f64 against f32 on {what} ({p.capacity} slots, {int(p.alive.sum())} live): f32 "
          f"census {spread(t32)}, f64 census {spread(t64)}, f64/f32 {ratio!r}; f64 bound "
          f"{bound!r} ms ({by}; {ev64} events; FP64 {PEAK_F64_OPS:.3g} op/s, "
          f"{PEAK_BYTES:.3g} B/s), f64 kernel at {bound / statistics.median(t64):.3f} of it",
          flush=True)
    return ratio


def f64_phases(transport_kernel, dev, cost, cost64, routes) -> list:
    """Phases 41-44, the float64 census (precision = f64). ``routes`` are
    (what, census inputs) of float32 paths that phase 44 times at both
    precisions. Returns the ``kernels`` entries of the float64 routes that the
    gates run."""
    from jaybenne_tpu_torch.ops import cuda_lib, kernel_rng

    phase("41 the double draw: Draw<double> (kernel_rng.cuh) vs the plain float64 pool")
    slots = torch.tensor([0, 1, 127, 128, 16383, 100003, (1 << 17) - 1, 201151, (1 << 31) - 1],
                         dtype=torch.int32)
    its = torch.tensor([0, 1, 7, 8, 1000, 12345, 65537, (1 << 31) - 1], dtype=torch.int32)
    tags = torch.arange(24, dtype=torch.int32)
    grid = torch.cartesian_prod(slots, its, tags).to(dev)
    lane, it, tag = (grid[:, k].contiguous() for k in range(3))
    n_draws = 0
    for seed in (-12345, 0, 349857, -(1 << 31), (1 << 31) - 1):
        got = kernel_rng.draws_f64_cuda(seed, lane, it, tag)
        want = kernel_rng.draws_f64_plain(seed, lane.long(), it.long(), tag.long())
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            raise AssertionError(f"the double draw differs from its plain version at seed {seed}")
        n_draws += got.numel()
    print(f"Draw<double>: u53, the spare half's u53, exp, cos and sin bitwise the plain float64 "
          f"pool's on {n_draws} (seed, slot, it, tag) values", flush=True)

    phase("42 all 36 float64 instantiations vs their float64 plain versions: phase 11's, 15's "
          "and 22's ledgers in float64, and one K3s and one K4s round")
    err64 = {}
    for ndim in (1, 2, 3):
        for absorb in (False, True):
            for ddmc in (False, True):
                seed = 1100 + ndim + 10 * absorb
                dt, mesh, prm, p0, coefs, _ = hybrid_setup(dev, ndim, absorb, ddmc, seed)
                name = transport_kernel.launch_name(ndim, absorb, ddmc, dtype=F64)
                err64[name] = f64_vs_plain(transport_kernel, dev, name, p0, coefs, mesh, prm, dt,
                                           seed)[0]
                seed = 1500 + ndim
                dt, mesh, prm, p0, coefs, _ = smr_setup(dev, ndim, absorb, ddmc, seed)
                name = transport_kernel.launch_name(ndim, absorb, ddmc, True, dtype=F64)
                err64[name] = f64_vs_plain(transport_kernel, dev, name, p0, coefs, mesh, prm, dt,
                                           seed)[0]
        for smr in (False, True):
            for ddmc in (False, True):
                seed = 2200 + ndim + 10 * smr
                dt, mesh, prm, p0, coefs, _, _ = nongray_setup(dev, ndim, ddmc, smr, seed)
                name = transport_kernel.launch_name(ndim, True, ddmc, smr, True, dtype=F64)
                err64[name] = f64_vs_plain(transport_kernel, dev, name, p0, coefs, mesh, prm, dt,
                                           seed)[0]
    before = dict(cuda_lib.LAUNCHES)
    err64["transport_3d_f64@z"] = z_round(transport_kernel, dev, Z_SHARD, 2801, F64)
    err64["transport_2d_ddmc_smr_f64@blocks"] = forest_round(transport_kernel, dev, 2901, F64)
    only_f64({k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()}, "phase 42 rounds")
    if len(err64) != 38 or any(e != 0.0 for e in err64.values()):
        raise AssertionError(f"float64 kernels against their plain versions: {err64}")
    print(f"all {len(err64) - 2} float64 instantiations and the two owned-range rounds bitwise "
          "their float64 plain versions (max_abs_err 0.0)", flush=True)

    phase("43 the float64 gates through driver.run_file: stepdiff, stepdiff_ddmc, "
          "stepdiff_smr, one EPBremss step on stepdiff_smr, stepdiff at 8 spatial shards")
    rows = []
    name = transport_kernel.launch_name(1, False, dtype=F64)
    sd, launches, sd_in, e0 = run_path(DECK, {**GATE, **PREC64}, name, energy_rtol=tally_rtol)
    only_f64(launches, "stepdiff f64")
    if sd.state.particles.x.dtype != F64 or sd.state.fields.energy_tally.dtype != F64:
        raise AssertionError("stepdiff f64: the state is not float64")
    gate(weighted_erf_error(sd), WERR_TOL, "stepdiff f64 werr")
    print(f"stepdiff f64: radiation energy conserved to {abs(radiation_energy(sd) - e0) / e0!r} "
          f"(the fixed-point tally's bound {tally_rtol(sd)!r}); events {sd.total_events}",
          flush=True)
    rows.append(f64_row(name, "stepdiff, 128 cells, 100k particles", launches, [err64[name]],
                        path_kernel(transport_kernel, dev, sd, sd_in, name, cost64)))

    name = transport_kernel.launch_name(1, False, True, dtype=F64)
    dd, launches, dd_in, _ = run_path(DDMC_DECK, {**DDMC_GATE, **PREC64}, name,
                                      energy_rtol=tally_rtol)
    only_f64(launches, "stepdiff_ddmc f64")
    gate(weighted_erf_error(dd), WERR_TOL, "stepdiff_ddmc f64 werr")
    rows.append(f64_row(name, "stepdiff_ddmc", launches, [err64[name]],
                        path_kernel(transport_kernel, dev, dd, dd_in, name, cost64)))
    table = table_check(transport_kernel, dev, dd_in[1][0], dd.mesh, dd_in[1][3], dd_in[1][4],
                        None, "stepdiff_ddmc f64's last census (the 1D DDMC record in float64)")
    rows.append({
        "name": "census_table_f64 (the float64 census's per-cell table in one pass)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/table_kernel.cu",
        "replaces": F64_REPLACES + ": its per-event coefficient gathers",
        "launches": launches.get("census_table_f64", 0), "max_abs_err": 0.0, "ms": table[0],
        "plain_ms": table[1], "bound_ms": table[2], "bound_by": "bytes", "library_ms": None})

    name = transport_kernel.launch_name(2, False, False, True, dtype=F64)
    s2, launches, s2_in, _ = run_path(SMR_DECK, {**SMR_GATE, **PREC64}, name,
                                      energy_rtol=tally_rtol)
    only_f64(launches, "stepdiff_smr f64")
    gate(weighted_erf_error(s2), SMR_TOL, "stepdiff_smr f64 werr")
    rows.append(f64_row(name, "stepdiff_smr", launches, [err64[name]],
                        path_kernel(transport_kernel, dev, s2, s2_in, name, cost64)))

    name = transport_kernel.launch_name(2, True, False, True, True, dtype=F64)
    p0 = initial_ledger(SMR_DECK, {**NG_SMR, **PREC64})
    k4, launches, k4_in, _ = run_path(SMR_DECK, {**NG_SMR, **PREC64}, name, 1,
                                      conserves_tally=False)
    only_f64(launches, "stepdiff_smr with ep_bremss f64")
    spectral_gate(k4, p0, "non-gray K4 f64", NG_SMR_JAX)
    rows.append(f64_row(name, "one EPBremss step on stepdiff_smr", launches, [err64[name]],
                        path_kernel(transport_kernel, dev, k4, k4_in, name, cost64)))

    what = "stepdiff spatial f64, 8 shards"
    sp, launches, sp_round, _, _ = spatial_path(DECK, {**STEPDIFF_SPATIAL, **PREC64}, None, what)
    only_f64(launches, what)
    gate(weighted_erf_error(sp), WERR_TOL, f"{what} werr")
    name = next(k for k in launches if k.startswith("transport_"))
    timing = round_kernel(transport_kernel, dev, sp_round, name, cost64)
    rows.append(f64_row(name, "stepdiff at 8 spatial shards, one launch a round", launches,
                        [], timing))
    mean_round_line(DECK, {**STEPDIFF_SPATIAL, **PREC64}, name, sp, timing[0])

    phase("44 the float64 census against the float32 one: time and bound")
    for what, inputs in routes:
        precision_line(transport_kernel, dev, what, inputs, cost64)
    print(f"SASS instructions on the straight-line path, float64: log {cost64['logf']}, divide "
          f"{cost64['div']}, the double draw (two hash words) {cost64['hash']}, exp "
          f"{cost64['expf']}, sqrt {cost64['sqrtf']} (float32: logf {cost['logf']}, divide "
          f"{cost['div']}, hash {cost['hash']})", flush=True)
    return rows


def bitwise_equal(a, b) -> bool:
    """Whether two tensors hold the same bits (a float by its integer view, so
    that -0.0 and 0.0 differ and a NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(view), b.contiguous().view(view))
    return torch.equal(a, b)


def same_states(a, b, what):
    """Raises unless two simulations stand at the same step with every field, every
    ledger column and ``overflow`` bitwise equal and the same history but for the
    wall time."""
    from jaybenne_tpu_torch.graph import state_tensors

    sa, sb = a.state, b.state
    if (a.t, a.cycle) != (b.t, b.cycle):
        raise AssertionError(f"{what}: clocks {(a.t, a.cycle)} and {(b.t, b.cycle)}")
    for x, y in zip(state_tensors(sa), state_tensors(sb)):
        if not bitwise_equal(x, y):
            raise AssertionError(f"{what}: a tensor of the state differs at cycle {a.cycle}")
    strip = [[{k: v for k, v in h.items() if k != "step_seconds"} for h in s.history]
             for s in (a, b)]
    if strip[0] != strip[1]:
        raise AssertionError(f"{what}: histories differ: {strip}")


def parent_insert_parts(ledger, valid, reserved=None):
    """The insert's destinations as the port made them before its scan kernel
    (the ranks' cumsum, a stable free-first argsort of the ledger, the sums, a
    where and a gather; then the write kernel), kept here only as the yardstick
    that the scan is timed against: (dest, n_dropped, parts), where parts maps each
    part's name to a call that repeats it on the same inputs."""
    cap = ledger.capacity
    vflat = valid.reshape(-1)

    def ranks():
        return torch.cumsum(vflat.to(torch.int64), 0) - 1

    def sort():
        occupied = ledger.alive if reserved is None else ledger.alive | reserved
        return occupied, torch.argsort(occupied.to(torch.uint8), stable=True)

    rank, (occupied, order) = ranks(), sort()

    def sums():
        ok = vflat & (rank < cap - occupied.sum())
        return ok, vflat.sum() - ok.sum()

    ok, n_dropped = sums()

    def gather():
        return torch.where(ok, order[rank.clamp(0, cap - 1)], cap)

    return gather(), n_dropped, {"the ranks' cumsum": ranks, "the stable argsort": sort,
                                 "the sums": sums, "the where and gather": gather}


def timed_ms(fn, dev, fresh=lambda: None, repeats=CENSUS_REPEATS) -> float:
    """The median ms of ``fn(fresh())`` between CUDA events after a device sleep
    (the host queues the call meanwhile), after one warm-up call."""
    fn(fresh())
    times = []
    for _ in range(repeats):
        arg = fresh()
        torch.cuda.synchronize(dev)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        start.record()
        fn(arg)
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def traced_launches(fn, fresh, repeats) -> list:
    """(name, device us) of each kernel, copy and memset in a ``torch.profiler``
    trace of ``repeats`` calls of ``fn(fresh())``, ``fresh()``'s own work left
    out."""
    from jaybenne_tpu_torch.profile import _DEVICE_CATS

    args = [fresh() for _ in range(repeats)]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for a in args:
            fn(a)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["dur"])) for e in events
            if e.get("cat") in _DEVICE_CATS and "dur" in e]


def launch_split(fn, fresh, names, repeats=CENSUS_REPEATS) -> dict:
    """The mean device ms of one launch of each kernel in ``names`` (substrings of
    the kernels' names, each launched once a call) over the launches of it that a
    ``torch.profiler`` trace of ``repeats`` calls of ``fn(fresh())`` holds, and
    under "traced" how many it holds of each (``repeats`` unless the trace lost
    some)."""
    events = traced_launches(fn, fresh, repeats)
    out, traced = {}, {}
    for name in names:
        us = [d for k, d in events if name in k]
        out[name] = sum(us) / 1e3 / max(len(us), 1)
        traced[name] = len(us)
    out["traced"] = traced
    return out


# the insert kernel's three launches (csrc/insert_kernel.cu), by kernel name
INSERT_LAUNCHES = ("count_kernel", "list_kernel", "write_kernel")


def insert_bound(ledger, cand, valid, written, reserved) -> float:
    """The least ms of an insert on the card (bytes / PEAK_BYTES): the ledger's
    alive flags (and ``reserved``'s) read once, every candidate's valid flag, the
    values of the ``written`` candidates, and their rows' columns written."""
    from jaybenne_tpu_torch.particles import _columns

    flags = ledger.capacity * (2 if reserved else 1) + valid.numel() * valid.element_size()
    values = sum(v.element_size() for v in cand.values())
    rows = sum(col.element_size() for col, _ in _columns(ledger, cand))
    return (flags + written * (values + rows)) / PEAK_BYTES * 1e3


def equal_ledgers(a, b, what) -> None:
    for f in dataclasses.fields(a):
        if not bitwise_equal(getattr(a, f.name), getattr(b, f.name)):
            raise AssertionError(f"{what}: column {f.name} differs")


def insert_check(dev, sim, smi) -> dict:
    """The insert kernel (csrc/insert_kernel.cu) on the 64^3 feedback row's ledger
    with the candidate grid its emission makes (one candidate a cell, 0.76 of
    them valid; the per-cell columns broadcast along the candidate axis, as
    ``sourcing.births`` makes them): the whole insert (one pass: the scans and
    the writes) and its plain version bitwise equal, their destinations those
    of the parent's stable free-first sort; each timed (CUDA events after a device
    sleep, median of CENSUS_REPEATS) beside its bound (``insert_bound``) and
    beside the parts of the parent's destinations, each a call of its own.
    Returns its ``kernels`` entry, the launches left to the caller."""
    from jaybenne_tpu_torch.particles import insert_destinations, insert_particles

    p0 = sim.state.particles.clone()
    gen = torch.Generator(device=dev).manual_seed(45)
    n = sim.mesh.total_cells
    shape = (n, 1)
    valid = torch.rand(shape, generator=gen, device=dev) < 0.76
    floats = ("x", "y", "z", "vx", "vy", "vz", "tau", "energy")
    cand = {k: torch.rand(shape, generator=gen, device=dev) for k in floats}
    cand["weight"] = torch.rand((n, 1), generator=gen, device=dev).expand(shape)
    cand.update({k: torch.randint(0, 8, (n, 1), generator=gen, device=dev,
                                  dtype=torch.int32).expand(shape)
                 for k in ("block", "i", "j", "k")})
    q, r = p0.clone(), p0.clone()
    drop = int(insert_particles(q, cand, valid)[1])
    plain_drop = int(insert_particles(r, cand, valid, plain=True)[1])
    equal_ledgers(q, r, "insert kernel against its plain version")
    dest, parent_drop, parts = parent_insert_parts(p0, valid)
    if (drop != plain_drop or drop != int(parent_drop)
            or not torch.equal(insert_destinations(p0, valid)[0], dest)):
        raise AssertionError(f"insert kernel: drops {drop}, {plain_drop}, {int(parent_drop)} "
                             "or the destinations differ from the stable sort's")
    ms = timed_ms(lambda x: insert_particles(x, cand, valid), dev, p0.clone)
    plain_ms = timed_ms(lambda x: insert_particles(x, cand, valid, plain=True), dev, p0.clone)
    part_ms = {name: timed_ms(lambda _, f=f: f(), dev) for name, f in parts.items()}
    split = launch_split(lambda x: insert_particles(x, cand, valid), p0.clone, INSERT_LAUNCHES)
    bound = insert_bound(p0, cand, valid, int(valid.sum()) - drop, False)
    print(f"insert at the 64^3 feedback row ({p0.capacity} slots, {n} candidates, "
          f"{int(valid.sum())} valid, {len(cand)} candidate columns and 4 fills; {smi}): "
          f"the whole insert, one pass of the kernel (3 launches: counts, lists, writes) "
          f"{ms!r} ms, its plain version {plain_ms!r} ms, bound {bound!r} ms (bytes), the "
          f"kernel at {bound / ms:.3f} of it; device ms by launch (torch.profiler) {split}; "
          f"the parent's destinations by part "
          f"{part_ms} ms, summed {sum(part_ms.values())!r} ms "
          "(its write kernel after them); every column bitwise equal, the destinations "
          "the stable sort's", flush=True)
    return {
        "name": "ledger_insert (the ledger insert: its destinations by scans and its writes, "
                "three launches a pass, every local shard in one pass)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/insert_kernel.cu",
        "replaces": "jaybenne_tpu/particles.py:103-125 (insert_particles: XLA's cumsum, "
                    "stable argsort and scatters with mode='drop', no Pallas kernel)",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
    }


def kept(v):
    """A copy of the candidate ``v`` with its strides: a dimension it broadcasts
    (stride 0) stays a broadcast, a strided view keeps its stride."""
    if not isinstance(v, torch.Tensor):
        return v
    base = v[tuple(slice(None) if st else slice(0, 1) for st in v.stride())]
    out = torch.empty_strided(base.shape, base.stride(), dtype=v.dtype, device=v.device)
    out.copy_(base)
    return out.expand(v.shape)


class RecordedInsert(typing.NamedTuple):
    """One pass of the insert kernel as a run made it: a clone of the ledger
    before it, the candidates and valid flags with their strides, whether the
    ledger's absorbed rows were reserved, and the shards it took at once."""

    ledger: object
    cand: dict
    valid: torch.Tensor
    reserved: bool
    m: int


def recorded_inserts(run, want, keep):
    """The first ``keep`` passes of the insert kernel (``particles._insert_cuda``)
    that ``run()`` makes whose candidates ``want(cand)`` takes, as
    ``RecordedInsert``s."""
    from jaybenne_tpu_torch import particles

    calls, real = [], particles._insert_cuda

    def recording(ledger, cand, valid, reserved, m):
        if len(calls) < keep and want(cand):
            if reserved is not None and reserved.data_ptr() != ledger.absorbed.data_ptr():
                raise AssertionError("insert: reserved rows other than the absorbed ones")
            calls.append(RecordedInsert(ledger.clone(), {k: kept(v) for k, v in cand.items()},
                                        kept(valid), reserved is not None, m))
        return real(ledger, cand, valid, reserved, m)

    particles._insert_cuda = recording
    try:
        run()
    finally:
        particles._insert_cuda = real
    return calls


def replay_insert(c: RecordedInsert, ledger, plain=False):
    """A recorded insert on ``ledger`` (a clone of its own) by the kernel, or by
    its plain version: returns the dropped counts, one a shard."""
    from jaybenne_tpu_torch import particles
    from jaybenne_tpu_torch.parallel import sharding

    if c.m > 1:
        if not c.reserved:
            raise AssertionError("insert: an insert over several shards reserves")
        return particles.insert_arrivals(sharding.split_ledger(ledger, c.m), c.cand, c.valid,
                                         plain=plain)
    reserved = ledger.absorbed if c.reserved else None
    return particles.insert_particles(ledger, c.cand, c.valid, reserved, plain=plain)[1][None]


def inserts_bitwise(calls, what) -> str:
    """Each recorded insert (``recorded_inserts``) by the kernel and by its plain
    version on clones of its ledger: raises unless every column and every drop
    count is bitwise equal and the kernel launched its three launches once.
    Returns what was held, as text."""
    from jaybenne_tpu_torch.ops import cuda_lib

    if not calls:
        raise AssertionError(f"insert on {what}: no call recorded")
    seen = []
    for c in calls:
        q, r = c.ledger.clone(), c.ledger.clone()
        before = cuda_lib.LAUNCHES["ledger_insert"]
        drops = replay_insert(c, q)
        if cuda_lib.LAUNCHES["ledger_insert"] != before + 3:
            raise AssertionError(f"insert on {what}: the kernel did not launch once")
        plain_drops = replay_insert(c, r, plain=True)
        equal_ledgers(q, r, f"insert on {what} against the plain version")
        if not torch.equal(drops, plain_drops):
            raise AssertionError(f"insert on {what}: dropped {drops} vs {plain_drops}")
        written = int((q.alive & ~c.ledger.alive).sum())
        if written == 0:
            raise AssertionError(f"insert on {what}: no candidate written")
        strides = sorted({tuple(v.stride()) for v in c.cand.values()})
        seen.append(f"{c.m} shard(s) in one pass, {tuple(c.valid.shape)} candidates, "
                    f"{written} written, {drops.tolist()} dropped, {q.x.dtype}, candidate "
                    f"strides {strides}")
    return f"{what}: " + "; ".join(seen)


def migration_insert_check(dev, c: RecordedInsert, smi) -> None:
    """A recorded migration round's insert over every local shard (one pass of the
    kernel) timed against its plain version (a shard at a time) and against the
    parent's destinations, a shard at a time (``parent_insert_parts``, every part
    in one call; its writes not counted), beside its bound; the destinations of
    every shard the stable sort's."""
    from jaybenne_tpu_torch import particles
    from jaybenne_tpu_torch.parallel import sharding

    nc = c.valid.shape[0] // c.m
    shards = sharding.split_ledger(c.ledger, c.m)
    valid = [c.valid[s * nc:(s + 1) * nc] != 0 for s in range(c.m)]
    parent = [parent_insert_parts(p, v, p.absorbed) for p, v in zip(shards, valid)]
    for p, v, (dest, _, _) in zip(shards, valid, parent):
        if not torch.equal(particles.insert_destinations(p, v, p.absorbed)[0], dest):
            raise AssertionError("migration insert: destinations differ from the stable sort's")
    ms = timed_ms(lambda x: replay_insert(c, x), dev, c.ledger.clone)
    plain_ms = timed_ms(lambda x: replay_insert(c, x, plain=True), dev, c.ledger.clone)

    def parent_dests(_):
        for p, v in zip(shards, valid):
            parent_insert_parts(p, v, p.absorbed)

    parent_ms = timed_ms(parent_dests, dev)
    split = launch_split(lambda x: replay_insert(c, x), c.ledger.clone, INSERT_LAUNCHES)
    q = c.ledger.clone()
    drops = replay_insert(c, q)
    written = int((q.alive & ~c.ledger.alive).sum())
    bound = insert_bound(c.ledger, c.cand, c.valid, written, True)
    print(f"insert of a migration round's arrivals at 8 shards ({c.ledger.capacity} slots, "
          f"{c.valid.shape[0]} candidates, {int((c.valid != 0).sum())} valid, {written} "
          f"written, {drops.tolist()} dropped; {smi}): one pass over every shard {ms!r} ms, "
          f"its plain version {plain_ms!r} ms, bound {bound!r} ms (bytes), the kernel at "
          f"{bound / ms:.3f} of it; device ms by launch (torch.profiler) {split}; the "
          f"parent's destinations, a shard at a time "
          f"{parent_ms!r} ms (its eight write launches after them)", flush=True)


def insert_paths_check(dev, outdir, smi) -> None:
    """The insert kernel bitwise its plain version at the shapes the main paths
    give it: stepdiff's initial thermal source (a [blocks x cells, candidates a
    cell] grid whose per-cell columns are broadcast with stride 0), the first
    migration arrivals of the 8-shard spatial step (every shard in one pass, with
    ``reserved``, carrying face and leak; then timed, ``migration_insert_check``),
    and stepdiff's initial source at precision = f64 (8-byte columns)."""
    from jaybenne_tpu_torch import driver

    def run(mods, nlim):
        return lambda: driver.run_file(DECK, outdir=outdir, modified_inputs=mods, quiet=True,
                                       nlim=nlim, device="cuda", graph=False)

    checks = (
        ("stepdiff's initial source", run(GATE, 0), lambda c: True, 1),
        ("the 8-shard spatial step's migration arrivals",
         run({**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8}, 1), lambda c: "face" in c, 2),
        ("stepdiff's initial source at precision = f64", run({**GATE, **PREC64}, 0),
         lambda c: True, 1),
    )
    for what, fn, want, keep in checks:
        calls = recorded_inserts(fn, want, keep)
        print("insert kernel bitwise its plain version, " + inserts_bitwise(calls, what),
              flush=True)
        if calls[0].m > 1:
            migration_insert_check(dev, calls[0], smi)
        torch.cuda.empty_cache()


class RecordedMigration(typing.NamedTuple):
    """One migration round as a run made it (``spatial.migrate``'s arguments): a
    clone of the local shards' joined ledger before it, their offsets, the blocks a
    shard, K, the shard count and a clone of the round's ``go`` flag (None: the
    round of a batch that began with work)."""

    ledger: object
    offsets: list
    bl: int
    K: int
    n: int
    go: object


def recorded_migrations(run, keep):
    """The first ``keep`` rounds of ``spatial.migrate`` that ``run()`` makes, as
    ``RecordedMigration``s; the rounds run as they would."""
    from jaybenne_tpu_torch.parallel import spatial
    from jaybenne_tpu_torch.particles import join_slices

    calls, real = [], spatial.migrate

    def recording(ledgers, offsets, bl, K, exchange, go=None, plain=False, work=None):
        if len(calls) < keep:
            calls.append(RecordedMigration(join_slices(ledgers)[0].clone(), list(offsets), bl,
                                           K, exchange.n, None if go is None else go.clone()))
        return real(ledgers, offsets, bl, K, exchange, go, plain, work)

    spatial.migrate = recording
    try:
        run()
    finally:
        spatial.migrate = real
    return calls


# ``go`` of a replayed round: the recorded round's own
RECORDED = "the recorded round's"


def replay_migration(c: RecordedMigration, ledger, plain=False, go=RECORDED, work=None):
    """A recorded round on ``ledger`` (a clone of its own), by the migration
    kernel (with the scratch ``work``, None: a fresh one) or by its plain
    version, through the in-process exchange and the insert: returns (dropped,
    sent), one a local shard."""
    from jaybenne_tpu_torch.parallel import exchange, sharding, spatial

    m = len(c.offsets)
    return spatial.migrate(sharding.split_ledger(ledger, m), c.offsets, c.bl, c.K,
                           exchange.InProcess(c.n), c.go if go is RECORDED else go, plain,
                           work)


def pack_of(c: RecordedMigration, ledger, plain=False, go=RECORDED, work=None):
    """A recorded round's sort and pack alone on ``ledger``: the kernel's
    (``spatial._pack_cuda``, with the scratch ``work``, None: a fresh one) or the
    plain version's (``spatial.pack_plain``, stacked as the in-process exchange
    stacks them) buffers, in the receivers' layout [n, local shards, K, words],
    their valid flags ([n, local shards, K]; the plain buffers' valid column) and
    sent counts."""
    from jaybenne_tpu_torch.parallel import sharding, spatial

    m, go = len(c.offsets), c.go if go is RECORDED else go
    shards = sharding.split_ledger(ledger, m)
    if plain:
        bufs, sent = spatial.pack_plain(shards, c.offsets, c.bl, c.K, c.n, go)
        buf = torch.stack(bufs, dim=1)
        return buf, buf[..., -1] == 1, sent
    return spatial._pack_cuda(shards, c.offsets, c.bl, c.K, c.n, go, work)


def migrations_bitwise(calls, what) -> str:
    """Each recorded round (``recorded_migrations``), and each again with ``go``
    false, by the kernel and by its plain version on clones of its ledger: raises
    unless the ledgers after the pack and after the whole round, the sent and
    dropped counts, the flags and the plain buffers' valid column, and every
    buffer row whose flag is set are bitwise equal, and the kernel launched once
    a round. Returns what was held, as text."""
    from jaybenne_tpu_torch.ops import cuda_lib

    if not calls:
        raise AssertionError(f"migration on {what}: no round recorded")
    seen = []
    for c in calls:
        for go in (RECORDED, torch.zeros((), dtype=torch.bool, device=c.ledger.alive.device)):
            q, r = c.ledger.clone(), c.ledger.clone()
            before = cuda_lib.LAUNCHES["migrate_pack"]
            buf, flags, sent = pack_of(c, q, go=go)
            if cuda_lib.LAUNCHES["migrate_pack"] != before + 1:
                raise AssertionError(f"migration on {what}: the kernel did not launch once")
            want, valid, plain_sent = pack_of(c, r, plain=True, go=go)
            if (not torch.equal(sent, plain_sent) or not torch.equal(flags, valid)
                    or not torch.equal(buf[valid], want[valid])):
                raise AssertionError(f"migration on {what}: the buffers, flags or sent counts "
                                     f"differ ({sent.tolist()} vs {plain_sent.tolist()})")
            equal_ledgers(q, r, f"migration pack on {what} against the plain version")
            q, r = c.ledger.clone(), c.ledger.clone()
            drops = replay_migration(c, q, go=go)
            plain_drops = replay_migration(c, r, plain=True, go=go)
            equal_ledgers(q, r, f"migration round on {what} against the plain version")
            if not all(torch.equal(a, b) for a, b in zip(drops, plain_drops)):
                raise AssertionError(f"migration on {what}: counts {drops} vs {plain_drops}")
            if go is RECORDED:
                if int(sent.sum()) == 0:
                    raise AssertionError(f"migration on {what}: nothing sent")
                line = (f"{len(c.offsets)} shards of {c.n} in one pass, {c.ledger.capacity} "
                        f"slots, K {c.K}, go {'None' if c.go is None else bool(c.go)}, "
                        f"{int(sent.sum())} sent, {int(drops[0].sum())} dropped, "
                        f"{c.ledger.x.dtype}; with go false nothing sent or changed")
            if go is not RECORDED and (int(sent.sum()) or int(valid.sum())):
                raise AssertionError(f"migration on {what}: a round with go false sent")
        seen.append(line)
    return f"{what}: " + "; ".join(seen)


# the migration kernel's launch (csrc/migrate_kernel.cu), by kernel name
MIGRATE_LAUNCHES = ("migrate_kernel",)


def migration_bound(c: RecordedMigration, sent) -> float:
    """The least ms of a round's sort and pack on the card (bytes / PEAK_BYTES):
    every slot's alive flag and block read once, the sent slots' columns read,
    their rows written and their alive flags cleared, and a byte of flags for
    each row of the [n, local shards, K] buffers."""
    from jaybenne_tpu_torch.parallel import spatial

    p = c.ledger
    cols = sum(getattr(p, name).element_size() for name in spatial.MIGRATE_FIELDS)
    rows = len(c.offsets) * c.n * c.K
    row = 4 * spatial.row_words(p)
    return (p.capacity * 5 + sent * (cols + row + 1) + rows) / PEAK_BYTES * 1e3


def migration_sector_bound(c: RecordedMigration, sent) -> float:
    """``migration_bound`` with the sent slots' column reads and alive clears
    counted in 32-byte sectors (each of a sent slot's 15 columns in a sector of
    its own, and its alive byte too: the slots leaving a tile are scattered), the
    least the card could take for the reads a round's scattered slots make."""
    from jaybenne_tpu_torch.parallel import spatial

    p = c.ledger
    rows = len(c.offsets) * c.n * c.K
    row = 4 * spatial.row_words(p)
    scattered = 32 * (len(spatial.MIGRATE_FIELDS) + 1)
    return (p.capacity * 5 + sent * (scattered + row) + rows) / PEAK_BYTES * 1e3


def work_by_kernel(fn, fresh, top=8, repeats=CENSUS_REPEATS) -> dict:
    """The mean device ms a call of ``fn(fresh())`` by kernel, copy and memset
    (the function's own name, without namespaces, template or parameters), the
    ``top`` largest."""
    out = {}
    for name, us in traced_launches(fn, fresh, repeats):
        short = name.replace("(anonymous namespace)", "").replace("void ", "")
        short = short.split("<")[0].split("(")[0].split("::")[-1].strip() or name
        out[short] = out.get(short, 0.0) + us / 1e3 / repeats
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def device_ms(fn, fresh, repeats=CENSUS_REPEATS) -> float:
    """The mean device ms a call of all the work of ``fn(fresh())`` (every kernel,
    copy and memset a ``torch.profiler`` trace holds), ``fresh()``'s own work left
    out."""
    return sum(us for _, us in traced_launches(fn, fresh, repeats)) / 1e3 / repeats


def migration_reading(dev, c: RecordedMigration, what, smi) -> dict:
    """A recorded round read apart (``what``; printed): the kernel's sort and pack
    (its one launch, device ms by launch with the launches the trace holds, and
    the window between CUDA events after a device sleep) against its bound in
    bytes and in sectors, the kernel's whole round (the pack and the insert, by
    kernel) and the plain version's (``spatial.migrate(plain=True)``), each timed
    alone, the plain round by kernel, the same round with ``go`` false by both,
    and, for comparison, the round's bookkeeping before and after the count
    kernel (``round_bookkeeping``). The kernel's calls share one scratch, as a
    step's rounds do. Returns the numbers."""
    from jaybenne_tpu_torch.parallel import sharding, spatial

    fresh = c.ledger.clone
    falsy = torch.zeros((), dtype=torch.bool, device=dev)
    m = len(c.offsets)
    work = spatial.MigrateScratch().reserve(m, c.ledger.capacity // m, c.n, dev)
    _, _, sent = pack_of(c, c.ledger.clone(), work=work)
    n_sent = int(sent.sum())

    def pack(x, go=RECORDED):
        return pack_of(c, x, go=go, work=work)

    def rnd(x, go=RECORDED):
        return replay_migration(c, x, go=go, work=work)

    def by_launch(fn, traces=3):
        """launch_split, again where a trace late in a long process held none."""
        for _ in range(traces):
            split = launch_split(fn, fresh, MIGRATE_LAUNCHES)
            if all(split["traced"].values()):
                break
        return split

    out = {
        "pack_ms": timed_ms(pack, dev, fresh),
        "pack_plain_ms": timed_ms(lambda x: pack_of(c, x, plain=True), dev, fresh),
        "pack_device_ms": by_launch(pack),
        "pack_go_false_device_ms": by_launch(lambda x: pack(x, falsy)),
        "round_ms": timed_ms(rnd, dev, fresh),
        "round_plain_ms": timed_ms(lambda x: replay_migration(c, x, plain=True), dev, fresh),
        "round_device_ms": device_ms(rnd, fresh),
        "round_by_kernel": work_by_kernel(rnd, fresh),
        "round_plain_device_ms": device_ms(lambda x: replay_migration(c, x, plain=True), fresh),
        "round_plain_by_kernel": work_by_kernel(lambda x: replay_migration(c, x, plain=True),
                                                fresh),
        "go_false_ms": timed_ms(lambda x: rnd(x, falsy), dev, fresh),
        "go_false_plain_ms": timed_ms(lambda x: replay_migration(c, x, plain=True, go=falsy),
                                      dev, fresh),
        "go_false_device_ms": device_ms(lambda x: rnd(x, falsy), fresh),
        "go_false_plain_device_ms": device_ms(
            lambda x: replay_migration(c, x, plain=True, go=falsy), fresh),
        "bound_ms": migration_bound(c, n_sent),
        "sector_bound_ms": migration_sector_bound(c, n_sent), "sent": n_sent,
    }
    ps = sharding.split_ledger(c.ledger.clone(), m)
    out.update(round_bookkeeping(dev, ps, c.n))
    print(f"migration round, {what} ({m} local shards of {c.n}, "
          f"{c.ledger.capacity} slots, {int(c.ledger.alive.sum())} live, K {c.K}, "
          f"{spatial.row_words(c.ledger)} words a row, {n_sent} sent; {smi}): the kernel's sort "
          f"and pack {out['pack_ms']!r} ms (device ms by launch {out['pack_device_ms']}; with "
          f"go false {out['pack_go_false_device_ms']}), bound {out['bound_ms']!r} ms (bytes, a "
          f"byte a flag), at {out['bound_ms'] / out['pack_ms']:.3f} of it; "
          f"{out['sector_bound_ms']!r} ms with the sent slots' column reads in 32-byte "
          f"sectors; the plain pack {out['pack_plain_ms']!r} ms; the whole round (pack, "
          f"insert) {out['round_ms']!r} ms ({out['round_device_ms']!r} on the device, by kernel "
          f"{out['round_by_kernel']}), the plain version's {out['round_plain_ms']!r} ms "
          f"({out['round_plain_device_ms']!r}); with go false {out['go_false_ms']!r} ms "
          f"({out['go_false_device_ms']!r}), the plain version's {out['go_false_plain_ms']!r} ms "
          f"({out['go_false_plain_device_ms']!r}); the plain round by kernel "
          f"{out['round_plain_by_kernel']} ms; for comparison the "
          f"round's bookkeeping on the device: before the count kernel (the z route's kept "
          f"clones and their torch.where, the gated counters, the unfinished sums) "
          f"{out['bookkeeping_before_device_ms']!r} ms in "
          f"{out['bookkeeping_before_launches']!r} device operations a round, of it the kept "
          f"clones {out['kept_device_ms']!r} and the unfinished sums "
          f"{out['unfinished_device_ms']!r}; with it (one round_counts launch) "
          f"{out['bookkeeping_after_device_ms']!r} ms in "
          f"{out['bookkeeping_after_launches']!r}", flush=True)
    return out


def round_bookkeeping(dev, ps, n, max_iters=1000) -> dict:
    """A spatial round's bookkeeping over the local shards' ledgers ``ps`` (adjacent
    slices, ``n`` shards in this process) on the device (torch.profiler, the mean
    of CENSUS_REPEATS calls): the parent's, the z route's kept clones of seven
    columns put back by ``torch.where``, the census's counters gated by
    ``torch.where``, the accumulators' adds, each shard's unfinished sum summed by
    the in-process exchange and the round's count (its kept clones and unfinished
    sums also alone); and this tree's, one launch of the count kernel
    (``counts.round_counts``). Device ms and device operations a round of each."""
    import types

    from jaybenne_tpu_torch.ops import counts
    from jaybenne_tpu_torch.parallel import exchange
    from jaybenne_tpu_torch.particles import join_slices

    m = len(ps)
    joined = join_slices(ps)[0]
    go = torch.ones((), dtype=torch.bool, device=dev)

    def z(dtype=torch.int64):
        return torch.zeros(m, dtype=dtype, device=dev)

    it, ev, drop, sent = z(torch.int32), z(), z(), z()
    acc = types.SimpleNamespace(iters=z(torch.int32), events=z(), hits=z(), dropped=z(),
                                sent=z(), rounds=torch.zeros((), dtype=torch.int64, device=dev),
                                unfinished=torch.zeros((), dtype=torch.int64, device=dev))

    def kept_columns():
        cols = (joined.x, joined.y, joined.z, joined.i, joined.j, joined.k, joined.block)
        old = [(x, x.clone()) for x in cols]
        for x, y in old:
            torch.where(go, x, y, out=x)

    def unfinished():
        return exchange.InProcess(n).sum([(p.alive & (p.tau < 1.0)).sum(dtype=torch.int64)
                                          for p in ps])[0]

    def before(_):
        kept_columns()
        hit = it >= max_iters
        i, e, hit = torch.where(go, it, 0), torch.where(go, ev, 0), hit & go
        acc.iters.add_(i)
        acc.events.add_(e)
        acc.hits.add_(hit.to(torch.int64))
        acc.dropped.add_(drop)
        acc.sent.add_(sent)
        acc.unfinished.copy_(unfinished())
        acc.rounds.add_(go.to(torch.int64))

    work = counts.scratch(m, dev)

    def after(_):
        counts.round_counts(ps, acc, it, ev, drop, sent, go, max_iters, work)

    out = {}
    for key, fn in (("bookkeeping_before", before), ("bookkeeping_after", after)):
        for _ in range(3):  # a trace late in a long process can hold none of them
            ops = traced_launches(fn, lambda: None, CENSUS_REPEATS)
            if ops:
                break
        out[f"{key}_device_ms"] = (sum(us for _, us in ops) / 1e3 / CENSUS_REPEATS if ops
                                   else None)
        out[f"{key}_launches"] = len(ops) / CENSUS_REPEATS if ops else None
    out["kept_device_ms"] = device_ms(lambda _: kept_columns(), lambda: None)
    out["unfinished_device_ms"] = device_ms(lambda _: unfinished(), lambda: None)
    return out


def migration_check(dev, outdir, smi) -> dict:
    """The migration kernel (csrc/migrate_kernel.cu) bitwise its plain version on
    the recorded first rounds of the 8-shard spatial step (big_mesh_spatial; and a
    later round of a batch, whose ``go`` is a device flag) and of the float64
    stepdiff at 8 spatial shards, each again with ``go`` false; its first round
    read apart (``migration_reading``). Returns the kernel's ``kernels`` entry,
    the launches left to the caller."""
    from jaybenne_tpu_torch import driver

    def run(mods):
        return lambda: driver.run_file(DECK, outdir=outdir, modified_inputs=mods, quiet=True,
                                       nlim=1, device="cuda", graph=False)

    big = recorded_migrations(run({**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8}), 2)
    f64 = recorded_migrations(run({**STEPDIFF_SPATIAL, **PREC64}), 1)
    for what, calls in (("big_mesh_spatial at 8 shards", big),
                        ("stepdiff at 8 spatial shards, f64", f64)):
        print("migration kernel bitwise its plain version, " + migrations_bitwise(calls, what),
              flush=True)
    if big[1].go is None:
        raise AssertionError("migration: the second round of a batch has no go flag")
    r = migration_reading(dev, big[0], "big_mesh_spatial at 8 shards, its first round", smi)
    migration_reading(dev, f64[0], "stepdiff at 8 spatial shards in float64, its first round",
                      smi)
    torch.cuda.empty_cache()
    return {
        "name": "migrate_pack (the spatial migration's sort and pack: each local shard's "
                "in-transit slots ranked by destination by a single-pass scan with a decoupled "
                "look-back and packed into rows, the valid flags apart, every local shard in "
                "one launch a round)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/migrate_kernel.cu",
        "replaces": "jaybenne_tpu/parallel/spatial.py:77-138 (migrate: XLA's stable argsort, "
                    "searchsorted and scatters) with jaybenne_tpu/ops/pallas_grid.py:554-578 "
                    "(_pack_cols' row gather), no Pallas kernel",
        "max_abs_err": 0.0, "ms": r["pack_ms"],
        "device_ms": (r["pack_device_ms"][MIGRATE_LAUNCHES[0]]
                      if r["pack_device_ms"]["traced"][MIGRATE_LAUNCHES[0]] else None),
        "plain_ms": r["pack_plain_ms"], "bound_ms": r["bound_ms"],
        "sector_bound_ms": r["sector_bound_ms"], "bound_by": "bytes", "library_ms": None,
    }


# the migration kernel's launches in each counted spatial path's run (its counts
# set to 0 just before it and read just after), for its entry of the kernels line
MIGRATE_PATHS = []
# the migration kernel's and the count kernel's launches in phase 30's 8-shard
# big_mesh_spatial run
MIGRATE_MAIN = [0]
COUNTS_MAIN = [0]


@contextlib.contextmanager
def exit_reads_counted(spatial_mod):
    """While active, each spatial batch's exit read (``spatial._exit_read``) is
    counted in the yielded list's one entry, and runs with synchronisation allowed
    whatever the debug mode."""
    reads, real = [0], spatial_mod._exit_read

    def counted(t):
        reads[0] += 1
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(t)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    spatial_mod._exit_read = counted
    try:
        yield reads
    finally:
        spatial_mod._exit_read = real


def graph_phase(dev, smi) -> tuple:
    """Phase 45: the step without the host. Returns the insert kernel's and the
    migration kernel's ``kernels`` entries (``insert_check``, ``migration_check``)."""
    from jaybenne_tpu_torch import driver
    from jaybenne_tpu_torch import profile as profile_mod
    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.parallel import spatial as spatial_mod
    from jaybenne_tpu_torch.step import STAT_NAMES

    phase("45 the step without the host: each path with the eager step and with the CUDA "
          "graph, bitwise after every step; a replay and the spatial step under "
          "set_sync_debug_mode('error'); host synchronisations and step wall times")
    # a registered generator: a replay after manual_seed draws what the eager
    # draw after the same manual_seed does
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise AssertionError(f"torch {torch.__version__}: no CUDAGraph.register_generator_state")
    gen = torch.Generator(device=dev)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    gen.manual_seed(1)
    with torch.cuda.graph(graph):
        drawn = torch.rand(1 << 16, generator=gen, device=dev)
    for seed in (12345, 67890):
        gen.manual_seed(seed)
        graph.replay()
        gen.manual_seed(seed)
        if not bitwise_equal(drawn, torch.rand(1 << 16, generator=gen, device=dev)):
            raise AssertionError(f"a replay after manual_seed({seed}) draws other numbers")
    del graph
    print(f"torch {torch.__version__}: CUDAGraph.register_generator_state; a replay after "
          "manual_seed draws bitwise what the eager draw does", flush=True)
    walls = {}
    with tempfile.TemporaryDirectory() as outdir:
        for what, deck, mods, steps in GRAPH_PATHS:
            sims = [driver.run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True,
                                    nlim=0, device="cuda", graph=g) for g in (False, True)]
            eager, graph = sims
            if eager.graphed or not graph.graphed:
                raise AssertionError(f"{what}: graph {eager.graphed}, {graph.graphed}")
            kinds, caps = [], []
            for _ in range(steps):
                launches = []
                for sim in sims:
                    cuda_lib.LAUNCHES.clear()
                    before = sim.step_fn.captures if sim.graphed else 0
                    sim.run(nlim=1)
                    launches.append(dict(cuda_lib.LAUNCHES))
                kinds.append("eager" if len(graph.history) == 1 else
                             "capture" if graph.step_fn.captures > before else "replay")
                caps.append(graph.state.particles.capacity)
                if launches[0] != launches[1]:
                    raise AssertionError(f"{what}: launches {launches} at cycle {graph.cycle}")
                same_states(eager, graph, what)
            if kinds.count("replay") < 1:
                raise AssertionError(f"{what}: no replay in {kinds}")
            grown = [k for k in range(1, steps) if caps[k] != caps[k - 1]]
            if "growing" in what and not any(kinds[k] == "capture" and k >= 2 for k in grown):
                raise AssertionError(f"{what}: no capture after the ledger grew: {kinds}, {caps}")
            # one more replay, with every synchronisation an error but a spatial
            # batch's exit read (counted)
            dt = graph.history[-1]["dt"]  # its graphs hold the state's tensors
            captures = graph.step_fn.captures
            with exit_reads_counted(spatial_mod) as reads:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    if graph.shards is None:
                        graph._state, stats = graph.step_fn(graph.state, dt)
                    else:
                        graph.shards, stats = graph.step_fn(graph.shards, dt)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            if graph.step_fn.captures != captures:
                raise AssertionError(f"{what}: the last step captured, it did not replay")
            rounds = dict(zip(STAT_NAMES, stats.packed.tolist()))["migration_rounds"]
            if graph.spatial and reads[0] != batches_of(graph, rounds):
                raise AssertionError(f"{what}: {reads[0]} exit reads for {rounds} rounds")
            if not graph.spatial and reads[0]:
                raise AssertionError(f"{what}: {reads[0]} exit reads in a step with no rounds")
            ew = [h["step_seconds"] for h in eager.history[1:]]
            gw = [h["step_seconds"] for h, k in zip(graph.history, kinds) if k == "replay"]
            walls[what] = (ew, gw)
            print(f"{what}: {steps} steps eager and graph, every field, ledger column, "
                  f"counter and overflow bitwise equal after every step, launches equal "
                  f"({launches[1]} in the last step); steps {kinds}, {graph.step_fn.captures} "
                  f"captures, capacities {caps}; a replay under set_sync_debug_mode('error') "
                  f"ran" + (f", {rounds} rounds in {reads[0]} batches, one exit read each"
                            if graph.spatial else ""), flush=True)
            if what == "the 64^3 feedback row":
                insert = insert_check(dev, graph, smi)
                insert_paths_check(dev, outdir, smi)
                migration = migration_check(dev, outdir, smi)
            del sims, eager, graph
            torch.cuda.empty_cache()

        # the 8-shard spatial step, eager and replayed: only each batch's exit read
        # and the step's packed read may synchronise
        mods = {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8}
        for g in (False, True):
            sim = driver.run_file(DECK, outdir=outdir, modified_inputs=mods, quiet=True,
                                  nlim=2, device="cuda", graph=g)  # eager, then captured
            rounds, batches = 0, 0
            dt = sim.cfg.jaybenne.dt
            with exit_reads_counted(spatial_mod) as reads:
                try:
                    for _ in range(BIG_SPATIAL_STEPS):
                        torch.cuda.set_sync_debug_mode("error")
                        sim.shards, stats = sim.step_fn(sim.shards, dt)
                        torch.cuda.set_sync_debug_mode("default")
                        r = dict(zip(STAT_NAMES, stats.packed.tolist()))["migration_rounds"]
                        rounds += r
                        batches += batches_of(sim, r)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            if reads[0] != batches:
                raise AssertionError(f"spatial: {reads[0]} exit reads for {batches} batches")
            print(f"big_mesh_spatial at 8 shards ({'CUDA graphs' if sim.graphed else 'eager'}"
                  f"), {BIG_SPATIAL_STEPS} steps under set_sync_debug_mode('error'): {rounds} "
                  f"rounds in {batches} batches of {spatial_core(sim).rounds_per_batch}, "
                  f"{reads[0]} exit reads "
                  f"(one a batch), and one packed read a step", flush=True)
            del sim

        # host synchronisations a step, as profile.py counts them (the driver's one
        # synchronisation a step among them)
        for what, deck, mods in (("stepdiff", DECK, GATE), ("the 64^3 feedback row", DECK,
                                                            FEEDBACK),
                                 ("Su-Olson", SUOLSON_DECK, SUOLSON),
                                 ("big_mesh_spatial at 8 shards", DECK,
                                  {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8})):
            sim = driver.run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True,
                                  nlim=2, device="cuda")
            n0 = len(sim.history)
            syncs = profile_mod.host_syncs(sim, SYNC_STEPS)
            hist = sim.history[n0:]
            rounds = sum(h["migration_rounds"] for h in hist)
            per_round = f", {syncs / rounds!r} a round ({rounds} rounds)" if rounds else ""
            if what == "Su-Olson" and syncs:
                raise AssertionError(f"Su-Olson: {syncs} host synchronisations in {len(hist)} "
                                     "steps")
            print(f"host synchronisations, {what} ({'CUDA graphs' if sim.graphed else 'eager'}"
                  f"): {syncs / len(hist)!r} a step{per_round} over {len(hist)} steps; "
                  f"before, the 8-shard spatial step made {SPATIAL_SYNCS_BEFORE[0]} a step, "
                  f"{SPATIAL_SYNCS_BEFORE[1]} a round", flush=True)
            del sim
    for what in GRAPH_TIMED:
        ew, gw = walls[what]
        line = f"step wall ms, {what} ({smi}): "
        for name, w in (("eager", ew), ("graph replay", gw)):
            if w:
                ms = [v * 1e3 for v in w]
                line += (f"{name} median {statistics.median(ms)!r} range [{min(ms)!r}, "
                         f"{max(ms)!r}] over {len(ms)}; ")
        print(line, flush=True)
    return insert, migration


# the tally kernel's three launches and the face kernel's one (csrc/tally_kernel.cu,
# csrc/faces_kernel.cu), by kernel name
TALLY_LAUNCHES = ("tally_exponent_kernel", "tally_sum_kernel", "tally_cell_kernel")
FACE_LAUNCHES = ("face_probs_kernel",)
# phase 46: the paths whose tally calls (the initial radiation's and the first
# step's) the tally kernel is held on bitwise; (what, deck, overrides)
TALLY_PATHS = (
    ("stepdiff", DECK, GATE),
    ("the 64^3 feedback row", DECK, FEEDBACK),
    ("the 64^3 DDMC row", DECK, BIG_DDMC),
    ("stepdiff in float64", DECK, {**GATE, **PREC64}),
    ("stepdiff_smr at 8 particle shards (phase 32's)", SMR_DECK, {**SMR_GATE, **EIGHT}),
    ("big_mesh_spatial at 8 shards (its tail)", DECK,
     {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8}),
)
# the paths whose face probabilities the face kernel is held on bitwise
FACE_PATHS = (
    ("the 64^3 DDMC row (3D, periodic y and z)", DECK, BIG_DDMC),
    ("the 64^3 DDMC row in float64", DECK, {**BIG_DDMC, **PREC64}),
    ("stepdiff_ddmc (1D)", DDMC_DECK, DDMC_GATE),
    ("stepdiff_ddmc in float64", DDMC_DECK, {**DDMC_GATE, **PREC64}),
    ("the native hybrid's refined forest (phase 21's)", HYBRID_DECK, NATIVE_HYBRID),
    ("stepdiff_smr_ddmc's refined forest", SMR_DDMC_DECK, SMR_GATE),
    ("stepdiff_smr_ddmc's refined forest in float64", SMR_DDMC_DECK, {**SMR_GATE, **PREC64}),
    ("the 8-shard spatial head (phase 33's SMR+DDMC deck), from the all-gathered surfaces",
     SMR_DDMC_DECK, {**SMR_SPATIAL, **SPATIAL, "jaybenne/n_devices": 8}),
)
# the steps profile.py reads (device time by kernel; the 64^3 DDMC row eagerly too,
# by span); (what, deck, overrides, eager)
PROFILED_STEPS = (
    ("the 64^3 DDMC row", DECK, BIG_DDMC, False),
    ("the 64^3 DDMC row, eager (by span)", DECK, BIG_DDMC, True),
    ("stepdiff", DECK, GATE, False),
    ("the 64^3 feedback row", DECK, FEEDBACK, False),
)


class RecordedTally(typing.NamedTuple):
    """One pass of the tally kernel as a run made it (``tally._tally_cuda``'s
    arguments): copies of each shard's tally and energy_delta, a clone of the local
    shards' joined ledger, the shard count and the rest as given."""

    fields: list
    ledger: object
    m: int
    mesh: object
    deposit: bool
    exchange: object
    block_offsets: object


def recorded_tallies(run) -> list:
    """Every pass of the tally kernel that ``run()`` makes, as ``RecordedTally``s;
    the run goes on as it would."""
    from jaybenne_tpu_torch.ops import tally
    from jaybenne_tpu_torch.particles import join_slices

    calls, real = [], tally._tally_cuda

    def recording(fields, particles, mesh, deposit, exchange=None, block_offsets=None):
        calls.append(RecordedTally(
            [dataclasses.replace(f, energy_tally=f.energy_tally.clone(),
                                 energy_delta=f.energy_delta.clone()) for f in fields],
            join_slices(particles)[0].clone(), len(particles), mesh, deposit, exchange,
            None if block_offsets is None else list(block_offsets)))
        return real(fields, particles, mesh, deposit, exchange, block_offsets)

    tally._tally_cuda = recording
    try:
        run()
    finally:
        tally._tally_cuda = real
    return calls


def replay_tally(c: RecordedTally, plain=False) -> list:
    """A recorded pass by the kernel, or by its plain version
    (``tally.tallies(plain=True)``): each shard's fields."""
    from jaybenne_tpu_torch.ops import tally
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    ps = split_ledger(c.ledger, c.m) if c.m > 1 else [c.ledger]
    if plain:
        return tally.tallies(c.fields, ps, c.mesh, c.deposit, c.exchange, c.block_offsets,
                             plain=True)
    return tally._tally_cuda(c.fields, ps, c.mesh, c.deposit, c.exchange, c.block_offsets)


def tally_bound(c: RecordedTally) -> float:
    """The least ms of a pass on the card (bytes / PEAK_BYTES): every slot's flags
    read once (alive, and absorbed with the deposit), the weight, block and cell
    of each slot that contributes (alive, or absorbed with the deposit, in its
    shard's own blocks), and each shard's tally written (and its energy_delta read
    and written with the deposit)."""
    p = c.ledger
    used = (p.alive | p.absorbed) if c.deposit else p.alive
    if c.block_offsets is not None:
        bl = c.fields[0].energy_tally.shape[0]
        g = torch.arange(p.capacity, device=p.block.device) // (p.capacity // c.m)
        local = p.block.long() - (c.block_offsets[0] + g * bl)
        used = used & (local >= 0) & (local < bl)
    flags = p.capacity * (2 if c.deposit else 1)
    slots = int(used.sum()) * (p.weight.element_size() + 16)
    t = c.fields[0].energy_tally
    cells = c.m * t.numel() * t.element_size() * (3 if c.deposit else 1)
    return (flags + slots + cells) / PEAK_BYTES * 1e3


def tallies_bitwise(calls, what) -> str:
    """Each recorded pass by the kernel and by its plain version: raises unless
    every shard's tally and energy_delta are bitwise equal and the kernel's three
    launches were counted. Returns what was held, as text."""
    from jaybenne_tpu_torch.ops import cuda_lib

    if not calls:
        raise AssertionError(f"tally on {what}: no call recorded")
    seen = []
    for c in calls:
        before = cuda_lib.LAUNCHES["tally"]
        got = replay_tally(c)
        if cuda_lib.LAUNCHES["tally"] != before + 3:
            raise AssertionError(f"tally on {what}: the kernel did not launch its three")
        want = replay_tally(c, plain=True)
        for s, (k, w) in enumerate(zip(got, want)):
            for name in ("energy_tally", "energy_delta"):
                if not bitwise_equal(getattr(k, name), getattr(w, name)):
                    raise AssertionError(f"tally on {what}: shard {s}'s {name} differs")
        kind = ("spatial" if c.block_offsets is not None else
                "particle" if c.exchange is not None else "one device")
        seen.append(f"{c.m} shard(s) in one pass ({kind}), {c.ledger.capacity} slots, "
                    f"{int(c.ledger.alive.sum())} alive, {int(c.ledger.absorbed.sum())} "
                    f"absorbed, {c.fields[0].energy_tally.numel()} cells a shard, "
                    f"{'deposit and tally' if c.deposit else 'tally'}, {c.ledger.weight.dtype}")
    return f"{what}: " + "; ".join(seen)


class RecordedFaces(typing.NamedTuple):
    """One launch of the face kernel as a run made it (``fleck._faces_cuda``'s
    arguments, sigma_t and the surfaces copied with their strides)."""

    mesh: object
    sigmas: list
    surfs: object
    offsets: list
    tau: float
    periodic: tuple
    dtype: object


def recorded_faces(run) -> list:
    """Every launch of the face kernel that ``run()`` makes, as ``RecordedFaces``."""
    from jaybenne_tpu_torch.ops import fleck

    calls, real = [], fleck._faces_cuda

    def recording(mesh, sigmas, surfs, offsets, tau, periodic, dtype):
        calls.append(RecordedFaces(mesh, [kept(t) for t in sigmas],
                                   None if surfs is None else [kept(g) for g in surfs],
                                   list(offsets), tau, tuple(periodic), dtype))
        return real(mesh, sigmas, surfs, offsets, tau, periodic, dtype)

    fleck._faces_cuda = recording
    try:
        run()
    finally:
        fleck._faces_cuda = real
    return calls


def replay_faces(c: RecordedFaces, plain=False) -> list:
    """A recorded launch by the kernel, or by its plain version
    (``ddmc_face_probs`` or ``ddmc_face_probs_spatial``, a shard at a time)."""
    from jaybenne_tpu_torch.ops import fleck

    if plain and c.surfs is None:
        return [fleck.ddmc_face_probs(c.mesh, c.sigmas[0], c.tau, c.periodic, c.dtype,
                                      plain=True)]
    if plain:
        return fleck.ddmc_face_probs_shards(c.mesh, c.sigmas, c.surfs, c.offsets, c.tau,
                                            c.periodic, c.dtype, plain=True)
    return fleck._faces_cuda(c.mesh, c.sigmas, c.surfs, c.offsets, c.tau, c.periodic, c.dtype)


def faces_bound(c: RecordedFaces) -> float:
    """The least ms of a launch on the card (bytes / PEAK_BYTES): each shard's
    sigma_t read once (one value where it is broadcast), the all-gathered surfaces
    once, and each shard's faces of its active axes written."""
    t = c.sigmas[0]
    size = t.element_size()
    sig = sum(1 if all(st == 0 for st in s.stride()) else s.numel() for s in c.sigmas)
    surf = 0 if c.surfs is None else len({g.data_ptr() for g in c.surfs}) * c.surfs[0].numel()
    Bl, nz, ny, nx = t.shape
    faces = sum(n for a, n in enumerate((nz * ny * (nx + 1), nz * (ny + 1) * nx,
                                         (nz + 1) * ny * nx)) if a < c.mesh.ndim)
    return (sig + surf + len(c.sigmas) * Bl * faces) * size / PEAK_BYTES * 1e3


def faces_bitwise(calls, what) -> str:
    """Each recorded launch by the kernel and by its plain version: raises unless
    every face array of every shard is bitwise equal and one launch was counted."""
    from jaybenne_tpu_torch.ops import cuda_lib

    if not calls:
        raise AssertionError(f"faces on {what}: no call recorded")
    seen = []
    for c in calls:
        before = cuda_lib.LAUNCHES["ddmc_face_probs"]
        got = replay_faces(c)
        if cuda_lib.LAUNCHES["ddmc_face_probs"] != before + 1:
            raise AssertionError(f"faces on {what}: the kernel did not launch once")
        want = replay_faces(c, plain=True)
        for s, (ks, ws) in enumerate(zip(got, want)):
            for a, (k, w) in enumerate(zip(ks, ws)):
                if not bitwise_equal(k, w):
                    raise AssertionError(f"faces on {what}: shard {s}'s axis {a} differs")
        seen.append(f"{len(c.sigmas)} shard(s) in one launch, {c.mesh.n_blocks} blocks "
                    f"(levels {sorted(set(c.mesh.block_level.tolist()))}), {c.mesh.ndim}D, "
                    f"periodic {c.periodic}, {c.dtype}"
                    + (", the surfaces all-gathered" if c.surfs is not None else ""))
    return f"{what}: " + "; ".join(seen[:2]) + (f"; and {len(seen) - 2} more" if len(seen) > 2
                                                 else "")


def kernel_reading(dev, fn, plain_fn, names, bound, what, smi, traces=3) -> dict:
    """A kernel read apart on a recorded call: device ms a call (torch.profiler:
    the mean launch of each kernel in ``names`` over the launches the trace holds,
    summed; a trace late in a long process can hold none of a kernel's launches,
    so up to ``traces`` are taken, and where none holds every kernel the device ms
    is None, not measured), its event window after a device sleep, the plain
    version's in the same call, its bound."""
    window = timed_ms(lambda _: fn(), dev)
    plain_ms = timed_ms(lambda _: plain_fn(), dev)
    for _ in range(traces):
        split = launch_split(lambda _: fn(), lambda: None, names)
        if all(split["traced"][n] for n in names):
            break
    device = sum(split[n] for n in names) if all(split["traced"][n] for n in names) else None
    share = (f"the kernel at {bound / device:.3f} of it on the device" if device else
             f"device ms not measured: {traces} traces held none of a launch")
    print(f"{what} ({smi}): device ms a call {device!r} (by launch {split}), event window "
          f"{window!r} ms, plain version {plain_ms!r} ms, bound {bound!r} ms (bytes), "
          f"{share}", flush=True)
    return {"device_ms": device, "ms": window, "plain_ms": plain_ms, "bound_ms": bound,
            "split": split}


def tally_faces_readings(dev, smi, which=("tally", "faces")) -> dict:
    """The tally kernel (``"tally"``: on each path of TALLY_PATHS, every pass of a
    step's run, the initial radiation's and the first step's) and the face kernel
    (``"faces"``: every launch on each path of FACE_PATHS) bitwise their plain
    versions, then each read apart (``kernel_reading``) on the path's first step.
    Returns the readings by (kernel, path)."""
    from jaybenne_tpu_torch import driver

    calls = {}
    with tempfile.TemporaryDirectory() as outdir:
        def run(deck, mods):
            return lambda: driver.run_file(deck, outdir=outdir, modified_inputs=mods,
                                           quiet=True, nlim=1, device="cuda", graph=False)

        for what, deck, mods in TALLY_PATHS if "tally" in which else ():
            got = recorded_tallies(run(deck, mods))
            print("tally kernel bitwise its plain version, " + tallies_bitwise(got, what),
                  flush=True)
            calls[("tally", what)] = got[-1]  # the first step's
            torch.cuda.empty_cache()
        for what, deck, mods in FACE_PATHS if "faces" in which else ():
            got = recorded_faces(run(deck, mods))
            print("face kernel bitwise its plain version, " + faces_bitwise(got, what),
                  flush=True)
            calls[("faces", what)] = got[0]
            torch.cuda.empty_cache()
    readings = {}
    for (kind, what), c in calls.items():
        if kind == "tally":
            readings[kind, what] = kernel_reading(
                dev, lambda c=c: replay_tally(c), lambda c=c: replay_tally(c, plain=True),
                TALLY_LAUNCHES, tally_bound(c), f"tally kernel on {what}'s first step", smi)
        else:
            readings[kind, what] = kernel_reading(
                dev, lambda c=c: replay_faces(c), lambda c=c: replay_faces(c, plain=True),
                FACE_LAUNCHES, faces_bound(c), f"face kernel on {what}", smi)
    torch.cuda.empty_cache()
    return readings


def tally_faces_phase(dev, smi) -> tuple:
    """Phase 46: the tally kernel and the face kernel bitwise their plain versions
    on the paths' own inputs, each read apart (``tally_faces_readings``), and the
    steps they change read by profile.py. Returns their ``kernels`` entries, the
    launches left to the caller."""
    from jaybenne_tpu_torch import profile as profile_mod

    phase("46 the tally kernel and the DDMC face kernel: bitwise their plain versions on the "
          "paths' own inputs, read apart; the steps by profile.py")
    readings = tally_faces_readings(dev, smi)
    for what, deck, mods, eager in PROFILED_STEPS:
        print(f"profile.py, {what} ({smi}):", flush=True)
        args = ["-i", deck, "--warm", "2", "--steps", "3"] + (["--eager"] if eager else [])
        profile_mod.main(args + [f"{k}={v}" for k, v in mods.items()])
    torch.cuda.empty_cache()
    t = readings[("tally", "the 64^3 DDMC row")]
    f = readings[("faces", "the 64^3 DDMC row (3D, periodic y and z)")]
    tally_kernel = {
        "name": "tally (the radiation-energy tally and the absorption deposit in fixed point, "
                "bitwise in any order: every local shard's slots in one pass of three launches)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/tally_kernel.cu",
        "replaces": "jaybenne_tpu/ops/tally.py:34-67 (segment_sum in evaluate_radiation_energy "
                    "and accumulate_absorption: XLA, no Pallas kernel)",
        "max_abs_err": 0.0, "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }
    face_kernel = {
        "name": "ddmc_face_probs (the DDMC face probabilities of every local shard's blocks in "
                "one launch, from a side map built once per mesh)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/faces_kernel.cu",
        "replaces": "jaybenne_tpu/ops/fleck.py:70-146 (ddmc_face_probs) and :203-283 "
                    "(ddmc_face_probs_spatial): XLA, no Pallas kernel",
        "max_abs_err": 0.0, "ms": f["ms"], "device_ms": f["device_ms"],
        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }
    return tally_kernel, face_kernel


# the count kernel's launch (csrc/count_kernel.cu), by kernel name
COUNT_LAUNCHES = ("round_counts_kernel",)
# a spatial round's accumulators that the count kernel adds to (spatial.StepTensors)
ACC_NAMES = ("iters", "events", "hits", "dropped", "sent", "rounds", "unfinished")
# phase 47: the paths whose count kernel calls (a round's, kept up to COUNT_ROUNDS,
# and every step's and tail's) are held against the plain version; on the spatial
# ones (gate True) the census gate too, on the recorded rounds; (what, deck,
# overrides, gate)
COUNT_PATHS = (
    ("big_mesh_spatial at 8 shards (transport_3d@z)", DECK,
     {**BIG_MESH, **SPATIAL, "jaybenne/n_devices": 8}, True),
    ("stepdiff at 8 spatial shards in float64 (transport_1d_smr_f64@blocks)", DECK,
     {**STEPDIFF_SPATIAL, **PREC64}, True),
    ("stepdiff at 8 spatial shards (transport_1d_smr@blocks)", DECK, STEPDIFF_SPATIAL, True),
    ("phase 33's SMR+DDMC deck at 8 spatial shards (transport_2d_ddmc_smr@blocks)",
     SMR_DDMC_DECK, {**SMR_SPATIAL, **SPATIAL, "jaybenne/n_devices": 8}, True),
    ("stepdiff", DECK, GATE, False),
    ("the 64^3 DDMC row", DECK, BIG_DDMC, False),
    ("the 64^3 feedback row", DECK, FEEDBACK, False),
    ("stepdiff_smr at 8 particle shards (phase 32's)", SMR_DECK, {**SMR_GATE, **EIGHT}, False),
)
COUNT_ROUNDS = 4


class RecordedCounts(typing.NamedTuple):
    """One call of the count kernel as a run made it (``counts.counts``, or with
    ``acc`` ``counts.round_counts``): a clone of the local shards' joined ledger,
    their number, and for a round clones of the step's accumulators before it
    (``acc``, by ACC_NAMES) and of the round's counts and flag."""

    ledger: object
    m: int
    acc: object = None
    it: object = None
    ev: object = None
    drop: object = None
    sent: object = None
    go: object = None
    max_iters: int = 0


def recorded_counts(run, keep_rounds=COUNT_ROUNDS) -> list:
    """The calls of the count kernel that ``run()`` makes, as ``RecordedCounts``:
    every ``counts.counts`` call and the first ``keep_rounds`` rounds'
    ``counts.round_counts``; the run goes on as it would."""
    from jaybenne_tpu_torch.ops import counts
    from jaybenne_tpu_torch.particles import join_slices

    calls, real, real_round = [], counts.counts, counts.round_counts
    rounds = [0]

    def cloned(t):
        return None if t is None else t.clone()

    def counting(ledgers, work=None, plain=False):
        calls.append(RecordedCounts(join_slices(ledgers)[0].clone(), len(ledgers)))
        return real(ledgers, work, plain)

    def rounding(ledgers, acc, it, ev, drop, sent, go, max_iters, work=None, plain=False):
        if rounds[0] < keep_rounds:
            calls.append(RecordedCounts(
                join_slices(ledgers)[0].clone(), len(ledgers),
                {k: getattr(acc, k).clone() for k in ACC_NAMES}, it.clone(), ev.clone(),
                cloned(drop), cloned(sent), cloned(go), max_iters))
        rounds[0] += 1
        return real_round(ledgers, acc, it, ev, drop, sent, go, max_iters, work, plain)

    counts.counts, counts.round_counts = counting, rounding
    try:
        run()
    finally:
        counts.counts, counts.round_counts = real, real_round
    return calls


def recorded_acc(c: RecordedCounts):
    """A copy of a recorded round's accumulators before it, as the step's."""
    import types

    return types.SimpleNamespace(**{k: v.clone() for k, v in c.acc.items()})


def replay_counts(c: RecordedCounts, plain=False, work=None, acc=None) -> tuple:
    """A recorded call by the kernel (``work`` its scratch, None for a fresh one),
    or by its plain version: the per-shard counts and totals (``counts``), or the
    round's accumulators after it, by ACC_NAMES (added into ``acc``, by default
    ``recorded_acc(c)``)."""
    from jaybenne_tpu_torch.ops import counts
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    ps = split_ledger(c.ledger, c.m) if c.m > 1 else [c.ledger]
    if c.acc is None:
        return counts.counts(ps, work, plain=plain)
    acc = recorded_acc(c) if acc is None else acc
    counts.round_counts(ps, acc, c.it, c.ev, c.drop, c.sent, c.go, c.max_iters, work,
                        plain=plain)
    return tuple(getattr(acc, k) for k in ACC_NAMES)


def counts_bound(c: RecordedCounts) -> float:
    """The least ms of a call on the card (bytes / PEAK_BYTES): each slot's alive
    flag and tau read once, each shard's counts and the totals written, and in a
    round the round's counts and flag read and the accumulators read and
    written."""
    p = c.ledger
    b = p.capacity * (1 + p.tau.element_size())
    if c.acc is None:
        return (b + 8 * (2 * c.m + 3)) / PEAK_BYTES * 1e3
    ins = sum(t.numel() * t.element_size() for t in (c.it, c.ev, c.drop, c.sent, c.go)
              if t is not None)
    accs = sum(t.numel() * t.element_size() for t in c.acc.values())
    return (b + ins + 2 * accs) / PEAK_BYTES * 1e3


def counts_bitwise(calls, what) -> str:
    """Each recorded call by the kernel and by its plain version: raises unless
    every count, total and accumulator is bitwise equal and one launch was
    counted. Returns what was held, as text."""
    from jaybenne_tpu_torch.ops import cuda_lib

    if not calls:
        raise AssertionError(f"counts on {what}: no call recorded")
    rounds = [c for c in calls if c.acc is not None]
    for c in calls:
        before = cuda_lib.LAUNCHES["round_counts"]
        got = replay_counts(c)
        if cuda_lib.LAUNCHES["round_counts"] != before + 1:
            raise AssertionError(f"counts on {what}: the kernel did not launch once")
        want = replay_counts(c, plain=True)
        for k, (a, b) in enumerate(zip(got, want)):
            if not bitwise_equal(a, b):
                raise AssertionError(f"counts on {what}: output {k} differs: {a.tolist()} vs "
                                     f"{b.tolist()}")
    last = calls[-1]
    per, totals = replay_counts(last, plain=True) if last.acc is None else (None, None)
    seen = (f"{len(calls) - len(rounds)} step or tail call(s) and the first {len(rounds)} "
            f"round(s), {calls[0].m} shard(s) in one launch, {calls[0].ledger.capacity} slots, "
            f"{calls[0].ledger.tau.dtype}")
    if totals is not None:
        seen += f"; the last call's live, max and unfinished {totals.tolist()}"
    if rounds:
        seen += (f"; the rounds' go {[None if c.go is None else bool(c.go) for c in rounds]}, "
                 f"max_iters {rounds[0].max_iters}")
    return f"{what}: " + seen


def census_gate_bitwise(rounds, what) -> str:
    """Each recorded round (``RoundRecorder.rounds``) by the census kernel with
    ``go`` false: every column bitwise as it was and its iterations and events 0,
    one launch counted; with ``go`` true bitwise the ungated call, columns and
    counts. Returns what was held, as text."""
    from jaybenne_tpu_torch.ops import cuda_lib, transport_kernel
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    if not rounds:
        raise AssertionError(f"census gate on {what}: no round recorded")
    names = []
    for p0, n, args in rounds:
        g = args[0].g
        name = transport_kernel.launch_name(g.ndim, g.absorb, g.ddmc, g.smr, g.nongray,
                                            g.route, g.real)
        dev = p0.x.device
        out = {}
        for go in (None, False, True):
            q = p0.clone()
            before = cuda_lib.LAUNCHES[name]
            flag = None if go is None else torch.tensor(go, device=dev)
            _, it, ev = transport_kernel.transport(split_ledger(q, n), *args, go=flag)
            if cuda_lib.LAUNCHES[name] != before + 1:
                raise AssertionError(f"census gate on {what}: {name} did not launch once")
            out[go] = (q, it, ev)
        q, it, ev = out[False]
        same_columns(q, p0, f"census gate on {what}: {name} with go false")
        if bool(it.any()) or bool(ev.any()):
            raise AssertionError(f"census gate on {what}: go false counted {it.tolist()}, "
                                 f"{ev.tolist()}")
        same_columns(out[True][0], out[None][0], f"census gate on {what}: {name} with go true")
        if not (torch.equal(out[True][1], out[None][1])
                and torch.equal(out[True][2], out[None][2])):
            raise AssertionError(f"census gate on {what}: go true counted other than ungated")
        if not int(out[None][2].sum()):
            raise AssertionError(f"census gate on {what}: the recorded round ran nothing")
        names.append(f"{name} over {n} shards ({p0.capacity} slots, "
                     f"{int((p0.alive & (p0.tau < 1.0)).sum())} unfinished)")
    return f"{what}: " + "; ".join(names)


def counts_phase(dev, smi) -> dict:
    """Phase 47: the census gate bitwise on the recorded rounds of every spatial
    route (``census_gate_bitwise``), the count kernel bitwise its plain version on
    every path of COUNT_PATHS (``counts_bitwise``), and read apart
    (``kernel_reading``, with the plain version's device ms from the trace) on
    big_mesh_spatial's and the float64 stepdiff's first round and tail at 8 shards
    and the 64^3 DDMC row's step. Returns the kernel's ``kernels`` entry, the
    launches left to the caller."""
    from jaybenne_tpu_torch import driver
    from jaybenne_tpu_torch.ops import counts, transport_kernel

    phase("47 the round's gate and counts: the census with go false changes nothing on every "
          "spatial route's recorded rounds; the count kernel bitwise its plain version on "
          "rounds, tails and steps, read apart")
    calls = {}
    with tempfile.TemporaryDirectory() as outdir:
        for what, deck, mods, gate in COUNT_PATHS:
            def run(deck=deck, mods=mods):
                driver.run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=1,
                                device="cuda", graph=False)

            with RoundRecorder(transport_kernel) as rec:
                got = recorded_counts(run)
            print("count kernel bitwise its plain version, " + counts_bitwise(got, what),
                  flush=True)
            if gate:
                print("census gate held, " + census_gate_bitwise(rec.rounds, what), flush=True)
            calls[what] = got
            del rec
            torch.cuda.empty_cache()
    readings = {}
    for what, which, pick in (
            (COUNT_PATHS[0][0], "its first round", lambda cs: cs[0]),
            (COUNT_PATHS[0][0], "its tail", lambda cs: cs[-1]),
            (COUNT_PATHS[1][0], "its first round", lambda cs: cs[0]),
            (COUNT_PATHS[1][0], "its tail", lambda cs: cs[-1]),
            ("the 64^3 DDMC row", "its step", lambda cs: cs[-1])):
        c = pick(calls[what])
        # a scratch and accumulators of the reading's own, made once, so that a
        # call's window holds the launch alone (a round's adds go on accumulating)
        work = counts.scratch(c.m, dev)
        acc, plain_acc = (None, None) if c.acc is None else (recorded_acc(c), recorded_acc(c))
        r = kernel_reading(dev, lambda c=c, work=work, acc=acc: replay_counts(c, work=work,
                                                                             acc=acc),
                           lambda c=c, acc=plain_acc: replay_counts(c, plain=True, acc=acc),
                           COUNT_LAUNCHES, counts_bound(c), f"count kernel on {what}, {which}",
                           smi)
        r["plain_device_ms"] = device_ms(
            lambda _, c=c, acc=plain_acc: replay_counts(c, plain=True, acc=acc), lambda: None)
        print(f"count kernel on {what}, {which}: the plain version's device ms "
              f"{r['plain_device_ms']!r}", flush=True)
        readings[what, which] = r
    torch.cuda.empty_cache()
    r = readings[COUNT_PATHS[0][0], "its first round"]
    return {
        "name": "round_counts (each local shard's live and unfinished counts over every local "
                "shard's slots in one launch, with a spatial round's counters folded in)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/count_kernel.cu",
        "replaces": "jaybenne_tpu/parallel/spatial.py:480-488 (local_unfinished, its psum's "
                    "local term and the round loop's carry adds) and jaybenne_tpu/step.py:280, "
                    ":317 (unfinished, num_alive; jaybenne_tpu/particles.py:78-79): XLA, no "
                    "Pallas kernel",
        "max_abs_err": 0.0, "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "plain_device_ms": r["plain_device_ms"],
        "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }


def gate_record(path, upto="--- phase: 46") -> tuple:
    """The event counts and gate lines of a chip_smoke.py log, each with its phase,
    up to the phase ``upto``: the numbers two trees must print digit for digit."""
    events, gates, where = [], [], ""
    with open(path) as f:
        for line in f:
            if line.startswith(upto):
                break
            if line.startswith("--- phase:"):
                where = line.split(":")[1].split()[0]
            events += [(where, int(m.group(1))) for m in re.finditer(r"\bevents:? (\d+)\b", line)]
            if re.search(r"\(tol [0-9.e+-]+\)\s*$", line):
                gates.append((where, line.strip()))
    return events, gates


def compare_logs(a, b) -> int:
    """``python3 chip_smoke.py --compare LOG LOG``: 0 where two logs' event counts
    and gate lines (``gate_record``) are equal, 1 where they differ."""
    (ea, ga), (eb, gb) = gate_record(a), gate_record(b)
    print(f"event counts {len(ea)} and {len(eb)}: {'equal' if ea == eb else 'differ'}; gate "
          f"lines {len(ga)} and {len(gb)}: {'equal' if ga == gb else 'differ'}")
    for x, y in [*zip(ea, eb), *zip(ga, gb)]:
        if x != y:
            print(f"  {x} | {y}")
    return 0 if (ea, ga) == (eb, gb) else 1


def main() -> int:
    if sys.argv[1:2] == ["--compare"]:
        return compare_logs(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("1 device")
    smi = device_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    from jaybenne_tpu_torch.ops import cuda_lib, kernel_rng, transport_kernel

    lib = cuda_lib.library()
    print(f"build_seconds {lib.build_seconds!r}  ({lib.path.name})", flush=True)
    native_build_line()
    resources = kernel_resources(lib.build_log, transport_kernel)
    for ndim in (1, 2, 3):
        for smr in (False, True):
            for absorb, ddmc, ng in ((False, False, False), (True, False, False),
                                     (False, True, False), (True, True, False),
                                     (True, False, True), (True, True, True)):
                name = transport_kernel.launch_name(ndim, absorb, ddmc, smr, ng)
                r = resources.get(name, {})
                print(f"  {name}: {r.get('registers', 'not read')} registers, stack "
                      f"{r.get('stack', 'not read')} bytes, spill stores/loads "
                      f"{r.get('spill_stores', 'not read')}/{r.get('spill_loads', 'not read')} "
                      f"bytes, {transport_kernel.resident_blocks(ndim, absorb, ddmc, smr, ng)} "
                      "resident blocks of 256 a SM", flush=True)
    for ndim in (1, 2, 3):  # the float64 census's (precision = f64)
        for smr in (False, True):
            for absorb, ddmc, ng in ((False, False, False), (True, False, False),
                                     (False, True, False), (True, True, False),
                                     (True, False, True), (True, True, True)):
                name = transport_kernel.launch_name(ndim, absorb, ddmc, smr, ng, dtype=F64)
                r = resources.get(name, {})
                blocks = transport_kernel.resident_blocks(ndim, absorb, ddmc, smr, ng, F64)
                floor = F64_RESIDENT_FLOOR.get(name)
                print(f"  {name}: {r.get('registers', 'not read')} registers, stack "
                      f"{r.get('stack', 'not read')} bytes, spill stores/loads "
                      f"{r.get('spill_stores', 'not read')}/{r.get('spill_loads', 'not read')} "
                      f"bytes, {blocks} resident blocks of 256 a SM"
                      + (f" (floor {floor})" if floor else ""), flush=True)
                if floor and (blocks < floor or r.get("spill_stores") != 0
                              or r.get("spill_loads") != 0):
                    raise AssertionError(f"{name}: a floor of {floor} resident blocks, "
                                         f"{blocks} held, resources {r}")
    listing = sass_listing(lib.path)
    cost = probe_costs(sass_counts(listing))
    cost64 = probe_costs(sass_counts(listing), f64=True)
    for fn, code in listing.items():  # where a stack frame is used: LDL/STL
        name = census_route(fn, transport_kernel)
        if name is not None and resources.get(name, {}).get("stack", 0) > 0:
            print(f"  {name}: {local_memory(code)} LDL/STL instructions", flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        mix_build = pool.submit(path_mix_library)
        paths = loop_paths(str(cuda_lib.SRC_DIR), EVENT_LOOP_ROUTES, transport_kernel,
                           ("scatter", "cross", "no_wall", "full"))
        mix_lib = mix_build.result()
    common = paths["scatter"]
    print(f"event loop common path (a scatter in the lane's cell), SASS instructions an "
          f"event: {common}; every path of the loop (LOOP_PATHS): {paths}", flush=True)
    if sorted(common) != sorted(EVENT_LOOP_ROUTES) or min(common.values()) <= 0:
        raise AssertionError(f"build: no event loop read: {common}")

    phase("3 K2 raw_bits vs plain")
    slots = torch.tensor([0, 1, 127, 128, 16383, 16384, 3 * 16384 + 5, 100003,
                          (1 << 17) - 1, 201151, (1 << 31) - 1], dtype=torch.int32)
    its = torch.tensor([0, 1, 7, 8, 1000, 12345, 65537, (1 << 31) - 1], dtype=torch.int32)
    tags = torch.arange(6, dtype=torch.int32)
    grid = torch.cartesian_prod(slots, its, tags).to(dev)
    lane, it, tag = (grid[:, k].contiguous() for k in range(3))
    n_k2 = 0
    for seed in (-12345, 0, 349857, -(1 << 31), (1 << 31) - 1):
        got = kernel_rng.raw_bits_cuda(seed, lane, it, tag)
        want = kernel_rng.raw_bits_plain(seed, lane.long(), it.long(), tag.long())
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K2: {bad} raw_bits words differ at seed {seed}")
        n_k2 += got.numel()
    print(f"K2 raw_bits bit-identical on {n_k2} (seed, slot, it, tag) points", flush=True)

    phase("4 K1(a) vs plain, 2^17 particles, sigma_s = 1024")
    cfg, mesh, prm, coefs = gate_setup(dev, 1024.0)
    dt = cfg.jaybenne.dt
    seed = -424242
    p0 = gate_ledger(dev)
    prm8 = dataclasses.replace(prm, max_iters=8)
    pk, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm8, dt)
    pp, it_p, ev_p = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm8, dt)
    torch.cuda.synchronize()
    for name in ("i", "block", "alive"):
        if not torch.equal(getattr(pk, name), getattr(pp, name)):
            raise AssertionError(f"K1 8 iterations: integer state {name} differs")
    if int(ev_k) != int(ev_p) or int(it_k) != int(it_p):
        raise AssertionError(f"K1 8 iterations: stats differ {ev_k} {ev_p} {it_k} {it_p}")
    err8, rel8 = max_float_err(pk, pp)
    if rel8 > FLOAT_RTOL:
        raise AssertionError(f"K1 8 iterations: float rel err {rel8} > {FLOAT_RTOL}")
    print(f"K1 8 iterations: integers identical, events {int(ev_k)}, "
          f"max_abs_err {err8:.3e} max_rel_err {rel8:.3e}", flush=True)

    pk, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm, dt)
    pp, it_p, ev_p = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm, dt)
    for out, name in ((pk, "kernel"), (pp, "plain")):
        if int(out.alive.sum()) != p0.capacity:
            raise AssertionError(f"K1 census ({name}): particles lost")
        if bool((out.tau < 1.0).any()):
            raise AssertionError(f"K1 census ({name}): a live slot is short of census")
    ev_k, ev_p = int(ev_k), int(ev_p)
    if abs(ev_k - ev_p) > EVENTS_RTOL * ev_p:
        raise AssertionError(f"K1 census: events {ev_k} vs {ev_p}")
    gk = pk.global_position(mesh)[0]
    gp = pp.global_position(mesh)[0]
    dmean = abs(float(gk.mean() - gp.mean()))
    dstd = abs(float(gk.std() - gp.std())) / float(gp.std())
    if dmean > MEAN_ATOL or dstd > STD_RTOL:
        raise AssertionError(f"K1 census: x statistics differ (mean {dmean}, std {dstd})")
    same = torch.equal(pk.x, pp.x) and torch.equal(pk.i, pp.i)
    print(f"K1 full census: events kernel {ev_k} plain {ev_p}, iterations "
          f"{int(it_k)}/{int(it_p)}, |dmean x| {dmean:.2e}, std rel {dstd:.2e}, "
          f"bitwise equal: {same}", flush=True)

    phase("5 main path: stepdiff 128 cells, 100k particles, 10 steps")
    from jaybenne_tpu_torch.driver import run_file

    with tempfile.TemporaryDirectory() as outdir:
        sim0 = run_file(DECK, outdir=outdir, modified_inputs=GATE, quiet=True,
                        nlim=0, device="cuda")
        e0 = radiation_energy(sim0)
        cuda_lib.LAUNCHES.clear()
        sim = run_file(DECK, outdir=outdir, modified_inputs=GATE, quiet=True,
                       device="cuda")
        launches = dict(cuda_lib.LAUNCHES)
        note_table("stepdiff", launches)
        cuda_lib.LAUNCHES.clear()
        plain = run_file(DECK, outdir=outdir,
                         modified_inputs={**GATE, "jaybenne/use_pallas": "off"},
                         quiet=True, nlim=PLAIN_STEPS, device="cuda")
        plain_launches = dict(cuda_lib.LAUNCHES)
        again = run_file(DECK, outdir=outdir, modified_inputs=GATE, quiet=True,
                         device="cuda")
    if launches.get("transport_1d", 0) != N_STEPS or sim.cycle != N_STEPS:
        raise AssertionError(f"main path: launches {launches}, cycles {sim.cycle}")
    # use_pallas = off runs eagerly on the card (its census reads its exit test),
    # past the step a graph would capture, with no census launch
    plain_tally = plain.state.fields.energy_tally
    if (plain.graphed or plain.cycle != PLAIN_STEPS or plain_launches.get("transport_1d", 0)
            or not bool(torch.isfinite(plain_tally).all())):
        raise AssertionError(f"plain version: graph {plain.graphed}, cycles {plain.cycle}, "
                             f"launches {plain_launches}")
    werr = weighted_erf_error(sim)
    e10 = radiation_energy(sim)
    tally = sim.state.fields.energy_tally
    if tally.shape != (1, 1, 1, 128) or not bool(torch.isfinite(tally).all()):
        raise AssertionError(f"main path: tally shape {tuple(tally.shape)} or not finite")
    if werr > WERR_TOL:
        raise AssertionError(f"main path: weighted erf error {werr} > {WERR_TOL}")
    if abs(e10 - e0) > ENERGY_RTOL * e0:
        raise AssertionError(f"main path: energy {e0} -> {e10}")
    step_s = [h["step_seconds"] for h in sim.history]
    events = sim.total_events
    rate = events / sum(step_s)
    plain_step_s = plain.history[-1]["step_seconds"]
    print(f"werr {werr!r} (tol {WERR_TOL}); energy step 0 {e0!r} step 10 {e10!r} "
          f"rel {abs(e10 - e0) / e0:.3e}", flush=True)
    print(f"events {events} (int64); step seconds {step_s}; "
          f"median {statistics.median(step_s) * 1e3!r} ms; {rate!r} events/s", flush=True)
    print(f"plain version (use_pallas = off, eager), {PLAIN_STEPS} steps on the GPU, no "
          f"census launch; its last step {plain_step_s * 1e3!r} ms "
          f"({plain.history[-1]['events']} events)", flush=True)

    # the kernel and its plain version on the main path's own ledger (tau = 0 after
    # the last step), same inputs, timed with CUDA events
    from jaybenne_tpu_torch.ops import transport as transport_ops
    from jaybenne_tpu_torch.step import make_transport_params

    cfgm, meshm = sim.cfg, sim.mesh
    prmm = make_transport_params(cfgm, torch.float32)
    f = sim.state.fields
    coefsm = transport_ops.precompute_coefs(
        f, meshm, cfgm.mcblock.build_eos(), cfgm.mcblock.build_opacity(),
        cfgm.mcblock.build_scattering(), False, torch.float32,
    )
    pm = sim.state.particles.clone()
    args = (coefsm, meshm, 12345, prmm, cfgm.jaybenne.dt)
    transport_kernel.transport(pm.clone(), *args)  # warm-up
    times, census_events = time_census(transport_kernel.transport, pm, args, dev, CENSUS_REPEATS)
    ms = statistics.median(times)
    plain_ms = statistics.median(time_census(transport_kernel.transport_plain, pm, args, dev,
                                             2)[0])
    a8 = dataclasses.replace(prmm, max_iters=8)
    qk = transport_kernel.transport(pm.clone(), coefsm, meshm, 12345, a8, cfgm.jaybenne.dt)[0]
    qp = transport_kernel.transport_plain(pm.clone(), coefsm, meshm, 12345, a8,
                                          cfgm.jaybenne.dt)[0]
    if not (torch.equal(qk.i, qp.i) and torch.equal(qk.alive, qp.alive)):
        raise AssertionError("K1 on the main-path ledger: integer state differs")
    err_m, rel_m = max_float_err(qk, qp)
    if rel_m > FLOAT_RTOL:
        raise AssertionError(f"K1 on the main-path ledger: float rel err {rel_m}")
    print(f"K1 on the main-path ledger ({pm.capacity} slots, {int(pm.alive.sum())} live): "
          f"kernel {spread(times)}, plain {plain_ms!r} ms per census; 8-iteration "
          f"max_abs_err {err_m:.3e}", flush=True)
    lanes_1d = event_loop_line(transport_kernel, dev, "transport_1d", (pm, args), ms,
                               census_events, resources.get("transport_1d", {}),
                               common["transport_1d"])
    path_mix_line("transport_1d", path_mix(transport_kernel, mix_lib, (pm, args)),
                  {k: v["transport_1d"] for k, v in paths.items()}, ms, census_events, dev)
    # K2 alone: the words of this census (two an event: the exp23 word and the u16
    # word), drawn by the census_words probe, against their plain version on the
    # first lanes and against the bound of their hash instructions at the issue rate
    words = 2
    kernel_rng.census_words(12345, lanes_1d, words)  # warm-up
    k2_times = []
    for _ in range(CENSUS_REPEATS):
        torch.cuda.synchronize(dev)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        got = kernel_rng.census_words(12345, lanes_1d, words)
        stop.record()
        torch.cuda.synchronize(dev)
        k2_times.append(start.elapsed_time(stop))
    k2_times.sort()
    head = lanes_1d[:K2_CHECK_LANES]
    if not torch.equal(got[:K2_CHECK_LANES], kernel_rng.census_words_plain(12345, head, words)):
        raise AssertionError("K2 census words: the probe differs from its plain version")
    n_words = words * int(lanes_1d.sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k2_bound = n_words * cost["hash"] / (sms * ISSUE_PER_SM_CLOCK * smi_value("clocks.max.sm")
                                         * 1e6) * 1e3
    print(f"K2 alone, the stepdiff census's {n_words} words ({words} an event): "
          f"{spread(k2_times)}; bound {k2_bound!r} ms ({cost['hash']} SASS instructions a "
          f"word at the issue rate, clocks.max.sm); the census {ms!r} ms; equal to the plain "
          f"version on the first {K2_CHECK_LANES} lanes", flush=True)

    phase("6 determinism")
    if not torch.equal(again.state.fields.energy_tally, tally):
        raise AssertionError("determinism: a second run with the same seed differs")
    print("second run with the same seed: tallies bitwise identical", flush=True)

    print(f"SASS instructions on the straight-line path: logf {cost['logf']}, divide "
          f"{cost['div']}, hash {cost['hash']}, expf {cost['expf']}, sqrtf {cost['sqrtf']}",
          flush=True)
    bound_1d, by_1d = census_bound(pm, 1, False, meshm.total_cells, census_events, cost)
    print(f"K1(a) bound on the main-path ledger: {census_events} events x "
          f"{ops_per_event(1, False, cost)} operations: {bound_1d!r} ms ({by_1d}); "
          f"kernel at {bound_1d / ms:.3f} of it", flush=True)

    phase("7 absorbing kernel vs plain, 3D and 2D, 2^17 particles")
    periodic = {f"parthenon/swarm/{s}x{k}_bc": "periodic" for s in "io" for k in "123"}
    grid3 = {**periodic, "mcblock/opacity_model": "constant",
             **{f"parthenon/mesh/nx{k}": 16 for k in "123"},
             **{f"parthenon/meshblock/nx{k}": 8 for k in "123"}}
    grid2 = {**periodic, "mcblock/opacity_model": "constant",
             "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64,
             "parthenon/meshblock/nx1": 32, "parthenon/meshblock/nx2": 32}
    err3 = compare_absorbing(transport_kernel, dev, 3, grid3, -31337)
    err2 = compare_absorbing(transport_kernel, dev, 2, grid2, 271828)

    phase("8 inf gate (tst/inf.py overrides) and a 2D matter-coupled path")
    from jaybenne_tpu_torch.utils.constants import AR

    name3, name2 = transport_kernel.launch_name(3, True), transport_kernel.launch_name(2, True)
    with tempfile.TemporaryDirectory() as outdir:
        cuda_lib.LAUNCHES.clear()
        inf = run_file(INF_DECK, outdir=outdir, modified_inputs=INF, quiet=True,
                       device="cuda")
        inf_launches = dict(cuda_lib.LAUNCHES)
        note_table("inf", inf_launches)
        sim2_0 = run_file(DECK, outdir=outdir, modified_inputs=FEEDBACK_2D, quiet=True,
                          nlim=0, device="cuda")
        e2_0, er2_0 = total_energy(sim2_0)
        cuda_lib.LAUNCHES.clear()
        sim2 = run_file(DECK, outdir=outdir, modified_inputs=FEEDBACK_2D, quiet=True,
                        nlim=FEEDBACK_2D_STEPS, device="cuda")
        launches_2d = dict(cuda_lib.LAUNCHES)
        note_table("2D feedback", launches_2d)
    if inf_launches.get(name3, 0) != INF_STEPS or inf.cycle != INF_STEPS:
        raise AssertionError(f"inf: launches {inf_launches}, cycles {inf.cycle}")
    var = inf.state.fields.energy_tally.double().cpu().numpy()
    ur = AR * 1.0**4  # the deck's initial_temperature, pinned with feedback off
    inf_err = float((np.fabs(ur - var) / np.fabs((ur + var) / 2.0)).mean())
    if not np.isfinite(var).all() or inf_err > INF_TOL:
        raise AssertionError(f"inf: mean fractional error {inf_err} > {INF_TOL}")
    if any(h["dropped"] or h["unfinished"] for h in inf.history):
        raise AssertionError("inf: particles dropped or a census incomplete")
    print(f"inf: {inf.cycle} steps, {inf_launches.get(name3, 0)} launches of {name3}, "
          f"mean tally {float(var.mean())!r} vs a T0^4 {ur!r}, mean fractional error "
          f"{inf_err!r} (tol {INF_TOL}), events {inf.total_events}", flush=True)
    e2_1, _ = total_energy(sim2)
    cons2 = abs(e2_1 - e2_0) / er2_0
    if (launches_2d.get(name2, 0) != FEEDBACK_2D_STEPS or cons2 > FEEDBACK_ENERGY_TOL
            or any(h["dropped"] or h["unfinished"] for h in sim2.history)):
        raise AssertionError(f"2D feedback: launches {launches_2d}, energy {cons2}")
    ms2, plain_ms2, ev2, err2m, in2 = path_census(sim2, transport_kernel, dev)
    bound_2d, by_2d = census_bound(sim2.state.particles, 2, True, sim2.mesh.total_cells,
                                   ev2, cost)
    print(f"2D feedback ({sim2.mesh.total_cells} cells, {FEEDBACK_2D_STEPS} steps): "
          f"{launches_2d.get(name2, 0)} launches, energy conservation {cons2!r}, events "
          f"{sim2.total_events}; on its ledger kernel {ms2!r} ms, plain {plain_ms2!r} ms, "
          f"{ev2} events, bound {bound_2d!r} ms ({by_2d})", flush=True)
    lanes_2d = event_loop_line(transport_kernel, dev, name2, in2, ms2, ev2,
                               resources.get(name2, {}), common[name2])
    block_spread_line(name2, lanes_2d, in2[0], transport_kernel.resident_blocks(2, True), dev)
    path_mix_line(name2, path_mix(transport_kernel, mix_lib, in2),
                  {k: v[name2] for k, v in paths.items()}, ms2, ev2, dev)

    phase("9 full width: big_mesh_feedback, 64^3 cells, 200k particles, 3 steps")
    with tempfile.TemporaryDirectory() as outdir:
        fb0 = run_file(DECK, outdir=outdir, modified_inputs=FEEDBACK, quiet=True,
                       nlim=0, device="cuda")
        e_0, er_0 = total_energy(fb0)
        del fb0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.LAUNCHES.clear()
        fb = run_file(DECK, outdir=outdir, modified_inputs=FEEDBACK, quiet=True,
                      nlim=FEEDBACK_STEPS, device="cuda")
        fb_launches = dict(cuda_lib.LAUNCHES)
        note_table("big_mesh_feedback", fb_launches)
        peak = torch.cuda.max_memory_allocated(dev)
        fb_fields = (fb.state.fields.energy_tally.clone(), fb.state.fields.u.clone())
        fb_ms, fb_plain_ms, fb_ev, fb_err, fb_in = path_census(fb, transport_kernel, dev)
        bound_3d, by_3d = census_bound(fb.state.particles, 3, True, fb.mesh.total_cells,
                                       fb_ev, cost)
        phase("10 determinism of phase 9")
        again_fb = run_file(DECK, outdir=outdir, modified_inputs=FEEDBACK, quiet=True,
                            nlim=FEEDBACK_STEPS, device="cuda")
    e_1, _ = total_energy(fb)
    cons = abs(e_1 - e_0) / er_0
    fb_events = fb.total_events
    if fb_launches.get(name3, 0) != FEEDBACK_STEPS or fb.cycle != FEEDBACK_STEPS:
        raise AssertionError(f"feedback: launches {fb_launches}, cycles {fb.cycle}")
    # the insert kernel, three launches a pass: the initial radiation's births and
    # each step's emission
    if fb_launches.get("ledger_insert", 0) != 3 * (FEEDBACK_STEPS + 1):
        raise AssertionError(f"feedback: ledger_insert launches {fb_launches}")
    if any(h["dropped"] or h["unfinished"] for h in fb.history) or fb.state.overflow:
        raise AssertionError(f"feedback: dropped or unfinished {fb.history}")
    if not bool(torch.isfinite(fb.state.fields.u).all()) or cons > FEEDBACK_ENERGY_TOL:
        raise AssertionError(f"feedback: energy conservation {cons} > {FEEDBACK_ENERGY_TOL}")
    if abs(fb_events - FEEDBACK_JAX_EVENTS) > FEEDBACK_EVENTS_RTOL * FEEDBACK_JAX_EVENTS:
        raise AssertionError(f"feedback: events {fb_events} vs JAX {FEEDBACK_JAX_EVENTS}")
    fb_step_s = [h["step_seconds"] for h in fb.history]
    print(f"feedback: energy conservation {cons!r} of the radiation energy {er_0!r} "
          f"(tol {FEEDBACK_ENERGY_TOL}); {fb_launches.get(name3, 0)} launches of {name3}, "
          f"{fb_launches.get('ledger_insert', 0)} of ledger_insert; "
          f"dropped 0, unfinished 0; alive {[h['alive'] for h in fb.history]}", flush=True)
    print(f"feedback: events {fb_events} (JAX package {FEEDBACK_JAX_EVENTS}, "
          f"{fb_events / FEEDBACK_JAX_EVENTS - 1.0:+.4f}); step seconds {fb_step_s}; "
          f"median {statistics.median(fb_step_s) * 1e3!r} ms; "
          f"{fb_events / sum(fb_step_s)!r} events/s; peak device memory {peak} bytes",
          flush=True)
    event_loop_line(transport_kernel, dev, name3, fb_in, fb_ms, fb_ev,
                    resources.get(name3, {}), common[name3])
    print(f"feedback ledger ({fb.state.particles.capacity} slots, "
          f"{int(fb.state.particles.alive.sum())} live): kernel {fb_ms!r} ms, plain "
          f"{fb_plain_ms!r} ms per census, {fb_ev} events; bound {bound_3d!r} ms "
          f"({by_3d}), kernel at {bound_3d / fb_ms:.3f} of it; 8-iteration max_abs_err "
          f"{fb_err:.3e}", flush=True)
    for got, want, what in zip((again_fb.state.fields.energy_tally, again_fb.state.fields.u),
                               fb_fields, ("energy_tally", "u")):
        if not torch.equal(got, want):
            raise AssertionError(f"determinism: feedback {what} differs on a rerun")
    print("feedback rerun with the same seed: energy_tally and u bitwise identical",
          flush=True)

    phase("11 K1(c): all twelve instantiations vs plain on a hybrid ledger, 2^17 particles")
    hybrid_err = {}
    for ndim, seed in ((1, 1101), (2, 1102), (3, 1103)):
        for absorb in (False, True):
            for ddmc in (False, True):
                name = transport_kernel.launch_name(ndim, absorb, ddmc)
                hybrid_err[name] = compare_hybrid(transport_kernel, dev, ndim, absorb, ddmc,
                                                  seed + 10 * absorb)
    # the DDMC instantiations that no path runs, timed on this ledger
    for ndim, absorb, seed in ((2, False, 1102), (2, True, 1112), (3, True, 1113)):
        name = transport_kernel.launch_name(ndim, absorb, True)
        ms_h, plain_h, ev_h, bound_h, by_h = hybrid_census_timing(transport_kernel, dev, ndim,
                                                                  absorb, seed, cost)
        print(f"{name} on the hybrid ledger's full census: kernel {ms_h!r} ms, plain "
              f"{plain_h!r} ms, {ev_h} events; bound {bound_h!r} ms ({by_h}), kernel at "
              f"{bound_h / ms_h:.3f} of it", flush=True)

    phase("12 DDMC main path: stepdiff_ddmc 128 cells, 100k particles, 10 steps")
    name_dd1 = transport_kernel.launch_name(1, False, True)
    dd, dd_launches, dd_in, _ = run_path(DDMC_DECK, DDMC_GATE, name_dd1)
    dd_tally = dd.state.fields.energy_tally
    if dd_tally.shape != (1, 1, 1, 128):
        raise AssertionError(f"DDMC main path: tally shape {tuple(dd_tally.shape)}")
    gate(weighted_erf_error(dd), WERR_TOL, "DDMC main path werr")
    dd_events = dd.total_events
    if abs(dd_events - DDMC_JAX_EVENTS) > DDMC_EVENTS_RTOL * DDMC_JAX_EVENTS:
        raise AssertionError(f"DDMC main path: events {dd_events} vs JAX {DDMC_JAX_EVENTS}")
    if dd_events >= DDMC_IMC_EVENTS_RATIO * events:
        raise AssertionError(f"DDMC main path: events {dd_events} vs IMC {events}")
    print(f"DDMC main path: events {dd_events} (JAX package {DDMC_JAX_EVENTS}, "
          f"{dd_events / DDMC_JAX_EVENTS - 1.0:+.4f}; IMC gate {events})", flush=True)
    ms_dd1, plain_dd1, _, err_dd1, bound_dd1, by_dd1 = path_kernel(
        transport_kernel, dev, dd, dd_in, name_dd1, cost)
    call_split_line(transport_kernel, dev, dd_in, name_dd1)
    table_check(transport_kernel, dev, dd_in[1][0], dd.mesh, dd_in[1][3], dd_in[1][4], None,
                "stepdiff_ddmc's last census (the 1D DDMC record)")

    phase("13 stiff gate: inf_stiff (tst/inf_stiff.py overrides), 10 steps")
    name_dd1a = transport_kernel.launch_name(1, True, True)
    with tempfile.TemporaryDirectory() as outdir:
        with CensusRecorder(transport_kernel, STIFF_STEPS) as rec_st:
            cuda_lib.LAUNCHES.clear()
            stiff = run_file(STIFF_DECK, outdir=outdir, modified_inputs=STIFF, quiet=True,
                             device="cuda", graph=False)  # recorded: the eager step
            stiff_launches = dict(cuda_lib.LAUNCHES)
            note_table("inf_stiff", stiff_launches)
    if stiff_launches.get(name_dd1a, 0) != STIFF_STEPS or stiff.cycle != STIFF_STEPS:
        raise AssertionError(f"inf_stiff: launches {stiff_launches}, cycles {stiff.cycle}")
    var_st = stiff.state.fields.energy_tally.double().cpu().numpy()
    ur_st = AR * 1.0**4  # the deck's initial_temperature, pinned with feedback off
    stiff_err = float((np.fabs(ur_st - var_st) / np.fabs((ur_st + var_st) / 2.0)).mean())
    if not np.isfinite(var_st).all() or stiff_err > STIFF_TOL:
        raise AssertionError(f"inf_stiff: mean fractional error {stiff_err} > {STIFF_TOL}")
    if any(h["dropped"] or h["unfinished"] for h in stiff.history):
        raise AssertionError("inf_stiff: particles dropped or a census incomplete")
    print(f"inf_stiff: {stiff.cycle} steps, {stiff_launches.get(name_dd1a, 0)} launches of "
          f"{name_dd1a}, mean tally {float(var_st.mean())!r} vs a T0^4 {ur_st!r}, mean "
          f"fractional error {stiff_err!r} (tol {STIFF_TOL}), events {stiff.total_events}, "
          f"alive {[h['alive'] for h in stiff.history]}", flush=True)
    ms_dd1a, plain_dd1a, _, err_dd1a, bound_dd1a, by_dd1a = path_kernel(
        transport_kernel, dev, stiff, rec_st.inputs, name_dd1a, cost)
    call_split_line(transport_kernel, dev, rec_st.inputs, name_dd1a)

    phase("14 full width in 3D: big_mesh with DDMC, 64^3 cells, 200k particles, 10 steps")
    name_dd3 = transport_kernel.launch_name(3, False, True)
    big, big_launches, big_in, e_big0 = run_path(DECK, BIG_DDMC, name_dd3)
    dmin = big.mesh.block_dx[:, : big.mesh.ndim].min(dim=1).values
    tau_cells = dmin * big.cfg.mcblock.scattering_constant_value
    if not bool((tau_cells > big.cfg.jaybenne.tau_ddmc).all()):
        raise AssertionError("big_mesh DDMC: not every cell is on the DDMC branch")
    # The thermal source gives each cell floor(npc) + Bernoulli(frac) particles,
    # npc = 200k / 64^3 = 0.76, so a quarter of the cells start empty and their
    # a T^4 is never sourced (the JAX package sources alike). Diffusion is linear,
    # so the expected tally is the erf solution times the sourced share of the
    # analytic energy UR0 x (hot volume): the gate holds the profile to that.
    xc0 = big.mesh.cell_centers()[0]
    dv = big.mesh.block_volume.double()[:, None, None, None].expand(xc0.shape)
    e_analytic = float(dv[xc0 < 0.0].sum()) * ERF_UR0
    sourced = e_big0 / e_analytic
    prof_err = profile_error(big, scale=sourced)
    prof_err_unscaled = profile_error(big)
    print(f"big_mesh DDMC: every cell DDMC (sigma dx min {float(tau_cells.min())!r} > "
          f"{big.cfg.jaybenne.tau_ddmc}); sourced {sourced!r} of a T^4; "
          f"{prof_err_unscaled!r} against the unscaled solution", flush=True)
    gate(prof_err, PROFILE_TOL, "big_mesh DDMC x-profile against the sourced solution")
    ms_dd3, plain_dd3, ev_dd3, err_dd3, bound_dd3, by_dd3 = path_kernel(
        transport_kernel, dev, big, big_in, name_dd3, cost)
    src = "jaybenne_tpu_torch/csrc/transport_kernel.cu"
    call_split_line(transport_kernel, dev, big_in, name_dd3)
    fold_check(transport_kernel, big_in, "the 64^3 DDMC row's last census")
    table = table_check(transport_kernel, dev, big_in[1][0], big.mesh, big_in[1][3],
                        big_in[1][4], None, "the 64^3 DDMC row's last census")
    if big_launches.get("census_table", 0) != PATH_STEPS:
        raise AssertionError(f"big_mesh DDMC: launches {big_launches}")
    table_kernel = {
        "name": "census_table (the census's per-cell table in one pass; XLA ops around K1 "
                "and K3 in the JAX package)",
        "route": "cuda", "source": "jaybenne_tpu_torch/csrc/table_kernel.cu",
        "replaces": "jaybenne_tpu/ops/pallas_transport.py:370 (_to_global_cells, with "
                    "_face_pair_vectors :319, around K1) and jaybenne_tpu/ops/pallas_grid.py:445 "
                    "(_to_global, _faces_to_global :455, _pack_rows :486, around K3)",
        "launches": big_launches.get("census_table", 0), "max_abs_err": 0.0, "ms": table[0],
        "plain_ms": table[1], "bound_ms": table[2], "bound_by": "bytes", "library_ms": None,
    }

    smr_kernels, s2_in = smr_phases(transport_kernel, dev, cost, src, resources, common)
    nongray_kernels = nongray_phases(transport_kernel, dev, cost, src)
    spatial_kernels = spatial_phases(transport_kernel, dev, cost, src, mix_lib)

    phase("36 the regrouping schedule at scale: the twelve DDMC instantiations, a full "
          "census on ledgers of 4 times the resident threads")
    schedule_phase(transport_kernel, dev)
    restart_phases(dev, smi)
    f64_kernels = f64_phases(
        transport_kernel, dev, cost, cost64,
        (("stepdiff (transport_1d)", (pm, args)), ("the 2D feedback path (transport_2d_abs)", in2),
         ("the 64^3 feedback row (transport_3d_abs)", fb_in),
         ("stepdiff_smr (transport_2d_smr)", s2_in)))

    insert_kernel, migrate_kernel = graph_phase(dev, smi)
    tally_kernel, face_kernel = tally_faces_phase(dev, smi)
    count_kernel = counts_phase(dev, smi)
    host_gap_phase(smi)
    # the main path: phase 30's 8-shard big_mesh_spatial run (one launch a round
    # queued and one a step's tail); beside it every counted path's
    count_kernel["launches"] = COUNTS_MAIN[0]
    count_kernel["launches_by_path"] = [[what, n] for what, n in COUNT_PATHS_RUN]
    if not COUNTS_MAIN[0] or any(n == 0 for _, n in COUNT_PATHS_RUN):
        raise AssertionError(f"round_counts: a path without a launch: {COUNT_PATHS_RUN}")
    print(f"round_counts launches by path: {COUNT_PATHS_RUN}", flush=True)
    # the main path of both: phase 14's 64^3 DDMC run (the initial radiation's tally
    # and ten steps'); beside it every path that phase 5-13 ran
    tally_kernel["launches"] = big_launches.get("tally", 0)
    face_kernel["launches"] = big_launches.get("ddmc_face_probs", 0)
    if not tally_kernel["launches"] or not face_kernel["launches"]:
        raise AssertionError(f"the 64^3 DDMC row: launches {big_launches}")
    tally_kernel["launches_by_path"] = [
        [what, n.get("tally", 0)] for what, n in (
            ("stepdiff", launches), ("inf", inf_launches), ("2D feedback", launches_2d),
            ("big_mesh_feedback", fb_launches), ("stepdiff_ddmc", dd_launches),
            ("inf_stiff", stiff_launches), ("big_mesh DDMC", big_launches))]
    face_kernel["launches_by_path"] = [
        [what, n.get("ddmc_face_probs", 0)] for what, n in (
            ("stepdiff_ddmc", dd_launches), ("inf_stiff", stiff_launches),
            ("big_mesh DDMC", big_launches))]
    for entry in (tally_kernel, face_kernel):
        if any(n == 0 for _, n in entry["launches_by_path"]):
            raise AssertionError(f"{entry['source']}: a path without a launch: "
                                 f"{entry['launches_by_path']}")
    print(f"tally launches by path: {tally_kernel['launches_by_path']}; ddmc_face_probs "
          f"launches by path: {face_kernel['launches_by_path']}", flush=True)
    migrate_kernel["launches"] = MIGRATE_MAIN[0]
    migrate_kernel["launches_by_path"] = [[what, n] for what, n in MIGRATE_PATHS]
    print(f"migrate_pack launches by path: {MIGRATE_PATHS}", flush=True)
    insert_kernel["launches"] = fb_launches.get("ledger_insert", 0)
    insert_kernel["launches_by_path"] = [["inf", inf_launches.get("ledger_insert", 0)],
                                         ["2D feedback", launches_2d.get("ledger_insert", 0)],
                                         ["big_mesh_feedback", insert_kernel["launches"]]]

    if "jax" in sys.modules or any(m.startswith("jaybenne_tpu.") for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    kernels = [
        {
            "name": "transport_1d (K1(a), with K2 inlined)",
            "route": "cuda", "source": src,
            "replaces": "jaybenne_tpu/ops/pallas_transport.py:382",
            "launches": launches.get("transport_1d", 0),
            "max_abs_err": max(err8, err_m),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_1d, "bound_by": by_1d,
            "library_ms": None,
        },
        {
            "name": f"{name2} (K1(b) and gray 2D K1(e), with K2 inlined)",
            "route": "cuda", "source": src,
            "replaces": "jaybenne_tpu/ops/pallas_transport.py:382",
            "launches": launches_2d.get(name2, 0),
            "max_abs_err": max(err2, err2m),
            "ms": ms2, "plain_ms": plain_ms2, "bound_ms": bound_2d, "bound_by": by_2d,
            "library_ms": None,
        },
        {
            "name": f"{name3} (K3 gray IMC at 64^3; K1(b) and gray 3D K1(e) on inf)",
            "route": "cuda", "source": src,
            "replaces": "jaybenne_tpu/ops/pallas_grid.py:678",
            "launches": fb_launches.get(name3, 0),
            "max_abs_err": max(err3, fb_err),
            "ms": fb_ms, "plain_ms": fb_plain_ms, "bound_ms": bound_3d, "bound_by": by_3d,
            "library_ms": None,
        },
        {
            "name": f"{name_dd1} (K1(c) DDMC, 1D; stepdiff_ddmc)",
            "route": "cuda", "source": src,
            "replaces": "jaybenne_tpu/ops/pallas_transport.py:655",
            "launches": dd_launches.get(name_dd1, 0),
            "max_abs_err": max(hybrid_err[name_dd1], err_dd1),
            "ms": ms_dd1, "plain_ms": plain_dd1, "bound_ms": bound_dd1, "bound_by": by_dd1,
            "library_ms": None,
        },
        {
            "name": f"{name_dd1a} (K1(c) DDMC with absorption, 1D; inf_stiff)",
            "route": "cuda", "source": src,
            "replaces": "jaybenne_tpu/ops/pallas_transport.py:655",
            "launches": stiff_launches.get(name_dd1a, 0),
            "max_abs_err": max(hybrid_err[name_dd1a], err_dd1a),
            "ms": ms_dd1a, "plain_ms": plain_dd1a, "bound_ms": bound_dd1a,
            "bound_by": by_dd1a, "library_ms": None,
        },
        {
            "name": f"{name_dd3} (K3 DDMC at 64^3; K1(c) in 3D)",
            "route": "cuda", "source": src,
            "replaces": "jaybenne_tpu/ops/pallas_grid.py:678",
            "launches": big_launches.get(name_dd3, 0),
            "max_abs_err": max(hybrid_err[name_dd3], err_dd3),
            "ms": ms_dd3, "plain_ms": plain_dd3, "bound_ms": bound_dd3, "bound_by": by_dd3,
            "library_ms": None,
            "folds": "the ledger's collapse to one block and its expansion back (once the kernels "
                     "ledger_collapse and ledger_expand) into the census's reads "
                     "and writes of every slot, on every uniform mesh of several blocks",
        },
    ]
    # ``launches`` is phase 14's; beside it every counted path's
    table_kernel["launches_by_path"] = [[what, n] for what, n in TABLE_PATHS]
    print(f"census_table launches by path: {TABLE_PATHS}", flush=True)
    kernels += ([table_kernel, insert_kernel, migrate_kernel, tally_kernel, face_kernel,
                 count_kernel]
                + smr_kernels + nongray_kernels + spatial_kernels + f64_kernels)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
