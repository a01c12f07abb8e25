// Census transport kernel: IMC, and hybrid IMC/DDMC, on a uniform mesh or a
// statically refined (SMR) block forest, 1D/2D/3D, with or without absorption,
// with a gray or a frequency-dependent opacity, in float32 or float64. One body,
// thirty-six instantiations at each precision: NDIM in {1, 2, 3} x SMR x (ABSORB x
// DDMC gray, and DDMC with NONGRAY, which implies ABSORB), and the working type
// Real. transport_kernel.cu instantiates the float32 census (jb_transport_launch),
// transport_kernel_f64.cu the float64 one (jb_transport_launch_f64, ``precision =
// f64``): two translation units, built by two nvcc started together.
//
// Replaces the three census kernels of the JAX package:
//
//   * jaybenne_tpu/ops/pallas_transport.py::_transport_kernel (:382; K1), the
//     VMEM-resident kernel with its has_absorption (K1(b)), multi_d/three_d and
//     nongray (K1(e)), use_ddmc (K1(c)) and multi-block SMR (K1(d)) branches;
//   * jaybenne_tpu/ops/pallas_grid.py::_grid_kernel (:678; K3), the kernel the
//     JAX package runs on uniform meshes past K1's 5120-cell VMEM limit, gray
//     and non-gray (:859-907);
//   * jaybenne_tpu/ops/pallas_bucketed.py::_bucketed_kernel (:221; K4), the one
//     it runs on refined forests past that limit, gray and non-gray (:355-403).
//
// and the two census rounds of the JAX package's spatial decomposition:
//
//   * jaybenne_tpu/ops/pallas_grid.py::make_spatial_grid (:1943; K3s), a shard's
//     round on the whole z planes of a uniform IMC mesh;
//   * jaybenne_tpu/ops/pallas_bucketed.py::make_spatial_transport (:1360; K4s), a
//     shard's round over its blocks of any forest.
//
// They exist separately on the TPU only because of VMEM. Here one kernel gathers
// its tables from global memory: on a uniform forest it tracks global cells on
// the collapsed single block; on a refined one the ledger stays block-local. The
// region slabs, halos, parity layouts, SIGMA_REFRESH stale lanes,
// pause-and-rebucket rounds, bucket sorts and bf16 pair packing of the TPU
// kernels are not carried over. It computes what they compute, per particle:
//
//   * a table of shards at run time (not a template parameter), one row per
//     local shard of the spatial decomposition, so that one launch runs a whole
//     round: the shard's ledger slots [slot_lo, slot_hi) (its lane is the slot's
//     index in that slice), its owned range [own_lo, own_hi), its K2 seed and
//     the first row of its range in the cell table. The range is the global z
//     cells of the shard's slab on the collapsed uniform mesh (K3s, cell table
//     row ((k - own_lo) ny + j) nx + i after the shard's first), or the shard's
//     blocks with SMR (K4s, row (block - own_lo) cells per block + local cell
//     after it; the block table and lookup grid global). Only a lane whose cell
//     lies in its shard's range runs, and a lane pauses, alive and short of
//     census, after the event that takes it out. With DDMC in 2D/3D a leak into
//     a finer block outside the range is not resampled: its code goes to the
//     ledger's leak column for the owning shard. On one device the table has one
//     row, the whole ledger and the whole mesh, and the census is the same draw
//     for draw;
//
//   * each lane runs its own history while alive && tau < 1 && it < max_iters,
//     with its own iteration counter. A lane of the JAX tile is active from
//     iteration 0 until census or absorption, so the lane's counter equals the
//     tile's for every draw the lane makes, and the variates (kernel_rng.cuh,
//     keyed by seed, lane, it, tag) are the JAX kernel's interpret-mode
//     variates. Tags follow the JAX DrawPool's order:
//     exp23 is tag 0, then the u23 branch draw (ABSORB only), then the u16 word,
//     then the circle word (multi-D only);
//   * per event: d_coll = exp23 * inv_sigt[cell]; with ABSORB a u23 branch draw
//     (a u16 draw must never feed a threshold test); d_end = c dt (1 - tau);
//     d_geom = min(dmin, d_end); the face distances c (face - x) / v on the
//     active axes; then, in order, collision (absorb when u23 < p_abs, else
//     scatter), crossing of x, else y, else z (ties go to the lower axis), else
//     census when d_end <= dmin (tau = 1 exactly). Absorption clears alive, sets
//     absorbed and does not scatter. A 1D scatter draws mu = 1 - 2 u16 with
//     vx = c mu, vy = c sqrt(1 - mu^2), vz = 0 (the azimuth is unobservable); a
//     multi-D scatter draws the azimuth from the circle word:
//     (c st cos(phi), c st sin(phi), c mu);
//   * domain walls use the half-finest-cell tolerant hit test and clip of the
//     JAX kernel's apply_bc (an exact comparison livelocks). After any wall hit
//     every active axis's cell is re-derived from the rebased position; every
//     other crossing updates the integer index;
//   * the per-cell table holds the f32 pair (p_abs = fleck sigma_a / sigma_t,
//     1 / sigma_t) in global row-major cell order, one 8-byte float2 per cell
//     (the TPU kernels' bf16 packing only halved their chunk scans). At the
//     128-cell stepdiff gate it stays in L1; at the 64^3 feedback mesh it is
//     2 MB and each event's gather is served from L2;
//   * DDMC (pallas_transport.py:502-870, 893-939, 1166-1167): the table holds
//     one 32-byte record per cell, (ea = fleck sigma_a, es = sigma_s +
//     (1 - fleck) sigma_a, P_lower, P_upper of x, y, z), read as two float4.
//     A lane whose cell has dmin sigma_t > tau_ddmc runs the DDMC event: the
//     albedo test 2 P (1 +- 1.5 v / c) against the extrapolated face
//     probability when it arrived at a face by an IMC crossing (rejection
//     bounces it into the neighbour cell eps_imc dx from the face, with no time
//     advance); else an exponential event time at rate c (ea + sum of the leak
//     rates P_face / dx) against the time to census: absorption, a leak eps_ddmc
//     dx beyond the face chosen by cumulative sum in the order x_lo, x_hi, y_lo,
//     y_hi, z_lo, z_hi (the numerical fall-through takes the last face) with the
//     transverse coordinates at the cell centre and a hemisphere direction, or
//     census with a uniform position in the cell and an isotropic direction.
//     Any other lane runs the IMC event with the JAX kernel's DDMC-mode
//     rounding (d_coll = exp23 / (sigma_t + tiny), absorption when u23 sigma_t
//     < ea) and records the face-arrival code +-(axis + 1) of a crossing (0
//     otherwise; a reflecting wall negates it). The ledger's face column is read
//     and written only by the DDMC instantiations. Draw tags continue the IMC
//     event's (the DrawPool's order): the albedo u23, the hemisphere mu from the
//     high half of the IMC scatter's u16 word, exp23, the leak u23, then u16
//     words for the leak mu, the census position and the census mu, each
//     followed by a circle word in 2D/3D where the JAX kernel draws one;
//   * SMR (pallas_transport.py:463-478, 888-891, 973-1151): each event gathers
//     the lane's block geometry (cell size, origin) from the block table, so
//     dmin, the face positions and, with DDMC, the reciprocal cell sizes (the
//     block table's f32(1 / dx) column) are per lane, and the cell table row is
//     block * cells-per-block + local cell. A lane whose index leaves its block
//     takes the global position origin + local, the domain BCs, and the lookup
//     probe: half a finest cell along a crossed face's normal (from the out
//     flags), 0.01 finest v / c along the others, with v the velocity after the
//     scatter and any reflection; floorf binning into the lookup grid, the new
//     block's origin subtracted (global - origin, in that order), and the cell
//     floorf(l / dx) by an IEEE divide, clipped. With DDMC in 2D/3D a leak
//     (not an albedo bounce) into a block of higher level is resampled onto a
//     fine subface: e = clip(rint(l / dx), 1, n - 1) on each transverse axis
//     gives the 2 (2D) or 4 (3D) fine faces around the coarse landing point;
//     one is picked by the fine block's P_lower (leak in +axis) or P_upper
//     (-axis), in 2D by u (P_l + P_u) >= P_l, in 3D by cumulative sum against
//     u (sum + tiny); the transverse position is redrawn uniformly on it and the
//     direction from a hemisphere into the block in the cyclic axis order. Its
//     variates continue the DrawPool after the DDMC event's: u_sel, u_t1, u_t2
//     (3D) and the hemisphere mu are u16 halves, then one circle word;
//   * NONGRAY (pallas_transport.py:484-501; pallas_grid.py:859-907;
//     pallas_bucketed.py:355-403): the table holds (rho, T, fleck, sigma_s) per
//     cell, one float4 (with DDMC followed by the six face probabilities and two
//     zeros: three float4), and each event evaluates EPBremss under NonCGSUnits
//     (models/opacity.py) at the lane's photon energy, read once from the
//     ledger's energy column, before the collision draw: x = E / (sb T), nu =
//     max(x (kb T) / h, 1e10), g = g_ff / nu, xc = min(nu h / (kb T), 80),
//     sigma_a = rho^2 g^3 / sqrt(T) (1 - exp(-xc)), in that order of float32
//     operations, each constant rounded to float32 on the host; then ea = fleck
//     sigma_a, sigma_t = ea + (sigma_s + (1 - fleck) sigma_a), and the event
//     runs with the DDMC-mode rounding (d_coll = exp23 / (sigma_t + tiny),
//     absorption when u23 sigma_t < ea); with DDMC the lane's own sigma_t picks
//     the branch (dmin sigma_t > tau_ddmc, pallas_transport.py:520-533). The JAX
//     kernel draws the same words with and without nongray, so the tags are
//     ABSORB's. K3 and K4 evaluate the models once per coefficient refresh and
//     stall a lane whose cell changed until the next one: the same function;
//   * events and the iteration maximum are summed per shard, in shared memory
//     and then with one int64 atomicAdd and one int32 atomicMax per block and
//     shard: integer atomics, so the statistics repeat exactly. The launch entry
//     zeroes the counters on the stream first (one cudaMemsetAsync).
//
// What bounds it on an H100: not bytes (each particle is read and written once
// per call, and the one table gather per event hits L1 or L2; SMR's block and
// lookup tables are O(blocks) and stay in L1), but the throughput of logf, the
// IEEE divides and the hash per event (NONGRAY adds an expf, a sqrtf and four
// divides), what a warp issues for nothing, and the longest history: a warp runs
// until its slowest lane ends, and on a hybrid forest a warp that holds lanes on
// both branches issues both bodies. On a spatial round, one launch per shard
// waited for each shard's slowest lane in turn.
//
// The schedule: one launch runs every local shard of a round (the shard table
// above). One thread takes one slot; the block then regroups once, before any
// event: it stages its runnable lanes (slot, shard, own iteration count,
// position, velocity, tau, cell, block, face, photon energy: at most 64 bytes a
// lane) in shared memory and deals them back so that they fill the lowest
// warps, those on the IMC branch first and, with DDMC, those on the DDMC branch
// from the next warp boundary. When the launch's blocks all fit on the card at
// once, the host asks for its slots spread: block b's warp w takes the 32 slots of
// group w x blocks + b, so that every block holds slots from across the launch (a
// ledger keeps its live particles first and its room to grow after them, and the
// blocks that held stepdiff's 100000 live lanes of 201152 slots in consecutive
// order left the busiest SM 1.69 times the mean SM's lane-events, counted by
// %smid; spread, 1.02). Dead, finished and unowned slots then leave whole
// warps empty, which issue nothing, and a hybrid warp runs one branch at its
// start. Each lane then runs its whole history with its state in registers: the
// lane's state in a struct, or the cell record returned by value, cost the 2D
// SMR DDMC instantiation a 240-byte stack frame (112 in the body with plain
// arrays) and halved its speed. A lane carries its slot and its own iteration
// count, so the results are bitwise those of one thread per slot. With SMR the
// block table carries f32(1 / dx) per axis (an IEEE divide on the host side), so
// the DDMC event's per-event divides are gone.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms a step by
// jaybenne_tpu_torch/profile.py, this kernel and the one before it, one thread
// per slot without a regroup, in one call): the native 128x64 hybrid 3.30-3.50
// against 3.25-3.62 (the regroup alone: 3.30 against 3.41-3.45 without it), the
// stepdiff gate 0.975-0.984 against 1.01-1.02. The slot order's warp efficiency
// (the plain version's per-slot events: their sum over 32 times the sum of each
// warp's longest lane) is 0.80 on the hybrid and 0.94 on stepdiff, so no
// regrouping can win more than a factor 1/0.80 and 1/0.94 there. Two other
// schedules were built and measured the same way and dropped: a persistent grid
// (as many blocks as the card holds) taking slots from a device-side cursor with
// a block regroup every 8 events, hybrid 2.88-2.92 against this one's 2.92-2.95
// in one call but stepdiff 1.33-1.35 against 0.96, since the block waits at
// each barrier for its slowest warp; and the same grid with warp-level refills
// and no barrier, slower than that on both.
//
// The event loop. Most events of a scatter-dominated lane stay in its cell, so a
// lane keeps what its cell gives an event in registers (``gather``: the record,
// the faces f dx and (f + 1) dx, with SMR the block's dx, origin and dmin) and
// gathers it again only after an event that changed its cell or block; a lane of
// a uniform mesh with DDMC gathers before every event, as before. The same
// operations run on the same operands, so the census stays bitwise its plain
// version's. A K2 word depends only on (seed, lane, iteration, tag), so an event's
// draws and what follows from them alone (exp23, the u23 branch draw, mu,
// sqrt(1 - mu^2), the circle's cos and sin) need not wait for its state: a gray
// lane on a refined forest makes them during the event before and carries them;
// a gray lane on a uniform mesh makes them at the top of the event, before the
// face divides; a DDMC or NONGRAY lane in place, the scatter's in the scatter.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; census_bench.py, each census the
// median of 7 on the same saved inputs, the kernel before this loop in the same
// call, in turns; variants built and dropped as noted): the cache alone took the
// native hybrid from 3.68 to 3.17 ms and slowed no gray route by more than 3 %;
// every IMC event's draws one event ahead took stepdiff_smr's census 10-14 %
// down in three calls but the 64^3 feedback census 5-6 % and the 2D feedback
// census 6-9 % up; the draws at the top of the event left stepdiff_smr 1-3 % up
// and took K3s's round 11-13 % and the 64^3 feedback census 1-3 % down; drawing
// only the collision's words ahead, and keeping no cell for NONGRAY, were no
// better and were dropped. With the placement above (two calls, four turns
// each): stepdiff_smr 2.085 -> 1.80 ms, the 64^3 feedback census 5.80 -> 5.63,
// K3s's round 2.99 -> 2.65, the native hybrid 3.42 -> 3.08, stepdiff 1.001 ->
// 1.000; the event loop's common path (a scatter in the cell) 243 -> 231 SASS
// instructions in 2D SMR, 297 -> 279 in 3D. The census issues 0.39-0.52 of the
// card's instruction rate on that path alone.
//
// The gray event on a uniform 1D or 2D mesh (stepdiff, the 2D feedback path).
// Counted per warp-event by a counting variant (chip_smoke.py ``path_mix``), a
// lane of the warp scattered in 0.998 (1D) and 0.996 (2D) of them, crossed in 0.82
// and 0.88, hit a wall in 0.014 and 0.021: so such a lane gathers its cell's
// record after every event, without the branch (``kGatherEvery``), and a 1D lane
// sets vy and vz once, from its last scatter's mu, when its history ends
// (``kVyAfter``: the scatter's sqrtf leaves the loop); a gray lane steps its K2
// key by kItStep an event. Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// census_bench.py, each candidate built alone and timed against the kernel before
// it in turns): stepdiff's census 1.0019 ms -> 0.8916 with vy after the history
// alone, 0.9703 with the branch-free gather alone, 0.9893 with the stepped key
// alone, 0.8502 with all three, 0.5808 with the slots spread too (above); the 2D
// feedback census 1.6854 -> 1.6363 with the gather, the key and the spread (vz
// after the history cost 1.1 % more). Landed, four turns each: stepdiff 0.9946 ->
// 0.5771 ms, the 2D feedback census 1.6773 -> 1.6276. Dropped: drawing 1D events
// one ahead (1.2 % slower with the spread, 0.9 % without); 128-thread blocks
// (stepdiff 27 % faster, the 2D and 64^3 feedback censuses 9.5 % and 6.3 %
// slower); the 1 KB 1D cell table staged in shared memory (7 % slower); a DDMC or
// NONGRAY lane carrying its key (9 registers fewer for the 2D SMR DDMC kernel, so
// 4 resident blocks instead of 3: its K4s round 8-9 % slower).
//
// The 3D gray DDMC census (the 64^3 DDMC row, stepdiff_3d). Measured before any
// change (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phases 14 and 20,
// census_bench.py): the 64^3 row's 200340 live lanes of 663168 slots run 9.2
// events each and the longest 23-28, stepdiff_3d's 499963 of 1016384 run 4.8 (3.2
// in its level-0 blocks, 8.6 in its level-1 ones) and the longest 23-26; the slot
// order's warp efficiency is 0.59 and 0.41; the busiest SM runs 1.36 and 1.47
// times the mean SM's lane-events (%smid); a lane leaks in 89 % and 79 % of its
// events and reaches census in the rest, and on stepdiff_3d 53 % of warp-events
// hold a lane that meets a block face (re-homing). The kernel alone took 0.18 of
// the 64^3 row's 0.45 ms census call: most of the rest was the ledger's collapse
// to one block and back in 44 elementwise passes (then one kernel pass each way,
// now folded into this kernel: see the census call below). The 112-byte stack
// frame of every 2D/3D DDMC
// instantiation held the lane's state arrays (position, cell, velocity, faces,
// cell size) in local memory: the compiler had turned the face placement's
// unrolled ``if (leak >> 1 == a)`` into stores at a runtime index, so every DDMC
// event read and wrote them there (LDL/STL in the SASS); the placement now writes
// every element through a select (``place_across``). Measured (census_bench.py,
// two turns in one call, the same inputs): the frame 112 -> 32 bytes (cosf's slow
// path, 20-25 LDL/STL left of 110-157), the kernel alone on the 64^3 row 0.182 ->
// 0.074 ms, on stepdiff_3d 0.284 -> 0.208 (79 -> 101 registers, 3 -> 2 resident
// blocks), on the native hybrid 2.83 -> 2.17, on phase 11's 2D/3D hybrid ledgers
// 22-30 % less; no route slower than 1 %. Built, measured in turns
// against the kernel before it in one call each, and dropped: a refill schedule
// (as many blocks as the card holds; each warp runs its lanes one event at a time
// and, once 8 or 16 are idle, refills them from a launch-wide cursor over groups
// of 32 slots; results bitwise) raised the SIMT efficiency from 0.59 to 0.61-0.66
// and from 0.41 to 0.69-0.82, yet the 64^3 row's kernel took 4-16 % longer,
// stepdiff_3d's moved by -2.3 to +1.4 % (97 registers, 2 resident blocks; held to
// 80 by launch bounds it spilled and took 8-10 % longer) and the absorbing 3D twin
// on a hybrid ledger took 20-29 % longer; one divide in the albedo test, measured
// only beside the refill, sped up no route it reaches. A launch bound of one
// resident block a SM, which should change nothing, raised the 1D DDMC kernels'
// registers (40 -> 44) and slowed stepdiff_ddmc's census by 23 %.
//
// The census call around the kernel (stepdiff_ddmc's 1D DDMC census, inf_stiff's
// absorbing twin, the 64^3 ep_bremss census). Measured first (NVIDIA H100 80GB
// HBM3, 700.00 W; census_bench.py, CUDA events around the call's parts): the 64^3
// ep_bremss call of 0.146 ms was the kernel's launch 0.047, the table's five
// elementwise passes 0.036, the ledger's collapse and expansion 0.038 and two
// counter fills 0.010; the 1D DDMC call of 0.054 ms was the launch 0.026, the
// table 0.0086 and the counters 0.010. The 1D DDMC kernel is not issue-bound (its
// warps issue for 0.33 of its time; a lane runs 11.9 events, the longest 28; four
// times the lanes take 0.45 of the time an event), and the ep_bremss kernel
// evaluates EPBremss only where a lane gathers a cell (98 SASS instructions, at
// most 9 % of its loop). So the table is one pass (csrc/table_kernel.cu), the
// counters one fill, and on a uniform mesh of several blocks this kernel folds the
// collapse to one block and the expansion back into its reads (``take``) and
// writes (``retire``) of every slot, by the plain versions' operations ((x + d) - d
// is not always x, so a slot that no lane takes is written back too); the 1D DDMC
// record carries the cell's leak rate, cdf and c cdf (``kCell1d``), and that event
// hashes its words at its start. Measured in turns against the kernel before it
// (census_bench.py, two turns, medians of 7): the calls 0.0537 -> 0.0483 ms (1D
// DDMC), 0.0549 -> 0.0435 (its absorbing twin), 0.1464 -> 0.0870 (64^3 ep_bremss),
// 0.2282 -> 0.1046 (64^3 DDMC); the fold costs the ep_bremss launch 0.047 -> 0.060
// ms (it reads every slot) for the two passes' 0.038. Without the lighter 1D event
// the 1D DDMC kernel took 41 registers (5 resident blocks, not 6: two waves) and
// its call was 4 % slower than before; 128-thread blocks for the 1D DDMC
// instantiations, built and dropped, took the twin's call 4 % lower and
// stepdiff_ddmc's 1.3 % higher.
//
// The two non-gray census calls on one block and on a forest (stepdiff and
// stepdiff_smr with ep_bremss: 1.6 and 2.2 events a live lane, 55 % of the
// launch's blocks without one, the loop at the issue rate 0.21 and 0.36 of the
// kernel). Measured first (NVIDIA H100 80GB HBM3, 700.00 W; census_bench.py, the
// call's parts in calls of their own, each less the two gaps its events add): on
// the forest the set-up rebuilt the block table, levels and lookup grid in six
// small operations every call (0.013 ms of 0.050), on both the table pass only
// copied four coefficient columns (0.005), and the counters' fill cost 0.002. So
// the forest's tables are built once per mesh (ops/transport_kernel.py,
// forest_tables), the kernel reads the non-gray record straight from the
// coefficient columns where the table would copy them (``Columns``; not with
// DDMC, a permuted uniform mesh or several ranges), and the launch entry zeroes
// the counters with a memset. Measured in turns against the kernel before it
// (census_bench.py, two turns, medians of 7, each candidate alone): the forest
// tables once took stepdiff_smr's ep_bremss call 0.0500 -> 0.0368 ms and
// stepdiff_3d's 0.224 -> 0.210; the columns took stepdiff's ep_bremss call 0.0213
// -> 0.0192 (the launch 0.0005 longer for four loads in place of one); the memset
// 1-2 % off the short calls. Built and dropped: counters without any zeroing,
// running totals that every block adds into and fences, and the last block by a
// ticket moves out and leaves at zero (the CUDA samples' threadfence reduction):
// every block, empty ones too, takes the ticket on one address, so the launches
// took longer (inf_stiff's call +7.9 %, the 64^3 ep_bremss call +5.5 %).
//
// The float64 census on a forest (stepdiff_smr's transport_2d_smr_f64, the 8-shard
// stepdiff round's transport_1d_smr_f64@blocks). Read first (NVIDIA H100 80GB HBM3,
// 700.00 W; census_bench.py on the paths' saved inputs): 98 and 68 registers, 2 and
// 3 resident blocks of 256; the warps issue for 0.61 and 0.56 of the kernel's time
// (the warp path mix at the card's issue rate: a warp-event holds a lane that
// crosses a cell in 0.92 and 0.73 of them, one that reaches a block face in 0.17
// and 0.02, at 367 and 178 more instructions), and the time an event fell 11-13 %
// and 16-24 % with two and four times the lanes: latency and issue both, too few
// warps to hide the FP64 chains (log 84 SASS instructions, divide 18). The lane
// kept in registers what its cell gives every event, in double two registers each
// (the block's dx and origin, dmin, the faces). So a lean lane (``kLean``, on the
// 1D and 2D gray forests without absorption) keeps its record alone and makes the
// rest anew at each event (an L1 read of the block table, two multiplies an axis),
// and draws at the top of the event: 98 -> 78 registers and 2 -> 3 resident blocks
// in 2D, 68 -> 60 and 3 -> 4 in 1D, no spills, every other instantiation's ptxas
// line as before. Measured in turns against the kernel before it (census_bench.py,
// the same inputs, outputs bitwise): stepdiff_smr's census 3.142 -> 2.499 ms, the
// 8-shard first round 1.770 -> 1.630. Built, measured and dropped: a register
// budget in __launch_bounds__ (3 and 4 blocks; with the lean lane the same blocks
// and time, 2.488 and 1.626 ms; alone, 2D at 80 registers with 16 bytes of spills,
// 2.706 ms, the 1D round at 64 registers 7.7 % slower; a 2D budget of 4 blocks,
// 64 registers, 40 bytes of spills, 3.320 ms), the lean lane drawing one event
// ahead (80 and 64 registers, 2.644 and 1.697 ms). 128-thread blocks would add
// resident warps only under 73 registers.
//
// The float64 census on a uniform 1D mesh (stepdiff's transport_1d_f64, 100001 live
// lanes of 201152 slots; stepdiff_ddmc's transport_1d_ddmc_f64). Read first (NVIDIA
// H100 80GB HBM3, 700.00 W; census_bench.py on the paths' saved inputs): 54 and 61
// registers, 4 resident blocks; 786 blocks of 256 slots, the live lanes in the
// first 391, for 528 resident, so the launch did not spread; the busiest SM ran
// 1.35 and 1.37 times the mean SM's lane-events (%smid), since the block
// scheduler put 4 live blocks on some SMs and 2 on others; the warps issued for
// 0.53-0.56 of the gray kernel's time (the busiest SM's about 0.75; the double log
// 84 of its event's 241 SASS instructions, the divide 18), and the time an event
// fell 28 % with twice the lanes. So these two launch on the card's resident grid
// (``kRounds``): at most SMs x resident blocks, one wave, each round the next
// kThreads x blocks slots spread over the blocks as a one-wave launch spreads
// them, so that stepdiff's live lanes run on every SM (busiest SM 1.06 and 1.04
// times the mean), and the gray lane draws one event ahead (``kDrawAhead``, vy
// after the history, so e23 and mu are what it carries). A round waits for the
// block's slowest warp before the next, and runs only the live lanes among its
// slots: a ledger twice or four times stepdiff's, live lanes in several rounds,
// took 21-29 % longer than one thread a slot, so the host takes the resident grid
// only where the slots take at most two rounds (ops/transport_kernel.py:
// launch_shape), where a ledger's live slots, first, fit the first. Measured in
// turns against the kernel before it (census_bench.py, the same inputs, outputs
// bitwise): transport_1d_f64 1.461 -> 1.184 ms (60 registers, 4 blocks; in other
// calls the rounds alone 1.284, 48 registers and 5 blocks, the draws ahead alone
// 1.441, 54 and 4), transport_1d_ddmc_f64 0.0542 -> 0.0499 (53 registers); their
// ledgers of two and four times the lanes within 2 %. Built, measured and
// dropped: two lanes a thread, an event of each in turn (87 registers, 2 blocks,
// 1.623 ms: two chains in a warp are as many as two warps' and cost the registers),
// and on the DDMC lane its record kept in registers or its exp23 one event ahead
// (1.8 % and 1.3 % slower: a DDMC lane leaks out of its cell in most events).
//
// The spatial round of the 2D SMR+DDMC block route (K4s, transport_2d_ddmc_smr@
// blocks, 8 shards of 24288 slots). Read first (NVIDIA H100 80GB HBM3, 700.00 W;
// census_bench.py on the path's first and second rounds): 759 blocks for 528
// resident, 1.44 waves, each shard's live lanes at the start of its slice, so 381
// blocks held the first round's 96000 lanes (2.2 events a lane, the longest 10,
// issue share 0.31) and the second round's 9666 (1.5 events, the longest 8,
// issue share 0.05) sat in 319 blocks, the busiest SM running 4.1 times the mean
// SM's lane-events: latency, a few events a lane on a few SMs. So the host asks
// this instantiation to interleave its shards (``kSpreadShards``): group G of 32
// slots is shard G % count's (G / count)-th, and the first W blocks take group w
// x W + b spread over them, W the resident blocks (or the launch's, if fewer)
// made prime to the shard count, so that the first wave holds every shard's
// first groups and a block's warps come from several shards (with W = 528, a
// multiple of 8, block b held only shard b mod 8's lanes, and the refined shards'
// longer histories sat on some SMs). Measured in turns against the kernel before
// it (census_bench.py, the same inputs, outputs bitwise): first round 0.0251 ->
// 0.0229 ms, second 0.0179 -> 0.0179. Built, measured and dropped: a launch over
// a list of the pending slots built by the insert kernel's scans, on the
// resident grid (1.28 and 1.40 times the kernel before it, its two list launches
// aside; in a loop of rounds it spilled 24 bytes).
//
// The float64 non-gray census on a 2D forest (stepdiff_smr with ep_bremss,
// transport_2d_abs_smr_ng_f64: 100005 live lanes of 221504 slots). Read first
// (NVIDIA H100 80GB HBM3, 700.00 W; census_bench.py on the path's saved inputs):
// 91 registers, a 40-byte stack, 2 resident blocks, so 866 blocks of 256 slots in
// 3.28 waves, the live lanes in the first 391 of them; 2.16 events a live lane,
// the longest 24, SIMT efficiency 0.26; the whole loop at the card's issue rate
// 0.44 of the kernel alone (0.063 ms), its busiest SM running 1.45-1.52 times the
// mean SM's lane-events; spread over the blocks of its several waves, 0.122 ms.
// So it runs on the resident grid in rounds (``kRounds``, as the uniform 1D routes
// do) where its ledger takes at most four (``kRoundsMax``): every live lane in the
// first rounds, on every SM, and the later rounds, of dead slots, short. Built so,
// the instantiation took 79 registers and 3 resident blocks (no other
// instantiation's resources moved), its draws in place as before. Measured in
// turns against the kernel before it (census_bench.py, two turns, the same
// inputs, outputs bitwise): the census 0.0590 -> 0.0553 ms, the kernel alone
// 0.0633 -> 0.0593. Built, measured and dropped: the lean lane (``kLean``) alone,
// 80 registers and 3 blocks, 0.0615 ms against 0.0598 (the cell's geometry made
// anew at each event costs more than the third block gains); the lean lane in
// rounds, 72 registers, 0.0552 ms, no better than the rounds alone.
//
// Built without --use_fast_math and with --fmad=false, so that every operation
// rounds as the plain PyTorch version's does. NDIM = 1 without absorption or DDMC
// executes the same float operations as the first (1D-only) version of this
// kernel, so the stepdiff gate reproduces its events and error to every digit;
// every line the DDMC, SMR and NONGRAY parameters add is dead code when they are
// false.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_rng.cuh"

namespace {

constexpr int kThreads = 256;

// The census's arithmetic at its working precision (``Real``): the float32
// census's constants, math calls and vector loads, unchanged, and the float64
// census's. kBig is the face distance of a lane at rest on an axis, kTiny the
// floor added to a rate before a divide: 3e38 and 1e-37 in float32, the largest
// and the smallest normal double in float64 (the JAX float64 loop's finfo max and
// tiny). A record of four reals is read as one float4 in float32 and, since a
// thread has no 32-byte load, as two double2 in float64.
template <class Real>
struct Num;

template <>
struct Num<float> {
  using V2 = float2;
  using V4 = float4;
  static constexpr float kBig = 3.0e38f;
  static constexpr float kTiny = 1.0e-37f;
  __device__ static __forceinline__ float sqrt(float x) { return sqrtf(x); }
  __device__ static __forceinline__ float exp(float x) { return expf(x); }
  __device__ static __forceinline__ float floor(float x) { return floorf(x); }
  __device__ static __forceinline__ float rint(float x) { return rintf(x); }
  __device__ static __forceinline__ float fmin(float a, float b) { return fminf(a, b); }
  __device__ static __forceinline__ float fmax(float a, float b) { return fmaxf(a, b); }
  __device__ static __forceinline__ bool same_bits(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b);
  }
  // element i of p read as an array of 4- or 2-vectors, through the read-only cache
  __device__ static __forceinline__ float4 ld4(const float* p, size_t i) {
    return __ldg(reinterpret_cast<const float4*>(p) + i);
  }
  __device__ static __forceinline__ float2 ld2(const float* p, size_t i) {
    return __ldg(reinterpret_cast<const float2*>(p) + i);
  }
  __device__ static __forceinline__ float4 make4(float x, float y, float z, float w) {
    return make_float4(x, y, z, w);
  }
};

struct Double4 {
  double x, y, z, w;
};

template <>
struct Num<double> {
  using V2 = double2;
  using V4 = Double4;
  static constexpr double kBig = 1.7976931348623157e308;
  static constexpr double kTiny = 2.2250738585072014e-308;
  __device__ static __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  __device__ static __forceinline__ double exp(double x) { return ::exp(x); }
  __device__ static __forceinline__ double floor(double x) { return ::floor(x); }
  __device__ static __forceinline__ double rint(double x) { return ::rint(x); }
  __device__ static __forceinline__ double fmin(double a, double b) { return ::fmin(a, b); }
  __device__ static __forceinline__ double fmax(double a, double b) { return ::fmax(a, b); }
  __device__ static __forceinline__ bool same_bits(double a, double b) {
    return __double_as_longlong(a) == __double_as_longlong(b);
  }
  __device__ static __forceinline__ Double4 ld4(const double* p, size_t i) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + 2 * i);
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 2 * i + 1);
    return Double4{a.x, a.y, b.x, b.y};
  }
  __device__ static __forceinline__ double2 ld2(const double* p, size_t i) {
    return __ldg(reinterpret_cast<const double2*>(p) + i);
  }
  __device__ static __forceinline__ Double4 make4(double x, double y, double z, double w) {
    return Double4{x, y, z, w};
  }
};

enum Bc : int { kPeriodic = 0, kOutflow = 1, kReflecting = 2 };

// Scalars of the event body at the census's precision, each rounded on the host
// as the JAX kernel rounds it (float32) or as its float64 loop does (float64).
// Per-axis arrays are (x, y, z); only the first NDIM are read.
template <class Real>
struct Geom {
  int n[3];           // cells per axis of the collapsed single block (SMR: a block)
  int bc[6];          // (ix1, ox1, ix2, ox2, ix3, ox3)
  int max_iters;
  Real dx[3];         // cell size (of the collapsed block; SMR gathers it)
  Real inv_dx[3];     // Real(1 / dx)
  Real org[3];        // block origin (domain lower bound)
  Real lo[3], hi[3];  // domain bounds
  Real lo_half[3];    // lo + half a finest cell
  Real hi_half[3];    // hi - half a finest cell
  Real span[3];       // Real(hi - lo)
  Real dmin;          // smallest cell size over the active axes (uniform)
  Real c, inv_c;      // speed of light and its reciprocal
  Real cdt;           // c * dt
  Real inv_cdt;       // 1 / (c * dt)
  // DDMC only
  Real tau_ddmc;      // a lane is on the DDMC branch when dmin sigma_t > tau_ddmc
  Real eps_imc;       // albedo bounce-back offset, in cells
  Real eps_ddmc;      // leak offset, in cells
  Real dt;            // Real(dt)
  Real inv_dt;        // Real(1) / Real(dt)
  Real lam2;          // Real(2 lambda_ext)
  Real pf2_num;       // Real(2 (2 / 3))
  // SMR only
  int nt[3];          // lookup tiles per axis
  Real tile[3];       // tile edge
  Real nudge_cross[3];  // 0.5 finest: the probe along a crossed face's normal
  Real nudge_tilt[3];   // 0.01 finest: the probe along the other axes, x v / c
  // NONGRAY only: EPBremss under NonCGSUnits (ops/transport_kernel.py,
  // NONGRAY_CONSTANTS)
  Real ng_rho_scale, ng_temp_scale, ng_len_scale;  // NonCGSUnits' scales
  Real ng_sb, ng_kb, ng_hh;  // Stefan-Boltzmann, Boltzmann and Planck constants
  Real ng_g;                 // (cff / m_p^2)^(1/3)
  Real ng_freq_min;          // the frequency clamp, 1e10
  Real ng_xc_max;            // the clamp of h nu / k T, 80
  // A uniform forest of several blocks, run collapsed to one block (``fold``
  // nonzero; never with SMR): the kernel applies collapse_plain's shift where it
  // reads a slot and expand_plain's where it writes one (ops/transport_kernel.py)
  int fold;
  int nrbx, nrby;     // root blocks along x and y
  int nloc[3];        // cells a block per axis
  Real shift[3];      // the extent of a block per axis
};
constexpr int kGeomInts = 19;
constexpr int kGeomFloats = 57;

// The local shards of one launch, by value in the kernel's parameters: shard k
// owns the ledger slots [slot_lo, slot_hi) (a slot's lane is its index in the
// slice), the owned range [own_lo, own_hi) (of blocks with SMR, of global z cells
// in 3D without; a lane runs while its cell lies in it), and the first row of its
// range in the cell table; its K2 seed of the round is seed[k], in device memory,
// so that a CUDA graph's launch keeps the pointer and each replay reads the seed
// copied there since. The launch scans the slots [first, first + n). ``go``, in
// device memory too, gates a spatial round: where it is not null and reads 0,
// every thread returns before it reads or writes a slot (a round that begins
// with nothing unfinished changes nothing, the fold's round trip included).
constexpr int kMaxShards = 64;
struct Shards {
  int count;
  int first;
  int spread;  // a block's warps take slot groups spread over the launch
  int slot_lo[kMaxShards], slot_hi[kMaxShards];
  int own_lo[kMaxShards], own_hi[kMaxShards];
  int row[kMaxShards];
  const uint32_t* seed;  // device memory, one a shard
  const uint8_t* go;     // device memory, one flag for the launch, or null
  // where the instantiation spreads its shards (``kSpreadShards``) and width > 0:
  // the first width blocks take 32-slot groups spread over them, later blocks 256
  // consecutive; group G of the launch is shard G % count's (G / count)-th group
  // of its slice of ``slice`` slots (the shards' slices equal and adjacent)
  int width, slice;
};

// One lane's shard: its owned range, the cell table row of the range's first
// cell, its seed.
struct Own {
  int lo, hi, row;
  uint32_t seed;
};

__device__ __forceinline__ Own own_of(const Shards& S, int k) {
  return Own{S.own_lo[k], S.own_hi[k], S.row[k], __ldg(S.seed + k)};
}

// The non-gray record read straight from the coefficient columns (rho, T, fleck,
// sigma_s), where the cell table would be their verbatim copy: a non-gray census
// without DDMC over one owned range, on one block or block by block on a forest
// (ops/transport_kernel.py, ``record_columns``). ``rho`` is null where the cell
// table holds the record.
template <class Real>
struct Columns {
  const Real* rho;
  const Real* temp;
  const Real* fleck;
  const Real* sigma_s;
};

// A refined forest's tables (SMR instantiations only): per block three rows of
// four reals, (dx, dy, dz, 0), (ox, oy, oz, 0) and the reciprocals (1/dx, 1/dy,
// 1/dz, 0); the int32 level of each block; the int32 lookup grid, (z, y, x)
// row-major. And the non-gray record's columns (NONGRAY without DDMC).
template <class Real>
struct Forest {
  const Real* block;
  const int32_t* level;
  const int32_t* lookup;
  Columns<Real> cols;
};

template <class Real>
struct Ledger {
  Real* x[3];         // x, y, z
  Real* v[3];         // vx, vy, vz
  Real* tau;
  int32_t* ci[3];     // i, j, k
  uint8_t* alive;
  uint8_t* absorbed;
  int32_t* face;      // face-arrival code (DDMC instantiations only)
  int32_t* blk;       // owning block (SMR instantiations only)
  const Real* energy;  // photon energy, read only (NONGRAY instantiations only)
  int32_t* leak;      // pending leak code, written on a pause (DDMC with SMR only)
};

template <class Real>
__device__ __forceinline__ Real clip(Real v, Real lo, Real hi) {
  using N = Num<Real>;
  return N::fmin(N::fmax(v, lo), hi);
}

// Python's floor division and modulo of an int32 by a positive divisor.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// The fold (Geom::fold), collapse_plain and expand_plain on one slot. The
// collapse: with (bx, by, bz) = (block mod nrbx, (block // nrbx) mod nrby, block //
// (nrbx nrby)), x += Real(bx) Dx and i += bx nx on each axis. The expansion: bk =
// i // nx, i -= bk nx, x -= Real(bk) Dx on each axis and block = (bz nrby + by) nrbx
// + bx, here summed axis by axis. The same float and int32 operations as the
// plain versions on every slot, so the same bits: (x + d) - d is not always x,
// so a slot that no lane takes gets the round trip too.
template <class Real>
__device__ __forceinline__ void root_block(const Geom<Real>& g, int b, int (&bk)[3]) {
  bk[0] = floor_mod(b, g.nrbx);
  bk[1] = floor_mod(floor_div(b, g.nrbx), g.nrby);
  bk[2] = floor_div(b, g.nrbx * g.nrby);
}

// expand_plain on axis ``a`` of a collapsed (x, i): writes them to their
// block-local values; returns the axis's term of the block id.
template <class Real>
__device__ __forceinline__ int unfold_axis(const Geom<Real>& g, int a, Real& x, int& i) {
  const int bk = floor_div(i, g.nloc[a]);
  i = i - bk * g.nloc[a];
  x = x - (Real)bk * g.shift[a];
  return bk * (a == 0 ? 1 : (a == 1 ? g.nrbx : g.nrbx * g.nrby));
}

// The round trip of slot ``q``'s axes from ``a0`` on, which the census does not
// move, as its block ``b`` gives it: each value written where its bits change.
// Returns those axes' terms of the block id.
template <class Real>
__device__ __forceinline__ int round_trip(const Ledger<Real>& L, const Geom<Real>& g, int q,
                                          int b, int a0) {
  int bk[3];
  root_block(g, b, bk);
  int part = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a < a0) continue;
    const Real x0 = L.x[a][q];
    const int i0 = L.ci[a][q];
    Real x = x0 + (Real)bk[a] * g.shift[a];
    int i = i0 + bk[a] * g.nloc[a];
    part += unfold_axis(g, a, x, i);
    if (!Num<Real>::same_bits(x, x0)) L.x[a][q] = x;
    if (i != i0) L.ci[a][q] = i;
  }
  return part;
}

// Whether a lane's cell lies in the owned range: its block with SMR, its global
// z cell in 3D without; 1D/2D uniform meshes are owned whole.
template <int NDIM, bool SMR>
__device__ __forceinline__ bool owned(const Own& o, int blk, const int (&ci)[3]) {
  if constexpr (SMR) return blk >= o.lo && blk < o.hi;
  if constexpr (NDIM == 3) return ci[2] >= o.lo && ci[2] < o.hi;
  return true;
}

// EPBremss under NonCGSUnits at photon energy en (models/opacity.py), in the JAX
// package's order of operations. The clamps pass a NaN through, as
// torch.clamp_min/clamp_max and jnp.maximum/minimum do.
template <class Real>
__device__ __forceinline__ Real epbremss(const Geom<Real>& g, Real rho, Real temp, Real en) {
  using N = Num<Real>;
  const Real r = rho * g.ng_rho_scale;
  const Real t = temp * g.ng_temp_scale;
  const Real x = en / (g.ng_sb * t);
  Real freq = x * (g.ng_kb * t) / g.ng_hh;
  freq = freq < g.ng_freq_min ? g.ng_freq_min : freq;
  const Real gg = g.ng_g / freq;
  Real xc = freq * g.ng_hh / (g.ng_kb * t);
  xc = xc > g.ng_xc_max ? g.ng_xc_max : xc;
  return r * r * gg * gg * gg / N::sqrt(t) * (Real(1.0) - N::exp(-xc)) * g.ng_len_scale;
}

// Draw tags of the DDMC event, continuing the IMC event's (the DrawPool's
// order), and of the SMR subface resample after it.
template <int NDIM, bool ABSORB>
struct DdmcTags {
  static constexpr bool kMultiD = NDIM >= 2;
  static constexpr uint32_t kU16 = ABSORB ? 2u : 1u;  // the IMC scatter's u16 word
  static constexpr uint32_t kAlbedo = kU16 + (kMultiD ? 2u : 1u);
  static constexpr uint32_t kExp = kAlbedo + (kMultiD ? 2u : 1u);
  static constexpr uint32_t kXi = kExp + 1u;
  static constexpr uint32_t kW2 = kXi + 1u;  // leak mu (lo), census x (hi)
  static constexpr uint32_t kW3 = kW2 + (kMultiD ? 2u : 1u);
  // the resample: in 2D u_sel and u_t1 are the halves of word kRes; in 3D u_sel
  // is the spare high half of the census mu word (kW3 + 1) and u_t1, u_t2 the
  // halves of kRes; then the hemisphere mu (kRes + 1, low half), the circle
  static constexpr uint32_t kRes = kW3 + (NDIM == 3 ? 3u : 2u);
};

// Whether the DDMC event reads what its cell alone gives it from the record
// instead of making it: on a uniform 1D gray mesh, where the record's columns 4-6
// (the face probabilities of y and z, which 1D never reads) hold the lower face's
// leak rate P_lower f32(1 / dx), cdf = (ea + the two leak rates) + tiny (without
// ABSORB the leak rates and tiny) and c cdf, made by the table with the event's own
// float32 operations (ops/transport_kernel.py: _pair_table). There the event also
// hashes its words at its start (exp, xi and the leak's or census's word, which
// depend on (seed, lane, it, tag) alone), off the chain that waits for the record
// and the divide.
template <int NDIM, bool DDMC, bool SMR, bool NONGRAY>
constexpr bool kCell1d = NDIM == 1 && DDMC && !SMR && !NONGRAY;

// A DDMC lane's move across a face of its cell on axis ``ax`` (the lower face when
// ``lower``): ``eps`` cells beyond the face, into the neighbour cell, with the
// direction (vn, vt1, vt2) on the axes (ax, ax + 1, ax + 2) mod 3; with
// ``centre`` the other coordinates go to the cell centre, else they stay. Every
// element is written on every axis through a select, never through an index
// that depends on ``ax``: a store to np_[ax], nci[ax] or v[(ax + 1) % 3] puts the
// lane's state arrays in local memory (a 112-byte stack frame, read and written
// on every DDMC event before, by the SASS). An ``ax`` outside the active axes
// (not a face code) leaves the lane as it is.
template <int NDIM, class Real>
__device__ __forceinline__ void place_across(int ax, bool lower, Real eps,
                                             Real vn, Real vt1, Real vt2, bool centre,
                                             const Real (&dx)[3], const Real (&flo)[3],
                                             const Real (&fhi)[3], const int (&ci)[3],
                                             Real (&np_)[3], int (&nci)[3], Real (&v)[3]) {
  if (ax < 0 || ax >= NDIM) return;
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    const bool hit = a == ax;
    const Real edge = lower ? flo[a] - eps * dx[a] : fhi[a] + eps * dx[a];
    np_[a] = hit ? edge : (centre ? flo[a] + Real(0.5) * dx[a] : np_[a]);
    nci[a] = hit ? ci[a] + (lower ? -1 : 1) : nci[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int q = (a - ax + 3) % 3;
    v[a] = q == 0 ? vn : (q == 1 ? vt1 : vt2);
  }
}

// The DDMC event of one lane (pallas_transport.py:655-870): writes the lane's
// new position, cell index, velocity, tau and absorption; the face code it
// leaves is 0. ``pf`` holds the cell's (P_lower, P_upper) of x, y, z, ``dx``
// and ``inv_dx`` its cell size and f32 reciprocal, ``flo`` and ``fhi`` its
// faces; with ``kCell`` (``kCell1d``) pf[2..4] the cell's leak rate, cdf and c
// cdf. ``leak_code`` is set to -(axis + 1) for a leak through a lower face,
// +(axis + 1) through an upper one, else 0.
template <int NDIM, bool ABSORB, bool kCell, class Real>
__device__ __forceinline__ void ddmc_event(const Geom<Real>& g, uint32_t seed, uint32_t lane, uint32_t it,
                                           int face, Real ea, Real sig_t,
                                           const Real (&pf)[6], const Real (&dx)[3],
                                           const Real (&inv_dx)[3], const Real (&flo)[3],
                                           const Real (&fhi)[3], const Real (&p)[3],
                                           const int (&ci)[3], Real (&v)[3],
                                           Real (&np_)[3], int (&nci)[3], Real& ptau,
                                           bool& palive, bool& pabsorbed, int& leak_code) {
  using N = Num<Real>;
  using D = Draw<Real>;
  using T = DdmcTags<NDIM, ABSORB>;
  constexpr bool kMultiD = T::kMultiD;
  constexpr uint32_t kTagU16 = T::kU16;
  constexpr uint32_t kTagAlbedo = T::kAlbedo;
  constexpr uint32_t kTagExp = T::kExp;
  constexpr uint32_t kTagXi = T::kXi;
  constexpr uint32_t kTagW2 = T::kW2;
  constexpr uint32_t kTagW3 = T::kW3;
  leak_code = 0;
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    np_[a] = p[a];
    nci[a] = ci[a];
  }
  // albedo test on arrival at a face: +code at the lower face, -code at the upper
  bool rejected = false;
  if (face != 0) {
    Real prob = Real(0.0);
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      const Real pf2 = g.pf2_num / (sig_t * dx[a] + g.lam2);
      const Real drift = Real(1.5) * v[a] * g.inv_c;
      if (face == a + 1) prob = pf2 * (Real(1.0) + drift);
      if (face == -(a + 1)) prob = pf2 * (Real(1.0) - drift);
    }
    rejected = D::u23(D::raw(seed, lane, it, kTagAlbedo)) > prob;
  }
  if (rejected) {  // bounce back into the neighbour cell, no time advance
    const Real amu = N::sqrt(D::u16_hi(D::raw(seed, lane, it, kTagU16)));
    const Real anu = N::sqrt(N::fmax(Real(1.0) - amu * amu, Real(0.0)));
    Real a2 = anu, a3 = Real(0.0);
    if constexpr (kMultiD) {
      Real cph, sph;
      D::circle(D::raw(seed, lane, it, kTagAlbedo + 1u), &cph, &sph);
      a2 = anu * cph;
      a3 = anu * sph;
    }
    const int fa = abs(face) - 1;
    const bool lower = face > 0;
    place_across<NDIM>(fa, lower, g.eps_imc, (g.c * (lower ? -Real(1.0) : Real(1.0))) * amu,
                       g.c * a2, g.c * a3, false, dx, flo, fhi, ci, np_, nci, v);
    return;
  }
  // in-cell step: leak rates P_face / dx, event time against census
  typename D::Word w_exp{}, w_xi{}, w2{};
  if constexpr (kCell) {
    const uint32_t key = jb_key(seed, lane, it);
    w_exp = D::word(key, kTagExp);
    w_xi = D::word(key, kTagXi);
    w2 = D::word(key, kTagW2);
  }
  Real lk[2 * NDIM];
  Real cdf, ccdf;
  if constexpr (kCell) {
    lk[0] = pf[2];
    cdf = pf[3];
    ccdf = pf[4];
  } else {
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      lk[2 * a] = pf[2 * a] * inv_dx[a];
      lk[2 * a + 1] = pf[2 * a + 1] * inv_dx[a];
    }
    Real leak_tot = lk[0] + lk[1];
#pragma unroll
    for (int e = 2; e < 2 * NDIM; ++e) leak_tot = leak_tot + lk[e];
    cdf = (ABSORB ? ea + leak_tot : leak_tot) + N::kTiny;
    ccdf = g.c * cdf;
    w_exp = D::raw(seed, lane, it, kTagExp);
  }
  const Real dt_ev = D::exp23(w_exp) / ccdf;
  const Real dt_rem = g.dt * (Real(1.0) - ptau);
  if constexpr (!kCell) w2 = D::raw(seed, lane, it, kTagW2);
  if (dt_ev < dt_rem) {
    ptau = ptau + dt_ev * g.inv_dt;
    if constexpr (!kCell) w_xi = D::raw(seed, lane, it, kTagXi);
    const Real xi = cdf * D::u23(w_xi);
    if (ABSORB && xi < ea) {
      palive = false;
      pabsorbed = true;
      return;
    }
    const Real xim = ABSORB ? xi - ea : xi;
    int leak = 2 * NDIM - 1;  // the numerical fall-through takes the last face
    if constexpr (kCell) {
      // 1D: the lower face when xim < 0 + lk[0], else the upper, found or not
      if (xim < lk[0]) leak = 0;
    } else {
      bool found = false;
      Real cum = Real(0.0);
#pragma unroll
      for (int e = 0; e < 2 * NDIM; ++e) {
        if (!found && xim < cum + lk[e]) {
          leak = e;
          found = true;
        }
        cum = cum + lk[e];
      }
    }
    const Real bmu = N::sqrt(D::u16_lo(w2));
    const Real bnu = N::sqrt(N::fmax(Real(1.0) - bmu * bmu, Real(0.0)));
    Real b2 = bnu, b3 = Real(0.0);
    if constexpr (kMultiD) {
      Real cph, sph;
      D::circle(D::raw(seed, lane, it, kTagW2 + 1u), &cph, &sph);
      b2 = bnu * cph;
      b3 = bnu * sph;
    }
    const int ax = leak >> 1;
    const bool lower = (leak & 1) == 0;
    leak_code = lower ? -(ax + 1) : ax + 1;
    place_across<NDIM>(ax, lower, g.eps_ddmc, (g.c * (lower ? -Real(1.0) : Real(1.0))) * bmu,
                       g.c * b2, g.c * b3, true, dx, flo, fhi, ci, np_, nci, v);
    return;
  }
  // census: uniform position in the cell, isotropic direction
  ptau = Real(1.0);
  np_[0] = flo[0] + D::u16_hi(w2) * dx[0];
  const typename D::Word w3 = D::raw(seed, lane, it, kTagW3);
  Real cmu;
  if constexpr (NDIM == 1) {
    cmu = Real(1.0) - Real(2.0) * D::u16_lo(w3);
  } else {
    np_[1] = flo[1] + D::u16_lo(w3) * dx[1];
    if constexpr (NDIM == 2) {
      cmu = Real(1.0) - Real(2.0) * D::u16_hi(w3);
    } else {
      np_[2] = flo[2] + D::u16_hi(w3) * dx[2];
      cmu = Real(1.0) - Real(2.0) * D::u16_lo(D::raw(seed, lane, it, kTagW3 + 1u));
    }
  }
  const Real cst = N::sqrt(N::fmax(Real(1.0) - cmu * cmu, Real(0.0)));
  if constexpr (NDIM == 1) {
    v[0] = g.c * cmu;
    v[1] = g.c * cst;
    v[2] = Real(0.0);
  } else {
    Real cph, sph;
    D::circle(D::raw(seed, lane, it, kTagW3 + (NDIM == 2 ? 1u : 2u)), &cph, &sph);
    v[0] = g.c * cst * cph;
    v[1] = g.c * cst * sph;
    v[2] = g.c * cmu;
  }
}

// The re-homing of a lane that left its block on a refined forest
// (pallas_transport.py:973-1151): the lookup probe, the rebase into the new
// block and, with DDMC in 2D/3D, the coarse->fine subface resample of a leak.
// ``gp`` is the global position after the BCs, ``v`` the velocity after the
// scatter and any reflection; ``leak`` the DDMC leak code of this event.
template <int NDIM, bool ABSORB, bool DDMC, bool NONGRAY, class Real>
__device__ __forceinline__ void rehome(const Geom<Real>& g, const Forest<Real>& F,
                                       const Real* table, const Own& o, uint32_t lane,
                                       uint32_t it, int leak, const bool (&out_lo)[3],
                                       const bool (&out_hi)[3], const Real (&gp)[3], int& blk,
                                       Real (&np_)[3], int (&nci)[3], Real (&v)[3],
                                       int& pending) {
  using N = Num<Real>;
  using D = Draw<Real>;
  int t[3];
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    const Real sg = (out_hi[a] ? Real(1.0) : Real(0.0)) - (out_lo[a] ? Real(1.0) : Real(0.0));
    const Real probe =
        gp[a] + (sg != Real(0.0) ? g.nudge_cross[a] * sg : g.nudge_tilt[a] * (v[a] * g.inv_c));
    t[a] = min(max((int)N::floor((probe - g.lo[a]) / g.tile[a]), 0), g.nt[a] - 1);
  }
  int tidx = t[0];
  if (NDIM == 2) tidx = t[1] * g.nt[0] + t[0];
  if (NDIM == 3) tidx = (t[2] * g.nt[1] + t[1]) * g.nt[0] + t[0];
  const int b_new = __ldg(F.lookup + tidx);
  const typename N::V4 r0 = N::ld4(F.block, 3 * b_new);      // (dx, dy, dz, 0)
  const typename N::V4 r1 = N::ld4(F.block, 3 * b_new + 1);  // (ox, oy, oz, 0)
  const Real ndx[3] = {r0.x, r0.y, r0.z};
  const Real nbox[3] = {r1.x, r1.y, r1.z};
  Real loc[3];
  int idx[3] = {0, 0, 0};
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    loc[a] = gp[a] - nbox[a];
    idx[a] = min(max((int)N::floor(loc[a] / ndx[a]), 0), g.n[a] - 1);
  }
  if constexpr (DDMC && NDIM >= 2) {
    const bool here = b_new >= o.lo && b_new < o.hi;
    // the fine faces of a block outside the owned range live on another shard:
    // the leak code travels with the lane, which pauses there
    if (leak != 0 && !here && __ldg(F.level + b_new) > __ldg(F.level + blk)) pending = leak;
    if (leak != 0 && here && __ldg(F.level + b_new) > __ldg(F.level + blk)) {
      using T = DdmcTags<NDIM, ABSORB>;
      const int ax = abs(leak) - 1;
      const Real lsgn = leak > 0 ? Real(1.0) : -Real(1.0);
      const int upper = leak < 0 ? 1 : 0;  // a leak in -axis enters the upper face
      Real u_sel, u_t[2] = {Real(0.0), Real(0.0)};
      const typename D::Word w = D::raw(o.seed, lane, it, T::kRes);
      if constexpr (NDIM == 2) {
        u_sel = D::u16_lo(w);
        u_t[0] = D::u16_hi(w);
      } else {
        u_sel = D::u16_hi(D::raw(o.seed, lane, it, T::kW3 + 1u));
        u_t[0] = D::u16_lo(w);
        u_t[1] = D::u16_hi(w);
      }
      const Real smu = N::sqrt(D::u16_lo(D::raw(o.seed, lane, it, T::kRes + 1u)));
      const Real snu = N::sqrt(N::fmax(Real(1.0) - smu * smu, Real(0.0)));
      Real cph, sph;
      D::circle(D::raw(o.seed, lane, it, T::kRes + 2u), &cph, &sph);
      // the transverse axes t1 < t2 (t2 in 3D only) and the fine edge around the
      // coarse landing point on each; every array index below is a compile-time
      // one and every pick by axis a select (``place_across``), so the lane's
      // state stays in registers
      const int t1 = ax == 0 ? 1 : 0;
      const int t2 = ax == 2 ? 1 : 2;
      int f_ax = 0, e1 = 0, e2 = 0;
      Real d1 = Real(0.0), d2 = Real(0.0);
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
        const int edge =
            min(max((int)N::rint(loc[a] / N::fmax(ndx[a], N::kTiny)), 1), g.n[a] - 1);
        f_ax = a == ax ? (lsgn > Real(0.0) ? 0 : g.n[a] - 1) : f_ax;
        e1 = a == t1 ? edge : e1;
        d1 = a == t1 ? ndx[a] : d1;
        if (NDIM == 3) {
          e2 = a == t2 ? edge : e2;
          d2 = a == t2 ? ndx[a] : d2;
        }
      }
      // the fine block's P_lower (leak in +axis) or P_upper of a candidate face,
      // in a record of 8 reals (ea, es, P...) or, NONGRAY, 12 (rho, T, fleck,
      // sigma_s, P..., 0, 0)
      constexpr int kRec = NONGRAY ? 12 : 8;
      constexpr int kP0 = NONGRAY ? 4 : 2;
      auto face_prob = [&](int c1, int c2) -> Real {
        int flat = b_new - o.lo;
#pragma unroll
        for (int a = NDIM - 1; a >= 0; --a) {
          const int ia = a == ax ? f_ax : (a == t1 ? c1 : (NDIM == 3 && a == t2 ? c2 : idx[a]));
          flat = flat * g.n[a] + ia;
        }
        return __ldg(table + kRec * ((size_t)o.row + flat) + kP0 + 2 * ax + upper);
      };
      int s1, s2 = 0;
      if constexpr (NDIM == 2) {
        const Real p_l = face_prob(e1 - 1, 0);
        const Real p_u = face_prob(e1, 0);
        s1 = u_sel * (p_l + p_u) >= p_l ? e1 : e1 - 1;
      } else {
        const Real pr[4] = {face_prob(e1 - 1, e2 - 1), face_prob(e1, e2 - 1),
                             face_prob(e1 - 1, e2), face_prob(e1, e2)};
        const Real xi = u_sel * (pr[0] + pr[1] + pr[2] + pr[3] + N::kTiny);
        Real cum = Real(0.0);
        s1 = e1;  // the numerical fall-through takes the last candidate
        s2 = e2;
        bool chosen = false;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!chosen && xi < cum + pr[q]) {
            s1 = (q & 1) ? e1 : e1 - 1;
            s2 = (q & 2) ? e2 : e2 - 1;
            chosen = true;
          }
          cum = cum + pr[q];
        }
      }
      const Real l1 = ((Real)s1 + u_t[0]) * d1;
      const Real l2 = ((Real)s2 + u_t[1]) * d2;
      // hemisphere direction into the block, in the cyclic axis order
      const Real vs[3] = {(g.c * lsgn) * smu, g.c * (snu * cph), g.c * (snu * sph)};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int q = (a - ax + 3) % 3;
        v[a] = q == 0 ? vs[0] : (q == 1 ? vs[1] : vs[2]);
        if (a < NDIM) {
          idx[a] = a == t1 ? s1 : idx[a];
          loc[a] = a == t1 ? l1 : loc[a];
        }
        if (NDIM == 3) {
          idx[a] = a == t2 ? s2 : idx[a];
          loc[a] = a == t2 ? l2 : loc[a];
        }
      }
    }
  }
  blk = b_new;
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    np_[a] = loc[a];
    nci[a] = idx[a];
  }
}

// Whether a lane keeps only its cell's record from one event to the next (the
// float64 census's lean lane; measured, see the note at the head of this file):
// a gray lane without absorption on a refined 1D or 2D forest in double, whose
// cell in registers (the block's dx, origin and dmin, the faces) held the 2D
// instantiation at 98 registers and 2 resident blocks. Its block's cell size is
// read again through the read-only cache at every event (``cell_size``), the
// faces made from the cell index there (``faces``), the block's origin read at a
// block face: the same operations on the same operands as ``gather``'s. The 3D
// and absorbing float64 forests, on no path measured, keep their cell in
// registers.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr bool kLean = sizeof(Real) == 8 && NDIM < 3 && !ABSORB && SMR && !DDMC && !NONGRAY;

// Whether an instantiation runs in rounds on the card's resident grid (measured,
// see the note at the head of this file): the float64 census without absorption
// on a uniform 1D mesh, gray or DDMC (stepdiff's and stepdiff_ddmc's at precision
// = f64), and the float64 non-gray census on a 2D forest (stepdiff_smr's with
// ep_bremss). Where the host asks for it (a ledger of at most kRoundsMax rounds:
// ops/transport_kernel.py, launch_shape) the launch has at most as many blocks as
// the card holds at once (``Launch``), and each round takes the next kThreads x
// blocks slots, spread over the blocks, so that a ledger's live slots at one end
// of it run on every SM; otherwise one thread takes one slot, as elsewhere.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr bool kRounds = sizeof(Real) == 8 && ((NDIM == 1 && !ABSORB && !SMR && !NONGRAY) ||
                                               (NDIM == 2 && SMR && !DDMC && NONGRAY));
// The most rounds a ledger may take there: two on the uniform 1D mesh, whose
// lanes run long histories (a ledger with live lanes in several rounds ran them a
// round at a time), four on the non-gray forest, whose lanes run two events or so
// and whose later rounds hold no live lane.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr int kRoundsMax = !kRounds<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real> ? 0 : NONGRAY ? 4 : 2;

// Whether an instantiation spreads a spatial round's shard slices over the card
// where the host asks for it (``Shards::width``; the 2D SMR+DDMC block route,
// K4s; measured, see the note at the head of this file): a launch of several
// waves whose live lanes sit at the start of each shard's slice ran them on the
// SMs that took those blocks; here the first wave's blocks take every shard's
// first groups, spread over them (``slot_of``), one thread a slot kept.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr bool kSpreadShards =
    sizeof(Real) == 4 && NDIM == 2 && !ABSORB && DDMC && SMR && !NONGRAY;

// A block's cell size per axis (the block table's first row) and dmin, the
// smallest over the active axes.
template <int NDIM, class Real>
__device__ __forceinline__ void cell_size(const Forest<Real>& F, int blk, Real (&dx)[3],
                                          Real& dmin) {
  using N = Num<Real>;
  const typename N::V4 b0 = N::ld4(F.block, 3 * blk);  // (dx, dy, dz, 0)
  dx[0] = b0.x;
  dx[1] = b0.y;
  dx[2] = b0.z;
  dmin = dx[0];
  if (NDIM >= 2) dmin = N::fmin(dmin, dx[1]);
  if (NDIM == 3) dmin = N::fmin(dmin, dx[2]);
}

// The faces of cell ci on each active axis: f dx and (f + 1) dx.
template <int NDIM, class Real>
__device__ __forceinline__ void faces(const int (&ci)[3], const Real (&dx)[3], Real (&flo)[3],
                                      Real (&fhi)[3]) {
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    const Real f = (Real)ci[a];
    flo[a] = f * dx[a];
    fhi[a] = (f + Real(1.0)) * dx[a];
  }
}

// A lane's state as a thread takes it from the ledger, stages it across the
// regroup and writes it back (``run_lane`` runs the history on a copy in
// registers). ``slot`` is -1 for a thread that holds no lane.
template <class Real>
struct Lane {
  int slot;    // its ledger slot
  int shard;   // its shard in the launch's table
  int it;      // its own iteration count: the K2 counter of its draws
  Real p[3], v[3], tau;
  int ci[3], blk, face;
  Real en;    // photon energy (NONGRAY)
  bool alive, absorbed;
  int pending; // a leak code for another shard (DDMC with SMR)
};

// What the lane's cell gives each of its events, gathered when the lane enters
// the cell: its geometry (the collapsed block's, or with SMR the lane's block's:
// dx, inv_dx, box, dmin), its faces (flo, fhi: f dx and (f + 1) dx on each active
// axis) and its table record: (p_abs, 1 / sigma_t) gray without DDMC (tab); with
// DDMC or NONGRAY fleck sigma_a (ea) and sigma_t; with DDMC the face
// probabilities (pf) and the branch (is_ddmc); where ``kCell1d``, pf[2..4] carry
// the record's leak rate, cdf and c cdf. Every value depends only on the lane's
// block, cell, shard and photon energy. Out-parameters, so that the lane's state
// stays in registers. A lean lane (``kLean``) gathers its record alone.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ void gather(const Geom<Real>& g, const Forest<Real>& F,
                                       const Real* table, const Own& o, int blk,
                                       const int (&ci)[3], Real en, Real (&dx)[3],
                                       Real (&inv_dx)[3], Real (&box)[3], Real (&flo)[3],
                                       Real (&fhi)[3], Real& dmin, typename Num<Real>::V2& tab,
                                       Real& ea, Real& sig_t, Real (&pf)[6], bool& is_ddmc) {
  using N = Num<Real>;
  using V4 = typename N::V4;
  constexpr bool kLeanLane = kLean<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>;
  int cell;
  if constexpr (SMR) {
    if constexpr (!kLeanLane) {
      cell_size<NDIM>(F, blk, dx, dmin);
      const V4 b1 = N::ld4(F.block, 3 * blk + 1);  // (ox, oy, oz, 0)
      box[0] = b1.x;
      box[1] = b1.y;
      box[2] = b1.z;
    }
    if constexpr (DDMC) {
      const V4 b2 = N::ld4(F.block, 3 * blk + 2);  // Real(1 / dx) per axis
      inv_dx[0] = b2.x;
      inv_dx[1] = b2.y;
      inv_dx[2] = b2.z;
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) inv_dx[a] = Real(0.0);
    }
    cell = blk - o.lo;
#pragma unroll
    for (int a = NDIM - 1; a >= 0; --a) cell = cell * g.n[a] + ci[a];
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dx[a] = g.dx[a];
      inv_dx[a] = g.inv_dx[a];
      box[a] = g.org[a];
    }
    dmin = g.dmin;
    cell = ci[0];
    if (NDIM == 2) cell = ci[1] * g.n[0] + ci[0];
    if (NDIM == 3) cell = ((ci[2] - o.lo) * g.n[1] + ci[1]) * g.n[0] + ci[0];
  }
  cell += o.row;
  ea = Real(0.0);
  sig_t = Real(0.0);
#pragma unroll
  for (int e = 0; e < 6; ++e) pf[e] = Real(0.0);
  is_ddmc = false;
  if constexpr (NONGRAY) {
    // (rho, T, fleck, sigma_s); with DDMC then (Px_lo, Px_hi, Py_lo, Py_hi) and
    // (Pz_lo, Pz_hi, 0, 0)
    const size_t rec = (DDMC ? 3 : 1) * (size_t)cell;
    const V4 r0 = !DDMC && F.cols.rho != nullptr
                      ? N::make4(__ldg(F.cols.rho + cell), __ldg(F.cols.temp + cell),
                                 __ldg(F.cols.fleck + cell), __ldg(F.cols.sigma_s + cell))
                      : N::ld4(table, rec);
    const Real sa = epbremss(g, r0.x, r0.y, en);
    ea = r0.z * sa;
    sig_t = ea + (r0.w + (Real(1.0) - r0.z) * sa);
    if constexpr (DDMC) {
      const V4 r1 = N::ld4(table, rec + 1);
      pf[0] = r1.x;
      pf[1] = r1.y;
      if (NDIM >= 2) {
        pf[2] = r1.z;
        pf[3] = r1.w;
      }
      if (NDIM == 3) {
        const V4 r2 = N::ld4(table, rec + 2);
        pf[4] = r2.x;
        pf[5] = r2.y;
      }
      is_ddmc = dmin * sig_t > g.tau_ddmc;
    }
  } else if constexpr (DDMC) {
    const size_t rec = 2 * (size_t)cell;
    const V4 r0 = N::ld4(table, rec);  // (ea, es, Px_lo, Px_hi)
    if (ABSORB) ea = r0.x;
    sig_t = ABSORB ? r0.x + r0.y : r0.y;
    pf[0] = r0.z;
    pf[1] = r0.w;
    if constexpr (kCell1d<NDIM, DDMC, SMR, NONGRAY>) {
      const V4 r1 = N::ld4(table, rec + 1);  // (P_lower / dx, cdf, c cdf, 0)
      pf[2] = r1.x;
      pf[3] = r1.y;
      pf[4] = r1.z;
    } else if (NDIM >= 2) {
      const V4 r1 = N::ld4(table, rec + 1);  // (Py_lo, Py_hi, Pz_lo, Pz_hi)
      pf[2] = r1.x;
      pf[3] = r1.y;
      pf[4] = r1.z;
      pf[5] = r1.w;
    }
    is_ddmc = dmin * sig_t > g.tau_ddmc;
  } else {
    tab = N::ld2(table, cell);
  }
  if constexpr (!kLeanLane) faces<NDIM>(ci, dx, flo, fhi);
}

// The words of an IMC event (kernel_rng.cuh: ``key`` is the key of the lane's
// seed, lane and iteration, a word that key's hash with its tag, in the
// DrawPool's order) and what follows from them alone: the collision's unit
// exponential (tag 0) and, with ABSORB, the u23 branch draw (tag 1); the
// scatter's mu = 1 - 2 u16 from the u16 word's low half with, unless ``kSt`` is
// false, st = sqrt(1 - mu^2), and in 2D/3D (cos phi, sin phi) from the circle
// word after it.
template <bool ABSORB, class Real>
__device__ __forceinline__ void collision_draws(uint32_t key, Real& e23, Real& ub) {
  using D = Draw<Real>;
  e23 = D::exp23(D::word(key, 0u));
  ub = ABSORB ? D::u23(D::word(key, 1u)) : Real(0.0);
}

template <int NDIM, bool ABSORB, bool kSt = true, class Real>
__device__ __forceinline__ void scatter_draws(uint32_t key, Real& mu, Real& st, Real& cph,
                                              Real& sph) {
  using N = Num<Real>;
  using D = Draw<Real>;
  constexpr uint32_t kTagU16 = ABSORB ? 2u : 1u;
  mu = Real(1.0) - Real(2.0) * D::u16_lo(D::word(key, kTagU16));
  st = kSt ? N::sqrt(N::fmax(Real(1.0) - mu * mu, Real(0.0))) : Real(0.0);
  cph = Real(0.0);
  sph = Real(0.0);
  if constexpr (NDIM > 1) D::circle(D::word(key, kTagU16 + 1u), &cph, &sph);
}

// kDraws values of an IMC event's words: e23, ub, mu, st, cph, sph.
constexpr int kDraws = 6;

template <int NDIM, bool ABSORB, bool kSt = true, class Real>
__device__ __forceinline__ void imc_draws(uint32_t key, Real (&dr)[kDraws]) {
  collision_draws<ABSORB>(key, dr[0], dr[1]);
  scatter_draws<NDIM, ABSORB, kSt>(key, dr[2], dr[3], dr[4], dr[5]);
}

// Where an instantiation's IMC event makes its draws (measured, see the note at
// the head of this file): a gray lane on a refined forest one event ahead, during
// the event before (``run_lane``), and so the float64 gray lane on a uniform 1D
// mesh (``kRounds``, without DDMC); any other gray lane on a uniform mesh at the
// top of the event; a lane of a DDMC or NONGRAY instantiation, whose events seldom
// scatter in a row, in place, the scatter's inside the scatter (a lane on the DDMC
// branch draws none of them). A lean lane (``kLean``) draws at the top of the
// event, so that no event's draws wait in registers through the event before.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr bool kDrawAhead =
    (SMR && !DDMC && !NONGRAY && !kLean<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>) ||
    (kRounds<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real> && !DDMC && !NONGRAY);
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr bool kDrawAtTop =
    (!SMR || kLean<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>) && !DDMC && !NONGRAY &&
    !kDrawAhead<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>;

// Whether a lane keeps its cell's values from one event to the next (measured,
// see the note at the head of this file): not with DDMC on a uniform mesh, where
// the record is two loads without a block table before them.
template <bool DDMC, bool SMR>
constexpr bool kKeepCell = SMR || !DDMC;

// Whether a lane gathers its cell's values after every event, without a branch:
// a gray lane on a uniform 1D or 2D mesh, where the gather is the record's one
// load and most warp-events hold a lane that crossed anyway (measured, see the
// note at the head of this file).
template <int NDIM, bool DDMC, bool SMR, bool NONGRAY>
constexpr bool kGatherEvery = NDIM < 3 && !DDMC && !SMR && !NONGRAY;

// Whether a lane's vy and vz wait for the end of its history: a gray lane on a
// uniform 1D mesh, or a lean one (``kLean``) on a 1D forest, where no event reads
// them (a block face's probe and a wall read vx alone). Its scatter sets vx and
// keeps mu; when the history ends, vy = c sqrt(1 - mu^2) and vz = 0 of the last
// scatter, the same operations on the same mu as that scatter's; a lane that did
// not scatter keeps its own.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
constexpr bool kVyAfter =
    NDIM == 1 && !DDMC && !NONGRAY && (!SMR || kLean<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>);

// mu of a lane that has not scattered (|mu| <= 1 after a scatter)
template <class Real>
constexpr Real kNoMu = Real(2.0);

// Whether a lane takes another event.
template <int NDIM, bool SMR, class Real>
__device__ __forceinline__ bool runs(const Geom<Real>& g, const Own& o, bool alive, Real tau,
                                     int it, int blk, const int (&ci)[3]) {
  return alive && tau < Real(1.0) && it < g.max_iters && owned<NDIM, SMR>(o, blk, ci);
}

// One event of a lane (``lane`` is its slot's index in its shard's slice, ``key``
// the K2 key of its seed, lane and iteration, which gray lanes carry), on its
// state in registers and its cell's values (``gather``). ``dr`` holds the event's
// draws where ``kDrawAhead`` (made during the event before it) and receives them
// at the top of the event where ``kDrawAtTop``. ``moved`` says whether the event
// changed the lane's cell or block. Where ``kVyAfter`` a scatter sets ``mu_last``
// instead of vy and vz.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ void event(const Geom<Real>& g, const Forest<Real>& F,
                                      const Real* table,
                                      const Own& o, uint32_t lane, uint32_t key, int& pit,
                                      Real (&p)[3], Real (&v)[3], Real& ptau, int (&ci)[3],
                                      int& blk, int& pface, bool& palive, bool& pabsorbed,
                                      int& pending,
                                      const Real (&dx)[3], const Real (&inv_dx)[3],
                                      const Real (&box)[3], const Real (&flo)[3],
                                      const Real (&fhi)[3], Real dmin,
                                      typename Num<Real>::V2 tab, Real ea, Real sig_t,
                                      const Real (&pf)[6], bool is_ddmc, Real (&dr)[kDraws],
                                      bool& moved, Real& mu_last) {
  using N = Num<Real>;
  const uint32_t it = (uint32_t)pit;
  Real np_[3];
  int nci[3];
  int nface = 0;
  int leak = 0;
  if (DDMC && is_ddmc) {
    constexpr bool kCell = kCell1d<NDIM, DDMC, SMR, NONGRAY>;
    ddmc_event<NDIM, ABSORB, kCell>(g, o.seed, lane, it, pface, ea, sig_t, pf, dx, inv_dx, flo,
                                    fhi, p, ci, v, np_, nci, ptau, palive, pabsorbed, leak);
  } else {
    constexpr bool kInPlace = DDMC || NONGRAY;
    // a gray lane carries its key; a DDMC or NONGRAY lane keys the words it draws
    // here (carried, the 2D SMR DDMC kernel fits 4 blocks a SM, not 3, and its K4s
    // round ran 8-9 % slower)
    const uint32_t ikey = kInPlace ? jb_key(o.seed, lane, it) : key;
    constexpr bool kVy = kVyAfter<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>;
    if constexpr (kDrawAtTop<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>)
      imc_draws<NDIM, ABSORB, !kVy>(key, dr);
    Real e23 = dr[0], u_branch = dr[1];
    if constexpr (kInPlace) collision_draws<ABSORB>(ikey, e23, u_branch);
    Real d_coll;
    if constexpr (DDMC || NONGRAY) {
      d_coll = e23 / (sig_t + N::kTiny);
    } else {
      d_coll = e23 * tab.y;
    }
    const Real d_end = g.cdt * (Real(1.0) - ptau);
    const Real d_geom = N::fmin(dmin, d_end);

    Real fd[3];
#pragma unroll
    for (int a = 0; a < NDIM; ++a)
      fd[a] = v[a] != Real(0.0) ? g.c * ((v[a] > Real(0.0) ? fhi[a] : flo[a]) - p[a]) / v[a]
                                : N::kBig;
    Real d_push = N::fmin(d_geom, fd[0]);
    if (NDIM == 2) d_push = N::fmin(d_push, fd[1]);
    if (NDIM == 3) d_push = N::fmin(d_push, N::fmin(fd[1], fd[2]));

    const bool coll = d_coll < d_push;
    bool absorb = false;
    if constexpr (ABSORB && (DDMC || NONGRAY)) absorb = coll && u_branch * sig_t < ea;
    if constexpr (ABSORB && !DDMC && !NONGRAY) absorb = coll && u_branch < tab.x;
    const bool scatter = coll && !absorb;
    bool cr[3] = {false, false, false};
    cr[0] = !coll && fd[0] <= d_geom;
    if (NDIM >= 2) cr[0] = cr[0] && fd[0] <= fd[1];
    if (NDIM == 3) cr[0] = cr[0] && fd[0] <= fd[2];
    if (NDIM >= 2) cr[1] = !coll && !cr[0] && fd[1] <= d_geom;
    if (NDIM == 3) cr[1] = cr[1] && fd[1] <= fd[2];
    if (NDIM == 3) cr[2] = !coll && !cr[0] && !cr[1] && fd[2] <= d_geom;
    const bool census = !coll && !cr[0] && !cr[1] && !cr[2] && d_end <= dmin;
    const Real d = coll ? d_coll : d_push;

    ptau = census ? Real(1.0) : ptau + d * g.inv_cdt;
    const Real step = d * g.inv_c;
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      np_[a] = p[a] + v[a] * step;
      nci[a] = ci[a];
      if (cr[a]) {
        np_[a] = v[a] > Real(0.0) ? fhi[a] : flo[a];
        nci[a] += v[a] > Real(0.0) ? 1 : -1;
        if (DDMC) nface = v[a] > Real(0.0) ? a + 1 : -(a + 1);
      }
    }
    if (scatter) {  // isotropic scatter
      Real mu = dr[2], st = dr[3], cph = dr[4], sph = dr[5];
      if constexpr (kInPlace) scatter_draws<NDIM, ABSORB>(ikey, mu, st, cph, sph);
      if (NDIM == 1) {
        v[0] = g.c * mu;
        if (kVy) {
          mu_last = mu;
        } else {
          v[1] = g.c * st;
          v[2] = Real(0.0);
        }
      } else {
        v[0] = g.c * st * cph;
        v[1] = g.c * st * sph;
        v[2] = g.c * mu;
      }
    }
    if (absorb) {
      palive = false;
      pabsorbed = true;
    }
  }

  bool out_lo[3], out_hi[3];
  bool any_out = false;
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    out_lo[a] = nci[a] < 0;
    out_hi[a] = nci[a] >= g.n[a];
    any_out = any_out || out_lo[a] || out_hi[a];
  }
  if (any_out) {  // a block face: the domain BCs, then the block and cell
    Real gp[3], org[3];
    if constexpr (kLean<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>) {  // the block's origin
      const typename N::V4 b1 = N::ld4(F.block, 3 * blk + 1);  // (ox, oy, oz, 0)
      org[0] = b1.x;
      org[1] = b1.y;
      org[2] = b1.z;
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) org[a] = box[a];
    }
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      gp[a] = org[a] + np_[a];
      const bool hit_lo = out_lo[a] && gp[a] <= g.lo_half[a];
      const bool hit_hi = out_hi[a] && gp[a] >= g.hi_half[a];
      if (hit_lo) {
        if (g.bc[2 * a] == kReflecting) {
          gp[a] = clip(Real(2.0) * g.lo[a] - gp[a], g.lo[a], g.hi[a]);
          v[a] = -v[a];
          if (DDMC) nface = -nface;
        } else if (g.bc[2 * a] == kPeriodic) {
          gp[a] = clip(gp[a] + g.span[a], g.lo[a], g.hi[a]);
        } else {
          palive = false;
        }
      }
      if (hit_hi) {
        if (g.bc[2 * a + 1] == kReflecting) {
          gp[a] = clip(Real(2.0) * g.hi[a] - gp[a], g.lo[a], g.hi[a]);
          v[a] = -v[a];
          if (DDMC) nface = -nface;
        } else if (g.bc[2 * a + 1] == kPeriodic) {
          gp[a] = clip(gp[a] - g.span[a], g.lo[a], g.hi[a]);
        } else {
          palive = false;
        }
      }
    }
    if (SMR && palive) {  // re-home by the lookup grid
      rehome<NDIM, ABSORB, DDMC, NONGRAY>(g, F, table, o, lane, it, leak, out_lo, out_hi, gp,
                                          blk, np_, nci, v, pending);
    } else {
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
        if (palive) {  // rebase into the block and re-derive every cell
          np_[a] = gp[a] - g.org[a];
          nci[a] = min(max((int)(np_[a] * g.inv_dx[a]), 0), g.n[a] - 1);
        } else {
          nci[a] = min(max(nci[a], 0), g.n[a] - 1);
        }
      }
    }
  }
  moved = any_out;
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    moved = moved || nci[a] != ci[a];
    p[a] = np_[a];
    ci[a] = nci[a];
  }
  pface = nface;
  ++pit;
}

// A lane's history from its state in ``st`` until it stops (absorbed, escaped,
// at census, out of its range or at the iteration cap): the state is copied into
// registers for the loop and back after it. Where ``kKeepCell`` the values of
// the lane's cell (``gather``) stay in registers from one event to the next and
// are gathered again only after an event that changed the lane's cell or block,
// so an event in the same cell loads nothing; where ``kGatherEvery`` they are
// gathered after every event, without a branch; elsewhere every event gathers
// them first. Where ``kDrawAhead`` each event's draws are made during the event
// before it (``imc_draws`` of the next key), off that event's dependent chain. A
// lane carries its own iteration count and, where gray, its K2 key, stepped by
// kItStep an event, so its words do not change. Where ``kVyAfter`` vy and vz are
// set from the last scatter's mu when the history ends. A lean lane (``kLean``)
// keeps its cell's record alone and makes its block's cell size, dmin and faces
// anew at every event.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ void run_lane(const Geom<Real>& g, const Forest<Real>& F,
                                         const Real* table, const Shards& S, Lane<Real>& st) {
  using N = Num<Real>;
  const Own o = own_of(S, st.shard);
  const uint32_t lane = (uint32_t)(st.slot - S.slot_lo[st.shard]);
  Real p[3] = {st.p[0], st.p[1], st.p[2]};
  Real v[3] = {st.v[0], st.v[1], st.v[2]};
  int ci[3] = {st.ci[0], st.ci[1], st.ci[2]};
  Real tau = st.tau;
  int it = st.it, blk = st.blk, face = st.face, pending = 0;
  bool alive = true, absorbed = false;
  Real dx[3], inv_dx[3], box[3], flo[3], fhi[3], dmin, ea, sig_t, pf[6];
  typename N::V2 tab;
  bool is_ddmc, moved;
  Real mu_last = kNoMu<Real>;
  constexpr bool kEvery = kGatherEvery<NDIM, DDMC, SMR, NONGRAY>;
  constexpr bool kKeep = kKeepCell<DDMC, SMR> && !kEvery;
  if constexpr (kKeep || kEvery)
    gather<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, o, blk, ci, st.en, dx, inv_dx, box, flo,
                                             fhi, dmin, tab, ea, sig_t, pf, is_ddmc);
  constexpr bool kAhead = kDrawAhead<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>;
  constexpr bool kSt = !kVyAfter<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>;
  uint32_t key = jb_key(o.seed, lane, (uint32_t)it);
  Real dr[kDraws] = {Real(0.0), Real(0.0), Real(0.0), Real(0.0), Real(0.0), Real(0.0)};
  if constexpr (kAhead) imc_draws<NDIM, ABSORB, kSt>(key, dr);
  while (true) {
    Real next[kDraws];
    if constexpr (kAhead) imc_draws<NDIM, ABSORB, kSt>(key + kItStep, next);
    if constexpr (kLean<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>) {  // the cell's geometry
      cell_size<NDIM>(F, blk, dx, dmin);
      faces<NDIM>(ci, dx, flo, fhi);
    }
    if constexpr (!kKeep && !kEvery)  // every event gathers its cell first
      gather<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, o, blk, ci, st.en, dx, inv_dx, box,
                                               flo, fhi, dmin, tab, ea, sig_t, pf, is_ddmc);
    event<NDIM, ABSORB, DDMC, SMR, NONGRAY>(
        g, F, table, o, lane, key, it, p, v, tau, ci, blk, face, alive, absorbed, pending, dx,
        inv_dx, box, flo, fhi, dmin, tab, ea, sig_t, pf, is_ddmc, dr, moved, mu_last);
    if (!runs<NDIM, SMR>(g, o, alive, tau, it, blk, ci)) break;
    if constexpr (kEvery)
      gather<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, o, blk, ci, st.en, dx, inv_dx, box,
                                               flo, fhi, dmin, tab, ea, sig_t, pf, is_ddmc);
    if (kKeep && moved)
      gather<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, o, blk, ci, st.en, dx, inv_dx, box,
                                               flo, fhi, dmin, tab, ea, sig_t, pf, is_ddmc);
    if constexpr (kAhead) {
#pragma unroll
      for (int k = 0; k < kDraws; ++k) dr[k] = next[k];
    }
    key += kItStep;
  }
  // vy, vz of the last scatter
  if (kVyAfter<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real> && mu_last <= Real(1.0)) {
    v[1] = g.c * N::sqrt(N::fmax(Real(1.0) - mu_last * mu_last, Real(0.0)));
    v[2] = Real(0.0);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    st.p[a] = p[a];
    st.v[a] = v[a];
    st.ci[a] = ci[a];
  }
  st.tau = tau;
  st.it = it;
  st.blk = blk;
  st.face = face;
  st.pending = pending;
  st.alive = alive;
  st.absorbed = absorbed;
}

// A thread without a lane takes ledger slot q if its particle runs: alive, short
// of census, in a shard of the launch and in that shard's owned range. Any other
// slot is left untouched, but with the fold (Geom::fold) written back at once with
// the round trip; a slot that runs takes its state on the collapsed block, and its
// axes beyond NDIM and its block wait for ``retire``.
template <int NDIM, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ void take(const Ledger<Real>& L, const Geom<Real>& g,
                                     const Shards& S, int q, Lane<Real>& s) {
  int k = -1;
  for (int j = 0; j < S.count; ++j)
    if (q >= S.slot_lo[j] && q < S.slot_hi[j]) k = j;
  const bool fold = !SMR && g.fold != 0;
  const bool run = k >= 0 && g.max_iters > 0 && L.alive[q] != 0 && L.tau[q] < Real(1.0);
  if (!run && !fold) return;
  const int b = SMR || fold ? L.blk[q] : 0;
  int bk[3] = {0, 0, 0};
  if (fold) root_block(g, b, bk);
  int ci[3] = {0, 0, 0};
#pragma unroll
  for (int a = 0; a < NDIM; ++a) ci[a] = L.ci[a][q] + bk[a] * g.nloc[a];
  if (!(run && owned<NDIM, SMR>(own_of(S, k), b, ci))) {
    if (fold) {
      const int moved = round_trip(L, g, q, b, 0);
      if (moved != b) L.blk[q] = moved;
    }
    return;
  }
  s.slot = q;
  s.shard = k;
  s.it = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Real x = Real(0.0);
    if (a < NDIM) x = fold ? L.x[a][q] + (Real)bk[a] * g.shift[a] : L.x[a][q];
    s.p[a] = x;
    s.v[a] = L.v[a][q];
    s.ci[a] = ci[a];
  }
  s.tau = L.tau[q];
  s.blk = SMR ? b : 0;
  s.face = DDMC ? L.face[q] : 0;
  s.en = NONGRAY ? L.energy[q] : Real(0.0);
  s.alive = true;
  s.absorbed = false;
  s.pending = 0;
}

// A lane that stopped (absorbed, escaped, at census, out of its range or at the
// iteration cap) writes its state back; with the fold, expand_plain's shift of its
// state, and the round trip of the axes it does not move.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, class Real>
__device__ __forceinline__ void retire(const Ledger<Real>& L, const Geom<Real>& g,
                                       const Lane<Real>& s) {
  const int q = s.slot;
  const bool fold = !SMR && g.fold != 0;
  int blk = 0;
  if (NDIM < 3 && fold) blk = round_trip(L, g, q, L.blk[q], NDIM);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a < NDIM) {
      Real x = s.p[a];
      int i = s.ci[a];
      if (fold) blk += unfold_axis(g, a, x, i);
      L.x[a][q] = x;
      L.ci[a][q] = i;
    }
    L.v[a][q] = s.v[a];
  }
  if (fold) L.blk[q] = blk;
  L.tau[q] = s.tau;
  L.alive[q] = s.alive ? 1 : 0;
  if (ABSORB && s.absorbed) L.absorbed[q] = 1;
  if (DDMC) L.face[q] = s.face;
  if (SMR) L.blk[q] = s.blk;
  if (DDMC && SMR && s.pending != 0) L.leak[q] = s.pending;
}

// Adds each thread's events ``it`` and iteration count to its shard's (``shard``
// -1 for a thread without a lane) in shared memory: one atomic pair per warp
// when the warp's lanes share a shard, as they do unless a slice boundary falls
// inside the block, else one per lane (same-address atomics of every lane cost
// the kernels of one or two events a lane up to twice their time). Every thread
// of the warp calls it.
__device__ __forceinline__ void count(int shard, int it, unsigned long long* ev, int* mx) {
  const int top = __reduce_max_sync(0xFFFFFFFFu, shard);
  if (__all_sync(0xFFFFFFFFu, shard < 0 || shard == top)) {
    unsigned long long sum = shard < 0 ? 0ull : (unsigned long long)it;
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    const int most = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)(shard < 0 ? 0 : it));
    if ((threadIdx.x & 31) == 0 && top >= 0) {
      atomicAdd(ev + top, sum);
      atomicMax(mx + top, most);
    }
  } else if (shard >= 0) {
    atomicAdd(ev + shard, (unsigned long long)it);
    atomicMax(mx + shard, it);
  }
}

constexpr int kWarps = kThreads / 32;

// Staging area of a block's regroup, one column per lane.
template <class Real>
struct Stage {
  int cnt[kWarps][2];    // lanes of each warp on the IMC and on the DDMC branch
  Real f[8][kThreads];   // x y z vx vy vz tau energy
  int i[8][kThreads];    // slot shard it i j k block face
};

// The block's regroup (every thread calls it): the live lanes are dealt back to
// the lowest threads, those on the IMC branch first and, with DDMC, those on the
// DDMC branch from the next warp boundary when they fit; a thread left without a
// lane gets slot -1. A full block on one branch keeps its arrangement.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ void regroup(const Geom<Real>& g, const Forest<Real>& F,
                                        const Real* table, const Shards& S, Stage<Real>& sm,
                                        Lane<Real>& st) {
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  // key 0 on the IMC branch, 1 on the DDMC branch, 2 no lane
  int key = 2;
  if (st.slot >= 0) {
    key = 0;
    if constexpr (DDMC) {
      Real dx[3], inv_dx[3], box[3], flo[3], fhi[3], dmin, ea, sig_t, pf[6];
      typename Num<Real>::V2 tab;
      bool is_ddmc;
      gather<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, own_of(S, st.shard), st.blk, st.ci,
                                               st.en, dx, inv_dx, box, flo, fhi, dmin, tab, ea,
                                               sig_t, pf, is_ddmc);
      key = is_ddmc ? 1 : 0;
    }
  }
  const unsigned b0 = __ballot_sync(0xFFFFFFFFu, key == 0);
  const unsigned b1 = __ballot_sync(0xFFFFFFFFu, key == 1);
  if ((threadIdx.x & 31) == 0) {
    sm.cnt[warp][0] = __popc(b0);
    sm.cnt[warp][1] = __popc(b1);
  }
  __syncthreads();
  int n0 = 0, n1 = 0, pre0 = 0, pre1 = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      pre0 += sm.cnt[w][0];
      pre1 += sm.cnt[w][1];
    }
    n0 += sm.cnt[w][0];
    n1 += sm.cnt[w][1];
  }
  // a full block on one branch keeps its arrangement
  if (n0 + n1 < kThreads || (n0 > 0 && n1 > 0)) {
    int start1 = (n0 + 31) & ~31;
    if (start1 + n1 > kThreads) start1 = n0;
    if (key != 2) {
      const int d = key == 0 ? pre0 + __popc(b0 & below) : start1 + pre1 + __popc(b1 & below);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (a < NDIM) {
          sm.f[a][d] = st.p[a];
          sm.i[3 + a][d] = st.ci[a];
        }
        sm.f[3 + a][d] = st.v[a];
      }
      sm.f[6][d] = st.tau;
      if (NONGRAY) sm.f[7][d] = st.en;
      sm.i[0][d] = st.slot;
      sm.i[1][d] = st.shard;
      sm.i[2][d] = st.it;
      if (SMR) sm.i[6][d] = st.blk;
      if (DDMC) sm.i[7][d] = st.face;
    }
    __syncthreads();
    const int t = threadIdx.x;
    st.slot = -1;
    if (t < n0 || (t >= start1 && t < start1 + n1)) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        st.p[a] = a < NDIM ? sm.f[a][t] : Real(0.0);
        st.ci[a] = a < NDIM ? sm.i[3 + a][t] : 0;
        st.v[a] = sm.f[3 + a][t];
      }
      st.tau = sm.f[6][t];
      st.en = NONGRAY ? sm.f[7][t] : Real(0.0);
      st.slot = sm.i[0][t];
      st.shard = sm.i[1][t];
      st.it = sm.i[2][t];
      st.blk = SMR ? sm.i[6][t] : 0;
      st.face = DDMC ? sm.i[7][t] : 0;
      st.alive = true;
      st.absorbed = false;
      st.pending = 0;
    }
  }
}

// The slot that a thread takes in the round of the launch at ``base``, or -1:
// block b's thread t the slot base + kThreads b + t, or where the launch spreads,
// warp w of block b the 32 slots of group w x blocks + b; where the instantiation
// spreads its shards and the host asks for it (``Shards::width``), the shards'
// groups interleaved, the first W blocks (W = width, at most the launch's
// blocks) taking group w x W + b spread and later blocks 256 consecutive; the
// host makes W prime to the shard count, so that a block's warps come from
// several shards.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ int slot_of(const Shards& S, int n, int base) {
  if constexpr (kSpreadShards<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>) {
    if (S.width > 0) {
      const int b = blockIdx.x, lane = threadIdx.x & 31, w = min(S.width, (int)gridDim.x);
      const int q = b < w ? 32 * ((threadIdx.x >> 5) * w + b) + lane : kThreads * b + threadIdx.x;
      const int grp = q >> 5, off = 32 * (grp / S.count) + lane;
      return off < S.slice ? S.first + (grp % S.count) * S.slice + off : -1;
    }
  }
  // spread: warp w of block b takes the 32 slots of group w x blocks + b
  const int warp_slots = base + 32 * ((threadIdx.x >> 5) * gridDim.x + blockIdx.x);
  const int q =
      S.spread ? warp_slots + (threadIdx.x & 31) : base + blockIdx.x * kThreads + threadIdx.x;
  return q < n ? S.first + q : -1;
}

// One thread's part of the census of the round at ``base``: it takes its slot
// (``slot_of``) if the particle runs (``take``), the block regroups, the lane
// runs its history and writes it back, and its events are counted.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__device__ __forceinline__ void census_slots(const Ledger<Real>& L, const Real* table,
                                             const Forest<Real>& F, int n, const Geom<Real>& g,
                                             const Shards& S, Stage<Real>& sm, int base,
                                             unsigned long long* s_ev, int* s_mx) {
  Lane<Real> st;
  st.slot = -1;
  st.it = 0;
  const int slot = slot_of<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>(S, n, base);
  if (slot >= 0) take<NDIM, DDMC, SMR, NONGRAY>(L, g, S, slot, st);
  regroup<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, S, sm, st);
  if (st.slot >= 0) {
    run_lane<NDIM, ABSORB, DDMC, SMR, NONGRAY>(g, F, table, S, st);
    retire<NDIM, ABSORB, DDMC, SMR>(L, g, st);
  }
  count(st.slot >= 0 ? st.shard : -1, st.it, s_ev, s_mx);
}

// The census: one thread per ledger slot. A thread takes its slot if the
// particle runs (``take``); the block regroups once, so that its live lanes fill
// its lowest warps, those on the IMC branch first and those on the DDMC branch
// from the next warp boundary; then each lane runs its whole history in
// registers and writes it back. A lane carries its slot and its own iteration
// count, so the thread that runs it does not change a draw.
template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY, class Real>
__global__ void __launch_bounds__(kThreads)
    transport_kernel(Ledger<Real> L, const Real* __restrict__ table, Forest<Real> F, int n,
                     Geom<Real> g, Shards S, unsigned long long* __restrict__ events,
                     int32_t* __restrict__ iters) {
  // one flag for the whole launch, so the exit is uniform over every block, before
  // the first round of a launch in rounds or of interleaved shard groups
  if (S.go != nullptr && *S.go == 0) return;
  __shared__ unsigned long long s_ev[kMaxShards];
  __shared__ int s_mx[kMaxShards];
  __shared__ Stage<Real> sm;
  for (int k = threadIdx.x; k < S.count; k += kThreads) {
    s_ev[k] = 0;
    s_mx[k] = 0;
  }
  if constexpr (kRounds<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>) {
    for (int base = 0; base < n; base += kThreads * gridDim.x) {
      // the regroup's staging is the next round's only once every thread is past it
      if (base > 0) __syncthreads();
      census_slots<NDIM, ABSORB, DDMC, SMR, NONGRAY>(L, table, F, n, g, S, sm, base, s_ev, s_mx);
    }
  } else {
    census_slots<NDIM, ABSORB, DDMC, SMR, NONGRAY>(L, table, F, n, g, S, sm, 0, s_ev, s_mx);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < S.count; k += kThreads) {
    if (s_ev[k] > 0) {
      atomicAdd(events + k, s_ev[k]);
      atomicMax(iters + k, s_mx[k]);
    }
  }
}

// Calls ``op.run<NDIM, ABSORB, DDMC, SMR, NONGRAY>()`` for the instantiation a
// launch asks for. A frequency-dependent opacity absorbs: NONGRAY is
// instantiated with ABSORB only (the entry points refuse it without).
template <int NDIM, bool SMR, class Op>
void dispatch_mode(bool absorb, bool ddmc, bool nongray, Op& op) {
  if (nongray) {
    if (!ddmc) op.template run<NDIM, true, false, SMR, true>();
    if (ddmc) op.template run<NDIM, true, true, SMR, true>();
    return;
  }
  if (!absorb && !ddmc) op.template run<NDIM, false, false, SMR, false>();
  if (absorb && !ddmc) op.template run<NDIM, true, false, SMR, false>();
  if (!absorb && ddmc) op.template run<NDIM, false, true, SMR, false>();
  if (absorb && ddmc) op.template run<NDIM, true, true, SMR, false>();
}

template <class Op>
void dispatch(int ndim, bool absorb, bool ddmc, bool smr, bool nongray, Op& op) {
  if (ndim == 1 && smr) dispatch_mode<1, true>(absorb, ddmc, nongray, op);
  if (ndim == 1 && !smr) dispatch_mode<1, false>(absorb, ddmc, nongray, op);
  if (ndim == 2 && smr) dispatch_mode<2, true>(absorb, ddmc, nongray, op);
  if (ndim == 2 && !smr) dispatch_mode<2, false>(absorb, ddmc, nongray, op);
  if (ndim == 3 && smr) dispatch_mode<3, true>(absorb, ddmc, nongray, op);
  if (ndim == 3 && !smr) dispatch_mode<3, false>(absorb, ddmc, nongray, op);
}

template <class Real>
struct Launch {
  const Ledger<Real>& L;
  const Real* table;
  const Forest<Real>& F;
  int n;
  const Geom<Real>& g;
  const Shards& S;
  unsigned long long* events;
  int32_t* iters;
  cudaStream_t stream;
  int grid;  // at most this many blocks where the instantiation runs in rounds
  template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY>
  void run() {
    int blocks = (n + kThreads - 1) / kThreads;
    if (kRounds<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real> && grid > 0 && grid < blocks)
      blocks = grid;
    // the shards' groups interleaved: every group of every slice, padded to 32
    if (kSpreadShards<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real> && S.width > 0)
      blocks = (S.count * ((S.slice + 31) / 32) * 32 + kThreads - 1) / kThreads;
    transport_kernel<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>
        <<<blocks, kThreads, 0, stream>>>(L, table, F, n, g, S, events, iters);
  }
};

template <class Real>
struct Occupancy {
  int blocks;
  int rounds;
  int err;
  template <int NDIM, bool ABSORB, bool DDMC, bool SMR, bool NONGRAY>
  void run() {
    rounds = kRoundsMax<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, transport_kernel<NDIM, ABSORB, DDMC, SMR, NONGRAY, Real>, kThreads, 0);
  }
};

// The launch entry at precision Real (transport_kernel.cu: jb_transport_launch in
// float32; transport_kernel_f64.cu: jb_transport_launch_f64 in float64).
// ptrs: 16 device pointers x y z vx vy vz tau i j k alive absorbed face block
// energy leak, of a ledger of ``capacity`` slots; the floats are Real.
// table: per cell, the pair (p_abs, 1 / sigma_t) without DDMC, the 8 reals
// (ea, es, Px_lo, Px_hi, Py_lo, Py_hi, Pz_lo, Pz_hi) with it (16-byte aligned);
// with nongray the 4 reals (rho, T, fleck, sigma_s), with DDMC followed by the
// six face probabilities and two zeros; in global row-major cell order on a
// uniform forest, block cell order with SMR; the shards' ranges one after another.
// cols: null, or with nongray and without ddmc a host array of 4 device pointers,
// the rho, T, fleck and sigma_s columns of one owned range that the table would
// copy verbatim; the kernel reads the record there, and table may be null.
// With smr: block_table (per block the 12 reals dx dy dz 0 ox oy oz 0 1/dx 1/dy
// 1/dz 0, 16-byte aligned), levels (int32 per block) and lookup (the int32 lookup
// grid); null otherwise.
// igeom: n[3] bc[6] max_iters nt[3] fold nrbx nrby nloc[3]; fgeom (Real): dx[3]
// inv_dx[3] org[3] lo[3] hi[3] lo_half[3] hi_half[3] span[3] dmin c inv_c cdt
// inv_cdt tau_ddmc eps_imc eps_ddmc dt inv_dt lam2 pf2_num tile[3] nudge_cross[3]
// nudge_tilt[3] rho_scale temp_scale length_scale sb kb hh g_ff freq_min xc_max
// shift[3] (host arrays). With fold the shards' slots must cover the ledger: every
// slot is rewritten.
// shards: n_shards rows of (slot_lo, slot_hi, own_lo, own_hi, first table row)
// (host array); seeds: the shards' n_shards K2 seeds (int32, device); go: null, or
// one flag (a bool, device) that the kernel reads first: where it is 0 the launch
// touches no slot, and the counters keep the zeros they were given. spread:
// nonzero for warp w of block b to take the 32 slots
// of group w x blocks + b instead of block b the 256 after 256 b, so that every
// block holds slots from across the launch (of each round, where the instantiation
// runs in rounds). grid: where the instantiation runs in rounds (kRounds), at most
// this many blocks when it is positive, each round the next 256 x blocks slots
// (the card's resident blocks: one wave); ignored elsewhere. width: where the
// instantiation spreads its shards (kSpreadShards), 0 or the blocks of the first
// wave that take the shards' slot groups interleaved, spread over them (the
// slices equal and adjacent, else -4); ignored elsewhere. events: n_shards uint64
// and iters: n_shards int32 (device), zeroed here on the stream before the launch
// (one memset where iters follows events), so the caller need not fill them;
// with zeroed nonzero the caller zeroed them on the stream already (the census
// table's launch, csrc/table_kernel.cu) and no memset is queued.
// Returns cudaGetLastError() after the launch, -1 for an unknown ndim, -2 for an
// SMR launch without its tables, -3 for nongray without absorb, -4 for a shard
// table the kernel does not take, -6 for a record neither in the table nor in
// columns the kernel takes.
template <class Real>
int launch_entry(int ndim, int absorb, int ddmc, int smr, int nongray, void* const* ptrs,
                 const void* table, const void* const* cols, const void* block_table,
                 const void* levels, const void* lookup, int capacity, const int* igeom,
                 const Real* fgeom, int n_shards, const int* shards, const void* seeds,
                 const void* go, int spread, int grid, int width, void* events, void* iters,
                 int zeroed, void* stream) {
  Ledger<Real> L;
  for (int a = 0; a < 3; ++a) {
    L.x[a] = (Real*)ptrs[a];
    L.v[a] = (Real*)ptrs[3 + a];
    L.ci[a] = (int32_t*)ptrs[7 + a];
  }
  L.tau = (Real*)ptrs[6];
  L.alive = (uint8_t*)ptrs[10];
  L.absorbed = (uint8_t*)ptrs[11];
  L.face = (int32_t*)ptrs[12];
  L.blk = (int32_t*)ptrs[13];
  L.energy = (const Real*)ptrs[14];
  L.leak = (int32_t*)ptrs[15];
  Forest<Real> F;
  F.block = (const Real*)block_table;
  F.level = (const int32_t*)levels;
  F.lookup = (const int32_t*)lookup;
  F.cols = Columns<Real>{nullptr, nullptr, nullptr, nullptr};
  if (cols != nullptr)
    F.cols = Columns<Real>{(const Real*)cols[0], (const Real*)cols[1], (const Real*)cols[2],
                           (const Real*)cols[3]};

  Geom<Real> g;
  const int* ip = igeom;
  for (int a = 0; a < 3; ++a) g.n[a] = *ip++;
  for (int a = 0; a < 6; ++a) g.bc[a] = *ip++;
  g.max_iters = *ip++;
  for (int a = 0; a < 3; ++a) g.nt[a] = *ip++;
  g.fold = *ip++;
  g.nrbx = *ip++;
  g.nrby = *ip++;
  for (int a = 0; a < 3; ++a) g.nloc[a] = *ip++;
  const Real* fp = fgeom;
  Real* dst[8] = {g.dx, g.inv_dx, g.org, g.lo, g.hi, g.lo_half, g.hi_half, g.span};
  for (int k = 0; k < 8; ++k)
    for (int a = 0; a < 3; ++a) dst[k][a] = *fp++;
  g.dmin = *fp++;
  g.c = *fp++;
  g.inv_c = *fp++;
  g.cdt = *fp++;
  g.inv_cdt = *fp++;
  g.tau_ddmc = *fp++;
  g.eps_imc = *fp++;
  g.eps_ddmc = *fp++;
  g.dt = *fp++;
  g.inv_dt = *fp++;
  g.lam2 = *fp++;
  g.pf2_num = *fp++;
  Real* smr_dst[3] = {g.tile, g.nudge_cross, g.nudge_tilt};
  for (int k = 0; k < 3; ++k)
    for (int a = 0; a < 3; ++a) smr_dst[k][a] = *fp++;
  Real* ng_dst[9] = {&g.ng_rho_scale, &g.ng_temp_scale, &g.ng_len_scale, &g.ng_sb, &g.ng_kb,
                     &g.ng_hh, &g.ng_g, &g.ng_freq_min, &g.ng_xc_max};
  for (int k = 0; k < 9; ++k) *ng_dst[k] = *fp++;
  for (int a = 0; a < 3; ++a) g.shift[a] = *fp++;
  static_assert(kGeomInts == 19 && kGeomFloats == 57, "geometry layout");

  if (ndim < 1 || ndim > 3) return -1;
  const bool sm = smr != 0;
  if (sm && (block_table == nullptr || levels == nullptr || lookup == nullptr)) return -2;
  const bool ng = nongray != 0;
  if (ng && absorb == 0) return -3;
  if (n_shards < 1 || n_shards > kMaxShards) return -4;
  const Columns<Real>& c = F.cols;
  if (cols == nullptr && table == nullptr) return -6;
  if (cols != nullptr && (!ng || ddmc != 0 || !c.rho || !c.temp || !c.fleck || !c.sigma_s))
    return -6;
  Shards S;
  S.count = n_shards;
  int first = capacity, last = 0;
  for (int k = 0; k < n_shards; ++k) {
    const int* row = shards + 5 * k;
    S.slot_lo[k] = row[0];
    S.slot_hi[k] = row[1];
    S.own_lo[k] = row[2];
    S.own_hi[k] = row[3];
    S.row[k] = row[4];
    if (row[0] < 0 || row[1] < row[0] || row[1] > capacity) return -4;
    first = row[0] < first ? row[0] : first;
    last = row[1] > last ? row[1] : last;
  }
  S.first = first;
  S.spread = spread;
  S.seed = (const uint32_t*)seeds;
  S.go = (const uint8_t*)go;
  S.width = width;
  S.slice = S.slot_hi[0] - S.slot_lo[0];
  if (width < 0) return -4;
  if (width > 0)  // interleaved: equal, adjacent slices
    for (int k = 0; k < n_shards; ++k)
      if (S.slot_lo[k] != first + k * S.slice || S.slot_hi[k] != S.slot_lo[k] + S.slice)
        return -4;
  const int n = last - first;
  auto st = (cudaStream_t)stream;
  constexpr size_t kEv = sizeof(unsigned long long), kIt = sizeof(int32_t);
  if (zeroed == 0 && (char*)iters == (char*)events + kEv * n_shards) {
    cudaMemsetAsync(events, 0, (kEv + kIt) * n_shards, st);
  } else if (zeroed == 0) {
    cudaMemsetAsync(events, 0, kEv * n_shards, st);
    cudaMemsetAsync(iters, 0, kIt * n_shards, st);
  }
  if (n > 0) {
    const Real* tab = (const Real*)table;
    auto* ev = (unsigned long long*)events;
    auto* itp = (int32_t*)iters;
    Launch<Real> op{L, tab, F, n, g, S, ev, itp, st, grid};
    dispatch(ndim, absorb != 0, ddmc != 0, sm, ng, op);
  }
  return (int)cudaGetLastError();
}

// Resident blocks of kThreads threads a SM of one instantiation at precision Real
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks, and into *rounds
// the most rounds a ledger may take where it runs in rounds on the resident grid
// (kRoundsMax: 2 or 4), else 0. Returns the
// CUDA error, -1 for an unknown ndim, -3 for nongray without absorb.
template <class Real>
int occupancy_entry(int ndim, int absorb, int ddmc, int smr, int nongray, int* blocks,
                    int* rounds) {
  if (ndim < 1 || ndim > 3) return -1;
  if (nongray != 0 && absorb == 0) return -3;
  Occupancy<Real> op{0, 0, 0};
  dispatch(ndim, absorb != 0, ddmc != 0, smr != 0, nongray != 0, op);
  *blocks = op.blocks;
  *rounds = op.rounds;
  return op.err;
}

}  // namespace
