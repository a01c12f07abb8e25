#!/usr/bin/env python3
"""Census kernel times of two trees of this repository, in turns, on the same saved
inputs; and, with ``--profile``, their device time a step by ``profile.py``.

    python3 census_bench.py --parent DIR [--variant DIR ...] [--repeats 7]
        [--turns 2] [--profile] [--only ROUTE ...] [--out FILE]

Run from the root of a checkout on a machine with one NVIDIA GPU. DIR is another
checkout of the repository, for example the parent commit unpacked by ``git
archive`` into a directory that ``.gitignore`` lists; each ``--variant`` DIR one
more tree, timed in the same turns. Nothing here imports jax.

1. With this tree's package it records the inputs of one census of every route
   that ``chip_smoke.py`` times, on the same paths with the same overrides: the
   stepdiff, 2D feedback and 64^3 feedback ledgers after their last step (seed
   12345, the coefficients of the final fields); the last census of the DDMC, SMR
   and non-gray paths; phase 11's hybrid ledgers; the first round of
   big_mesh_spatial and of SMR+DDMC spatial at 8 shards (of the latter, K4s, its
   second round too, LATER_ROUNDS); the float64 routes of
   phase 43 (the last census of stepdiff, stepdiff_ddmc, stepdiff_smr and its
   EPBremss step, the first round of stepdiff at 8 spatial shards); at other
   numbers of lanes a SM, the 64^3 feedback ledger's first eighth, the
   stepdiff_smr ledger eight times over and the lane sweep: the stepdiff, 2D
   feedback, 64^3 DDMC, stepdiff_3d, stepdiff_ddmc and 64^3 ep_bremss ledgers and
   the float64 routes of F64_READ two and four times over (the copies in other
   slots, so other draws; of a round, each shard's slice). They go to one file;
   with ``--only`` the named routes and their sweep alone.
2. Child processes, each importing the package of one tree (``--child``), time the
   census kernel on those inputs: every route the median of ``--repeats``
   censuses, each on a fresh copy of the saved ledger, timed with CUDA events
   after a device sleep (as ``chip_smoke.time_census``), and in as many more the
   parts of the call (``chip_smoke.CallSplit``: the cell table, the forest
   tables, the counters, the census launch; apart, since its events lengthen a
   call). The children run in turns,
   parent, the variants, this tree, this tree, the variants in reverse, parent,
   ``--turns`` times over. Every child
   digests each route's output ledger; the script fails unless all children agree
   on every digest and every event count, so the trees' kernels are bitwise equal
   there and their counters agree.
3. ``--profile`` runs ``python -m jaybenne_tpu_torch.profile`` from each tree's
   root in the same turns on stepdiff_smr (64x32, 100k particles), the 64^3
   feedback row, the 64^3 DDMC row, stepdiff_3d (``chip_smoke.py`` phases 14
   and 20), big_mesh_spatial at 8 shards (phase 30; its migration's inserts)
   and, in float64, stepdiff_smr and stepdiff at 8 spatial shards (phase 43;
   ``--profile DECK ...`` names some), and reads the census kernel's device
   ms a step and its launches a step (the mean launch: a spatial round), the
   step's device total and the unprofiled steps' wall median.

With ``--only census_table`` it reads the census table apart first, in the same
turns, on the set-ups of TABLE_PATHS (each path's first step: the 64^3 DDMC and
ep_bremss rows, big_mesh_spatial at 8 shards, stepdiff's pair table, stepdiff_ddmc
in float32 and float64; ``--table-child``): per tree the set-up with the table
kernel (the median of ``--repeats`` after a device sleep), with an empty kernel of
the table's grid in its place (the floor of its launch), and with the kernel
whose loads are replaced by their addresses (its index arithmetic and stores
alone), the kernel's own duration on the device (torch.profiler), the share of
its bytes bound of each, the instantiation's registers and runtime
integer divisions in its SASS; on a single device the census call and its split.

With ``--only tally`` and ``--only faces`` it reads the tally kernel
(``csrc/tally_kernel.cu``) and the DDMC face kernel (``csrc/faces_kernel.cu``)
apart first, in this tree: each bitwise its plain version on every call of
``chip_smoke.py`` phase 46's paths (TALLY_PATHS, FACE_PATHS) and read apart on
each path's first step (device ms by launch from torch.profiler with the
launches its trace holds, the event window after a device sleep, the plain
version's, the bytes bound); then profile.py on TALLY_FACES_DECKS in the turns,
as CUDA graphs, and the 64^3 DDMC row eagerly once for the parent and this tree
(every span, ``step.face_probs`` among them).

With ``--only round`` it reads the spatial round's gate and counts apart first,
in this tree (``chip_smoke.counts_phase``: the census with go false bitwise no
change on every spatial route's recorded rounds, the count kernel
``csrc/count_kernel.cu`` bitwise its plain version on every path and read apart
against its bound and the plain ops' device time); then profile.py on
ROUND_DECKS (big_mesh_spatial and the float64 stepdiff at 8 shards, the 64^3
DDMC row) in the turns, as CUDA graphs, with each trace's device operations a
step and a round queued, and this tree at each of ROUND_BATCHES rounds a batch
in turns on the spatial decks.

With ``--only steps`` it runs profile.py in the turns on chip_smoke.py phase 32's
8-device SMR rows (the particle decomposition's step: PARTICLE_DECKS) and on
big_mesh_spatial and the float64 stepdiff at 8 spatial shards (HOST_DECKS), each
as the tree runs it on the card (chip_smoke.py phase 48 reads this tree's spatial
steps with and without a batch queued ahead of an exit read), and prints the
device ms a step of the hand-written kernels and of the rest, the census launches
a step, the step wall less the device time and the host ms a step of the spatial
spans (``chip_smoke.HOST_SPANS``).

With ``--only migrate`` it reads the spatial migration apart first, in this tree:
on the recorded first round of each deck of MIGRATE_DECKS (big_mesh_spatial and
the float64 stepdiff at 8 shards) the migration kernel bitwise its plain version
(go false too) and ``chip_smoke.migration_reading`` (against the plain migrate,
``migrate(plain=True)``), and on one rank's round (MIGRATE_RANK: one local shard
of 8, its slice made from big_mesh_spatial's round, thousands of tiles) the pack
bitwise its plain version; then each tree's migration kernel on those rounds in
the turns (``--migrate-child``: the pack's window and device ms by launch, the
round with the insert, the round with go false; every tree's outputs equal);
then profile.py on those decks in the turns, as CUDA graphs, eagerly once for
the parent and this tree (the spans of ``spatial.round`` with their device work
by kernel), and this tree at MIGRATE_BATCH rounds a batch.
``--only migrate_kernel`` does all of it but the profile.py turns.

With ``--only counts_apart`` it reads the count kernel (``csrc/count_kernel.cu``)
apart on big_mesh_spatial's first round at 8 shards and the 64^3 DDMC step, in
this tree: the kernel, an empty kernel of its grid and its slot pass alone
(COUNTS_CUT), each by device ms and window; the last block's ticket and epilogue
are the kernel less its slot pass.

It prints the card's name and power limit; for each tree the nvcc ``-Xptxas -v``
resources of the routes whose event loop ``chip_smoke.py`` reads (from the child
that built the tree's library), the instantiations whose resources differ from
the parent's, and their event loop's common-path SASS instructions
(``chip_smoke.common_paths`` on the tree's sources); one line per route with every
tree's medians, ranges and their ratio to the parent's, the kernel alone's and the
call's parts; the parent's and this tree's warp path mix (MIX_ROUTES:
``--mix-child``, its kernel's counting variant, ``chip_smoke.path_mix``; the
variants share their event loop with one of them), with how their lane-events
spread over the SMs (%smid); on the DDMC routes (``chip_smoke.DDMC_ROUTES``) its
DDMC reading (``ddmc_reading``: the kernel alone, registers and resident blocks,
the slot order's warp efficiency, the live lanes and events by block of 256
slots, the events of a live lane, the DDMC path mix with its issue time and share
from the DDMC event's SASS, and on stepdiff_3d the events of a live lane by the
level of its block); on the non-gray routes their reading (``ng_reading``: the same,
the kernel alone with its slots spread and in order, and the opacity's SASS against
the event loop's); on the float64 IMC routes of F64_READ their reading
(``f64_reading``: the kernel alone, registers and resident blocks, the warp path
mix with the instructions a warp-event modelled from the loop's float64 SASS and
its issue share, and the double log's and divide's share of the common path);
the float64 DDMC route of F64_READ has the DDMC reading; the lane sweep's time an event
at 1, 2 and 4 times the live lanes of SWEEP_ROUTES (a time an event that falls
with more lanes says the census leaves throughput unused: unevenly loaded SMs,
which the path mix shows, or latency); with ``--out`` it writes everything there
as JSON.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's SMR_GATE mesh at 8 particle shards (phase 32)
SMR_8P = ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32", "parthenon/meshblock/nx1=16",
          "parthenon/meshblock/nx2=16", "jaybenne/n_devices=8", "parthenon/output0/file_type=none"]
PROFILE_DECKS = {
    "stepdiff_smr": ("inputs/stepdiff_smr.in", [
        "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32", "parthenon/meshblock/nx1=16",
        "parthenon/meshblock/nx2=16", "parthenon/output0/file_type=none"]),
    "feedback_64": ("inputs/stepdiff.in", [
        "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "parthenon/mesh/nx3=64",
        "parthenon/mesh/ix2_bc=periodic", "parthenon/mesh/ox2_bc=periodic",
        "parthenon/mesh/ix3_bc=periodic", "parthenon/mesh/ox3_bc=periodic",
        "parthenon/meshblock/nx1=8", "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=8",
        "jaybenne/num_particles=200000", "jaybenne/do_emission=true",
        "jaybenne/do_feedback=true", "mcblock/opacity_model=constant",
        "mcblock/opacity_constant_value=3.0", "jaybenne/capacity_factor=3",
        "parthenon/output0/file_type=none"]),
    # chip_smoke.py phase 30's big_mesh_spatial at 8 in-process shards (bench.py's
    # big mesh, IMC, 200k particles): the spatial step, its migration's inserts
    "big_mesh_spatial_8": ("inputs/stepdiff.in", [
        "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "parthenon/mesh/nx3=64",
        "parthenon/mesh/ix2_bc=periodic", "parthenon/mesh/ox2_bc=periodic",
        "parthenon/mesh/ix3_bc=periodic", "parthenon/mesh/ox3_bc=periodic",
        "parthenon/meshblock/nx1=8", "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=8",
        "jaybenne/num_particles=200000", "jaybenne/decomposition=spatial",
        "jaybenne/n_devices=8", "parthenon/output0/file_type=none"]),
    # chip_smoke.py phases 14 (BIG_DDMC) and 20 (SMR3D)
    "big_mesh_ddmc": ("inputs/stepdiff.in", [
        "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "parthenon/mesh/nx3=64",
        "parthenon/mesh/ix2_bc=periodic", "parthenon/mesh/ox2_bc=periodic",
        "parthenon/mesh/ix3_bc=periodic", "parthenon/mesh/ox3_bc=periodic",
        "parthenon/meshblock/nx1=8", "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=8",
        "jaybenne/num_particles=200000", "jaybenne/use_ddmc=true",
        "parthenon/output0/file_type=none"]),
    # chip_smoke.py phase 5's stepdiff gate (128 cells, 100k particles)
    "stepdiff": ("inputs/stepdiff.in", [
        "parthenon/mesh/nx1=128", "parthenon/meshblock/nx1=128",
        "jaybenne/num_particles=100000", "parthenon/output0/file_type=none"]),
    "stepdiff_3d": ("inputs/stepdiff_3d_smr_ddmc.in", [
        "jaybenne/num_particles=500000", "parthenon/output0/file_type=none"]),
    # chip_smoke.py phase 43's float64 stepdiff_smr and stepdiff at 8 spatial shards
    "stepdiff_smr_f64": ("inputs/stepdiff_smr.in", [
        "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32", "parthenon/meshblock/nx1=16",
        "parthenon/meshblock/nx2=16", "parthenon/output0/file_type=none",
        "jaybenne/precision=f64"]),
    "stepdiff_spatial_f64": ("inputs/stepdiff.in", [
        "parthenon/mesh/nx1=128", "parthenon/meshblock/nx1=16", "jaybenne/num_particles=100000",
        "parthenon/output0/file_type=none", "jaybenne/decomposition=spatial",
        "jaybenne/n_devices=8", "jaybenne/capacity_factor=4", "jaybenne/precision=f64"]),
    # chip_smoke.py phase 32's 8-device SMR rows (the particle decomposition)
    "stepdiff_smr_8p": ("inputs/stepdiff_smr.in", SMR_8P),
    "stepdiff_smr_ddmc_8p": ("inputs/stepdiff_smr_ddmc.in", SMR_8P),
    "hybrid_8p": ("inputs/stepdiff_smr_hybrid.in",
                  SMR_8P + ["jaybenne/tau_ddmc=10.0", "jaybenne/num_particles=100000"]),
    "stepdiff_smr2_8p": ("inputs/stepdiff_smr2.in", SMR_8P),
}


PROFILE_ARGS = ("--warm", "3", "--steps", "3")
SWEEP_ROUTES = ("transport_1d", "transport_2d_abs", "transport_3d_ddmc", "transport_3d_ddmc_smr",
                "transport_1d_ddmc", "transport_3d_abs_ng", "transport_2d_smr_f64",
                "transport_1d_smr_f64@blocks", "transport_1d_f64", "transport_1d_ddmc_f64")
SWEEP = (1, 2, 4)
# the float64 routes read apart: stepdiff_smr's, stepdiff's and stepdiff_ddmc's
# last census and the first round of stepdiff at 8 spatial shards (chip_smoke.py
# phase 43's); the IMC ones by ``f64_reading``, the DDMC one
# (``chip_smoke.DDMC_ROUTES``) by ``ddmc_reading``
F64_READ = ("transport_2d_smr_f64", "transport_1d_smr_f64@blocks", "transport_1d_f64",
            "transport_1d_ddmc_f64")
# the spatial routes whose second round is recorded too (a later round: its lanes
# the first round's leftovers and arrivals), and read apart by ``ddmc_reading``
LATER_ROUNDS = ("transport_2d_ddmc_smr@blocks",)
K4S_READ = ("transport_2d_ddmc_smr@blocks", "transport_2d_ddmc_smr@blocks, its second round")


# ``--only census_table``: the census table read apart on the paths that launch it
# (each path's first step; chip_smoke.py's decks and overrides): its name, deck,
# overrides and whether it runs through the spatial decomposition (its set-up over
# every shard's range)
TABLE = "census_table"
TABLE_PATHS = (("the 64^3 DDMC row", "DECK", "BIG_DDMC", False),
               ("the 64^3 ep_bremss row", "DECK", "NG_BIG", False),
               ("big_mesh_spatial at 8 shards", "DECK", "BIG_SPATIAL_8", True),
               ("stepdiff (the gray pair)", "DECK", "GATE", False),
               ("stepdiff_ddmc", "DDMC_DECK", "DDMC_GATE", False),
               ("stepdiff_ddmc f64", "DDMC_DECK", "DDMC_GATE_F64", False))
# a runtime integer division's SASS: each sequence converts its divisor once
DIVISION = re.compile(r"\bI2F(\.U32)?\.RP\b")
TABLE_KERNEL = re.compile(r"table_kernelILi(\d+)ELb([01])E(?:Li(\d+)E)?([fd])E")
# a load of the table kernel replaced by a word made from its address, so that the
# kernel keeps its index arithmetic and its stores and reads nothing
NO_LOAD = """#include <cstdint>
template <class T>
__device__ __forceinline__ T jb_noload(const T* p) {
  union { T v; unsigned w[sizeof(T) / 4]; } u;
  for (int k = 0; k < (int)(sizeof(T) / 4); ++k) u.w[k] = (unsigned)(uintptr_t)p + k;
  return u.v;
}
"""


def sweep_name(name, k) -> str:
    """The route of ``name``'s census ledger ``k`` times over (the copies in other
    slots, so other draws)."""
    return name if k == 1 else f"{name}, its ledger {k} times"


def times_over(p, k, n=1):
    """A ledger of ``n`` equal slices (shards) with each slice ``k`` times over (the
    copies in other slots, so other draws)."""
    from jaybenne_tpu_torch.particles import ParticleLedger

    return ParticleLedger(**{f.name: getattr(p, f.name).view(n, -1).repeat(1, k).reshape(-1)
                             for f in dataclasses.fields(p)})


def record(path, only=None) -> None:
    """Step 1: the census inputs of every timed route (of ``only``'s, where given),
    saved to ``path``."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.ops import transport as transport_ops
    from jaybenne_tpu_torch.ops import transport_kernel as tk
    from jaybenne_tpu_torch.particles import ParticleLedger
    from jaybenne_tpu_torch.step import make_transport_params

    dev = torch.device("cuda", 0)
    routes = {}

    def want(name):
        return only is None or name in only

    f64 = cs.PREC64
    with tempfile.TemporaryDirectory() as outdir:
        for name, deck, mods, steps in (
                ("transport_1d", cs.DECK, cs.GATE, cs.N_STEPS),
                ("transport_2d_abs", cs.DECK, cs.FEEDBACK_2D, cs.FEEDBACK_2D_STEPS),
                ("transport_3d_abs", cs.DECK, cs.FEEDBACK, cs.FEEDBACK_STEPS)):
            if not want(name):
                continue
            sim = run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=steps,
                           device="cuda")
            m = sim.cfg.mcblock
            coefs = transport_ops.precompute_coefs(
                sim.state.fields, sim.mesh, m.build_eos(), m.build_opacity(),
                m.build_scattering(), False, torch.float32)
            prm = make_transport_params(sim.cfg, torch.float32)
            routes[name] = (sim.state.particles.clone(), 1,
                            (coefs, sim.mesh, 12345, prm, sim.cfg.jaybenne.dt))
        for name, deck, mods, steps in (
                ("transport_1d_ddmc", cs.DDMC_DECK, cs.DDMC_GATE, cs.PATH_STEPS),
                ("transport_1d_abs_ddmc", cs.STIFF_DECK, cs.STIFF, cs.STIFF_STEPS),
                ("transport_3d_ddmc", cs.DECK, cs.BIG_DDMC, cs.PATH_STEPS),
                ("transport_2d_smr", cs.SMR_DECK, cs.SMR_GATE, cs.PATH_STEPS),
                ("transport_3d_ddmc_smr", cs.SMR3D_DECK, cs.SMR3D, cs.PATH_STEPS),
                ("transport_2d_ddmc_smr", cs.HYBRID_DECK, cs.NATIVE_HYBRID, cs.PATH_STEPS),
                ("transport_1d_abs_ng", cs.DECK, cs.NG_GATE, 1),
                ("transport_3d_abs_ng", cs.DECK, cs.NG_BIG, cs.FEEDBACK_STEPS),
                ("transport_2d_abs_smr_ng", cs.SMR_DECK, cs.NG_SMR, 1),
                ("transport_1d_f64", cs.DECK, {**cs.GATE, **f64}, cs.N_STEPS),
                ("transport_1d_ddmc_f64", cs.DDMC_DECK, {**cs.DDMC_GATE, **f64}, cs.PATH_STEPS),
                ("transport_2d_smr_f64", cs.SMR_DECK, {**cs.SMR_GATE, **f64}, cs.PATH_STEPS),
                ("transport_2d_abs_smr_ng_f64", cs.SMR_DECK, {**cs.NG_SMR, **f64}, 1)):
            if not want(name):
                continue
            with cs.CensusRecorder(tk, steps) as rec:  # recorded: the eager step
                run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=steps,
                         device="cuda", graph=False)
            p, args = rec.inputs
            routes[name] = (p, 1, args)
    for ndim, absorb, seed in ((2, False, 1102), (2, True, 1112), (3, True, 1113)):
        if only is not None:
            break
        dt, mesh, prm, p0, coefs, _ = cs.hybrid_setup(dev, ndim, absorb, True, seed)
        p0.tau.copy_(0.9 + 0.1 * torch.rand(p0.capacity, device=dev,
                                            generator=torch.Generator(dev).manual_seed(seed)))
        routes[f"{tk.launch_name(ndim, absorb, True)} (phase 11's ledger)"] = (
            p0, 1, (coefs, mesh, seed, prm, dt))
    for name, deck, mods, steps in (
            (tk.launch_name(3, False, route="@z"), cs.DECK,
             {**cs.BIG_MESH, **cs.SPATIAL, "jaybenne/n_devices": 8}, cs.BIG_SPATIAL_STEPS),
            (tk.launch_name(2, False, True, True, route="@blocks"), cs.SMR_DDMC_DECK,
             {**cs.SMR_SPATIAL, **cs.SPATIAL, "jaybenne/n_devices": 8}, cs.SMR_SPATIAL_STEPS),
            (tk.launch_name(1, False, False, True, route="@blocks", dtype=torch.float64),
             cs.DECK, {**cs.STEPDIFF_SPATIAL, **f64}, 1)):
        later = f"{name}, its second round"
        if want(name) or want(later):
            sim = cs.spatial_path(deck, mods, steps, name)[0]
            routes[name] = sim.recorded_rounds[0]
            if name in LATER_ROUNDS:
                routes[later] = sim.recorded_rounds[1]
    if only is None:
        # the two routes whose event loop chip_smoke.py reads at other numbers of
        # lanes a SM: the 64^3 feedback ledger's first eighth, the stepdiff_smr
        # ledger eight times over (the copies in other slots, so other draws)
        p, _, args = routes["transport_3d_abs"]
        part = ParticleLedger(**{f.name: getattr(p, f.name)[: p.capacity // 8].clone()
                                 for f in dataclasses.fields(p)})
        routes["transport_3d_abs, the first eighth of its ledger"] = (part, 1, args)
        p, _, args = routes["transport_2d_smr"]
        routes["transport_2d_smr, its ledger eight times"] = (times_over(p, 8), 1, args)
    # the lane sweep: each route's ledger (each shard's slice) SWEEP times over
    for name in SWEEP_ROUTES:
        if name not in routes:
            continue
        p, n, args = routes[name]
        for k in SWEEP[1:]:
            routes[sweep_name(name, k)] = (times_over(p, k, n), n, args)
    torch.save(routes, path)


def record_tables(path) -> None:
    """The census set-ups of TABLE_PATHS (``prepare``'s arguments) and, on a single
    device, the census call's inputs, saved to ``path``."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jaybenne_tpu_torch.driver import run_file
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    decks = {"BIG_SPATIAL_8": {**cs.BIG_MESH, **cs.SPATIAL, "jaybenne/n_devices": 8},
             "DDMC_GATE_F64": {**cs.DDMC_GATE, **cs.PREC64}}
    tables = {}
    with tempfile.TemporaryDirectory() as outdir:
        for name, deck, mods, spatial in TABLE_PATHS:
            deck, mods = getattr(cs, deck), decks.get(mods) or getattr(cs, mods)
            if spatial:
                tables[name] = (cs.spatial_path(deck, mods, 1, name)[4], None)
                continue
            with cs.CensusRecorder(tk, 1) as rec:  # recorded: the eager step
                run_file(deck, outdir=outdir, modified_inputs=mods, quiet=True, nlim=1,
                         device="cuda", graph=False)
            p, (coefs, mesh, seed, prm, dt) = rec.inputs
            tables[name] = ((coefs, mesh, prm, dt, None), (p, (coefs, mesh, seed, prm, dt)))
    torch.save(tables, path)


def table_probes(pkg, tmp) -> dict:
    """Built in ``tmp`` from the tree under ``pkg``: its table kernel's source as a
    cubin (``-Xptxas -v``: registers; SASS), the same with every load replaced by
    its address (NO_LOAD) as a library of its C entries, and this tree's probes
    (``csrc/sass_probes.cu``: ``jb_empty_launch``), all compiled at once. Returns
    the cubin's path and ptxas log, and the two libraries (ctypes)."""
    import ctypes

    from jaybenne_tpu_torch.ops import cuda_lib

    src = os.path.join(pkg, "jaybenne_tpu_torch", "csrc", "table_kernel.cu")
    with open(src) as f:
        text = f.read()
    noload = os.path.join(tmp, "table_noload.cu")
    with open(noload, "w") as f:
        f.write(NO_LOAD + text.replace("__ldg(", "jb_noload("))
    own = os.path.join(ROOT, "jaybenne_tpu_torch", "csrc")
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {"cubin": (["-Xptxas", "-v", "-cubin"], src, "table.cubin"),
            "noload": (["-shared"], noload, "libtable_noload.so"),
            "probes": (["-shared", "-I", own], os.path.join(own, "sass_probes.cu"),
                       "libprobes.so")}
    procs = {k: subprocess.Popen([cuda_lib.nvcc(), *flags, *extra, "-o", os.path.join(tmp, out),
                                  cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, (extra, cu, out) in jobs.items()}
    logs = {k: proc.communicate(timeout=600)[0] for k, proc in procs.items()}
    for k, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"table probe {k}: nvcc failed:\n{logs[k][-3000:]}")
    out = {"cubin": os.path.join(tmp, "table.cubin"), "log": logs["cubin"]}
    for k in ("noload", "probes"):
        out[k] = ctypes.CDLL(os.path.join(tmp, jobs[k][2]))
    for name in ("jb_table_launch", "jb_table_launch_f64"):
        fn = getattr(out["noload"], name)
        fn.argtypes = list(cuda_lib._SIGNATURES[name])
        fn.restype = ctypes.c_int
    out["probes"].jb_empty_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out["probes"].jb_empty_launch.restype = ctypes.c_int
    return out


def table_instantiations(cubin, log) -> dict:
    """Per table kernel instantiation, (kind, absorb, run or None, "f" or "d") ->
    its registers (ptxas ``log``) and the runtime-division sequences in its SASS."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    out = {}
    for fn, code in cs.sass_listing(cubin).items():
        m = TABLE_KERNEL.search(fn)
        if m:
            key = (int(m.group(1)), m.group(2) == "1",
                   int(m.group(3)) if m.group(3) else None, m.group(4))
            out[key] = {"registers": regs.get(fn),
                        "divisions": sum(1 for _, t in code if DIVISION.search(t))}
    return out


def table_child(inputs, pkg, repeats, out) -> None:
    """``--only census_table`` in one process, for the package under ``pkg``: on each
    saved set-up of TABLE_PATHS the census set-up (``_prepare`` on the card: the
    table kernel) the median of ``repeats`` after a device sleep, the same with an
    empty kernel of the table's grid in its place (the floor of its launch), and
    with the kernel whose loads are replaced by their addresses (its index
    arithmetic and stores alone); the table's bytes; the instantiation's registers
    and runtime divisions; and on a single device the census call (median) and its
    split (``chip_smoke.CallSplit``)."""
    sys.path.insert(0, pkg)
    import torch

    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    dev = torch.device("cuda", 0)
    lib = cuda_lib.library()
    cs = this_chip_smoke()
    tables = torch.load(inputs, weights_only=False)

    def timed(fn):
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(stop))
        return sorted(times)

    def device(fn, tmp):
        """Sorted ms of the table kernel's launches on the device (torch.profiler's
        kernel durations) over ``repeats`` calls of ``fn``."""
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize(dev)
        trace = os.path.join(tmp, "table_trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        return sorted(float(e["dur"]) / 1e3 for e in events
                      if e.get("cat") == "kernel" and "table_kernel" in e["name"])

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        probes = table_probes(pkg, tmp)
        kinds = table_instantiations(probes["cubin"], probes["log"])
        for name, (setup, census) in tables.items():
            coefs, mesh, prm, dt, own = setup

            def prepare():
                return tk._prepare(coefs, mesh, prm, dt, own, True)

            ready = prepare()
            g, cell = ready.g, ready.tabs.cell
            row = {"kernel": timed(prepare), "device": device(prepare, tmp)}
            with cs.TableEntry(lib, cs.empty_table(tk, probes["probes"].jb_empty_launch)):
                row["floor"] = timed(prepare)
            with cs.TableEntry(lib, lambda n, *a: lib_check(n, getattr(probes["noload"], n)(*a))):
                row["index_only"] = timed(prepare)
            cset = list(coefs) if isinstance(coefs, (list, tuple)) else [coefs]
            row["bytes"] = cs.table_bytes(tk, cset, g, cell)
            row["rows"], row["width"] = list(cell.shape)
            real = "d" if g.real == torch.float64 else "f"
            row["instantiations"] = {str(k[2]): v for k, v in kinds.items()
                                     if k[0] == tk._table_kind(g) and k[1] == g.absorb
                                     and k[3] == real}
            if hasattr(tk, "table_plan"):
                row["run"] = tk.table_plan(mesh, g, [c.sigma_s.numel() for c in cset]).run
            if census is not None:
                p0, args = census
                row["call"] = timed(lambda: tk.transport(p0.clone(), *args))
                parts = []
                with cs.CallSplit(tk, lib) as win:
                    for _ in range(repeats):
                        q = p0.clone()
                        torch.cuda.synchronize(dev)
                        torch.cuda._sleep(50_000_000)
                        tk.transport(q, *args)
                        parts.append(win.ms())
                row["split"] = {k: statistics.median(d[k] for d in parts)
                                for k in ("table", "counters", "launch", "gap")}
            result[name] = row
            print(f"  {os.path.basename(pkg.rstrip('/')) or pkg}: {name} table median "
                  f"{statistics.median(row['kernel'])!r} ms", flush=True)
    with open(out, "w") as f:
        json.dump(result, f)


def lib_check(name, err) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def table_lines(kids, trees, label) -> None:
    """Prints ``--only census_table``'s reading, a line per path: for each tree the
    medians of its turns (ms) of the set-up with the table kernel, with an empty
    kernel of its grid, with the kernel reading nothing (index arithmetic and
    stores), the kernel's own duration on the device (torch.profiler) and its
    share of the bytes bound, the instantiation's registers and runtime divisions;
    and on a single device the census call and its split."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    for name in kids[0]["tables"]:
        row0 = kids[0]["tables"][name]
        bound = row0["bytes"] / cs.PEAK_BYTES * 1e3
        cells = []
        for tree in trees:
            runs = [kid["tables"][name] for kid in kids if kid["tree"] == label[tree]]
            med = {k: statistics.median(statistics.median(r[k]) for r in runs)
                   for k in ("kernel", "floor", "index_only", "device")}
            turns = [statistics.median(r["kernel"]) for r in runs]
            cells.append(f"{label[tree]}: kernel {med['kernel']!r} (turns {turns}), empty launch "
                         f"of its grid {med['floor']!r}, loads replaced by their addresses "
                         f"{med['index_only']!r}, bound share {bound / med['kernel']:.3f}; on the "
                         f"device {med['device']!r}, bound share {bound / med['device']:.3f}; run "
                         f"{runs[0].get('run', 1)}; registers and runtime divisions by run "
                         f"{runs[0]['instantiations']}")
        print(f"census_table on {name} ({row0['rows']} rows of {row0['width']}, "
              f"{row0['bytes']} bytes, bound {bound!r} ms): " + " | ".join(cells), flush=True)
        if "call" not in row0:
            continue
        cells = []
        for tree in trees:
            runs = [kid["tables"][name] for kid in kids if kid["tree"] == label[tree]]
            call = statistics.median(statistics.median(r["call"]) for r in runs)
            split = {k: statistics.median(r["split"][k] for r in runs)
                     for k in ("table", "counters", "launch", "gap")}
            cells.append(f"{label[tree]}: call {call!r} (turns "
                         f"{[statistics.median(r['call']) for r in runs]}), cell table "
                         f"{split['table']!r}, counters {split['counters']!r}, census launch "
                         f"{split['launch']!r} (gap {split['gap']!r})")
        print(f"  {name} census call and its split, medians over the turns (ms): "
              + " | ".join(cells), flush=True)


def digest(p) -> str:
    """sha256 of every column of a ledger."""
    h = hashlib.sha256()
    for f in dataclasses.fields(p):
        h.update(getattr(p, f.name).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


MIX_ROUTES = ("transport_1d", "transport_2d_abs", "transport_3d_ddmc", "transport_3d_ddmc_smr",
              "transport_1d_ddmc", "transport_1d_abs_ddmc", "transport_3d_abs_ng",
              "transport_1d_abs_ng", "transport_2d_abs_smr_ng", "transport_2d_abs_smr_ng_f64",
              *F64_READ, *K4S_READ)
# the non-gray routes whose opacity's share of the event loop is read: the loop as
# built, and with EPBremss returning at once (``chip_smoke.LOOP_PATHS``)
NG_ROUTES = ("transport_3d_abs_ng", "transport_1d_abs_ng", "transport_2d_abs_smr_ng",
             "transport_2d_abs_smr_ng_f64")
NG_PATHS = ("scatter", "full", "no_opacity")


def this_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, in a child that imports another
    tree's package: its readings apply to any tree's kernel of the same layout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


DD_PATHS = ("dd_leak", "dd_step", "dd_any")


def kernel_alone(cs, tk, dev, p0, args, repeats, spread=None, n=1) -> list:
    """Sorted ms of the census kernel alone with its counters (``chip_smoke.CallSplit``'s
    ``kernel``) in ``repeats`` censuses on fresh copies of ``p0`` (of ``n`` shards'
    slices), each after a device sleep; with ``spread`` False or True, each
    launch's slots spread or not whatever ``transport_kernel.spreads`` would
    choose."""
    import torch

    from jaybenne_tpu_torch.ops import cuda_lib

    times, chooser = [], tk.spreads
    census = cs.sliced(tk.transport, n) if n > 1 else tk.transport
    if spread is not None:
        tk.spreads = lambda *a: spread
    try:
        with cs.CallSplit(tk, cuda_lib.library()) as win:
            for _ in range(repeats):
                p = p0.clone()
                torch.cuda.synchronize(dev)
                torch.cuda._sleep(50_000_000)
                census(p, *args)
                times.append(win.ms()["kernel"])
    finally:
        tk.spreads = chooser
    return sorted(times)


def ddmc_mix_line(cs, name, mix, paths, kernel_ms, events, dev) -> dict:
    """Prints the DDMC warp path mix of the route ``name`` (``chip_smoke.path_mix``),
    checked against the census's ``events``: the share of warp-events with a lane
    on the DDMC branch, one that leaked, reached census from it, was rejected or
    accepted at a face's albedo test or was absorbed, and with a lane that did
    anything else than a DDMC leak or census inside its block ("other"); what a
    lane-event did; the SIMT efficiency (lane-events over 32 x warp-events) and how
    the lane-events spread over the SMs (%smid). Then the instructions a warp
    issues an event, modelled from the mix and the DDMC loop paths (``paths``,
    {path: count}): the leak's path (dd_leak; a lane leaks in 0.9 or more of the
    warp-events of these routes), plus the census's code (dd_step - dd_leak) where
    a lane reached census and the rest of the DDMC event (dd_any - dd_step: albedo
    tests, absorption, block faces and walls) where one did anything else; the
    issue time, those instructions x warp-events at the card's issue rate (SMs x 4
    warp instructions a SM clock x the SM clock, nvidia-smi, read just after), and
    the warp issue share, the issue time over ``kernel_ms`` (the kernel alone).
    Returns the mix with the model's numbers."""
    import torch

    if mix["lane_events"] != events:
        raise AssertionError(f"{name} path mix: {mix['lane_events']} lane-events, census {events}")
    we, le, by_sm = mix["warp_events"], mix["lane_events"], mix["by_sm"]
    keys = ("ddmc", "dd_leak", "dd_census", "dd_rejected", "dd_accepted", "dd_absorbed",
            "dd_other")
    share = {k: mix[k] / we for k in keys}
    lane = {k: mix[k] / le for k in ("lane_ddmc", "lane_leaks", "lane_dd_census",
                                     "lane_rejected", "lane_accepted", "lane_dd_absorbed")}
    leak, step, any_ = (paths[k] for k in DD_PATHS)
    per_warp = leak + share["dd_census"] * (step - leak) + share["dd_other"] * (any_ - step)
    clock = cs.smi_value("clocks.sm")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = sms * (cs.ISSUE_PER_SM_CLOCK // 32) * clock * 1e6
    issue_ms = per_warp * we / rate * 1e3
    print(f"{name} DDMC warp path mix: {we} warp-events for {le} lane-events (SIMT efficiency "
          f"{le / (32 * we)!r}); share of warp-events with a lane "
          + ", ".join(f"{k} {v!r}" for k, v in share.items()) + "; a lane-event "
          + ", ".join(f"{k} {v!r}" for k, v in lane.items())
          + f"; loop paths (SASS) dd_leak {leak}, dd_step {step}, dd_any {any_}: census "
          f"+{step - leak}, other +{any_ - step}; modelled {per_warp!r} instructions a "
          f"warp-event; SM clock {clock!r} MHz; at the issue rate {issue_ms!r} ms; warp issue "
          f"share {issue_ms / kernel_ms!r} (kernel alone {kernel_ms!r} ms); lane-events a SM "
          f"(%smid): {len(by_sm)} of {sms} SMs ran lanes, max/mean over the {sms} "
          f"{max(by_sm) * sms / sum(by_sm)!r}", flush=True)
    return {**mix, "instructions_per_warp_event": per_warp, "issue_ms": issue_ms,
            "warp_issue_share": issue_ms / kernel_ms}


def history_line(label, lanes, p) -> None:
    """Prints the events of a live lane of the census (``lanes``, the plain
    version's per slot): the mean and the longest history."""
    live = p.alive & (p.tau < 1.0)
    ev = lanes[live].double()
    print(f"{label}: {int(live.sum())} live lanes, events a live lane mean "
          f"{float(ev.mean())!r}, longest {int(ev.max())}", flush=True)


def ng_reading(cs, tk, dev, label, inputs, res, paths, mix, repeats) -> dict:
    """The reading of a non-gray route (NG_ROUTES) on a census's ``inputs``: the
    kernel alone (with its slots spread over the launch's blocks and without), the
    event loop's line (its common path a scatter in the cell),
    how its lanes spread over blocks of 256 slots, the events of a live lane, and
    the opacity's SASS: the event loop as built (``paths["full"]``) less the loop
    with EPBremss returning at once, which a lane runs when it gathers its cell
    anew (the share of warp-events that do, from the path mix). The issue time is
    the whole loop's instructions a warp-event at the card's issue rate, an upper
    bound of what the warps issue; its share of the kernel alone says whether the
    kernel is issue-bound."""
    import torch

    p, args = inputs
    prm, smr = args[3], args[1].max_level > 0
    events = int(tk.transport(p.clone(), *args)[2])
    if mix["lane_events"] != events:
        raise AssertionError(f"{label} path mix: {mix['lane_events']} lane-events, census "
                             f"{events}")
    k_ms = statistics.median(kernel_alone(cs, tk, dev, p, args, repeats))
    blocks = tk.resident_blocks(prm.ndim, True, False, smr, True, dtype=p.x.dtype)
    spreads = tk.spreads(p.capacity, torch.cuda.get_device_properties(dev).multi_processor_count,
                         blocks)
    other = statistics.median(kernel_alone(cs, tk, dev, p, args, repeats, not spreads))
    print(f"{label}: the kernel alone (CUDA events around its launch) {k_ms!r} ms, its slots "
          f"{'spread' if spreads else 'in order'}; {other!r} ms "
          f"{'in order' if spreads else 'spread'}", flush=True)
    lanes = cs.event_loop_line(tk, dev, label, inputs, k_ms, events, res, paths["scatter"])
    cs.block_spread_line(label, lanes, p, blocks, dev)
    history_line(label, lanes, p)
    we = mix["warp_events"]
    opacity = paths["full"] - paths["no_opacity"]
    clock = cs.smi_value("clocks.sm")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = sms * (cs.ISSUE_PER_SM_CLOCK // 32) * clock * 1e6
    issue_ms = paths["full"] * we / rate * 1e3
    print(f"{label}: {we} warp-events for {mix['lane_events']} lane-events (SIMT efficiency "
          f"{mix['lane_events'] / (32 * we)!r}); share with a lane that gathers its cell anew "
          f"{mix['regather'] / we!r}, crossed {mix['cross'] / we!r}, scattered "
          f"{mix['scatter'] / we!r}, reached census {mix['census'] / we!r}; loop paths (SASS) "
          f"scatter {paths['scatter']}, full {paths['full']}, full without the opacity "
          f"{paths['no_opacity']}: the opacity {opacity} instructions a gather; the whole loop "
          f"a warp-event at the issue rate {issue_ms!r} ms, {issue_ms / k_ms!r} of the kernel "
          f"alone; lane-events a SM (%smid): max/mean "
          f"{max(mix['by_sm']) * sms / sum(mix['by_sm'])!r}", flush=True)
    return {**mix, "kernel_ms": k_ms, "kernel_ms_other_spread": other, "spreads": spreads,
            "issue_ms": issue_ms, "warp_issue_share": issue_ms / k_ms,
            "opacity_instructions": opacity, "slot_order_warp_efficiency":
            tk.warp_efficiency(lanes)}


def ddmc_reading(cs, tk, dev, label, name, inputs, res, paths, mix, repeats, n=1) -> dict:
    """The reading of the DDMC route ``name`` (``chip_smoke.DDMC_ROUTES``, K4S_READ)
    on a census's ``inputs`` ((ledger, args), of ``n`` shards' slices), its lines
    headed ``label``: the kernel alone (``kernel_alone``), the event loop's line (``chip_smoke.event_loop_line``,
    registers and stack from ``res``, its common path the DDMC loop's dd_step), how
    the live lanes and the events spread over blocks of 256 slots
    (``chip_smoke.block_spread_line``), the DDMC warp path mix ``mix`` with the
    issue figures (``ddmc_mix_line``, the loop paths ``paths``) and, on a refined
    forest, the events of a live lane by the level of its block. Returns the mix
    with the kernel alone's ms, the slot-order warp efficiency and the issue
    figures."""
    p, args = inputs
    prm, mesh = args[3], args[1]
    census = cs.sliced(tk.transport, n) if n > 1 else tk.transport
    events = int(census(p.clone(), *args)[2])
    k_ms = statistics.median(kernel_alone(cs, tk, dev, p, args, repeats, n=n))
    print(f"{label}: the kernel alone (CUDA events around its launch) {k_ms!r} ms", flush=True)
    lanes = cs.event_loop_line(tk, dev, label, inputs, k_ms, events, res, paths["dd_step"],
                               n=n)
    blocks = tk.resident_blocks(prm.ndim, bool(prm.has_absorption), True, mesh.max_level > 0,
                                dtype=p.x.dtype)
    cs.block_spread_line(label, lanes, p, blocks, dev)
    history_line(label, lanes, p)
    out = ddmc_mix_line(cs, label, mix, paths, k_ms, events, dev)
    if mesh.max_level > 0:
        live = p.alive & (p.tau < 1.0)
        lvl = mesh.block_level.to(p.x.device)[p.block.long()]
        per = {int(lv): (int((live & (lvl == lv)).sum()),
                         float(lanes[live & (lvl == lv)].double().mean()))
               for lv in sorted(set(mesh.block_level.tolist()))}
        print(f"{label}: events a live lane by the level of its block at the census's start "
              f"(lanes, mean events): {per}; longest {int(lanes.max())}", flush=True)
    return {**out, "kernel_ms": k_ms, "slot_order_warp_efficiency": tk.warp_efficiency(lanes)}


def f64_reading(cs, tk, dev, label, inputs, n, res, paths, mix, repeats, cost64) -> dict:
    """The reading of a float64 IMC route (F64_READ) on a census's ``inputs``
    ((ledger, args), of ``n`` shards' slices): the kernel alone, the event loop's
    line (registers, stack and spills from ``res``, resident blocks, the common
    path from ``paths``, the slot order's warp efficiency, the issue share), the
    share of the common path that the double log and the divides (one an active
    axis) take, from the float64 probes' SASS (``cost64``, ``chip_smoke.probe_costs``),
    the warp path mix with the instructions a warp-event modelled from ``paths``
    (``chip_smoke.path_mix_line``: a lane that reaches a block face is re-homed by
    the lookup, or meets a wall) and its issue share of the kernel alone."""
    p, args = inputs
    census = cs.sliced(tk.transport, n) if n > 1 else tk.transport
    events = int(census(p.clone(), *args)[2])
    k_ms = statistics.median(kernel_alone(cs, tk, dev, p, args, repeats, n=n))
    print(f"{label}: the kernel alone (CUDA events around its launch) {k_ms!r} ms", flush=True)
    cs.event_loop_line(tk, dev, label, inputs, k_ms, events, res, paths["scatter"], n=n)
    ndim, common = args[3].ndim, paths["scatter"]
    log, div = cost64["logf"], ndim * cost64["div"]
    print(f"{label}: of the common path's {common} SASS instructions the double log takes "
          f"{log} ({log / common!r}) and the {ndim} divide(s) {div} ({div / common!r}); the two "
          f"hash words of each of the event's two draws {4 * cost64['hash']} (the double draw's "
          f"probe, four words)", flush=True)
    return {**cs.path_mix_line(label, mix, paths, k_ms, events, dev), "kernel_ms": k_ms,
            "log_share": log / common, "divide_share": div / common}


def mix_child(inputs, pkg, repeats, out) -> None:
    """The warp path mix (``chip_smoke.path_mix``) of the package under ``pkg`` on
    the saved inputs of MIX_ROUTES: its kernel's counting variant, built from its
    own sources, run through its own launch; on the DDMC routes the DDMC reading
    (``ddmc_reading``), with the DDMC event's loop paths (``chip_smoke.loop_paths``)
    compiled from the same sources meanwhile."""
    sys.path.insert(0, pkg)
    import concurrent.futures

    import torch

    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    dev = torch.device("cuda", 0)
    cs = this_chip_smoke()
    routes = torch.load(inputs, weights_only=False)
    res = cs.kernel_resources(cuda_lib.library().build_log, tk)
    cost64 = cs.probe_costs(cs.sass_counts(cs.sass_listing(cuda_lib.library().path)), f64=True)
    mixed = [name for name in MIX_ROUTES if name in routes]
    f64_imc = [name for name in F64_READ if name not in cs.DDMC_ROUTES]
    csrc = str(cuda_lib.SRC_DIR)

    def reading(pool, names, paths):  # the loop paths of the mixed routes among names
        names = [name.split("@")[0] for name in names if name in mixed]
        return pool.submit(cs.loop_paths, csrc, names, tk, paths) if names else None

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = (reading(pool, cs.DDMC_ROUTES + K4S_READ, DD_PATHS),
                  reading(pool, NG_ROUTES, NG_PATHS),
                  reading(pool, f64_imc, ("scatter", "cross", "no_wall", "full")))
        lib = cs.path_mix_library(cuda_lib.SRC_DIR, cuda_lib.BUILD_DIR / "path_mix")
        dd, ng, f64_paths = (b.result() if b else None for b in builds)
    label = os.path.basename(pkg.rstrip("/")) or pkg
    result = {}
    for name in mixed:
        p0, n, args = routes[name]
        mix = cs.path_mix(tk, lib, (p0, args), n)
        if name in cs.DDMC_ROUTES or name in K4S_READ:
            base = name.split("@")[0]
            mix = ddmc_reading(cs, tk, dev, f"{label}: {name}", name, (p0, args),
                               res.get(base, {}), {k: dd[k][base] for k in DD_PATHS}, mix,
                               repeats, n)
        elif name in F64_READ:
            base = name.split("@")[0]
            mix = f64_reading(cs, tk, dev, f"{label}: {name}", (p0, args), n,
                              res.get(base, {}), {k: v[base] for k, v in f64_paths.items()},
                              mix, repeats, cost64)
        elif name in NG_ROUTES:
            mix = ng_reading(cs, tk, dev, f"{label}: {name}", (p0, args), res.get(name, {}),
                             {k: ng[k][name] for k in NG_PATHS}, mix, repeats)
        by_sm = mix.pop("by_sm")
        result[name] = {**mix, "sms_with_lanes": len(by_sm),
                        "sm_max_over_mean": max(by_sm) * torch.cuda.get_device_properties(
                            0).multi_processor_count / sum(by_sm)}
    with open(out, "w") as f:
        json.dump(result, f)


def child(inputs, pkg, repeats, out) -> None:
    """Step 2 in one process: the census kernel of the package under ``pkg`` timed
    on every saved route."""
    sys.path.insert(0, pkg)
    import torch

    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.ops import transport_kernel as tk
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    dev = torch.device("cuda", 0)
    lib = cuda_lib.library()
    cs = this_chip_smoke()
    routes = torch.load(inputs, weights_only=False)
    result = {"pkg": pkg, "build_seconds": lib.build_seconds, "build_log": lib.build_log,
              "routes": {}}
    for name, (p0, n, args) in routes.items():
        def census(p):
            return tk.transport(p if n == 1 else split_ledger(p, n), *args)[2]

        census(p0.clone())  # warm-up
        times, parts = [], []
        for _ in range(repeats):
            p = p0.clone()
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)  # ~25 ms at 1980 MHz
            start.record()
            events = census(p)
            stop.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(stop))
        with cs.CallSplit(tk, lib) as win:
            for _ in range(repeats):
                q = p0.clone()
                torch.cuda.synchronize(dev)
                torch.cuda._sleep(50_000_000)
                census(q)
                parts.append(win.ms())
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
                                "nounits"], capture_output=True, text=True, check=True).stdout
        live = int((p0.alive & (p0.tau < 1.0)).sum())
        split = {k: sorted(d[k] for d in parts) for k in parts[0]}
        result["routes"][name] = {"times": sorted(times), **split,
                                  "events": int(events.sum()),
                                  "digest": digest(p), "slots": p0.capacity, "live": live,
                                  "sm_clock_mhz": float(clock.split()[0]),
                                  "blocks": cs.census_blocks(tk, p0, args)}
        print(f"  {os.path.basename(pkg.rstrip('/')) or pkg}: {name} median "
              f"{statistics.median(times)!r} ms", flush=True)
    with open(out, "w") as f:
        json.dump(result, f)


def trace_ops(path, steps) -> dict:
    """The device operations a step in a ``profile.py --trace`` Chrome trace of
    ``steps`` steps: kernels, copies and memsets, and the count kernel's launches
    (``csrc/count_kernel.cu``, ``round_counts``)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    kinds = {"kernels": "kernel", "copies": "gpu_memcpy", "memsets": "gpu_memset"}
    out = {k: sum(e.get("cat") == c for e in events) / steps for k, c in kinds.items()}
    out["round_counts"] = sum(e.get("cat") == "kernel" and "round_counts_kernel" in e["name"]
                              for e in events) / steps
    return out


def profile(tree, deck, extra=(), ops=False) -> dict:
    """Step 3 for one tree and deck: the census kernel's device ms a step, its
    launches a step (under the spatial decomposition one a round queued, so that
    the census ms over them is the mean round's), the device total a step and the
    unprofiled steps' wall median, from ``python -m jaybenne_tpu_torch.profile``
    (with ``extra`` arguments: ``--eager``, ``--rounds-per-batch R``); and the
    lines of its spans under ``spatial.round`` (``spans``). With ``ops`` also the
    device operations a step of its trace (``trace_ops``) and the rounds queued a
    step (``rounds_queued``: the census launches a step on a spatial deck)."""
    path, mods = PROFILE_DECKS[deck]
    tmp = tempfile.TemporaryDirectory()
    trace = ("--trace", os.path.join(tmp.name, "trace.json")) if ops else ()
    args = [*PROFILE_ARGS, *extra]  # a later --steps in ``extra`` overrides
    res = subprocess.run([sys.executable, "-m", "jaybenne_tpu_torch.profile", "-i",
                          os.path.join(ROOT, path), *args, *trace, *mods],
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"profile {deck} in {tree}:\n{res.stderr[-3000:]}")
    kernel = sum(float(m.group(1)) for m in re.finditer(
        r"device_ms_per_step (\S+) .*transport_kernel", res.stdout))
    m = re.search(r"device total (\S+) ms per step; unprofiled step wall median (\S+) ms",
                  res.stdout)
    launches = ast.literal_eval(re.search(r"launches in the profiled steps: (\{.*\})",
                                          res.stdout).group(1))
    steps = int(args[len(args) - 1 - args[::-1].index("--steps") + 1])
    census = sum(v for k, v in launches.items() if k.startswith("transport_")) / steps
    spans = [line for line in res.stdout.splitlines() if line.startswith("span ")]
    out = {"census_ms_per_step": kernel, "census_launches_per_step": census,
           "device_ms_per_step": float(m.group(1)), "step_wall_ms": float(m.group(2)),
           "spans": [line for line in spans if line.startswith("span spatial.round")],
           "all_spans": spans,
           "device_lines": [line for line in res.stdout.splitlines()
                            if line.startswith("device_ms_per_step ")]}
    if ops:
        out["ops_per_step"] = trace_ops(trace[1], steps)
    tmp.cleanup()
    return out


# ``--only migrate``: the spatial migration read apart on the recorded first round
# of these decks of PROFILE_DECKS (``chip_smoke.migration_reading``, this tree) and
# on a rank's round made from big_mesh_spatial's (MIGRATE_RANK), the trees'
# migration kernels on those rounds in the turns (``migrate_child``), then their
# steps by profile.py in the turns, as CUDA graphs and eagerly (its spans), and
# this tree's at MIGRATE_BATCH rounds a batch beside ROUNDS_PER_BATCH's
MIGRATE, MIGRATE_KERNEL = "migrate", "migrate_kernel"  # the latter: no profile.py turns
MIGRATE_DECKS = {"big_mesh_spatial_8": ("DECK", "BIG_SPATIAL_8"),
                 "stepdiff_spatial_f64": ("DECK", "STEPDIFF_SPATIAL_F64")}
MIGRATE_BATCH = 8
# one rank of a multi-GPU spatial run (one local shard of n): the middle local
# shard's slice of this deck's first round, this many times over, K as many
# times (the step's own K, a slice over 2 n); its slice has ten thousand tiles,
# where a kernel whose blocks sum their slice's tile counts grows with the square
# of the tiles
MIGRATE_RANK = ("big_mesh_spatial_8", 128)


def rank_ledger(p, m, times):
    """The middle of the ``m`` slices of the ledger ``p``, ``times`` over."""
    from jaybenne_tpu_torch.parallel import sharding
    from jaybenne_tpu_torch.particles import ParticleLedger

    one = sharding.split_ledger(p, m)[m // 2]
    return ParticleLedger(**{f.name: getattr(one, f.name).repeat(times)
                             for f in dataclasses.fields(one)})


def rank_round(c, times):
    """A ``chip_smoke.RecordedMigration`` of one rank: the middle local shard's
    slice of the recorded round ``c``, ``times`` over (``rank_ledger``), with
    ``times`` K."""
    import chip_smoke as cs

    m = len(c.offsets)
    return cs.RecordedMigration(rank_ledger(c.ledger, m, times), [c.offsets[m // 2]], c.bl,
                                c.K * times, c.n, c.go)


def rank_bitwise(c, what) -> str:
    """The kernel's pack bitwise its plain version's on a rank's round ``c`` (its
    ledger after it, its sent count, its flags and every row they mark), and
    again with go false (nothing sent); a rank alone has no in-process round.
    Returns what was held, as text."""
    import torch

    import chip_smoke as cs

    for go in (cs.RECORDED, torch.zeros((), dtype=torch.bool, device=c.ledger.alive.device)):
        q, r = c.ledger.clone(), c.ledger.clone()
        buf, flags, sent = cs.pack_of(c, q, go=go)
        want, valid, plain_sent = cs.pack_of(c, r, plain=True, go=go)
        if (not torch.equal(sent, plain_sent) or not torch.equal(flags, valid)
                or not torch.equal(buf[valid], want[valid])):
            raise AssertionError(f"migration on {what}: the buffers, flags or sent counts "
                                 f"differ ({sent.tolist()} vs {plain_sent.tolist()})")
        cs.equal_ledgers(q, r, f"migration pack on {what} against the plain version")
        if go is cs.RECORDED:
            line = (f"{what}: 1 shard of {c.n}, {c.ledger.capacity} slots, K {c.K}, "
                    f"{int(sent.sum())} sent")
        elif int(sent.sum()) or int(valid.sum()):
            raise AssertionError(f"migration on {what}: a round with go false sent")
    return line + "; with go false nothing sent or changed"


def migrate_reading() -> tuple:
    """``--only migrate``'s reading of the recorded rounds, in this process with this
    tree's package: the kernel bitwise its plain version (go false too), and its
    pack and round against the plain migrate (``spatial.migrate(plain=True)``), a
    round with go false, the kept clones and the unfinished sums; on the rank's
    round (MIGRATE_RANK) the pack bitwise its plain version (go false too) and its
    bounds. Returns the readings and the rounds as plain tensors
    (``migrate_child``'s input; ``rank``: the pack alone)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jaybenne_tpu_torch import driver

    dev = torch.device("cuda", 0)
    decks = {"BIG_SPATIAL_8": {**cs.BIG_MESH, **cs.SPATIAL, "jaybenne/n_devices": 8},
             "STEPDIFF_SPATIAL_F64": {**cs.STEPDIFF_SPATIAL, **cs.PREC64}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out, rounds = {}, {}

    def saved(c, bound_ms):
        return {"cols": {f.name: getattr(c.ledger, f.name).cpu()
                         for f in dataclasses.fields(c.ledger)},
                "offsets": c.offsets, "bl": c.bl, "K": c.K, "n": c.n,
                "go": None if c.go is None else bool(c.go), "bound_ms": bound_ms}

    with tempfile.TemporaryDirectory() as outdir:
        for deck, (path, mods) in MIGRATE_DECKS.items():
            calls = cs.recorded_migrations(
                lambda: driver.run_file(getattr(cs, path), outdir=outdir,
                                        modified_inputs=decks[mods], quiet=True, nlim=1,
                                        device="cuda", graph=False), 1)
            print("migration kernel bitwise its plain version, "
                  + cs.migrations_bitwise(calls, deck), flush=True)
            out[deck] = cs.migration_reading(dev, calls[0], f"{deck}, its first round", smi)
            rounds[deck] = saved(calls[0], out[deck]["bound_ms"])
            if deck == MIGRATE_RANK[0]:
                rc = rank_round(calls[0], MIGRATE_RANK[1])
                rank = f"a rank of {deck} x{MIGRATE_RANK[1]}"
                print("migration kernel bitwise its plain version, " + rank_bitwise(rc, rank),
                      flush=True)
                sent = int(cs.pack_of(rc, rc.ledger.clone())[-1].sum())
                out[rank] = {"bound_ms": cs.migration_bound(rc, sent),
                             "sector_bound_ms": cs.migration_sector_bound(rc, sent),
                             "sent": sent, "slots": rc.ledger.capacity, "K": rc.K}
                print(f"migration on {rank}: {sent} sent of {rc.ledger.capacity} slots; bound "
                      f"{out[rank]['bound_ms']!r} ms in bytes, "
                      f"{out[rank]['sector_bound_ms']!r} in sectors; {smi}", flush=True)
                # the rank's round made again in each child from its deck's
                rounds[rank] = {"rank_of": deck, "times": MIGRATE_RANK[1],
                                "offsets": rc.offsets, "bl": rc.bl, "K": rc.K, "n": rc.n,
                                "go": None if rc.go is None else bool(rc.go),
                                "bound_ms": out[rank]["bound_ms"]}
                del rc
            del calls
            torch.cuda.empty_cache()
    return out, rounds


def migrate_child(inputs, pkg, repeats, out) -> None:
    """``--only migrate``'s turn in one process, for the package under ``pkg``: on
    each saved round (``migrate_reading``) the migration kernel's pack (the median
    window of ``repeats`` between CUDA events after a device sleep; device ms by
    launch from torch.profiler, with the launches the trace holds), and, on every
    round but a rank's, the whole round through the in-process exchange and the
    insert (window, device ms and device ms by kernel) and the round with go false
    (window, device ms); the sent counts and a digest of the ledger after the
    round (a rank's: after the pack), which every tree must share."""
    import inspect

    sys.path.insert(0, pkg)
    import torch

    from jaybenne_tpu_torch.parallel import exchange, sharding, spatial
    from jaybenne_tpu_torch.particles import ParticleLedger

    dev = torch.device("cuda", 0)
    cs = this_chip_smoke()
    takes_work = "work" in inspect.signature(spatial.migrate).parameters
    result = {}
    saved = torch.load(inputs, weights_only=False)
    for deck, r in saved.items():
        rank = "rank_of" in r
        if rank:
            base = saved[r["rank_of"]]
            led = rank_ledger(ParticleLedger(**{k: v.to(dev) for k, v in base["cols"].items()}),
                              len(base["offsets"]), r["times"])
        else:
            led = ParticleLedger(**{k: v.to(dev) for k, v in r["cols"].items()})
        m, n, K, bl, offsets = len(r["offsets"]), r["n"], r["K"], r["bl"], r["offsets"]
        go = None if r["go"] is None else torch.tensor(r["go"], device=dev)
        falsy = torch.zeros((), dtype=torch.bool, device=dev)
        kw = {"work": spatial.MigrateScratch().reserve(m, led.capacity // m, n, dev)
              } if takes_work else {}

        def pack(x, go=go):
            return spatial._pack_cuda(sharding.split_ledger(x, m), offsets, bl, K, n, go,
                                      **kw)[-1]

        def rnd(x, go=go):
            return spatial.migrate(sharding.split_ledger(x, m), offsets, bl, K,
                                   exchange.InProcess(n), go, **kw)

        def by_launch(fn):
            ops = cs.traced_launches(fn, led.clone, repeats)
            kinds = {}
            for name, us in ops:
                if "migrate" in name:
                    short = name.replace("(anonymous namespace)", "").replace("void ", "")
                    short = short.split("<")[0].split("(")[0].split("::")[-1].strip()
                    kinds.setdefault(short, []).append(us / 1e3)
            return {k: [sum(v) / len(v), len(v)] for k, v in kinds.items()}

        q = led.clone()
        sent = pack(q)
        row = {"sent": sent.tolist(), "bound_ms": r["bound_ms"],
               "pack_ms": cs.timed_ms(pack, dev, led.clone, repeats),
               "pack_device_ms": by_launch(pack)}
        if not rank:
            q = led.clone()
            drop, rsent = rnd(q)
            row.update(round_sent=rsent.tolist(), dropped=drop.tolist(),
                       round_ms=cs.timed_ms(rnd, dev, led.clone, repeats),
                       round_device_ms=cs.device_ms(rnd, led.clone, repeats),
                       round_by_kernel=cs.work_by_kernel(rnd, led.clone, repeats=repeats),
                       go_false_ms=cs.timed_ms(lambda x: rnd(x, falsy), dev, led.clone,
                                               repeats),
                       go_false_device_ms=cs.device_ms(lambda x: rnd(x, falsy), led.clone,
                                                       repeats))
        row["digest"] = digest(q)
        result[deck] = row
        print(f"  {os.path.basename(pkg.rstrip('/')) or pkg}: {deck} pack {row['pack_ms']!r} "
              f"ms, round {row.get('round_ms')!r} ms", flush=True)
        del led, q
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(result, f)


def migrate_turns(order, label, rounds, repeats) -> list:
    """``--only migrate``'s kernel turns: each tree of ``order`` in a child
    (``migrate_child``) on the saved ``rounds``; raises unless every tree's sent
    and dropped counts and ledger digests agree. Prints a line a tree and deck,
    and returns the children's readings."""
    import torch

    kids = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "rounds.pt")
        torch.save(rounds, inputs)
        for k, tree in enumerate(order):
            out = os.path.join(tmp, f"migrate{k}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--repeats", str(repeats),
                            "--migrate-child", inputs, tree, out], check=True, timeout=1800)
            with open(out) as f:
                kids.append({"tree": label[tree], "decks": json.load(f)})
    for deck in rounds:
        seen = {json.dumps([kid["decks"][deck].get(k) for k in ("sent", "round_sent", "dropped",
                                                                 "digest")]) for kid in kids}
        if len(seen) != 1:
            raise AssertionError(f"migration on {deck}: the trees' outputs differ: {seen}")
        for k, kid in enumerate(kids):
            r = kid["decks"][deck]
            more = (f"; the round (pack, insert) {r['round_ms']!r} ms, {r['round_device_ms']!r} "
                    f"on the device, by kernel {r['round_by_kernel']}; with go false "
                    f"{r['go_false_ms']!r} ms, {r['go_false_device_ms']!r} on the device"
                    if "round_ms" in r else "")
            print(f"migration turn {k}: {kid['tree']}, {deck}: the pack {r['pack_ms']!r} ms "
                  f"(window), by launch {r['pack_device_ms']} (ms, launches traced), bound "
                  f"{r['bound_ms']!r}{more}; {r['sent']} sent", flush=True)
    return kids


# ``--only counts_apart``: the count kernel (csrc/count_kernel.cu, round_counts)
# read apart on big_mesh_spatial's first round at 8 shards and the 64^3 DDMC step:
# the kernel, an empty kernel of its grid, and its slot pass alone (the kernel cut
# before its ticket: the loads, the warp sums and the shard sums' atomics), so
# that the last block's ticket and epilogue are the kernel less its slot pass
COUNTS_APART = "counts_apart"
COUNTS_CUT = ("    __threadfence();  // the sums land before the ticket\n"
              "    s_last = atomicAdd(scratch + 2 * m, 1ULL) == gridDim.x - 1;\n",
              "    s_last = false;\n")


def counts_apart(repeats) -> dict:
    """``--only counts_apart`` in this process with this tree's package: on each
    recorded call, the count kernel's device ms (torch.profiler, the launches the
    trace holds) and window between CUDA events after a device sleep, the same of
    an empty kernel of its grid (``jb_empty_launch``) and of its slot pass alone
    (COUNTS_CUT built by nvcc in its C entry's place, with a scratch of its own)."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jaybenne_tpu_torch import driver
    from jaybenne_tpu_torch.ops import counts, cuda_lib

    dev = torch.device("cuda", 0)
    lib = cuda_lib.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    paths = {what: (deck, mods) for what, deck, mods, _ in cs.COUNT_PATHS}
    picks = (("big_mesh_spatial at 8 shards (transport_3d@z)", "its first round", 0),
             ("the 64^3 DDMC row", "its step", -1))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(cuda_lib.SRC_DIR / "count_kernel.cu") as f:
            text = f.read()
        if text.count(COUNTS_CUT[0]) != 1:
            raise RuntimeError("count kernel: the slot pass's cut is not in its source")
        src, so = os.path.join(tmp, "count_cut.cu"), os.path.join(tmp, "libcount_cut.so")
        with open(src, "w") as f:
            f.write(text.replace(*COUNTS_CUT))
        flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([cuda_lib.nvcc(), *flags, "-shared", "-o", so, src], check=True,
                       capture_output=True, timeout=600)
        cut = ctypes.CDLL(so).jb_counts_launch
        cut.argtypes = list(cuda_lib._SIGNATURES["jb_counts_launch"])
        cut.restype = ctypes.c_int
        for what, which, k in picks:
            deck, mods = paths[what]
            c = cs.recorded_counts(lambda: driver.run_file(
                deck, outdir=tmp, modified_inputs=mods, quiet=True, nlim=1, device="cuda",
                graph=False))[k]
            cap_l = c.ledger.capacity // c.m
            blocks = c.m * max(1, -(-cap_l // 2048))  # count_kernel.cu's kTile
            work, cut_work = counts.scratch(c.m, dev), counts.scratch(c.m, dev)
            acc = None if c.acc is None else cs.recorded_acc(c)

            def full(_):
                cs.replay_counts(c, work=work, acc=acc)

            def empty(_):
                lib.call("jb_empty_launch", blocks, 1, 256, cuda_lib.stream_handle(dev))

            def slot_pass(_):
                real = lib.call
                lib.call = lambda name, *a: (lib_check(name, cut(*a))
                                             if name == "jb_counts_launch" else real(name, *a))
                try:
                    cs.replay_counts(c, work=cut_work, acc=acc)
                finally:
                    del lib.call

            row = {"blocks": blocks, "slots": c.ledger.capacity}
            for part, fn, name in (("kernel", full, "round_counts_kernel"),
                                   ("empty", empty, "empty_kernel"),
                                   ("slot_pass", slot_pass, "round_counts_kernel")):
                us = [d for kname, d in cs.traced_launches(fn, lambda: None, repeats)
                      if name in kname]
                row[part] = {"ms": cs.timed_ms(fn, dev, repeats=repeats),
                             "device_ms": sum(us) / 1e3 / max(len(us), 1), "traced": len(us)}
            row["ticket_and_epilogue_device_ms"] = (row["kernel"]["device_ms"]
                                                    - row["slot_pass"]["device_ms"])
            out[f"{what}, {which}"] = row
            print(f"count kernel read apart on {what}, {which} ({smi}; {c.m} shard(s), "
                  f"{c.ledger.capacity} slots, {blocks} blocks of 256): the kernel "
                  f"{row['kernel']}, "
                  f"an empty kernel of its grid {row['empty']}, its slot pass alone "
                  f"{row['slot_pass']} (ms: window; device, launches traced); the ticket and "
                  f"epilogue {row['ticket_and_epilogue_device_ms']!r} ms on the device",
                  flush=True)
            torch.cuda.empty_cache()
    return out


# ``--only tally`` and ``--only faces``: the tally kernel and the DDMC face kernel
# read apart on the paths' recorded calls (chip_smoke.py phase 46's
# ``tally_faces_readings``, this tree), then the steps they change by profile.py in
# the turns, as CUDA graphs, and eagerly once for the parent and this tree (the
# 64^3 DDMC row's spans, ``step.face_probs`` among them)
TALLY_FACES = ("tally", "faces")
TALLY_FACES_DECKS = ("big_mesh_ddmc", "feedback_64", "stepdiff")


def tally_faces_reading(which) -> dict:
    """``--only tally`` / ``--only faces``: each kernel bitwise its plain version on
    every path's recorded calls and read apart, in this process with this tree's
    package (``chip_smoke.tally_faces_readings``)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    readings = cs.tally_faces_readings(torch.device("cuda", 0), smi, which)
    return {f"{kind}: {what}": r for (kind, what), r in readings.items()}


# ``--only round``: the spatial round's gate and counts read apart (chip_smoke.py
# phase 47's ``counts_phase``, this tree), then the steps it changes by profile.py
# in the turns, as CUDA graphs (the device operations a step from each trace), and
# this tree at each of ROUND_BATCHES rounds a batch in turns on the spatial decks
# (ROUNDS_PER_BATCH's choice)
ROUND = "round"
ROUND_DECKS = ("big_mesh_spatial_8", "stepdiff_spatial_f64", "big_mesh_ddmc")
ROUND_BATCHES = (4, 8)
ROUND_STEPS = ("--steps", "7")  # steps timed a profile (the decks end after 10)


def round_reading() -> dict:
    """``--only round``'s reading, in this process with this tree's package
    (``chip_smoke.counts_phase``): the census gate on every spatial route's
    recorded rounds, the count kernel bitwise its plain version on every path and
    read apart. Returns its ``kernels`` entry."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return cs.counts_phase(torch.device("cuda", 0), smi)


def round_turns(order, label, turns) -> list:
    """``--only round``'s profiles: each tree of ``order`` on ROUND_DECKS, then this
    tree at ROUND_BATCHES rounds a batch (the first, the rest, the rest reversed,
    the first, ``turns`` times) on the spatial ones; printed as they come."""
    runs = [(tree, ROUND_STEPS, label[tree], ROUND_DECKS) for tree in order]
    spatial = [d for d in ROUND_DECKS if "spatial" in d]
    batches = list(ROUND_BATCHES) + list(ROUND_BATCHES)[::-1]
    runs += [(ROOT, ROUND_STEPS + ("--rounds-per-batch", str(r)),
              f"this tree at {r} rounds a batch", spatial) for r in batches] * turns
    rows = []
    for k, (tree, extra, who, decks) in enumerate(runs):
        for deck in decks:
            row = profile(tree, deck, extra, ops=True)
            ops = row["ops_per_step"]
            rounds = row["census_launches_per_step"] if "spatial" in deck else 0
            per_round = (f"; a round queued {ops['kernels'] / rounds!r} kernels, "
                         f"{ops['copies'] / rounds!r} copies, {ops['memsets'] / rounds!r} "
                         f"memsets, {ops['round_counts'] / rounds!r} round_counts launches"
                         if rounds else "")
            print(f"profile {k}: {deck} {who}: device total {row['device_ms_per_step']!r} ms a "
                  f"step, step wall median {row['step_wall_ms']!r} ms, census "
                  f"{row['census_ms_per_step']!r} ms in {rounds or 'its'} launches; device "
                  f"operations a step {ops}{per_round}", flush=True)
            rows.append({"tree": who, "deck": deck, **row})
    return rows


# ``--only steps``: the particle decomposition's step on chip_smoke.py phase 32's
# rows and the spatial steps (the host between their batches) by profile.py in the
# turns, as the trees run them on the card
STEPS = "steps"
PARTICLE_DECKS = ("stepdiff_smr_8p", "stepdiff_smr_ddmc_8p", "hybrid_8p", "stepdiff_smr2_8p")
HOST_DECKS = ("big_mesh_spatial_8", "stepdiff_spatial_f64")


def steps_turns(order, label) -> list:
    """``--only steps``' profiles, printed as they come: each tree of ``order`` on
    PARTICLE_DECKS and HOST_DECKS, with the device ms a step of the hand-written kernels
    (``chip_smoke.HAND_KERNELS``) and of the rest, and the host ms a step of the
    spatial spans (``chip_smoke.HOST_SPANS``; a parent without a span reads 0)."""
    import chip_smoke as cs

    rows = []
    for k, tree in enumerate(order):
        who = label[tree]
        for deck in PARTICLE_DECKS + HOST_DECKS:
            row = profile(tree, deck)
            n = int(PROFILE_ARGS[PROFILE_ARGS.index("--steps") + 1])
            by = {}
            for line in row.pop("device_lines"):
                ms, name = line.split(" ", 2)[1:]
                by[name] = by.get(name, 0.0) + float(ms)
            hand = sum(v for name, v in by.items() if cs.HAND_KERNELS.search(name))
            spans = {}
            for line in row["all_spans"]:
                m = re.match(r"span (\S+): host_ms_per_step (\S+) .*count_per_step (\S+)", line)
                if m:
                    spans[m.group(1)] = (float(m.group(2)), float(m.group(3)))
            gap = row["step_wall_ms"] - row["device_ms_per_step"]
            print(f"profile {k}: {deck} {who}: device total "
                  f"{row['device_ms_per_step']!r} ms a step (hand-written kernels "
                  f"{hand!r}, the rest {row['device_ms_per_step'] - hand!r}; census "
                  f"{row['census_ms_per_step']!r} in {row['census_launches_per_step']!r} "
                  f"launches), step wall median {row['step_wall_ms']!r} ms, wall less "
                  f"device {gap!r}; host spans a step (ms, count): "
                  + ", ".join(f"{s} {spans.get(s, (0.0, 0.0))}" for s in cs.HOST_SPANS),
                  flush=True)
            rows.append({"tree": who, "deck": deck, "steps": n, "hand_ms": hand,
                         "spans": spans, **row})
    return rows


def issue_share(kids, tree, name, summary, sms) -> float:
    """The issue share of ``tree``'s census ``name``: its event loop's common-path
    SASS instructions times the census's events over the median of its turns'
    medians times the SMs, the instructions a SM issues a clock and the median SM
    clock read after each turn."""
    import chip_smoke as cs

    runs = [kid["routes"][name] for kid in kids if kid["tree"] == tree]
    ms = statistics.median(statistics.median(r["times"]) for r in runs)
    mhz = statistics.median(r["sm_clock_mhz"] for r in runs)
    ops = summary["common_path"][tree][name] * runs[0]["events"]
    return ops / (ms * 1e-3 * sms * cs.ISSUE_PER_SM_CLOCK * mhz * 1e6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--variant", action="append", default=[], help="one more tree's root")
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--turns", type=int, default=1, help="rounds of the turns")
    ap.add_argument("--profile", nargs="*", metavar="DECK",
                    help=f"profile.py's reading of these decks, every deck if none is "
                    f"named: {', '.join(PROFILE_DECKS)}")
    ap.add_argument("--only", action="append", metavar="ROUTE",
                    help="time this route (with its lane sweep) alone; may repeat; "
                    f"{TABLE}: the census table read apart on TABLE_PATHS; {MIGRATE}: the "
                    "spatial migration read apart on MIGRATE_DECKS; tally, faces: the tally "
                    f"kernel, the DDMC face kernel read apart on chip_smoke.py's paths; {ROUND}: "
                    "the round's gate and count kernel, ROUND_DECKS in turns, ROUND_BATCHES; "
                    f"{COUNTS_APART}: the count kernel read apart (empty grid, slot pass); "
                    f"{MIGRATE_KERNEL}: {MIGRATE}'s readings without its profile.py turns")
    ap.add_argument("--out", help="also write every number here, as JSON")
    ap.add_argument("--child", nargs=3, metavar=("INPUTS", "PKG", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--mix-child", nargs=3, metavar=("INPUTS", "PKG", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--table-child", nargs=3, metavar=("INPUTS", "PKG", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--migrate-child", nargs=3, metavar=("INPUTS", "PKG", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child[0], args.child[1], args.repeats, args.child[2])
        return 0
    if args.mix_child:
        mix_child(args.mix_child[0], args.mix_child[1], args.repeats, args.mix_child[2])
        return 0
    if args.table_child:
        table_child(args.table_child[0], args.table_child[1], args.repeats,
                    args.table_child[2])
        return 0
    if args.migrate_child:
        migrate_child(*args.migrate_child[:2], args.repeats, args.migrate_child[2])
        return 0
    import torch

    if not torch.cuda.is_available() or args.parent is None:
        print("census_bench: needs a GPU and --parent", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jaybenne_tpu_torch.ops import cuda_lib
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parent = os.path.abspath(args.parent)
    variants = [os.path.abspath(v) for v in args.variant]
    trees = [parent, *variants, ROOT]
    label = {t: os.path.basename(t.rstrip("/")) for t in trees}
    label[parent], label[ROOT] = "parent", "this tree"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = [parent, *variants, ROOT, ROOT, *variants[::-1], parent] * args.turns
    summary = {"device": smi, "order": [label[t] for t in order], "children": [],
               "profile": [], "common_path": {}, "resources": {}, "mix": {}, "tables": []}
    if args.only and TABLE in args.only:
        with tempfile.TemporaryDirectory() as tmp:
            inputs = os.path.join(tmp, "tables.pt")
            record_tables(inputs)
            for k, tree in enumerate(order):
                out = os.path.join(tmp, f"table{k}.json")
                print(f"turn {k}: {label[tree]} (census_table)", flush=True)
                subprocess.run([sys.executable, os.path.abspath(__file__), "--repeats",
                                str(args.repeats), "--table-child", inputs, tree, out],
                               check=True, timeout=1800)
                with open(out) as f:
                    summary["tables"].append({"tables": json.load(f), "tree": label[tree]})
        table_lines(summary["tables"], trees, label)
        args.only = [r for r in args.only if r != TABLE]
        if not args.only:
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
            print(smi)
            return 0
    if args.only and any(k in args.only for k in TALLY_FACES):
        summary["tally_faces"] = tally_faces_reading([k for k in TALLY_FACES if k in args.only])
        eager_read = set()  # the parent and this tree eagerly too, once each (the spans)
        for k, tree in enumerate(order):
            who = label[tree]
            read = who in ("parent", "this tree") and who not in eager_read
            eager_read.add(who)
            for deck in TALLY_FACES_DECKS:
                for eager in ((), ("--eager",)) if read and deck == "big_mesh_ddmc" else ((),):
                    row = profile(tree, deck, eager)
                    summary["profile"].append({"tree": who, "deck": deck,
                                               "eager": bool(eager), **row})
                    print(f"profile {k}: {deck} {who}{' eager' if eager else ''}: device total "
                          f"{row['device_ms_per_step']!r} ms a step, step wall median "
                          f"{row['step_wall_ms']!r} ms", flush=True)
                    for line in row["all_spans"] if eager else ():
                        print(f"  {who} {deck}: {line}", flush=True)
        args.only = [r for r in args.only if r not in TALLY_FACES]
        if not args.only:
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
            print(smi)
            return 0
    if args.only and ROUND in args.only:
        summary["round"] = round_reading()
        summary["profile"] += round_turns(order, label, args.turns)
        args.only = [r for r in args.only if r != ROUND]
        if not args.only:
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
            print(smi)
            return 0
    if args.only and STEPS in args.only:
        summary["profile"] += steps_turns(order, label)
        args.only = [r for r in args.only if r != STEPS]
        if not args.only:
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
            print(smi)
            return 0
    if args.only and COUNTS_APART in args.only:
        summary["counts_apart"] = counts_apart(args.repeats)
        args.only = [r for r in args.only if r != COUNTS_APART]
        if not args.only:
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
            print(smi)
            return 0
    if args.only and (MIGRATE in args.only or MIGRATE_KERNEL in args.only):
        summary["migrate"], rounds = migrate_reading()
        summary["migrate_turns"] = migrate_turns(order, label, rounds, args.repeats)
        runs = [(tree, (), label[tree]) for tree in order] if MIGRATE in args.only else []
        runs += [(ROOT, ("--rounds-per-batch", str(MIGRATE_BATCH)),
                  f"this tree at {MIGRATE_BATCH} rounds a batch")] * (2 * args.turns * bool(runs))
        eager_read = set()  # the parent and this tree eagerly too, once each (the spans)
        for k, (tree, extra, who) in enumerate(runs):
            read = not extra and who in ("parent", "this tree") and who not in eager_read
            eager_read.add(who)
            for deck in MIGRATE_DECKS:
                for eager in ((), ("--eager",)) if read else ((),):
                    print(f"profile {k}: {who}, {deck} {' '.join(eager + extra)}", flush=True)
                    row = profile(tree, deck, eager + extra)
                    summary["profile"].append({"tree": who, "deck": deck,
                                               "eager": bool(eager), **row})
                    print(f"profile {deck} {who}{' eager' if eager else ''}: device total "
                          f"{row['device_ms_per_step']!r} ms a step, step wall median "
                          f"{row['step_wall_ms']!r} ms, census {row['census_ms_per_step']!r} ms "
                          f"a step in {row['census_launches_per_step']!r} launches", flush=True)
                    for line in row["spans"] if eager else ():
                        print(f"  {who} {deck}: {line}", flush=True)
        args.only = [r for r in args.only if r not in (MIGRATE, MIGRATE_KERNEL)]
        if not args.only:
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
            print(smi)
            return 0
    loop_routes = [r for r in cs.EVENT_LOOP_ROUTES if args.only is None or r in args.only]
    for tree in trees:
        csrc = os.path.join(tree, "jaybenne_tpu_torch", "csrc")
        summary["common_path"][label[tree]] = (cs.common_paths(csrc, loop_routes, tk)
                                               if loop_routes else {})
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        record(inputs, args.only)
        own_log = cuda_lib.library().build_log  # this tree's library, built by record
        for k, tree in enumerate(order):
            out = os.path.join(tmp, f"child{k}.json")
            print(f"turn {k}: {label[tree]}", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__), "--repeats",
                            str(args.repeats), "--child", inputs, tree, out], check=True,
                           timeout=1800)
            with open(out) as f:
                summary["children"].append({**json.load(f), "tree": label[tree]})
        for tree in (parent, ROOT):
            out = os.path.join(tmp, f"mix_{len(summary['mix'])}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--repeats",
                            str(args.repeats), "--mix-child", inputs, tree, out], check=True,
                           timeout=1800)
            with open(out) as f:
                summary["mix"][label[tree]] = json.load(f)
    if args.profile is not None:
        for tree in order:
            for deck in args.profile or PROFILE_DECKS:
                summary["profile"].append({"tree": label[tree], "deck": deck,
                                           **profile(tree, deck)})
    kids = summary["children"]
    names = list(kids[0]["routes"])
    for name in names:
        seen = {kid["routes"][name]["digest"] for kid in kids}
        if len(seen) != 1:
            raise AssertionError(f"{name}: output ledgers differ between runs: {seen}")
        counts = {kid["routes"][name]["events"] for kid in kids}
        if len(counts) != 1:
            raise AssertionError(f"{name}: events differ between runs: {counts}")
    for tree in trees:
        logs = [kid.pop("build_log") for kid in kids if kid["tree"] == label[tree]]
        log = own_log if tree == ROOT else next((log for log in logs if log), "")
        res = summary["resources"][label[tree]] = cs.kernel_resources(log, tk)
        shown = cs.EVENT_LOOP_ROUTES + cs.DDMC_ROUTES + NG_ROUTES
        print(f"{label[tree]}: resources {({k: res.get(k) for k in shown})}; event "
              f"loop common path {summary['common_path'][label[tree]]} SASS instructions",
              flush=True)
    base = summary["resources"]["parent"]
    for tree in trees[1:]:
        res = summary["resources"][label[tree]]
        moved = {k: (base.get(k), v) for k, v in sorted(res.items()) if base.get(k) != v}
        print(f"{label[tree]}: instantiations whose resources differ from the parent's "
              f"(parent, tree): {moved}", flush=True)
    print(f"route: per tree the medians of {args.repeats} censuses in each turn (ms), the range "
          "of each turn, and the median of the turns over the parent's; outputs bitwise equal")
    for name in names:
        row, base = [], None
        for tree in trees:
            runs = [kid["routes"][name]["times"] for kid in kids if kid["tree"] == label[tree]]
            meds = [statistics.median(t) for t in runs]
            base = base or statistics.median(meds)
            row.append(f"{label[tree]} {meds} {[(t[0], t[-1]) for t in runs]} "
                       f"{statistics.median(meds) / base:.3f}")
        r0 = kids[0]["routes"][name]
        print(f"{name} ({r0['events']} events, {r0['live']} live lanes of {r0['slots']}): "
              + " | ".join(row), flush=True)
        blocks = {label[t]: next(kid["routes"][name].get("blocks") for kid in kids
                                 if kid["tree"] == label[t]) for t in trees}
        print(f"  {name} resident blocks of 256 a SM: {blocks}", flush=True)
        row, base = [], None
        for tree in trees:
            meds = [statistics.median(kid["routes"][name]["kernel"]) for kid in kids
                    if kid["tree"] == label[tree]]
            base = base or statistics.median(meds)
            row.append(f"{label[tree]} {meds} {statistics.median(meds) / base:.3f}")
        print(f"  {name} kernel alone (CUDA events around its launch), medians of each turn "
              "(ms) and over the parent's: " + " | ".join(row), flush=True)
        row = []
        for tree in trees:
            runs = [kid["routes"][name] for kid in kids if kid["tree"] == label[tree]]
            med = {k: statistics.median(statistics.median(r[k]) for r in runs)
                   for k in ("table", "forest", "counters", "launch", "gap")}
            row.append(f"{label[tree]} cell table {med['table']!r}, forest tables "
                       f"{med['forest']!r}, counters {med['counters']!r}, census launch "
                       f"{med['launch']!r} (gap {med['gap']!r})")
        print(f"  {name} call split, median over the turns (ms): " + " | ".join(row), flush=True)
        if name in cs.EVENT_LOOP_ROUTES:
            print(f"  {name} issue share (common path x events over the median census x "
                  f"{sms} SMs x {cs.ISSUE_PER_SM_CLOCK} x the SM clock read after it): "
                  + ", ".join(f"{label[t]} {issue_share(kids, label[t], name, summary, sms)!r}"
                              for t in trees), flush=True)
    for name in MIX_ROUTES:
        if name not in names:
            continue
        for tree in (parent, ROOT):
            m = summary["mix"][label[tree]][name]
            we = m["warp_events"]
            what = (f"DDMC {m['ddmc'] / we!r}, leaked {m['dd_leak'] / we!r}, DDMC census "
                    f"{m['dd_census'] / we!r}, other {m['dd_other'] / we!r}; issue "
                    f"{m['issue_ms']!r} ms, {m['warp_issue_share']!r} of the kernel alone "
                    f"{m['kernel_ms']!r} ms; slot-order warp efficiency "
                    f"{m['slot_order_warp_efficiency']!r}"
                    if name in cs.DDMC_ROUTES or name in K4S_READ else
                    f"gathered anew {m['regather'] / we!r}, crossed {m['cross'] / we!r}; the "
                    f"opacity {m['opacity_instructions']} SASS a gather; the whole loop at the "
                    f"issue rate {m['issue_ms']!r} ms, {m['warp_issue_share']!r} of the kernel "
                    f"alone {m['kernel_ms']!r} ms (slots "
                    f"{'spread' if m['spreads'] else 'in order'}; "
                    f"{m['kernel_ms_other_spread']!r} ms if not); slot-order warp efficiency "
                    f"{m['slot_order_warp_efficiency']!r}"
                    if name in NG_ROUTES else
                    f"crossed {m['cross'] / we!r}, reached a block face or wall "
                    f"{m['wall'] / we!r}; {m['instructions_per_warp_event']!r} instructions a "
                    f"warp-event, warp issue share {m['warp_issue_share']!r} of the kernel alone "
                    f"{m['kernel_ms']!r} ms"
                    if name in F64_READ else f"crossed {m['cross'] / we!r}")
            print(f"path mix {name} {label[tree]}: {we} warp-events, SIMT efficiency "
                  f"{m['lane_events'] / (32 * we)!r}, warp-events with a lane that {what}; "
                  f"lane-events a SM (%smid): {m['sms_with_lanes']} SMs ran lanes, max/mean "
                  f"{m['sm_max_over_mean']!r}", flush=True)
    for name in SWEEP_ROUTES:
        if name not in names:
            continue
        for tree in trees:
            cells = []
            for k in SWEEP:
                runs = [kid["routes"][sweep_name(name, k)] for kid in kids
                        if kid["tree"] == label[tree]]
                ms = statistics.median(statistics.median(r["times"]) for r in runs)
                cells.append(f"{k}x {runs[0]['live']} live lanes {ms!r} ms "
                             f"{ms * 1e6 / runs[0]['events']!r} ns an event")
            print(f"lane sweep {name} {label[tree]}: " + "; ".join(cells), flush=True)
    for row in summary["profile"]:
        launches = row["census_launches_per_step"]
        print(f"profile {row['deck']} {row['tree']}: census {row['census_ms_per_step']!r} ms a "
              f"step in {launches!r} launches (the mean launch "
              f"{row['census_ms_per_step'] / max(launches, 1)!r} ms), device total "
              f"{row['device_ms_per_step']!r} ms a step, step wall median "
              f"{row['step_wall_ms']!r} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
