#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch + CUDA port (``jaybenne_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (``python3
chip_smoke.py``, no arguments). It builds the port's CUDA kernels from ``csrc/``,
holds each against its plain PyTorch version, drives the stepdiff main path through
``driver.run_file`` on the GPU, and checks the result against the analytic erf
solution of ``tst/stepdiff_common.py``. Every phase raises on failure; the last line
of standard output is the JSON result, printed only when every phase passed. It
exits non-zero without a GPU. Nothing here imports jax.

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc time of the kernel library;
  3. K2: the CUDA raw_bits hash is bit-identical to the PyTorch hash;
  4. K1(a): the CUDA census kernel against its plain version on one ledger
     (2^17 particles, gate mesh, sigma_s = 1024): after 8 iterations integer state
     identical and floats within FLOAT_RTOL; after a full census every live slot at
     tau = 1, event totals within 2 %, mean and std of x within the CPU tests'
     tolerances;
  5. main path: stepdiff at 128 cells, 100k particles, 10 steps through the kernel
     (launch count 10), weighted-mean erf error <= 0.05, radiation energy conserved
     to 1e-5; event total, wall time per step and events/s; one step of the plain
     version (use_pallas = off) for comparison; the kernel and its plain version
     timed on the main path's own ledger;
  6. determinism: the main path again with the same seed gives bitwise-identical
     tallies.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(ROOT, "inputs", "stepdiff.in")
GATE = {
    "parthenon/mesh/nx1": 128,
    "parthenon/meshblock/nx1": 128,
    "jaybenne/num_particles": 100000,
    "parthenon/output0/file_type": "none",
}
N_STEPS = 10
WERR_TOL = 0.05
ENERGY_RTOL = 1e-5
# kernel vs plain after 8 iterations: both run the same IEEE float32 operations
# (the kernel is built without fast math or FMA contraction), so any difference
# is a 1-ulp difference of a math-library call carried through a few events
FLOAT_RTOL = 1e-5
EVENTS_RTOL = 0.02
MEAN_ATOL = 0.01  # the CPU tests' tolerances (tests/test_pallas.py)
STD_RTOL = 0.10


def phase(name):
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
    from jaybenne_tpu_torch import config as cm
    from jaybenne_tpu_torch.mesh import build_mesh
    from jaybenne_tpu_torch.ops.transport import TransportCoefs
    from jaybenne_tpu_torch.step import make_transport_params
    from jaybenne_tpu_torch.utils.deck import Deck

    cfg = cm.from_deck(Deck.from_file(DECK).update(GATE))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    nc = mesh.total_cells
    coefs = TransportCoefs(
        sigma_a=torch.zeros(nc, device=dev),
        sigma_s=torch.full((nc,), sigma_s, device=dev),
        fleck=torch.ones(nc, device=dev),
    )
    return cfg, mesh, prm, coefs


def weighted_erf_error(sim) -> float:
    """Weighted-mean fractional error of the tally against the erf solution, as
    tst/regression_test.py::analytic_comparison computes it."""
    sys.path.insert(0, os.path.join(ROOT, "tst"))
    from stepdiff_common import erf_profile

    var = sim.state.fields.energy_tally.double().cpu().numpy()
    xc, yc, zc = (a.double().cpu().numpy() for a in sim.mesh.cell_centers())
    sol = erf_profile(sim.t, xc, yc, zc)
    frac = np.fabs(sol - var) / np.fabs((sol + var) / 2.0)
    return float((frac * sol).sum() / sol.sum())


def radiation_energy(sim) -> float:
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    return float((sim.state.fields.energy_tally.double() * dv).sum())


def time_census(fn, p0, args, dev, repeats):
    """ms per census call (CUDA events), each on a fresh copy of ``p0``."""
    times = []
    for _ in range(repeats):
        p = p0.clone()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(p, *args)
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_float_err(a, b):
    err, rel = 0.0, 0.0
    for name in ("x", "vx", "vy", "vz", "tau"):
        ta, tb = getattr(a, name), getattr(b, name)
        d = (ta - tb).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float((d / tb.abs().clamp_min(1e-30)).max()))
    return err, rel


def main() -> int:
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
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

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
        plain = run_file(DECK, outdir=outdir,
                         modified_inputs={**GATE, "jaybenne/use_pallas": "off"},
                         quiet=True, nlim=1, device="cuda")
        again = run_file(DECK, outdir=outdir, modified_inputs=GATE, quiet=True,
                         device="cuda")
    if launches.get("transport_1d", 0) != N_STEPS or sim.cycle != N_STEPS:
        raise AssertionError(f"main path: launches {launches}, cycles {sim.cycle}")
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
    plain_step_s = plain.history[0]["step_seconds"]
    print(f"werr {werr!r} (tol {WERR_TOL}); energy step 0 {e0!r} step 10 {e10!r} "
          f"rel {abs(e10 - e0) / e0:.3e}", flush=True)
    print(f"events {events} (int64); step seconds {step_s}; "
          f"median {statistics.median(step_s) * 1e3!r} ms; {rate!r} events/s", flush=True)
    print(f"plain version, one step on the GPU: {plain_step_s * 1e3!r} ms "
          f"({plain.history[0]['events']} events)", flush=True)

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
    ms = time_census(transport_kernel.transport, pm, args, dev, 5)
    plain_ms = time_census(transport_kernel.transport_plain, pm, args, dev, 2)
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
          f"kernel {ms!r} ms, plain {plain_ms!r} ms per census; 8-iteration "
          f"max_abs_err {err_m:.3e}", flush=True)

    phase("6 determinism")
    if not torch.equal(again.state.fields.energy_tally, tally):
        raise AssertionError("determinism: a second run with the same seed differs")
    print("second run with the same seed: tallies bitwise identical", flush=True)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = [{
        "name": "transport_1d (K1(a), with K2 inlined)",
        "route": "cuda",
        "source": "jaybenne_tpu_torch/csrc/transport_kernel.cu",
        "replaces": "jaybenne_tpu/ops/pallas_transport.py:382",
        "launches": launches.get("transport_1d", 0),
        "max_abs_err": max(err8, err_m),
        "ms": ms,
        "plain_ms": plain_ms,
    }]
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
