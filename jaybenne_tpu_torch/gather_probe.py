"""What the census kernel's per-event table gather costs as the table outgrows L1.

    python -m jaybenne_tpu_torch.gather_probe [--sizes 16 32 64 128] [--particles N]

Runs the 3D absorbing census kernel on periodic meshes of N^3 cells (8 blocks),
with sigma_t dx = 16, p_abs = 1/64 and c dt = 4 dx held fixed, so that a particle
runs the same events on every mesh and only the size of the pair table (8 bytes a
cell: 32 KB at 16^3, 2 MB at 64^3, 16 MB at 128^3) changes. Prints, per N, the
events and the kernel's median ms over three censuses (CUDA events, after a
warm-up, with the host's latency kept out) and its ns per event, beside
``nvidia-smi``'s card name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys

import torch

from . import config as config_mod
from .mesh import build_mesh
from .ops import transport_kernel
from .ops.transport import TransportCoefs
from .particles import uniform_ledger
from .step import make_transport_params
from .utils.constants import CC
from .utils.deck import Deck

DECK = """
<parthenon/job>
problem_id = gather_probe
<parthenon/mesh>
nx1 = 16
x1min = 0.0
x1max = 1.0
nx2 = 16
x2min = 0.0
x2max = 1.0
nx3 = 16
x3min = 0.0
x3max = 1.0
<parthenon/swarm>
ix1_bc = periodic
ox1_bc = periodic
ix2_bc = periodic
ox2_bc = periodic
ix3_bc = periodic
ox3_bc = periodic
<parthenon/time>
tlim = 1.0e-12
<jaybenne>
num_particles = 1
dt = 1.0e-12
<mcblock>
opacity_model = constant
scattering_model = constant
initial_density = 1.0
initial_temperature = 1.0
initial_radiation = none
"""


def census_ns_per_event(n_cells: int, n_particles: int, dev, repeats: int = 3):
    """(events, median ms) of one census on an n_cells^3 periodic mesh."""
    mods = {f"parthenon/mesh/nx{k}": n_cells for k in "123"}
    mods.update({f"parthenon/meshblock/nx{k}": n_cells // 2 for k in "123"})
    cfg = config_mod.from_deck(Deck.parse(DECK).update(mods))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    prm = dataclasses.replace(prm, max_iters=100000)
    dx = 1.0 / n_cells
    sigma_t = 16.0 / dx
    nc = mesh.total_cells
    coefs = TransportCoefs(
        sigma_a=torch.full((nc,), sigma_t / 64.0, device=dev),
        sigma_s=torch.full((nc,), sigma_t * 63.0 / 64.0, device=dev),
        fleck=torch.ones(nc, device=dev),
    )
    dt = 4.0 * dx / CC
    p0 = uniform_ledger(mesh, n_particles, torch.Generator(device=dev).manual_seed(n_cells), CC)
    transport_kernel.transport(p0.clone(), coefs, mesh, 7, prm, dt)  # warm-up
    times, events = [], 0
    for _ in range(repeats):
        p = p0.clone()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        # keep the card busy while the host prepares the call, so that the
        # interval holds device work only
        torch.cuda._sleep(50_000_000)
        start.record()
        _, _, ev = transport_kernel.transport(p, coefs, mesh, 7, prm, dt)
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop))
        events = int(ev)
    return events, statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[16, 32, 64, 128])
    ap.add_argument("--particles", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_probe: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    for n in args.sizes:
        events, ms = census_ns_per_event(n, args.particles, dev)
        print(f"N {n} table_bytes {8 * n**3} events {events} ms {ms!r} "
              f"ns_per_event {ms * 1e6 / events!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
