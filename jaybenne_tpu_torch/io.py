"""HDF5 dumps (port of ``jaybenne_tpu/io.py``: ``dump_filename``, ``write_dump``,
``latest_dump``).

The dump schema is the JAX package's compact one, so ``analysis/jhdf.py`` and the
``tst/`` gates read the port's dumps unchanged. ``h5py`` is imported inside
``write_dump``: a run whose deck writes no dump (``file_type = none``) needs no
``h5py``. Checkpoint/restart and the Parthenon layout arrive with slice 7 (ROADMAP
Queue 1, item 16).
"""

from __future__ import annotations

import glob
import os

import numpy as np

# dump-variable name -> Fields attribute
VARIABLE_MAP = {
    "field.material.density": "rho",
    "field.material.sie": "sie",
    "field.material.internal_energy": "u",
    "field.jaybenne.energy_tally": "energy_tally",
    "field.jaybenne.fleck_factor": "fleck",
    "field.jaybenne.energy_delta": "energy_delta",
    "field.jaybenne.source_ew_per_cell": "source_ew",
    "field.jaybenne.source_num_per_cell": "source_num",
}


def _np(t):
    return t.detach().cpu().numpy()


def dump_filename(problem_id: str, number: int, outdir: str = ".") -> str:
    return os.path.join(outdir, f"{problem_id}.out0.{number:05d}.phdf")


def write_dump(path, state, mesh, variables, swarm_variables=()):
    import h5py

    f = state.fields
    with h5py.File(path, "w") as h:
        h.attrs["Time"] = float(state.t)
        h.attrs["NCycle"] = int(state.cycle)
        h.attrs["NumBlocks"] = mesh.n_blocks
        h.attrs["ndim"] = mesh.ndim
        h.attrs["NX1"] = mesh.nx
        h.attrs["NX2"] = mesh.ny
        h.attrs["NX3"] = mesh.nz
        h.attrs["bounds"] = np.asarray(mesh.bounds)
        h.create_dataset("blocks/origin", data=_np(mesh.block_origin))
        h.create_dataset("blocks/dx", data=_np(mesh.block_dx))
        h.create_dataset("blocks/level", data=_np(mesh.block_level))
        for var in variables:
            attr = VARIABLE_MAP.get(var)
            if attr is not None:
                h.create_dataset(f"vars/{var}", data=_np(getattr(f, attr)))
        if swarm_variables:
            p = state.particles
            alive = _np(p.alive)
            gx, gy, gz = p.global_position(mesh)
            sw = {
                "swarm.x": _np(gx)[alive],
                "swarm.y": _np(gy)[alive],
                "swarm.z": _np(gz)[alive],
                "swarm.weight": _np(p.weight)[alive],
            }
            for name in swarm_variables:
                if name in sw:
                    h.create_dataset(f"swarm/photons/{name}", data=sw[name])


def latest_dump(problem_id: str, outdir: str = ".") -> str:
    files = sorted(glob.glob(os.path.join(outdir, f"{problem_id}.out0.*.phdf")))
    if not files:
        raise FileNotFoundError(f"no dumps for {problem_id} in {outdir}")
    return files[-1]
