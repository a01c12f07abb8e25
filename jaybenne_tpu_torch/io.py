"""HDF5 dumps and checkpoint/restart (port of ``jaybenne_tpu/io.py``).

The dump schemas are the JAX package's: the compact one (``write_dump``), which
``analysis/jhdf.py`` and the ``tst/`` gates read, and Parthenon's binary layout
(``write_dump_parthenon``, ``file_type = phdf_parthenon``). A checkpoint
(``.rhdf``) holds the JAX package's restart schema, so each package restarts
from the other's files:

  * attributes ``Time`` (float64), ``NCycle`` and ``overflow`` (int64);
  * ``fields/<name>`` for the eleven ``Fields`` members, real blocks only;
  * ``particles/<name>`` for every ledger column;
  * ``rng_key``: the JAX package's ``PRNGKey(seed)``, ``uint32 [0, seed]`` for a
    seed in [0, 2^32). The port keys its streams by the integer seed, which the
    reader recovers from the key.

A checkpoint is written and read in two layers: ``checkpoint_tree`` flattens a
state into a dict of numpy arrays keyed by the file's dataset and attribute
names, and ``state_from_checkpoint_tree`` restores such a dict onto a state's
device; ``write_checkpoint`` and ``read_checkpoint`` move the dict to and from
HDF5. ``h5py`` is imported only by the functions that read or write HDF5, so a
run that writes no HDF5 file (``file_type = none``, a restart from a tree) needs
none, and one that asks for an HDF5 file without it raises ``RuntimeError``.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from .parallel.spatial import PAD_ONES

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

# a checkpoint's attributes; every other entry of its tree is a dataset
CHECKPOINT_ATTRS = ("Time", "NCycle", "overflow")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py is not installed: HDF5 dumps and checkpoints cannot be "
                           "written or read (use file_type = none, or restart from a "
                           "checkpoint tree)") from e
    return h5py


def _np(t):
    return t.detach().cpu().numpy()


def dump_filename(problem_id: str, number: int, outdir: str = ".") -> str:
    return os.path.join(outdir, f"{problem_id}.out0.{number:05d}.phdf")


def write_dump(path, state, mesh, variables, swarm_variables=()):
    h5py = _h5py()
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
                h.create_dataset(f"vars/{var}", data=_np(getattr(f, attr))[: mesh.n_blocks])
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


def write_dump_parthenon(path, state, mesh, variables, swarm_variables=()):
    """Parthenon's binary ``.phdf`` layout (OutputFormatVersion 3), as the JAX
    package's writer lays it out: group ``Info`` with the attributes
    ``parthenon_tools.phdf`` reads, per-block node and cell-centre coordinates
    (``Locations``, ``VolumeLocations``), ``Levels`` and ``LogicalLocations``
    (level-local integer block coordinates, from the lookup grid's integers),
    one float64 dataset per output variable ``[B, nz, ny, nx]``, and a
    ``photons`` group with one flat dataset per swarm variable, grouped by block,
    with per-block ``counts`` and ``offsets``."""
    h5py = _h5py()
    B = mesh.n_blocks
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    origin = _np(mesh.block_origin).astype(np.float64)  # [B, 3] (x, y, z)
    bdx = _np(mesh.block_dx).astype(np.float64)
    levels = _np(mesh.block_level).astype(np.int64)
    x1min, x1max, x2min, x2max, x3min, x3max = mesh.bounds
    nrb3, nrb2, nrb1 = mesh.root_grid

    names = [v for v in variables if VARIABLE_MAP.get(v)]
    with h5py.File(path, "w") as h:
        info = h.create_group("Info")
        info.attrs["OutputFormatVersion"] = np.int32(3)
        info.attrs["Time"] = np.float64(state.t)
        info.attrs["NCycle"] = np.int32(state.cycle)
        info.attrs["WallTime"] = np.float64(0.0)
        info.attrs["NumDims"] = np.int32(mesh.ndim)
        info.attrs["NumMeshBlocks"] = np.int32(B)
        info.attrs["MeshBlockSize"] = np.asarray([nx, ny, nz], dtype=np.int32)
        info.attrs["MaxLevel"] = np.int32(mesh.max_level)
        info.attrs["NGhost"] = np.int32(0)
        info.attrs["IncludesGhost"] = np.int32(0)
        info.attrs["Multilevel"] = np.int32(1 if mesh.max_level > 0 else 0)
        info.attrs["NBNew"] = np.int32(0)
        info.attrs["NBDel"] = np.int32(0)
        info.attrs["RootLevel"] = np.int32(0)
        info.attrs["Coordinates"] = "UniformCartesian"
        info.attrs["RootGridSize"] = np.asarray([nrb1 * nx, nrb2 * ny, nrb3 * nz],
                                                dtype=np.int32)
        # (min, max, ratio) a dimension; a uniform root grid has ratio 1
        info.attrs["RootGridDomain"] = np.asarray(
            [x1min, x1max, 1.0, x2min, x2max, 1.0, x3min, x3max, 1.0], dtype=np.float64)
        info.attrs["OutputDatasetNames"] = names
        info.attrs["ComponentNames"] = names
        info.attrs["NumComponents"] = np.ones((len(names),), dtype=np.int32)

        loc = h.create_group("Locations")
        vloc = h.create_group("VolumeLocations")
        for d, (axname, n) in enumerate((("x", nx), ("y", ny), ("z", nz))):
            nodes = origin[:, d:d + 1] + bdx[:, d:d + 1] * np.arange(n + 1)
            loc.create_dataset(axname, data=nodes)
            vloc.create_dataset(axname, data=0.5 * (nodes[:, :-1] + nodes[:, 1:]))

        h.create_dataset("Levels", data=levels)
        # a block's first finest-level lookup tile, shifted down to its own level:
        # exact integers, where rounding the float32 origins can miss by a stride
        lookup = _np(mesh.lookup)
        flat = lookup.reshape(-1)
        order = np.argsort(flat, kind="stable")
        first = order[np.searchsorted(flat[order], np.arange(B))]
        tz, ty, tx = np.unravel_index(first, lookup.shape)
        tiles = np.stack([tx, ty, tz], axis=1).astype(np.int64)
        # refined dimensions halve a level; the others keep one tile a root block
        shift = np.where(np.arange(3)[None, :] < mesh.ndim,
                         np.int64(mesh.max_level) - levels[:, None], 0)
        h.create_dataset("LogicalLocations", data=tiles >> shift)
        blocks = h.create_group("Blocks")
        blocks.create_dataset("xmin", data=origin[:, : max(mesh.ndim, 1)])
        lgl = np.zeros((B, 5), dtype=np.int32)
        lgl[:, 0] = levels
        lgl[:, 1] = np.arange(B)  # gid
        lgl[:, 2] = np.arange(B)  # lid (one rank)
        blocks.create_dataset("loc.level-gid-lid-cnghost-gflag", data=lgl)

        f = state.fields
        for var in names:
            arr = _np(getattr(f, VARIABLE_MAP[var])).astype(np.float64)
            ds = h.create_dataset(var, data=arr[:B])
            ds.attrs["ComponentNames"] = [var]

        if swarm_variables:
            p = state.particles
            alive = _np(p.alive)
            gx, gy, gz = p.global_position(mesh)
            blk = _np(p.block)[alive]
            order = np.argsort(blk, kind="stable")  # particles grouped by block
            counts = np.bincount(blk, minlength=B).astype(np.int64)
            sw = h.create_group("photons")
            sw.create_dataset("counts", data=counts)
            sw.create_dataset("offsets", data=np.concatenate([[0], np.cumsum(counts)[:-1]]))
            cols = {
                "x": _np(gx)[alive],
                "y": _np(gy)[alive],
                "z": _np(gz)[alive],
                "weight": _np(p.weight)[alive],
                "id": np.flatnonzero(alive).astype(np.int64),
            }
            for name in ("x", "y", "z", "weight", "id"):
                if name in ("x", "y", "z", "id") or f"swarm.{name}" in swarm_variables:
                    sw.create_dataset(name, data=cols[name][order])


def latest_dump(problem_id: str, outdir: str = ".") -> str:
    files = sorted(glob.glob(os.path.join(outdir, f"{problem_id}.out0.*.phdf")))
    if not files:
        raise FileNotFoundError(f"no dumps for {problem_id} in {outdir}")
    return files[-1]


# ---------------------------------------------------------------- checkpoint
def prng_key(seed: int) -> np.ndarray:
    """The JAX package's ``PRNGKey(seed)`` for a seed in [0, 2^32):
    ``uint32 [0, seed]``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside [0, 2^32): a checkpoint's rng_key holds "
                         "the seed as a JAX PRNGKey of one word")
    return np.array([0, seed], dtype=np.uint32)


def seed_from_key(key) -> int:
    """The seed of a ``prng_key``; raises for a key of any other form."""
    key = np.asarray(key)
    if key.dtype != np.uint32 or key.shape != (2,) or key[0] != 0:
        raise ValueError(f"checkpoint rng_key {key!r} ({key.dtype}, shape {key.shape}) is "
                         "not PRNGKey(seed) of a seed in [0, 2^32): uint32 [0, seed]")
    return int(key[1])


def checkpoint_tree(state, mesh, t=None, cycle=None) -> dict:
    """A state as the checkpoint's entries: dataset path or attribute name ->
    numpy value. ``t`` and ``cycle`` (``Simulation``'s host clock) take the place of
    the state's own when given. Fields keep their real blocks only, so a
    checkpoint does not depend on the decomposition that wrote it."""
    B = mesh.n_blocks
    tree = {
        "Time": np.float64(state.t if t is None else t),
        "NCycle": np.int64(state.cycle if cycle is None else cycle),
        "overflow": np.int64(int(state.overflow)),
    }
    for fld in dataclasses.fields(state.fields):
        tree[f"fields/{fld.name}"] = _np(getattr(state.fields, fld.name)[:B])
    for fld in dataclasses.fields(state.particles):
        tree[f"particles/{fld.name}"] = _np(getattr(state.particles, fld.name))
    tree["rng_key"] = prng_key(state.seed)
    return tree


def _refit_blocks(arr, want, name):
    """A field's block axis re-fit to ``want`` blocks: padding blocks added hold
    the spatial decomposition's fill, blocks past ``want`` are padding."""
    if arr.shape[0] < want:
        fill = 1.0 if name in PAD_ONES else 0.0
        pad = np.full((want - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
        return np.concatenate([arr, pad])
    return arr[:want]


def state_from_checkpoint_tree(tree, state):
    """``state`` with the fields, ledger, clock, seed and overflow of a checkpoint
    tree, on the state's device. The ledger is re-fit to the state's capacity:
    it grows by dead slots; it shrinks by dropping dead tail slots, or when a live
    particle lies past the capacity by a stable live-first compaction; it raises
    when the live particles do not fit. A tree without ``leak`` gets it
    zero-filled."""
    fvals = {}
    for fld in dataclasses.fields(state.fields):
        cur = getattr(state.fields, fld.name)
        arr = _refit_blocks(np.asarray(tree[f"fields/{fld.name}"]), cur.shape[0], fld.name)
        if arr.shape[1:] != tuple(cur.shape[1:]):
            raise ValueError(f"checkpoint field {fld.name} has cells {arr.shape[1:]}, the "
                             f"mesh {tuple(cur.shape[1:])}")
        fvals[fld.name] = torch.from_numpy(np.ascontiguousarray(arr)).to(cur.device, cur.dtype)

    alive = np.asarray(tree["particles/alive"]).astype(bool)
    cap, saved = state.particles.capacity, alive.shape[0]
    perm = None
    if saved > cap:
        n_live = int(alive.sum())
        if n_live > cap:
            raise ValueError(f"checkpoint holds {n_live} live particles but the restart "
                             f"ledger capacity is {cap}; raise jaybenne/capacity_factor")
        if alive[cap:].any():
            perm = np.argsort(~alive, kind="stable")
    pvals = {}
    for fld in dataclasses.fields(state.particles):
        cur = getattr(state.particles, fld.name)
        key = f"particles/{fld.name}"
        if key in tree:
            arr = np.asarray(tree[key])
        elif fld.name == "leak":
            arr = np.zeros(saved, np.int32)
        else:
            raise KeyError(f"checkpoint has no {key}")
        if perm is not None:
            arr = arr[perm]
        if arr.shape[0] < cap:
            arr = np.concatenate([arr, np.zeros((cap - arr.shape[0],), arr.dtype)])
        pvals[fld.name] = torch.from_numpy(np.ascontiguousarray(arr[:cap])).to(cur.device,
                                                                               cur.dtype)
    return dataclasses.replace(
        state,
        fields=dataclasses.replace(state.fields, **fvals),
        particles=dataclasses.replace(state.particles, **pvals),
        t=float(tree["Time"]),
        cycle=int(tree["NCycle"]),
        overflow=int(tree["overflow"]),
        seed=seed_from_key(tree["rng_key"]),
    )


def write_checkpoint(path, state, mesh, t=None, cycle=None):
    """``checkpoint_tree`` of the state, written to an HDF5 file."""
    h5py = _h5py()
    tree = checkpoint_tree(state, mesh, t, cycle)
    with h5py.File(path, "w") as h:
        for key, val in tree.items():
            if key in CHECKPOINT_ATTRS:
                h.attrs[key] = val
            else:
                h.create_dataset(key, data=val)


def read_checkpoint_tree(path) -> dict:
    """The checkpoint tree an HDF5 checkpoint holds (either package's)."""
    h5py = _h5py()
    tree = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            tree[name] = obj[...]

    with h5py.File(path, "r") as h:
        for key in CHECKPOINT_ATTRS:
            tree[key] = h.attrs[key]
        h.visititems(visit)
    return tree


def read_checkpoint(path, state):
    """``state`` restored from an HDF5 checkpoint (``state_from_checkpoint_tree``)."""
    return state_from_checkpoint_tree(read_checkpoint_tree(path), state)
