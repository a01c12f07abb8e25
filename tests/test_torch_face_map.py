"""The face kernel's side map and arithmetic on the CPU: ``csrc/faces_kernel.cu``
runs only on a GPU, so its reads are mirrored here in PyTorch, face by face as
the kernel runs them, from the map that ``fleck.face_sides`` builds once per mesh
(each face side's flat cell; in another shard's block, that block's all-gathered
boundary surface, 0 inside it): bitwise ``ddmc_face_probs`` on 1D, 2D and 3D
uniform forests (periodic and not) and on refined forests (those of
``tests/test_torch_smr.py`` and ``tests/test_torch_spatial.py``), in float32 and
float64, bitwise ``ddmc_face_probs_spatial`` at 2 and 4 shards, and within the
tolerance of those tests of the JAX package's ``ddmc_face_probs``.

On a GPU, ``tests/test_torch_cuda.py`` holds the kernel itself bitwise against
the same plain versions."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.ops import fleck as jfleck
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.ops import fleck as tfleck
from jaybenne_tpu_torch.parallel import exchange, spatial
from jaybenne_tpu_torch.utils.constants import LAM_EXT
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
PERIODIC = {f"parthenon/mesh/{s}x{k}_bc": "periodic" for s in "io" for k in "123"}
PERIODIC_YZ = {f"parthenon/mesh/{s}x{k}_bc": "periodic" for s in "io" for k in "23"}
SMR_FOREST = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,  # test_torch_spatial.py
              "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8}
UNIFORM = {"parthenon/mesh/refinement": "none"}
# (deck, overrides) of each forest, cut to a CPU size
MESHES = {
    "1d": ("stepdiff_ddmc.in", {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 8}),
    "2d": ("stepdiff_smr_ddmc.in", {**SMR_FOREST, **UNIFORM}),
    "2d_periodic": ("stepdiff_smr_ddmc.in", {**SMR_FOREST, **UNIFORM, **PERIODIC}),
    # the 64^3 DDMC row's layout: 3D blocks, y and z periodic
    "3d_periodic_yz": ("stepdiff.in", {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8,
                                       "parthenon/mesh/nx3": 8, "parthenon/meshblock/nx1": 4,
                                       "parthenon/meshblock/nx2": 4,
                                       "parthenon/meshblock/nx3": 4, **PERIODIC_YZ}),
    "refined_2d": ("stepdiff_smr_ddmc.in", SMR_FOREST),
    "refined_2d_periodic": ("stepdiff_smr_ddmc.in", {**SMR_FOREST, **PERIODIC}),
    "refined_3d": ("stepdiff_3d_smr_ddmc.in",  # test_torch_smr.py's 3d_level1
                   {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8,
                    "parthenon/mesh/nx3": 8, "parthenon/meshblock/nx1": 4,
                    "parthenon/meshblock/nx2": 4, "parthenon/meshblock/nx3": 4}),
}
TAU = 5.0
PROB_RTOL = 1e-6  # tests/test_torch_smr.py's, against the JAX package
# the forests held against the JAX package here too (the 2D ones are in
# tests/test_torch_spatial.py and tests/test_torch_smr.py)
JAX_HELD = ("1d", "2d_periodic", "3d_periodic_yz", "refined_3d")


def _meshes(name, dtype):
    deck, mods = MESHES[name]
    path = os.path.join(INPUTS, deck)
    tcfg = tcm.from_deck(TDeck.from_file(path).update(dict(mods)))
    jcfg = jcm.from_deck(JDeck.from_file(path).update(dict(mods)))
    return tcfg, jcfg, tbuild_mesh(tcfg.mesh, dtype=dtype)


def _sigma(mesh, n_blocks, dtype, seed):
    """sigma_t whose tau straddles TAU on every level."""
    rng = np.random.default_rng(seed)
    dmin = float(mesh.block_dx[:, : mesh.ndim].min())
    shape = (n_blocks, mesh.nz, mesh.ny, mesh.nx)
    return torch.from_numpy((TAU / dmin) * np.exp(rng.uniform(-2.0, 1.5, shape))).to(dtype)


def _faces_from_map(mesh, sigmas, surfs, offsets, periodic, dtype):
    """The face kernel's launch in PyTorch: each shard's faces of its blocks
    [offsets[g], offsets[g] + Bl) from the side map, a side in the shard's own
    blocks read from its sigma_t, one elsewhere from the surfaces (0 inside a
    block), tau = sigma_t dx of the side's block, 2 lambda_ext at or below TAU,
    P = 2 / (3 (lower + upper)); padding blocks 0."""
    sides = tfleck.face_sides(mesh, periodic, dtype)
    Bl, nz, ny, nx = sigmas[0].shape
    ncell = nz * ny * nx
    index = torch.from_numpy(tfleck._surface_index(nz, ny, nx)).long()
    tau = torch.tensor(TAU, dtype=dtype)
    thin = torch.tensor(2.0 * LAM_EXT, dtype=dtype)
    out = []
    for g, (sig, off) in enumerate(zip(sigmas, offsets)):
        faces = []
        for a, shape in enumerate(tfleck._face_shapes(Bl, nz, ny, nx)):
            p = torch.zeros(shape, dtype=dtype)
            if sides[a] is not None:
                fpb = int(np.prod(shape[1:]))
                real = max(0, min(Bl, mesh.n_blocks - off))
                taus = []
                for cell in (s[off * fpb:(off + real) * fpb].long() for s in sides[a]):
                    b, r = cell // ncell, cell % ncell
                    own = b - off
                    value = sig.reshape(-1)[own.clamp(0, Bl - 1) * ncell + r]
                    if surfs is not None:
                        q = index[r]
                        far = torch.where(q >= 0, surfs[g][b, q.clamp(min=0)], 0.0)
                        value = torch.where((own >= 0) & (own < Bl), value, far)
                    t = value * mesh.block_dx[b, a]
                    taus.append(torch.where(t > tau, t, thin))
                p.view(-1)[:real * fpb] = 2.0 / (3.0 * (taus[0] + taus[1]))
            faces.append(p)
        out.append(tuple(faces))
    return out


def _bitwise(a, b):
    view = torch.int64 if a.element_size() == 8 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("name,dtype", [
    ("1d", torch.float32), ("2d", torch.float32), ("2d_periodic", torch.float32),
    ("3d_periodic_yz", torch.float32), ("3d_periodic_yz", torch.float64),
    ("refined_2d", torch.float32), ("refined_2d", torch.float64),
    ("refined_2d_periodic", torch.float32), ("refined_3d", torch.float32)])
def test_map_faces_bitwise_plain(name, dtype):
    """The faces from the side map are bitwise ``ddmc_face_probs``; in float32
    within PROB_RTOL of the JAX package's (JAX_HELD); the map is built once per
    mesh."""
    tcfg, jcfg, mesh = _meshes(name, dtype)
    assert (mesh.max_level > 0) == name.startswith("refined")
    periodic = tcfg.mesh.periodic_flags
    sig = _sigma(mesh, mesh.n_blocks, dtype, seed=len(name))
    want = tfleck.ddmc_face_probs(mesh, sig, TAU, periodic, dtype)
    (got,) = _faces_from_map(mesh, [sig], None, [0], periodic, dtype)
    for a, (g, w) in enumerate(zip(got, want)):
        assert _bitwise(g, w), a
        assert bool((g > 0).all()) == (a < mesh.ndim)
    sides = tfleck.face_sides(mesh, periodic, dtype)
    assert tfleck.face_sides(mesh, periodic, dtype) is sides
    assert [s is None for s in sides] == [a >= mesh.ndim for a in range(3)]
    if dtype == torch.float32 and name in JAX_HELD:
        jmesh = jbuild_mesh(jcfg.mesh)
        jw = jfleck.ddmc_face_probs(jmesh, jnp.asarray(sig.numpy()), TAU,
                                    jcfg.mesh.periodic_flags, jnp.float32)
        for a, (g, w) in enumerate(zip(got, jw)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PROB_RTOL, err_msg=str(a))


@pytest.mark.parametrize("name", ["2d", "refined_2d"])
@pytest.mark.parametrize("n", [2, 4])
def test_map_faces_bitwise_spatial(name, n):
    """Every shard's faces from the map, its own sigma_t and the all-gathered
    surfaces, in one pass, are bitwise ``ddmc_face_probs_spatial``'s
    (``ddmc_face_probs_shards``' plain version), padding blocks 0."""
    tcfg, _, mesh = _meshes(name, torch.float32)
    periodic = tcfg.mesh.periodic_flags
    bl = spatial.blocks_per_shard(mesh, n)
    sig = _sigma(mesh, n * bl, torch.float32, seed=n)
    sigmas = [sig[s * bl:(s + 1) * bl] for s in range(n)]
    surfs = exchange.InProcess(n).all_gather([tfleck.pack_boundary_surface(mesh, t)
                                              for t in sigmas])
    offsets = [s * bl for s in range(n)]
    want = tfleck.ddmc_face_probs_shards(mesh, sigmas, surfs, offsets, TAU, periodic,
                                         torch.float32)
    got = _faces_from_map(mesh, sigmas, surfs, offsets, periodic, torch.float32)
    for s, (gs, ws) in enumerate(zip(got, want)):
        for a, (g, w) in enumerate(zip(gs, ws)):
            assert _bitwise(g, w), (s, a)
    if n * bl > mesh.n_blocks:  # the last shard's padding blocks
        assert not bool(got[-1][0][mesh.n_blocks - (n - 1) * bl:].any())
