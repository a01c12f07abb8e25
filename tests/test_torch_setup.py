"""The PyTorch port's setup path against the JAX package: deck -> config, mesh,
problem generator, Fleck factor and transport coefficients, on the stepdiff deck
(one 128-cell block, the gate's size) and on the deck as shipped (two 50-cell
blocks). Both packages get the same deck; the port's results are compared with the
JAX package's on the CPU."""

import dataclasses
import enum
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.models.problems import generate_problem as jgenerate
from jaybenne_tpu.ops import fleck as jfleck
from jaybenne_tpu.ops import transport as jT
from jaybenne_tpu.state import empty_fields as jempty_fields
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.models.problems import generate_problem as tgenerate
from jaybenne_tpu_torch.ops import fleck as tfleck
from jaybenne_tpu_torch.ops import transport as tT
from jaybenne_tpu_torch.state import empty_fields as tempty_fields
from jaybenne_tpu_torch.step import build_step_core
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
DECKS = {
    "gate_1block": {"parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 128},
    "shipped_2block": {},
}
# float32 scalar setup math may round in another order in the two packages
RTOL = 1e-6


def _configs(mods):
    return (
        jcm.from_deck(JDeck.from_file(STEPDIFF).update(dict(mods))),
        tcm.from_deck(TDeck.from_file(STEPDIFF).update(dict(mods))),
    )


def _plain(obj):
    """Config dataclasses as nested plain values (enums by value)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, tuple):
        return tuple(_plain(v) for v in obj)
    return obj


def _setup(mods):
    jcfg, tcfg = _configs(mods)
    jmesh = jbuild_mesh(jcfg.mesh)
    tmesh = tbuild_mesh(tcfg.mesh)
    jf = jgenerate(
        jempty_fields(jmesh.n_blocks, jmesh.nz, jmesh.ny, jmesh.nx), jmesh, jcfg, jnp.float32
    )
    tf = tgenerate(
        tempty_fields(tmesh.n_blocks, tmesh.nz, tmesh.ny, tmesh.nx), tmesh, tcfg, torch.float32
    )
    return jcfg, tcfg, jmesh, tmesh, jf, tf


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_config_matches_jax(deck):
    jcfg, tcfg = _configs(DECKS[deck])
    assert _plain(tcfg) == _plain(jcfg)
    assert tcfg.jaybenne.dtype == torch.float32


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_build_mesh_matches_jax(deck):
    jcfg, tcfg = _configs(DECKS[deck])
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    assert tmesh.n_blocks == (1 if deck == "gate_1block" else 2)
    for name in ("ndim", "nx", "ny", "nz", "n_blocks", "max_level", "bounds",
                 "tile_shape", "root_grid", "finest"):
        assert getattr(tmesh, name) == getattr(jmesh, name), name
    for name in ("block_origin", "block_dx", "block_level", "lookup"):
        np.testing.assert_array_equal(getattr(tmesh, name).numpy(), np.asarray(getattr(jmesh, name)))
    np.testing.assert_allclose(
        tmesh.block_volume.numpy(), np.asarray(jmesh.block_volume), rtol=RTOL
    )
    # the bridge rebuilds the same geometry from the JAX mesh's arrays
    d = {f.name: (np.asarray(getattr(jmesh, f.name)) if f.name in (
        "block_origin", "block_dx", "block_level", "lookup") else getattr(jmesh, f.name))
        for f in dataclasses.fields(jmesh)}
    bm = bridge.state_from_numpy(d)
    for name in ("block_origin", "block_dx", "block_level", "lookup"):
        assert torch.equal(getattr(bm, name), getattr(tmesh, name)), name
    assert bridge.state_to_numpy(bm)["bounds"] == jmesh.bounds


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_generate_problem_matches_jax(deck):
    _, _, jmesh, tmesh, jf, tf = _setup(DECKS[deck])
    for name in ("rho", "sie", "u"):
        np.testing.assert_allclose(
            getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), rtol=RTOL
        )
    for a, b in zip(tmesh.cell_centers(), jmesh.cell_centers()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-7)
    # the hot/cold step sits at x = 0
    assert (tf.sie.numpy()[..., :] > 1e3).sum() == tf.sie.numel() // 2


@pytest.mark.parametrize("deck", sorted(DECKS))
@pytest.mark.parametrize("opacity", [None, 0.5])
def test_fleck_and_coefs_match_jax(deck, opacity):
    mods = dict(DECKS[deck])
    if opacity is not None:  # exercise the emissivity term of the Fleck factor
        mods.update({"mcblock/opacity_model": "constant",
                     "mcblock/opacity_constant_value": opacity})
    jcfg, tcfg, jmesh, tmesh, jf, tf = _setup(mods)
    dt = jcfg.jaybenne.dt
    jm, tm = jcfg.mcblock, tcfg.mcblock
    jfl = jfleck.fleck_factor(jf.rho, jf.sie, jm.build_eos(), jm.build_opacity(), dt, jnp.float32)
    tfl = tfleck.fleck_factor(tf.rho, tf.sie, tm.build_eos(), tm.build_opacity(), dt, torch.float32)
    np.testing.assert_allclose(tfl.numpy(), np.asarray(jfl), rtol=RTOL)
    if opacity is None:
        assert bool((tfl == 1.0).all())  # no absorption: the Fleck factor is exactly 1
    else:
        assert float(tfl.min()) < 0.999

    jf = dataclasses.replace(jf, fleck=jfl)
    tf = dataclasses.replace(tf, fleck=tfl)
    jc = jT.precompute_coefs(jf, jmesh, jm.build_eos(), jm.build_opacity(),
                             jm.build_scattering(), False, jnp.float32)
    tc = tT.precompute_coefs(tf, tmesh, tm.build_eos(), tm.build_opacity(),
                             tm.build_scattering(), False, torch.float32)
    # the bridge carries the JAX coefficients over (ignoring the DDMC face arrays)
    bc = bridge.state_from_numpy(
        {f.name: np.asarray(getattr(jc, f.name)) for f in dataclasses.fields(jc)
         if getattr(jc, f.name) is not None}
    )
    for name in ("sigma_a", "sigma_s", "fleck"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), rtol=RTOL
        )
        np.testing.assert_array_equal(getattr(bc, name).numpy(), np.asarray(getattr(jc, name)))
    assert float(tc.sigma_s[0]) == 1.0e3


@pytest.mark.parametrize(
    "mods, where",
    [
        ({"mcblock/eos_model": "power_law_cv"}, "item 14"),
        ({"mcblock/opacity_model": "ep_bremss"}, "item 14"),
        ({"mcblock/scattering_model": "thomson"}, "item 14"),
        ({"jaybenne/use_ddmc": "true"}, "K1(c)"),
        ({"mcblock/opacity_model": "constant", "mcblock/opacity_constant_value": 1.0}, "K1(b)"),
        ({"jaybenne/do_emission": "true"}, "item 11"),
        ({"jaybenne/precision": "f64"}, "item 7"),
        ({"jaybenne/n_devices": 2}, "item 17"),
        ({"parthenon/output0/file_type": "rst"}, "item 16"),
    ],
)
def test_unported_configurations_raise(mods, where, tmp_path):
    """Every configuration outside the slice raises and names its ROADMAP item; none
    falls back to another path."""
    _, tcfg = _configs(mods)
    with pytest.raises(NotImplementedError, match="ROADMAP .*" + re.escape(where)):
        Simulation(tcfg, outdir=str(tmp_path), quiet=True, device="cpu")


def test_unported_2d_raises():
    mods = {"parthenon/mesh/nx2": 4, "parthenon/meshblock/nx2": 4}
    _, tcfg = _configs(mods)
    with pytest.raises(NotImplementedError, match=r"K1\(e\)"):
        build_step_core(tbuild_mesh(tcfg.mesh), tcfg)
