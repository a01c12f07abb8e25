"""K1(a): the port's census (``jaybenne_tpu_torch/ops/transport_kernel.py``) against
the JAX kernel run as ``tests/test_pallas.py`` runs it (``transport_pallas(...,
interpret=True)``) and against the JAX XLA event loop (``T.transport``).

The ledger is the 100-cell, 2-block forest of ``tests/test_pallas.py``, which
exercises the uniform-forest collapse, with particles in the middle and next to
both reflecting walls. sigma_s = 256 makes the JAX kernel's bf16 (p_abs, 1/sigma_t)
pair exact (1/256 is a power of two), so its table equals the port's f32 table and
both draw the same K2 variates per slot: over the first events the two agree
particle by particle. Over a full census the float32 ``log`` of the two packages
may differ by an ulp, a rare branch flip then separates one history, and the
comparison is statistical."""

import dataclasses

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.ops import transport as jT
from jaybenne_tpu.ops.pallas_transport import TILE, transport_pallas
from jaybenne_tpu.particles import ParticleLedger as JLedger
from jaybenne_tpu.step import make_transport_params as jparams
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

DECK = """
<parthenon/job>
problem_id = stepdiff
<parthenon/mesh>
nx1 = 100
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting
<parthenon/meshblock>
nx1 = 50
<parthenon/time>
tlim = 3.335641e-11
<jaybenne>
num_particles = 4000
dt = 3.335641e-11
do_emission = false
do_feedback = false
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 256.0
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""
SIGMA_S = 256.0
N = 4000
N_WALL = 8        # particles a hair from each wall, flying into it
C = 2.99792458e10
KEY = jr.PRNGKey(20261016)
# per-particle agreement over the first events: one ulp of log may flip a branch
INT_AGREE = 0.999
FLOAT_RTOL = 1e-5
# absolute floors, where XLA rounds a cancelling expression differently: positions
# within a block [cm]; velocities, since sqrt(1 - mu^2) magnifies the rounding of
# 1 - mu^2 near |mu| = 1; tau, which adds d / (c dt) per event with d a difference of
# positions of order 1 cm in the collapsed block, where one f32 ulp is 6e-8 cm
FLOAT_ATOL = {"x": 1e-8, "vx": 1e-6 * C, "vy": 1e-6 * C, "vz": 1e-6 * C, "tau": 1e-6}
# full census, the checks of tests/test_pallas.py
MEAN_ATOL = 0.01
STD_RTOL = 0.10
EVENTS_RTOL = 0.05


def _ledger_np():
    """Numpy ledger of TILE slots: N live particles in three groups (lower wall
    cell, mid block 0, upper wall cell) with isotropic directions, plus N_WALL
    particles at each wall flying straight into it."""
    rng = np.random.default_rng(7)
    dxc = 0.01
    f = lambda: np.zeros(TILE, np.float32)  # noqa: E731
    i = lambda: np.zeros(TILE, np.int32)  # noqa: E731
    d = dict(x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(), tau=f(), weight=f(),
             energy=f(), block=i(), i=i(), j=i(), k=i(), face=i(),
             alive=np.zeros(TILE, bool), absorbed=np.zeros(TILE, bool))
    grp = np.arange(N) % 3
    blk = np.where(grp == 2, 1, 0)
    cell = np.choose(grp, [0, 25, 49])
    d["block"][:N], d["i"][:N] = blk, cell
    d["x"][:N] = (cell + rng.random(N)) * dxc
    mu = 1.0 - 2.0 * rng.random(N)
    phi = 2 * np.pi * rng.random(N)
    st = np.sqrt(1.0 - mu * mu)
    d["vx"][:N], d["vy"][:N], d["vz"][:N] = C * mu, C * st * np.cos(phi), C * st * np.sin(phi)
    w = slice(N, N + 2 * N_WALL)
    lower = np.arange(2 * N_WALL) < N_WALL
    d["block"][w] = np.where(lower, 0, 1)
    d["i"][w] = np.where(lower, 0, 49)
    d["x"][w] = np.where(lower, 1e-6, 0.5 - 1e-6)
    d["vx"][w] = np.where(lower, -C, C)
    d["alive"][: N + 2 * N_WALL] = True
    d["weight"][: N + 2 * N_WALL] = 1.0
    return d


def _setup(max_iters=None, bc="jaybenne_reflecting"):
    mods = {"parthenon/swarm/ix1_bc": bc, "parthenon/swarm/ox1_bc": bc}
    jcfg = jcm.from_deck(JDeck.parse(DECK).update(mods))
    tcfg = tcm.from_deck(TDeck.parse(DECK).update(mods))
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    if max_iters is not None:
        jprm = dataclasses.replace(jprm, max_iters=max_iters)
        tprm = dataclasses.replace(tprm, max_iters=max_iters)
    d = _ledger_np()
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()}, leak=jnp.zeros(TILE, jnp.int32))
    tl = bridge.state_from_numpy(d)
    nc = jmesh.total_cells
    jc = jT.TransportCoefs(
        sigma_a=jnp.zeros((nc,)), sigma_s=jnp.full((nc,), SIGMA_S), fleck=jnp.ones((nc,)),
        px=jnp.zeros((2, 1, 1, 51)), py=jnp.zeros((2, 1, 2, 50)), pz=jnp.zeros((2, 2, 1, 50)),
    )
    tc = TransportCoefs(sigma_a=torch.zeros(nc), sigma_s=torch.full((nc,), SIGMA_S),
                        fleck=torch.ones(nc))
    seed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    return jcfg.jaybenne.dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed


def _np(ledger):
    return {k: np.asarray(v) for k, v in (
        bridge.state_to_numpy(ledger) if not isinstance(ledger, JLedger)
        else {f.name: getattr(ledger, f.name) for f in dataclasses.fields(ledger)}
    ).items()}


@pytest.mark.parametrize(
    "max_iters, bc",
    [(1, "jaybenne_reflecting"), (8, "jaybenne_reflecting"), (1, "periodic"), (8, "outflow")],
)
def test_first_events_match_jax_kernel_per_particle(max_iters, bc):
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed = _setup(max_iters, bc)
    jout, jit_, jev = transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt), interpret=True)
    tout, tit, tev = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    a, b = _np(tout), _np(jout)
    live = b["alive"]
    if bc == "outflow":  # the wall-bound particles leave; others may too
        assert not live[N : N + 2 * N_WALL].any()
        live = _np(tl)["weight"] > 0  # compare every slot that started live
    else:  # no absorption: nobody dies
        assert live.sum() == N + 2 * N_WALL
    same = (a["i"] == b["i"]) & (a["block"] == b["block"]) & (a["alive"] == b["alive"])
    assert same[live].mean() >= INT_AGREE, same[live].mean()
    ok = live & same
    for name in ("x", "vx", "vy", "vz", "tau"):
        np.testing.assert_allclose(a[name][ok], b[name][ok], rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL[name], err_msg=name)
    assert int(tit) == int(jit_) == max_iters
    assert abs(int(tev) - int(jev)) <= (1 - INT_AGREE) * int(jev) + 1
    assert tev.dtype == torch.int64
    if max_iters == 1:
        # the wall-bound particles reach their wall in the first event: reflected,
        # they turn back at it; periodic, they re-enter at the far wall
        w = slice(N, N + 2 * N_WALL)
        lower = np.arange(2 * N_WALL) < N_WALL
        flip = bc == "jaybenne_reflecting"
        for out in (a, b):
            want_vx = np.where(lower, -C, C) * (-1 if flip else 1)
            np.testing.assert_allclose(out["vx"][w], want_vx, rtol=1e-6)
            at_lower = lower if flip else ~lower
            np.testing.assert_allclose(out["x"][w], np.where(at_lower, 0.0, 0.5))
            np.testing.assert_array_equal(out["block"][w], np.where(at_lower, 0, 1))
            np.testing.assert_array_equal(out["i"][w], np.where(at_lower, 0, 49))


def test_full_census_matches_jax_kernel_and_xla_loop():
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed = _setup()
    jk, _, ev_k = transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt), interpret=True)
    jx, _, ev_x = jT.transport(jl, jc, jmesh, KEY, jprm, jnp.float32(dt))
    tout, _, ev_t = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    n_live = N + 2 * N_WALL
    a = _np(tout)
    assert a["alive"].sum() == n_live  # pure scattering between reflecting walls
    assert not (a["tau"][a["alive"]] < 1.0).any()  # census reached
    assert ((a["i"] >= 0) & (a["i"] < tmesh.nx)).all()
    gx_t = tout.global_position(tmesh)[0].numpy()[a["alive"]]
    assert (gx_t >= -0.5).all() and (gx_t <= 0.5).all()
    for ref, ev_r, name in ((jk, ev_k, "jax kernel"), (jx, ev_x, "xla loop")):
        alive = np.asarray(ref.alive)
        gx_r = np.asarray(ref.global_position(jmesh)[0])[alive]
        assert abs(gx_t.mean() - gx_r.mean()) < MEAN_ATOL, name
        assert abs(gx_t.std() - gx_r.std()) / gx_r.std() < STD_RTOL, name
        assert abs(int(ev_t) - int(ev_r)) / int(ev_r) < EVENTS_RTOL, name
