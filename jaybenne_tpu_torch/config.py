"""Runtime configuration (port of ``jaybenne_tpu/config.py``).

The same ``<block> key = value`` decks, parsed by :mod:`.utils.deck` into the typed
dataclasses below, with the JAX package's parameter names, defaults and validation.
Every key parses, so a deck means the same thing to both packages, and the port
runs every configuration the JAX package runs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .models import eos as eos_models
from .models import opacity as opacity_models
from .utils.deck import Deck, DeckError


class SourceStrategy(enum.Enum):
    uniform = "uniform"
    energy = "energy"  # parsed but rejected at runtime, like the reference


class InitialRadiation(enum.Enum):
    none = "none"
    thermal = "thermal"


class BC(enum.Enum):
    """Particle (swarm) boundary conditions per domain face."""

    periodic = "periodic"
    outflow = "outflow"
    reflecting = "jaybenne_reflecting"


@dataclasses.dataclass(frozen=True)
class RefinementRegion:
    level: int
    x1min: float
    x1max: float
    x2min: float
    x2max: float
    x3min: float
    x3max: float


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """``<parthenon/mesh>`` + ``<parthenon/meshblock>`` +
    ``<parthenon/static_refinement*>``."""

    nx1: int
    nx2: int
    nx3: int
    x1min: float
    x1max: float
    x2min: float
    x2max: float
    x3min: float
    x3max: float
    # meshblock size (defaults to whole mesh = single block)
    mbnx1: int = 0
    mbnx2: int = 0
    mbnx3: int = 0
    refinement: str = "none"
    refinement_regions: tuple = ()
    # particle BCs per face, from <parthenon/swarm>
    swarm_bc: tuple = (BC.periodic,) * 6  # (ix1, ox1, ix2, ox2, ix3, ox3)
    # field BCs per face, from <parthenon/mesh> ix1_bc etc.
    field_bc: tuple = ("periodic",) * 6

    @property
    def periodic_flags(self):
        """(x, y, z) periodicity of the field ghost semantics."""
        return (
            self.field_bc[0] == "periodic",
            self.field_bc[2] == "periodic",
            self.field_bc[4] == "periodic",
        )

    @property
    def ndim(self) -> int:
        return 3 if self.nx3 > 1 else (2 if self.nx2 > 1 else 1)

    @property
    def block_shape(self):
        """(nx3, nx2, nx1) cells per block."""
        return (self.mbnx3 or self.nx3, self.mbnx2 or self.nx2, self.mbnx1 or self.nx1)


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    tlim: float
    integrator: str = "rk1"


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    file_type: str = "hdf5"
    dt: float = 0.0
    variables: tuple = ()
    swarms: tuple = ()
    swarm_variables: tuple = ()


@dataclasses.dataclass(frozen=True)
class JaybenneConfig:
    """``<jaybenne>`` parameters, including the JAX package's extensions."""

    num_particles: int
    dt: float = float(np.finfo(np.float64).max)
    min_swarm_occupancy: float = 0.0
    numin: float = float(np.finfo(np.float64).tiny)
    numax: float = float(np.finfo(np.float64).max)
    unique_rank_seeds: bool = True
    seed: int = 123
    max_transport_iterations: int = 10000
    use_ddmc: bool = False
    tau_ddmc: float = 5.0
    source_strategy: SourceStrategy = SourceStrategy.uniform
    do_emission: bool = True
    do_feedback: bool = True
    # particle-ledger capacity headroom over num_particles
    capacity_factor: float = 2.0
    precision: str = "f32"
    n_devices: int = 1
    decomposition: str = "particle"
    # census kernel: "auto" and "on" run the CUDA kernel on a GPU; "off" runs the
    # kernel's plain PyTorch version (the only way to run it on a GPU)
    use_pallas: str = "auto"
    max_migration_rounds: int = 128
    migration_buffer_k: int = 0
    census_iters_per_round: int = 128
    debug_checks: bool = False
    external_source_q: float = 0.0
    external_source_tmax: float = 1e300
    external_source_box: Optional[tuple] = None
    external_source_num: int = 0
    external_source_temperature: float = 0.0

    def __post_init__(self):
        if not (0.0 <= self.min_swarm_occupancy < 1.0):
            raise DeckError("min_swarm_occupancy must be >= 0 and < 1")
        if self.source_strategy == SourceStrategy.energy:
            raise DeckError("Energy source strategy not implemented!")
        if self.precision not in ("f32", "f64"):
            raise DeckError("precision must be f32 or f64")
        if self.decomposition not in ("particle", "spatial"):
            raise DeckError("decomposition must be particle or spatial")
        if self.use_pallas not in ("auto", "on", "off"):
            raise DeckError("use_pallas must be auto, on or off")
        if self.census_iters_per_round < 0:
            raise DeckError("census_iters_per_round must be >= 0")
        if self.max_migration_rounds < 1:
            raise DeckError("max_migration_rounds must be >= 1")
        if self.migration_buffer_k < 0:
            raise DeckError("migration_buffer_k must be >= 0")
        if self.external_source_q < 0:
            raise DeckError("external_source must be >= 0")
        if self.external_source_num < 0:
            raise DeckError("external_source_num must be >= 0")

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "f64" else torch.float32


@dataclasses.dataclass(frozen=True)
class McblockConfig:
    """``<mcblock>`` parameters."""

    problem_id: str
    initial_temperature: float
    initial_density: float
    initial_radiation: InitialRadiation
    gamma: float = 1.66666666667
    cv: Optional[float] = None
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0
    opacity_model: str = "none"
    opacity_constant_value: float = 0.0
    opacity_table_file: str = ""
    scattering_model: str = "none"
    scattering_constant_value: float = 0.0
    apm: float = 1.0
    eos_model: str = "ideal"
    cv_alpha: float = 1.0
    cv_exponent: float = 3.0

    def _scales(self):
        return dict(
            time_scale=self.time_scale,
            mass_scale=self.mass_scale,
            length_scale=self.length_scale,
            temperature_scale=self.temperature_scale,
        )

    def build_eos(self):
        if self.eos_model == "power_law_cv":
            base = eos_models.PowerLawCv(alpha=self.cv_alpha, n=self.cv_exponent)
        elif self.eos_model == "ideal":
            cv = self.cv if self.cv is not None else 1.0 / (self.gamma - 1.0)
            base = eos_models.IdealGas(gm1=self.gamma - 1.0, cv=cv)
        else:
            raise DeckError("Only ideal or power_law_cv eos models supported!")
        return eos_models.UnitSystemEOS(base, **self._scales())

    def build_opacity(self):
        if self.opacity_model == "none":
            base = opacity_models.Gray(0.0)
        elif self.opacity_model == "constant":
            base = opacity_models.Gray(self.opacity_constant_value)
        elif self.opacity_model == "ep_bremss":
            base = opacity_models.EPBremss()
        elif self.opacity_model == "table":
            base = opacity_models.TabulatedOpacity.from_file(self.opacity_table_file)
        else:
            raise DeckError(
                "Only none, constant, ep_bremss, or table opacity models supported!"
            )
        return opacity_models.NonCGSUnits(base, **self._scales())

    def build_scattering(self):
        if self.scattering_model == "none":
            base = opacity_models.GrayS(0.0, self.apm)
        elif self.scattering_model == "constant":
            base = opacity_models.GrayS(self.scattering_constant_value, self.apm)
        elif self.scattering_model == "thomson":
            base = opacity_models.ThomsonS(self.apm)
        else:
            raise DeckError("Only none or constant scattering models supported!")
        return opacity_models.NonCGSUnitsS(base, **self._scales())


@dataclasses.dataclass(frozen=True)
class RunConfig:
    problem_id: str
    mesh: MeshConfig
    time: TimeConfig
    jaybenne: JaybenneConfig
    mcblock: McblockConfig
    outputs: tuple = ()


def _parse_bcs(deck: Deck) -> tuple:
    faces = ["ix1_bc", "ox1_bc", "ix2_bc", "ox2_bc", "ix3_bc", "ox3_bc"]
    out = []
    for f in faces:
        name = deck.get_or_add_str("parthenon/swarm", f, "periodic")
        try:
            out.append(BC(name))
        except ValueError:
            raise DeckError(f"unknown swarm boundary condition {name!r}") from None
    return tuple(out)


def _parse_refinement(deck: Deck) -> tuple:
    regions = []
    for block in deck.blocks:
        if block.startswith("parthenon/static_refinement"):
            regions.append(
                RefinementRegion(
                    level=deck.get_int(block, "level"),
                    x1min=deck.get_real(block, "x1min"),
                    x1max=deck.get_real(block, "x1max"),
                    x2min=deck.get_or_add_real(block, "x2min", -0.5),
                    x2max=deck.get_or_add_real(block, "x2max", 0.5),
                    x3min=deck.get_or_add_real(block, "x3min", -0.5),
                    x3max=deck.get_or_add_real(block, "x3max", 0.5),
                )
            )
    return tuple(regions)


def from_deck(deck: Deck) -> RunConfig:
    """Build the full static run configuration from a parsed deck."""
    problem_id = deck.get_str("parthenon/job", "problem_id")

    mb = "parthenon/meshblock" in deck.blocks
    mesh = MeshConfig(
        nx1=deck.get_int("parthenon/mesh", "nx1"),
        nx2=deck.get_or_add_int("parthenon/mesh", "nx2", 1),
        nx3=deck.get_or_add_int("parthenon/mesh", "nx3", 1),
        x1min=deck.get_real("parthenon/mesh", "x1min"),
        x1max=deck.get_real("parthenon/mesh", "x1max"),
        x2min=deck.get_or_add_real("parthenon/mesh", "x2min", -0.5),
        x2max=deck.get_or_add_real("parthenon/mesh", "x2max", 0.5),
        x3min=deck.get_or_add_real("parthenon/mesh", "x3min", -0.5),
        x3max=deck.get_or_add_real("parthenon/mesh", "x3max", 0.5),
        mbnx1=deck.get_or_add_int("parthenon/meshblock", "nx1", 0) if mb else 0,
        mbnx2=deck.get_or_add_int("parthenon/meshblock", "nx2", 0) if mb else 0,
        mbnx3=deck.get_or_add_int("parthenon/meshblock", "nx3", 0) if mb else 0,
        refinement=deck.get_or_add_str("parthenon/mesh", "refinement", "none"),
        refinement_regions=_parse_refinement(deck),
        swarm_bc=_parse_bcs(deck),
        field_bc=tuple(
            deck.get_or_add_str("parthenon/mesh", f, "periodic")
            for f in ("ix1_bc", "ox1_bc", "ix2_bc", "ox2_bc", "ix3_bc", "ox3_bc")
        ),
    )

    time = TimeConfig(
        tlim=deck.get_real("parthenon/time", "tlim"),
        integrator=deck.get_or_add_str("parthenon/time", "integrator", "rk1"),
    )
    if time.integrator != "rk1":
        raise DeckError("McBlock driver only supports first order time integration")

    jb = JaybenneConfig(
        num_particles=deck.get_int("jaybenne", "num_particles"),
        dt=deck.get_or_add_real("jaybenne", "dt", 1e300),
        min_swarm_occupancy=deck.get_or_add_real("jaybenne", "min_swarm_occupancy", 0.0),
        numin=deck.get_or_add_real("jaybenne", "numin", 1e-300),
        numax=deck.get_or_add_real("jaybenne", "numax", 1e300),
        unique_rank_seeds=deck.get_or_add_bool("jaybenne", "unique_rank_seeds", True),
        seed=deck.get_or_add_int("jaybenne", "seed", 123),
        max_transport_iterations=deck.get_or_add_int(
            "jaybenne", "max_transport_iterations", 10000
        ),
        use_ddmc=deck.get_or_add_bool("jaybenne", "use_ddmc", False),
        tau_ddmc=deck.get_or_add_real("jaybenne", "tau_ddmc", 5.0),
        source_strategy=SourceStrategy(
            deck.get_or_add_str("jaybenne", "source_strategy", "uniform")
        ),
        do_emission=deck.get_or_add_bool("jaybenne", "do_emission", True),
        do_feedback=deck.get_or_add_bool("jaybenne", "do_feedback", True),
        capacity_factor=deck.get_or_add_real("jaybenne", "capacity_factor", 2.0),
        precision=deck.get_or_add_str("jaybenne", "precision", "f32"),
        n_devices=deck.get_or_add_int("jaybenne", "n_devices", 1),
        decomposition=deck.get_or_add_str("jaybenne", "decomposition", "particle"),
        use_pallas=deck.get_or_add_str("jaybenne", "use_pallas", "auto"),
        max_migration_rounds=deck.get_or_add_int("jaybenne", "max_migration_rounds", 128),
        migration_buffer_k=deck.get_or_add_int("jaybenne", "migration_buffer_k", 0),
        census_iters_per_round=deck.get_or_add_int(
            "jaybenne", "census_iters_per_round", 128
        ),
        debug_checks=deck.get_or_add_bool("jaybenne", "debug_checks", False),
        external_source_q=deck.get_or_add_real("jaybenne", "external_source", 0.0),
        external_source_tmax=deck.get_or_add_real(
            "jaybenne", "external_source_tmax", 1e300
        ),
        external_source_box=tuple(
            deck.get_or_add_real("jaybenne", f"external_source_{k}", d)
            for k, d in (
                ("x1min", mesh.x1min), ("x1max", mesh.x1max),
                ("x2min", mesh.x2min), ("x2max", mesh.x2max),
                ("x3min", mesh.x3min), ("x3max", mesh.x3max),
            )
        ),
        external_source_num=deck.get_or_add_int("jaybenne", "external_source_num", 0),
        external_source_temperature=deck.get_or_add_real(
            "jaybenne", "external_source_temperature", 0.0
        ),
    )

    gamma = deck.get_or_add_real("mcblock", "gamma", 1.66666666667)
    mc = McblockConfig(
        problem_id=problem_id,
        initial_temperature=deck.get_real("mcblock", "initial_temperature"),
        initial_density=deck.get_real("mcblock", "initial_density"),
        initial_radiation=InitialRadiation(deck.get_str("mcblock", "initial_radiation")),
        gamma=gamma,
        cv=deck.get_or_add_real("mcblock", "cv", 1.0 / (gamma - 1.0)),
        time_scale=deck.get_or_add_real("mcblock", "time_scale", 1.0),
        mass_scale=deck.get_or_add_real("mcblock", "mass_scale", 1.0),
        length_scale=deck.get_or_add_real("mcblock", "length_scale", 1.0),
        temperature_scale=deck.get_or_add_real("mcblock", "temperature_scale", 1.0),
        opacity_model=deck.get_str("mcblock", "opacity_model"),
        opacity_constant_value=(
            deck.get_real("mcblock", "opacity_constant_value")
            if deck.has("mcblock", "opacity_constant_value")
            else 0.0
        ),
        opacity_table_file=deck.get_or_add_str("mcblock", "opacity_table_file", ""),
        scattering_model=deck.get_or_add_str("mcblock", "scattering_model", "none"),
        scattering_constant_value=(
            deck.get_real("mcblock", "scattering_constant_value")
            if deck.has("mcblock", "scattering_constant_value")
            else 0.0
        ),
        apm=deck.get_or_add_real("mcblock", "apm", 1.0),
        eos_model=deck.get_or_add_str("mcblock", "eos_model", "ideal"),
        cv_alpha=deck.get_or_add_real("mcblock", "cv_alpha", 1.0),
        cv_exponent=deck.get_or_add_real("mcblock", "cv_exponent", 3.0),
    )

    outputs = []
    for block in deck.blocks:
        if block.startswith("parthenon/output"):
            outputs.append(
                OutputConfig(
                    file_type=deck.get_or_add_str(block, "file_type", "hdf5"),
                    dt=deck.get_or_add_real(block, "dt", 0.0),
                    variables=tuple(
                        deck.get_list(block, "variables") if deck.has(block, "variables") else ()
                    ),
                    swarms=tuple(
                        deck.get_list(block, "swarms") if deck.has(block, "swarms") else ()
                    ),
                    swarm_variables=tuple(
                        deck.get_list(block, "swarm_variables")
                        if deck.has(block, "swarm_variables")
                        else ()
                    ),
                )
            )

    return RunConfig(
        problem_id=problem_id,
        mesh=mesh,
        time=time,
        jaybenne=jb,
        mcblock=mc,
        outputs=tuple(outputs),
    )


def from_file(path) -> RunConfig:
    return from_deck(Deck.from_file(path))
