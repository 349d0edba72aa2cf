"""Typed configuration system.

The port's own copy of ``pylrbms_tpu/config.py`` (stdlib only).

The reference passes plain dicts hardcoded at script tops and stringly-typed
solver options (SURVEY.md §5.6: "No argparse, no config files, no env flags
... New framework: a real typed config system").  These dataclasses validate
early, provide defaults, and still accept the reference's dict spelling via
``from_dict`` (so the script-level dicts keep working).

Wiring (this module is the single validation funnel, not a parity-table
checkmark): every ``problems/*.init_grid_and_problem`` runs its config dict
through :func:`validate_config` (typos raise instead of silently falling
through ``dict.get`` defaults), and the model/solver layer runs solver-option
dicts through :func:`validate_solver_options` (``model.solve``,
``model.prepare_solver``, ``discretize``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

# every key any problem/discretizer/script-level config dict may carry
# (the reference's flat script-dict spelling, SURVEY.md §5.6)
FLAT_CONFIG_KEYS = frozenset({
    "num_subdomains", "half_num_fine_elements_per_subdomain_and_dim",
    "num_refinements", "grid_type",
    "initial_RB_order",
    "enrichment_target_error", "marking_doerfler_theta", "marking_max_age",
    "T", "nt", "dt",                      # parabolic script configs
    "num_grid_refinements",               # EOC scripts
})

GRID_TYPES_2D = ("tri", "crisscross", "alu", "quad", "yasp")
GRID_TYPES_3D = ("hex",)
GRID_TYPES = GRID_TYPES_2D + GRID_TYPES_3D

# every key the solver/option plumbing consumes (AssembledBlockOp.solve,
# model._mf_solve, model.solve post-check, mixed-precision refinement,
# greedy snapshot_options); a typo'd key used to silently fall through the
# dict gets — now it raises at the entry points
SOLVER_OPTION_KEYS = frozenset({
    "type", "precision", "max_iter", "post_check_solves_system",
    "post_check", "fallback", "return_iters", "two_level",
    "coarse_space", "coarse_modes",
    "mixed", "mixed_inner_tol", "mixed_rounds", "mixed_inner_maxiter",
})
SOLVER_TYPES = ("auto", "dense", "direct", "pcg", "mf_pcg")
COARSE_SPACES = ("modal", "harvested", "geneo")


def validate_solver_options(options: dict | None, where: str = "solver_options"):
    """Early validation of a stringly-typed solver-option dict.  Returns the
    dict unchanged (or None) so call sites can wrap in-line; raises
    ``ValueError`` on unknown keys or out-of-domain values."""
    if options is None:
        return None
    if isinstance(options, SolverConfig):
        return options.as_dict()
    unknown = set(options) - SOLVER_OPTION_KEYS
    if unknown:
        raise ValueError(
            f"unknown {where} key(s) {sorted(unknown)}; known keys: "
            f"{sorted(SOLVER_OPTION_KEYS)}")
    kind = options.get("type", "auto")
    if kind not in SOLVER_TYPES:
        raise ValueError(f"{where}['type'] = {kind!r} not in {SOLVER_TYPES}")
    cs = options.get("coarse_space")
    if cs is not None and cs not in COARSE_SPACES:
        raise ValueError(
            f"{where}['coarse_space'] = {cs!r} not in {COARSE_SPACES}")
    prec = options.get("precision")
    if prec is not None and not prec > 0:
        raise ValueError(f"{where}['precision'] must be > 0, got {prec}")
    mi = options.get("max_iter")
    if mi is not None and not int(mi) > 0:
        raise ValueError(f"{where}['max_iter'] must be > 0, got {mi}")
    return options


def validate_config(config) -> dict:
    """Validate a script-level config (dict, :class:`GridConfig` or
    :class:`LRBMSConfig`) and return the flat dict form.  Unknown keys
    raise ``ValueError`` — the problems' ``init_grid_and_problem`` all
    funnel through here."""
    if isinstance(config, LRBMSConfig):
        return config.flat_dict()
    if isinstance(config, GridConfig):
        return config.as_dict()
    unknown = set(config) - FLAT_CONFIG_KEYS
    if unknown:
        raise ValueError(
            f"unknown config key(s) {sorted(unknown)}; known keys: "
            f"{sorted(FLAT_CONFIG_KEYS)}")
    dim = len(config.get("num_subdomains", (1, 1)))
    allowed = GRID_TYPES_3D if dim == 3 else GRID_TYPES_2D
    gt = config.get("grid_type", allowed[0] if dim == 3 else "tri")
    if gt not in allowed:
        raise ValueError(
            f"config['grid_type'] = {gt!r} not in {allowed} ({dim}D)")
    return dict(config)


@dataclass
class GridConfig:
    num_subdomains: Tuple[int, ...] = (2, 2)
    half_num_fine_elements_per_subdomain_and_dim: int = 1
    num_refinements: int = 2
    grid_type: str = "tri"

    def __post_init__(self):
        assert all(k >= 1 for k in self.num_subdomains), \
            "need at least one subdomain per dim"
        assert len(self.num_subdomains) in (2, 3)
        assert self.half_num_fine_elements_per_subdomain_and_dim >= 1
        assert self.num_refinements >= 0
        if len(self.num_subdomains) == 3 and self.grid_type == "tri":
            # dimension-aware default: 3D has a single grid family
            object.__setattr__(self, "grid_type", "hex")
        allowed = GRID_TYPES_3D if len(self.num_subdomains) == 3 \
            else GRID_TYPES_2D
        assert self.grid_type in allowed, \
            f"grid_type {self.grid_type!r} not in {allowed} for " \
            f"{len(self.num_subdomains)}D"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class SolverConfig:
    """<-> the ISTL solver-option dicts (``online_adaptive_lrbms.py:71-72``)."""
    type: str = "auto"                 # see SOLVER_TYPES
    precision: float = 1e-10
    max_iter: int = 400
    post_check_solves_system: Optional[float] = 1e-5
    two_level: Optional[bool] = None
    coarse_space: Optional[str] = None
    coarse_modes: Optional[int] = None

    def __post_init__(self):
        assert self.type in SOLVER_TYPES
        assert self.precision > 0 and self.max_iter > 0
        assert self.coarse_space is None or self.coarse_space in COARSE_SPACES

    def as_dict(self) -> dict:
        """Dict spelling, with unset optional knobs dropped (so downstream
        ``options.get(...)`` defaults keep applying)."""
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclass
class EnrichmentConfig:
    target_error: float = 1e-2
    marking_doerfler_theta: float = 0.33
    marking_max_age: int = 4
    enrichment_steps: int = 10

    def __post_init__(self):
        assert 0.0 < self.marking_doerfler_theta <= 1.0


@dataclass
class GreedyConfig:
    target_error: float = 1e-4
    max_extensions: int = 50
    training_samples: int = 10
    criterion: str = "residual"

    def __post_init__(self):
        assert self.criterion in ("residual", "estimator")


@dataclass
class LRBMSConfig:
    grid: GridConfig = field(default_factory=GridConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    enrichment: EnrichmentConfig = field(default_factory=EnrichmentConfig)
    greedy: GreedyConfig = field(default_factory=GreedyConfig)
    initial_RB_order: int = 0

    @staticmethod
    def from_dict(cfg: dict) -> "LRBMSConfig":
        """Accept the reference's flat script dicts (unknown keys raise)."""
        cfg = validate_config(cfg)
        grid_keys = {f.name for f in dataclasses.fields(GridConfig)}
        grid = GridConfig(**{k: tuple(v) if k == "num_subdomains" else v
                             for k, v in cfg.items() if k in grid_keys})
        enr = EnrichmentConfig(
            target_error=cfg.get("enrichment_target_error", 1e-2),
            marking_doerfler_theta=cfg.get("marking_doerfler_theta", 0.33),
            marking_max_age=cfg.get("marking_max_age", 4))
        return LRBMSConfig(grid=grid, enrichment=enr,
                           initial_RB_order=cfg.get("initial_RB_order", 0))

    def flat_dict(self) -> dict:
        """The reference's flat script-dict spelling (grid + enrichment
        keys), for handing to ``init_grid_and_problem``."""
        out = self.grid.as_dict()
        out.update({
            "initial_RB_order": self.initial_RB_order,
            "enrichment_target_error": self.enrichment.target_error,
            "marking_doerfler_theta": self.enrichment.marking_doerfler_theta,
            "marking_max_age": self.enrichment.marking_max_age,
        })
        return out

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "LRBMSConfig":
        raw = json.loads(text)
        return LRBMSConfig(
            grid=GridConfig(**{**raw.get("grid", {}),
                               "num_subdomains": tuple(raw.get("grid", {}).get("num_subdomains", (2, 2)))}),
            solver=SolverConfig(**raw.get("solver", {})),
            enrichment=EnrichmentConfig(**raw.get("enrichment", {})),
            greedy=GreedyConfig(**raw.get("greedy", {})),
            initial_RB_order=raw.get("initial_RB_order", 0))
