"""Structured domain-decomposed grid with oversampling neighborhoods.

The port's own copy of ``pylrbms_tpu/grid.py`` (numpy and stdlib only).

Replacement for the dune-xt-grid DD subdomain provider consumed by the
upstream pylrbms (``python/dune/pylrbms/grid.py:8-69``,
``make_cube_dd_subdomains_grid__*`` with ``num_refinements=2`` and
``num_oversampling_layers=1`` hardcoded at ``grid.py:26-28``).

Semantics (ours, grid-pointer-free):

* domain = [ll, ur], partitioned into ``kx x ky`` congruent rectangular
  subdomains (``num_subdomains``, ``grid.py:27``);
* each subdomain carries ``s x s`` fine quad cells with
  ``s = half_num_fine_elements_per_subdomain_and_dim * 2**num_refinements``
  (the reference refines the macro grid twice, ``grid.py:26``);
* for ``grid_type='tri'`` (the reference's ALU simplex default,
  ``scripts/*.py: 'grid_type': 'alu'``) every quad cell is split into two
  triangles along the (0,0)-(1,1) diagonal (DUNE Kuhn triangulation):
  triangle A = {(0,0),(1,0),(1,1)} (below), B = {(0,0),(0,1),(1,1)} (above);
* for ``grid_type='crisscross'`` the diagonal direction ALTERNATES per cell
  (checkerboard, parity p = (gx+gy)%2: p=0 main diagonal A/B as above, p=1
  ANTI-diagonal with triangles C = {(0,0),(1,0),(0,1)} below and
  E = {(1,0),(1,1),(0,1)} above) — this is the triangulation that DUNE's
  ``ALU_2D_SIMPLEX_CONFORMING`` newest-vertex bisection produces from a Kuhn
  macro pair after an even number of halvings (verified against an
  independent unstructured oracle, ``scripts/crisscross_oracle.py``), i.e.
  the mesh family the reference's golden values were computed on;
* oversampling neighborhoods are the 3x3 subdomain patch clipped at the
  domain boundary (1 oversampling layer, ``grid.py:28``) — this includes
  diagonal neighbors, which is required for the Oswald-interpolation block
  structure (vertex coupling; ``discretize_elliptic_block_swipdg.py:72-122``).

All topology is *static* numpy metadata; there are no pointers, walkers or
mappers — per-subdomain objects become a leading axis of batched arrays
(SURVEY.md §7 design stance).

Topology/geometry queries mirror the dune grid API used by the reference:
``num_subdomains``, ``neighborhood_of``, ``neighboring_subdomains``,
``boundary_subdomains``, ``num_elements``, ``max_entity_diameter``
(``discretize_elliptic_block_swipdg.py:66-70,421,436,641``; ``EOC.py:253-264``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class Grid:
    lower_left: Tuple[float, float]
    upper_right: Tuple[float, float]
    kx: int                      # subdomains in x
    ky: int                      # subdomains in y
    s: int                       # fine quad cells per subdomain per dim
    grid_type: str = "tri"       # 'tri' | 'crisscross' (2 tri/quad) | 'quad'

    # ------------------------------------------------------------------
    # sizes
    # ------------------------------------------------------------------
    @property
    def num_subdomains(self) -> int:
        return self.kx * self.ky

    @property
    def tri_per_cell(self) -> int:
        return 1 if self.grid_type == "quad" else 2

    def cell_parity(self) -> np.ndarray:
        """[s, s] per-cell diagonal parity within a subdomain (indexed
        [cy, cx]; 0 = main diagonal, 1 = anti-diagonal).  Identical for
        every subdomain since ``s`` is even for 'crisscross' (asserted in
        BlockDGSpace), so the global checkerboard (gx+gy)%2 restricts to
        (cx+cy)%2 locally."""
        cy, cx = np.meshgrid(np.arange(self.s), np.arange(self.s), indexing="ij")
        if self.grid_type != "crisscross":
            return np.zeros((self.s, self.s), dtype=np.int64)
        return (cy + cx) % 2

    @property
    def global_nx(self) -> int:
        """fine quad cells per dim (x), whole domain"""
        return self.kx * self.s

    @property
    def global_ny(self) -> int:
        return self.ky * self.s

    @property
    def num_elements(self) -> int:
        """total number of elements (triangles for 'tri')"""
        return self.global_nx * self.global_ny * self.tri_per_cell

    @property
    def cells_per_subdomain(self) -> int:
        return self.s * self.s * self.tri_per_cell

    @property
    def hx(self) -> float:
        return (self.upper_right[0] - self.lower_left[0]) / self.global_nx

    @property
    def hy(self) -> float:
        return (self.upper_right[1] - self.lower_left[1]) / self.global_ny

    def max_entity_diameter(self) -> float:
        """max element diameter (triangle hypotenuse / quad diagonal).

        Mirrors ``grid.max_entity_diameter()`` (``EOC.py:259``)."""
        return math.hypot(self.hx, self.hy)

    def subdomain_diameter(self, ii: int = 0) -> float:
        """Diagonal of the (rectangular) subdomain; the RS2017
        ``residual_indicator_subdomain_diameter`` equivalent
        (``discretize_elliptic_block_swipdg.py:779``)."""
        return math.hypot(self.s * self.hx, self.s * self.hy)

    # ------------------------------------------------------------------
    # subdomain indexing: ii = sy * kx + sx
    # ------------------------------------------------------------------
    def subdomain_index(self, sx: int, sy: int) -> int:
        return sy * self.kx + sx

    def subdomain_coords(self, ii: int) -> Tuple[int, int]:
        return ii % self.kx, ii // self.kx

    def neighboring_subdomains(self, ii: int) -> List[int]:
        """Face neighbors (4-connectivity), the coupling stencil
        (``discretize_elliptic_block_swipdg.py:421``)."""
        sx, sy = self.subdomain_coords(ii)
        out = []
        for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nx_, ny_ = sx + dx, sy + dy
            if 0 <= nx_ < self.kx and 0 <= ny_ < self.ky:
                out.append(self.subdomain_index(nx_, ny_))
        return sorted(out)

    def neighborhood_of(self, ii: int) -> List[int]:
        """Oversampled neighborhood: 3x3 patch clipped at the boundary,
        *including* ``ii`` itself and diagonal neighbors
        (1 oversampling layer, ``grid.py:28``; consumed at
        ``discretize_elliptic_block_swipdg.py:641,793``)."""
        sx, sy = self.subdomain_coords(ii)
        out = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nx_, ny_ = sx + dx, sy + dy
                if 0 <= nx_ < self.kx and 0 <= ny_ < self.ky:
                    out.append(self.subdomain_index(nx_, ny_))
        return sorted(out)

    def boundary_subdomains(self) -> List[int]:
        out = []
        for ii in range(self.num_subdomains):
            sx, sy = self.subdomain_coords(ii)
            if sx in (0, self.kx - 1) or sy in (0, self.ky - 1):
                out.append(ii)
        return out

    @property
    def subdomains_on_rank(self) -> List[int]:
        """Single-process view: all subdomains.  Distribution happens by
        sharding the leading K axis over a device mesh instead of MPI ranks
        (SURVEY.md §2.5)."""
        return list(range(self.num_subdomains))

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------
    def cell_origin(self, gx, gy):
        """lower-left corner of global quad cell (gx, gy); array friendly."""
        return (np.asarray(self.lower_left[0]) + np.asarray(gx) * self.hx,
                np.asarray(self.lower_left[1]) + np.asarray(gy) * self.hy)

    def cell_origins(self) -> np.ndarray:
        """[Sy, Sx, 2] lower-left corners of all global quad cells."""
        gx = np.arange(self.global_nx)
        gy = np.arange(self.global_ny)
        X, Y = np.meshgrid(gx, gy)  # [Sy, Sx]
        ox = self.lower_left[0] + X * self.hx
        oy = self.lower_left[1] + Y * self.hy
        return np.stack([ox, oy], axis=-1)

    def subdomain_cell_origins(self) -> np.ndarray:
        """[K, s, s, 2] lower-left corners, grouped by subdomain
        (cy, cx within subdomain)."""
        o = self.cell_origins()                      # [Sy, Sx, 2]
        o = o.reshape(self.ky, self.s, self.kx, self.s, 2)
        o = o.transpose(0, 2, 1, 3, 4)               # [ky, kx, s, s, 2]
        return o.reshape(self.num_subdomains, self.s, self.s, 2)

    def visualize(self, filename: str, *args, **kwargs):
        """Subdomain-id field on the grid as a VTU file; returns its name."""
        from .utils.vtk import write_grid_vtu
        return write_grid_vtu(self, filename)


def make_grid(domain=((0.0, 0.0), (1.0, 1.0)),
              num_subdomains=None,
              half_num_fine_elements_per_subdomain_and_dim: int = 4,
              inner_boundary_segment_index: int = 18446744073709551573,
              num_refinements: int = 2,
              grid_type: str = "tri",
              mpi_comm=None) -> Grid:
    """Factory mirroring ``dune.pylrbms.grid.make_grid`` (``grid.py:8-42``).

    ``inner_boundary_segment_index`` (the magic 2**64-43 marker,
    ``grid.py:11``) and ``mpi_comm`` are accepted for interface parity and
    ignored — inner boundaries are implicit in the structured partition, and
    distribution is handled by jax.sharding rather than MPI.
    """
    ll, ur = tuple(map(float, domain[0])), tuple(map(float, domain[1]))
    # accept the reference's grid-type tokens: ALU = simplex, Yasp = cube.
    # 'alu_conform'/'cc' select the crisscross family — the triangulation the
    # reference's conforming ALU bisection actually produces (see Grid doc).
    grid_type = {"alu": "tri", "alu_grid": "tri", "simplex": "tri",
                 "alu_conform": "crisscross", "cc": "crisscross",
                 "yasp": "quad", "yasp_grid": "quad", "cube": "quad"}.get(
        grid_type, grid_type)
    assert grid_type in ("tri", "quad", "crisscross"), grid_type
    s = int(half_num_fine_elements_per_subdomain_and_dim) * (2 ** num_refinements)
    if num_subdomains is None:
        kx = ky = 1
    else:
        kx, ky = int(num_subdomains[0]), int(num_subdomains[1])
    return Grid(lower_left=ll, upper_right=ur, kx=kx, ky=ky, s=s, grid_type=grid_type)


def make_boundary_info(grid: Grid, config) -> str:
    """All problems in the reference use all-Dirichlet boundaries
    (``grid.py:45-53``; every problem file passes
    ``{'type': 'xt.grid.boundaryinfo.alldirichlet'}``).  We return the type
    string as a token; face classification is a static mask in assembly."""
    return (config or {}).get("type", "xt.grid.boundaryinfo.alldirichlet")


def grid_info(log, grid: Grid, mpi_comm=None):
    """Mirrors ``grid.py:56-69``."""
    log(f"Grid {grid.grid_type} | subdomains {grid.num_subdomains} "
        f"({grid.kx}x{grid.ky}) | elements {grid.num_elements} "
        f"| h {grid.max_entity_diameter():.4e}")
