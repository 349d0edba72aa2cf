"""Structured 3D domain-decomposed hex grid with oversampling neighborhoods.

The port's own copy of ``pylrbms_tpu/grid3d.py`` (numpy and stdlib only).

BEYOND the reference: the reference's grid layer is 2D-only (its
``make_cube_dd_subdomains_grid__*`` providers are instantiated for 2D ALU /
Yasp grids, ``python/dune/pylrbms/grid.py:17-42`` upstream), while the
BASELINE north-star data set — SPE10 model 2 — is natively a 60 x 220 x 85
*3D* permeability tensor.  This module extends the same grid-pointer-free
design (``grid.py``) to 3D:

* domain = [ll, ur] in R^3, partitioned into ``kx x ky x kz`` congruent box
  subdomains;
* each subdomain carries ``s^3`` fine hex cells
  (``s = half_num_fine_elements_per_subdomain_and_dim * 2**num_refinements``);
* one element per cell (trilinear Q1 DG, ``grid_type='hex'``);
* oversampling neighborhoods are the 3x3x3 subdomain patch clipped at the
  domain boundary (1 oversampling layer, including edge/corner neighbors —
  required for the vertex-coupled Oswald block structure, exactly as in 2D).

All topology is static numpy metadata; per-subdomain objects become a leading
K axis of batched arrays (SURVEY.md §7 design stance).  Topology/geometry
queries mirror the dune grid API surface (``num_subdomains``,
``neighborhood_of``, ``neighboring_subdomains``, ``boundary_subdomains``,
``num_elements``, ``max_entity_diameter``) so every 2D consumer works
unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class Grid3D:
    lower_left: Tuple[float, float, float]
    upper_right: Tuple[float, float, float]
    kx: int                      # subdomains in x
    ky: int                      # subdomains in y
    kz: int                      # subdomains in z
    s: int                       # fine hex cells per subdomain per dim
    grid_type: str = "hex"

    dim = 3

    # ------------------------------------------------------------------
    # sizes
    # ------------------------------------------------------------------
    @property
    def num_subdomains(self) -> int:
        return self.kx * self.ky * self.kz

    @property
    def tri_per_cell(self) -> int:
        return 1

    @property
    def global_nx(self) -> int:
        return self.kx * self.s

    @property
    def global_ny(self) -> int:
        return self.ky * self.s

    @property
    def global_nz(self) -> int:
        return self.kz * self.s

    @property
    def num_elements(self) -> int:
        return self.global_nx * self.global_ny * self.global_nz

    @property
    def cells_per_subdomain(self) -> int:
        return self.s ** 3

    @property
    def hx(self) -> float:
        return (self.upper_right[0] - self.lower_left[0]) / self.global_nx

    @property
    def hy(self) -> float:
        return (self.upper_right[1] - self.lower_left[1]) / self.global_ny

    @property
    def hz(self) -> float:
        return (self.upper_right[2] - self.lower_left[2]) / self.global_nz

    def max_entity_diameter(self) -> float:
        """Max element diameter (hex space diagonal)."""
        return math.sqrt(self.hx ** 2 + self.hy ** 2 + self.hz ** 2)

    def subdomain_diameter(self, ii: int = 0) -> float:
        """Space diagonal of the (box) subdomain — the RS2017
        ``residual_indicator_subdomain_diameter`` analog in 3D."""
        return math.sqrt((self.s * self.hx) ** 2 + (self.s * self.hy) ** 2
                         + (self.s * self.hz) ** 2)

    # ------------------------------------------------------------------
    # subdomain indexing: ii = (sz*ky + sy)*kx + sx
    # ------------------------------------------------------------------
    def subdomain_index(self, sx: int, sy: int, sz: int) -> int:
        return (sz * self.ky + sy) * self.kx + sx

    def subdomain_coords(self, ii: int) -> Tuple[int, int, int]:
        sx = ii % self.kx
        sy = (ii // self.kx) % self.ky
        sz = ii // (self.kx * self.ky)
        return sx, sy, sz

    def neighboring_subdomains(self, ii: int) -> List[int]:
        """Face neighbors (6-connectivity), the coupling stencil."""
        sx, sy, sz = self.subdomain_coords(ii)
        out = []
        for dx, dy, dz in ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                           (0, 0, -1), (0, 0, 1)):
            nx_, ny_, nz_ = sx + dx, sy + dy, sz + dz
            if 0 <= nx_ < self.kx and 0 <= ny_ < self.ky and 0 <= nz_ < self.kz:
                out.append(self.subdomain_index(nx_, ny_, nz_))
        return sorted(out)

    def neighborhood_of(self, ii: int) -> List[int]:
        """Oversampled neighborhood: 3x3x3 patch clipped at the boundary,
        *including* ``ii`` itself and edge/corner neighbors (1 oversampling
        layer)."""
        sx, sy, sz = self.subdomain_coords(ii)
        out = []
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    nx_, ny_, nz_ = sx + dx, sy + dy, sz + dz
                    if (0 <= nx_ < self.kx and 0 <= ny_ < self.ky
                            and 0 <= nz_ < self.kz):
                        out.append(self.subdomain_index(nx_, ny_, nz_))
        return sorted(out)

    def boundary_subdomains(self) -> List[int]:
        out = []
        for ii in range(self.num_subdomains):
            sx, sy, sz = self.subdomain_coords(ii)
            if (sx in (0, self.kx - 1) or sy in (0, self.ky - 1)
                    or sz in (0, self.kz - 1)):
                out.append(ii)
        return out

    @property
    def subdomains_on_rank(self) -> List[int]:
        """Single-process view: all subdomains (distribution = K-axis
        sharding over a device mesh, as in 2D)."""
        return list(range(self.num_subdomains))

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------
    def subdomain_origins(self) -> np.ndarray:
        """[K, 3] physical lower corner of each subdomain."""
        sx = np.arange(self.kx) * (self.s * self.hx) + self.lower_left[0]
        sy = np.arange(self.ky) * (self.s * self.hy) + self.lower_left[1]
        sz = np.arange(self.kz) * (self.s * self.hz) + self.lower_left[2]
        SZ, SY, SX = np.meshgrid(sz, sy, sx, indexing="ij")   # [kz, ky, kx]
        return np.stack([SX.ravel(), SY.ravel(), SZ.ravel()], axis=-1)

    def visualize(self, filename: str, *args, **kwargs):
        """Subdomain-id field on the hex grid as a VTU file (<->
        ``Grid.visualize``); returns its name."""
        from .ops.spaces3d import BlockDGSpace3D
        from .utils.vtk import write_hex_vtu
        space = BlockDGSpace3D(self)
        ids = np.repeat(np.arange(self.num_subdomains, dtype=float)[:, None], space.N, axis=1)
        return write_hex_vtu(space, ids, filename, name="subdomain")


def make_grid3d(domain=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                num_subdomains=None,
                half_num_fine_elements_per_subdomain_and_dim: int = 2,
                num_refinements: int = 1,
                grid_type: str = "hex",
                mpi_comm=None, **_ignored) -> Grid3D:
    """3D factory with the same knob semantics as 2D ``make_grid``."""
    ll = tuple(map(float, domain[0]))
    ur = tuple(map(float, domain[1]))
    assert len(ll) == 3 and len(ur) == 3
    assert grid_type in ("hex",), grid_type
    s = int(half_num_fine_elements_per_subdomain_and_dim) * (2 ** num_refinements)
    if num_subdomains is None:
        kx = ky = kz = 1
    else:
        kx, ky, kz = (int(v) for v in num_subdomains)
    return Grid3D(lower_left=ll, upper_right=ur, kx=kx, ky=ky, kz=kz, s=s,
                  grid_type=grid_type)
