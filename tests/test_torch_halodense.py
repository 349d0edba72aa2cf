"""The halo-dense and banded operator forms in the port, against the block
operator and the JAX package on CPU float64.

Mirrors tests/test_halodense.py (2D) and tests/test_banded.py: the halo
apply (one static gather, one batched product of [K, N, Nh] blocks) equals
``AssembledBlockOp.apply`` and JAX's halo apply (1e-12 relative to the
field's max |.|: the same coefficients summed in another order), its PCG
equals the block PCG (1e-8); the implicit-Euler trajectory with the halo
f32 inner operator equals the stencil-inner one (1e-7 of its max |.|, the
reference's bound) and JAX's halo trajectory (1e-8); the banded apply
equals the dense apply (1e-12) on tri, quad and crisscross, and its bands
equal JAX's where JAX builds them (tri, quad).  Blocks stay at N <= 96.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.problems.spe10 import init_grid_and_problem as jax_spe10  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize as jax_parabolic  # noqa: E402
from pylrbms_tpu.ops.halodense import halo_from_assembled as jax_halo  # noqa: E402
from pylrbms_tpu.ops.banded import banded_operator as jax_banded  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015  # noqa: E402
from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem as spe10  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as parabolic  # noqa: E402
from pylrbms_tpu_torch.ops.halodense import halo_from_assembled, make_halo_plan  # noqa: E402
from pylrbms_tpu_torch.ops.banded import banded_operator  # noqa: E402

TOL = 1e-12


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def cfg(subs, half, nref=1, gt="tri"):
    return {"num_subdomains": subs, "half_num_fine_elements_per_subdomain_and_dim": half,
            "num_refinements": nref, "grid_type": gt}


@pytest.fixture(scope="module")
def tri_models():
    c = cfg([3, 2], 1)
    dj, _ = jax_discretize(jax_os2015(c))
    d, _ = discretize(os2015(c), device="cpu")
    return dj, d


def test_halo_plan_pads_to_128(tri_models):
    _, d = tri_models
    plan = make_halo_plan(d.op.static)
    assert plan.Nh % 128 == 0 and plan.Nh >= plan.N + 4 * plan.strip


@pytest.mark.parametrize("lanes", [(), (3,)])
def test_halo_2d_tri_apply_equals_block_and_jax(tri_models, lanes):
    dj, d = tri_models
    mu, muj = d.parse_parameter(0.7), dj.parse_parameter(0.7)
    A = d.assemble(mu)
    H = halo_from_assembled(A)
    Hj = jax_halo(dj.assemble(muj))
    x = np.random.default_rng(0).normal(size=lanes + (d.space.K, d.space.N))
    y = H.apply(torch.tensor(x))
    assert rel(y, A.apply(torch.tensor(x))) <= TOL
    assert rel(y, Hj.apply(jnp.asarray(x))) <= TOL


def test_halo_pcg_equals_block_pcg(tri_models):
    _, d = tri_models
    A = d.assemble(d.parse_parameter(0.4))
    H = halo_from_assembled(A)
    b = torch.tensor(np.random.default_rng(1).normal(size=(d.space.K, d.space.N)))
    assert rel(H.solve_pcg(b, tol=1e-12, maxiter=2000),
               A.solve_pcg(b, tol=1e-12, maxiter=2000)) <= 1e-8


def test_halo_ir_trajectory_parity():
    """The mixed implicit-Euler trajectory with the halo f32 inner operator
    equals the stencil-inner one and JAX's halo trajectory."""
    c = cfg([4, 4], 1)
    kw = dict(raster=(4, 4), raster_mode="nearest", max_contrast=1e3)
    imj, _ = jax_parabolic(jax_spe10(c, **kw), T=0.5, nt=4)
    im, _ = parabolic(spe10(c, **kw), T=0.5, nt=4, device="cpu")
    mu, muj = im.parse_parameter([0.7]), imj.parse_parameter([0.7])
    run = dict(tol=1e-11, two_level=False, precision="mixed")
    t_st = im._solve_mf(mu, 0.125, inner="stencil", **run)
    t_ha = im._solve_mf(mu, 0.125, inner="halo", **run)
    assert float((t_ha - t_st).abs().max()) < 1e-7 * float(t_st.abs().max())
    assert rel(t_ha, imj._solve_mf(muj, 0.125, inner="halo", **run)) <= 1e-8


@pytest.mark.parametrize("gt,subs,half", [
    ("tri", [3, 2], 1),
    ("quad", [3, 2], 1),
    ("crisscross", [3, 2], 1),
    ("tri", [1, 1], 2),          # monolithic: no interface strips
    ("crisscross", [2, 2], 2),   # the alternating boundary-layer element at s = 4
])
def test_banded_apply_equals_dense(gt, subs, half):
    d, data = discretize(os2015(cfg(subs, half, nref=1, gt=gt), mu_bar=1.0, mu_hat=1.0),
                         device="cpu")
    sp = data["space"]
    bop = banded_operator(sp, d.op)
    x = torch.tensor(np.random.RandomState(7).randn(2, sp.K, sp.N))
    for mu_v in (0.3, 1.0):
        mu = d.parse_parameter(mu_v)
        y_b = bop.apply(bop.assemble(d.theta(mu)), x)
        assert rel(y_b, d.assemble(mu).apply(x)) <= TOL


@pytest.mark.parametrize("gt", ["tri", "quad"])
def test_banded_bands_equal_jax(gt):
    c = cfg([3, 2], 1, gt=gt)
    dj, dataj = jax_discretize(jax_os2015(c, mu_bar=1.0, mu_hat=1.0))
    d, data = discretize(os2015(c, mu_bar=1.0, mu_hat=1.0), device="cpu")
    bop = banded_operator(data["space"], d.op)
    bopj = jax_banded(dataj["space"], dj.op)
    assert tuple(bop.offsets) == tuple(int(o) for o in bopj.offsets)
    assert rel(bop.bands_q, bopj.bands_q) <= TOL
