"""The quad (Q1) family beyond the stencil in the port, on CPU float64.

Mirrors tests/test_quad.py: flux-reconstruction local conservation (1e-10),
the Oswald projection property (1e-12), ROM estimator parity — the port's
ROM estimate equals its FOM estimate of the reconstruction (1e-8) and the
JAX ROM built from the same snapshots (1e-9) —, online enrichment down to
the FOM floor, and a small parabolic run held to a host implicit-Euler
solve (1e-9).  Blocks stay at N = 64 (s = 4): torch's CPU batched LU has
hung on stacks of larger blocks.  One JAX model.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.reductor import LRBMSReductor as JaxReductor  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.ops import assembly as asm  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402

CFG = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 2,
       "num_refinements": 1, "grid_type": "yasp"}
SNAPSHOTS = (0.2, 0.6, 1.0)


@pytest.fixture(scope="module")
def fom():
    gpd = init_grid_and_problem(CFG, mu_bar=1.0, mu_hat=1.0)
    m, data = discretize(gpd, device="cpu")
    return gpd, m, data


def test_quad_flux_reconstruction_local_conservation(fom):
    """SWIPDG with v = 1_T gives |T| div(t)|_T = int_T f exactly."""
    _, m, data = fom
    mu = m.parse_parameter(0.5)
    U = m.solve(mu)
    sp = data["space"]
    t = m.estimator.reconstruct_flux(U, mu).numpy()            # [K, Nrt]
    _chi, idx, div = sp.rt_cell_tab()
    t_cell = t[:, idx.reshape(-1)].reshape(sp.K, sp.s, sp.s, sp.T, idx.shape[-1])
    div_t = np.einsum("kyxte,te->kyxt", t_cell, div)
    xq = asm.tensor(asm.vol_points(sp))
    f = m.estimator.data.f_funcs[0](xq).numpy()
    int_f = sp.hx * sp.hy * np.einsum("tq,kyxtq->kyxt", sp.vol_w, f)
    assert np.abs(sp.hx * sp.hy * div_t - int_f).max() < 1e-10


def test_quad_oswald_projection(fom):
    """I_os reproduces continuous nodal data that vanish on the boundary."""
    _, m, data = fom
    sp = data["space"]
    xn = sp.node_coords_phys()
    u = (np.sin(np.pi * (xn[..., 0] + 1) / 2)
         * np.sin(np.pi * (xn[..., 1] + 1) / 2)).reshape(sp.K, sp.N)
    err = m.estimator.data.oswald.apply(torch.tensor(u))
    assert float(err.abs().max()) < 1e-12


def test_quad_rom_estimator_parity(fom):
    _, m, data = fom
    red = LRBMSReductor(m, products=data["local_energy_dg_product"], order=0)
    for v in SNAPSHOTS:
        red.extend_basis(m.solve(m.parse_parameter(v)))
    rd = red.reduce()
    mu = m.parse_parameter(0.45)
    c = rd.solve(mu)
    eta_rom = float(rd.estimate(c, mu))
    assert abs(eta_rom - float(m.estimate(red.reconstruct(c), mu))) <= 1e-8 * eta_rom

    mj, dj = jax_discretize(jax_problem(CFG, mu_bar=1.0, mu_hat=1.0))
    redj = JaxReductor(mj, products=dj["local_energy_dg_product"], order=0)
    for v in SNAPSHOTS:
        redj.extend_basis(mj.solve({"diffusion": v}))
    rdj = redj.reduce()
    muj = {"diffusion": jnp.asarray([0.45])}
    eta_jax = float(rdj.estimate(rdj.solve(muj), muj))
    assert abs(eta_rom - eta_jax) <= 1e-9 * eta_jax
    assert float(m.estimate(m.solve(mu), mu)) == pytest.approx(
        float(mj.estimate(mj.solve(muj), muj)), rel=1e-10)


def test_quad_online_enrichment_reaches_fom_floor(fom):
    from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment
    gpd, m, data = fom
    mu = m.parse_parameter(0.37)
    eta_fom = float(m.estimate(m.solve(mu), mu))
    red = LRBMSReductor(m, products=data["local_energy_dg_product"], order=0)
    rd = red.reduce()
    ae = AdaptiveEnrichment(gpd, m, data["block_space"], red, rd,
                            target_error=1.001 * eta_fom, marking_doerfler_theta=0.5)
    u, rd2, _ = ae.solve(mu, enrichment_steps=8)
    assert float(rd2.estimate(u, mu)) <= 1.01 * eta_fom


def test_quad_parabolic_run():
    """The channels problem on quads: the trajectory equals a host
    implicit Euler on the dense operator (1e-9) and the parabolic estimate
    is finite and positive."""
    from pylrbms_tpu_torch.problems.artificial_channels import init_grid_and_problem as channels
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as dpar
    gpd = channels({"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
                    "num_refinements": 1, "grid_type": "yasp"})
    T, nt = 1.0, 8
    im, _ = dpar(gpd, T=T, nt=nt, device="cpu")
    mu = im.parse_parameter({"switch": 0.4})
    traj = im.solve(mu)
    st = im.stationary
    dt = T / nt
    A = st.assemble(mu).to_dense().numpy()
    M = np.zeros_like(A)
    N = st.space.N
    for k in range(st.space.K):
        M[k * N:(k + 1) * N, k * N:(k + 1) * N] = im.mass[k].numpy()
    u = np.zeros(A.shape[0])
    for n in range(nt):
        theta_f = im._theta_f_steps(mu, dt)[n].numpy()
        f = np.einsum("q,qkn->kn", theta_f, st.rhs_q.numpy()).ravel()
        u = np.linalg.solve(M + dt * A, M @ u + dt * f)
    assert np.abs(traj[-1].numpy().ravel() - u).max() <= 1e-9 * np.abs(u).max()
    est, _parts = im.estimate(traj, mu)
    assert np.isfinite(float(est)) and float(est) > 0
