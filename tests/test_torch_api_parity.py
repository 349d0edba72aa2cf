"""The port's JAX-call-compatible surface against the JAX package on CPU
float64 (f32 where stated): the same seeded inputs through both.

* ``AssembledBlockOp.solve_pcg`` with ``two_level=True``, with a [K, K]
  ``coarse_inv`` and no basis (the subdomain-constant coarse level), and
  with a harvested basis (``prepare_coarse``): U to 1e-10 and equal
  iteration counts, on OS2015 2D (4x4, half 1, nref 1: K=16, N=24) and
  academic3d Q1 (2x2x2, half 1, nref 1: K=8, N=64), at tol 1e-12;
  ``coarse_f32=True`` within 15% of JAX's count (the coarse apply's f32
  rounding moves the late residual history);
* ``geneo_basis`` as spanned subspaces (per-subdomain orthogonal
  projectors to 1e-8: eigenvector signs are free), ``AffineBlockOp.Q``;
* ``BlockOpStatic.from_space3`` equals ``from_space`` on a 3D space;
* ``ops/ir.make_precond_f32`` for f32 and bf16 block factors, per-cell
  factors with ``cell_shape``, and each coarse form: rtol 1e-6;
* ``scatter_vec``, ``merge_parameter_types`` and the ``dtype=`` keywords
  of ``fold_diag``, ``fold_diag3``, ``AffineBlockOp.from_components`` and
  ``truth.SolveOnlyModel``: equal to JAX's (1e-14);
* ``LRBMSReductor(num_cpus=2)`` equals the default; ``timers.trace``
  writes a Chrome trace.
"""
import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_academic3d  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize3  # noqa: E402
from pylrbms_tpu.la import block as jblock  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015  # noqa: E402
from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as academic3d  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as discretize3  # noqa: E402
from pylrbms_tpu_torch.la import block as tblock  # noqa: E402

f64 = torch.float64
THETA = np.array([1.0, 0.6])
CFG2 = {"num_subdomains": [4, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": 1}
CFG3 = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": 1}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def T(a, dtype=f64):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype)


@pytest.fixture(scope="module", params=["2d", "3d"])
def models(request):
    """(JAX model, port model, assembled JAX op, assembled port op, rhs)."""
    if request.param == "2d":
        dj, _ = jax_discretize(jax_os2015(CFG2))
        dt, _ = discretize(os2015(CFG2), device="cpu")
    else:
        dj, _ = jax_discretize3(jax_academic3d(CFG3))
        dt, _ = discretize3(academic3d(CFG3), device="cpu")
    Aj = dj.op.assemble(jnp.asarray(THETA))
    At = dt.op.assemble(T(THETA))
    b = np.random.default_rng(0).standard_normal((dt.space.K, dt.space.N))
    return dj, dt, Aj, At, b


def _solve_both(Aj, At, b, jax_kw, port_kw, tol=1e-12):
    xj, itj = Aj.solve_pcg(jnp.asarray(b), tol=tol, maxiter=3000, return_iters=True, **jax_kw)
    xt, itt = At.solve_pcg(T(b), tol=tol, maxiter=3000, return_iters=True, **port_kw)
    return np.asarray(xj), int(itj), xt.numpy(), int(itt)


def _harvested(Aj, At, dt):
    C = tblock.harvested_coarse_basis(At, At.block_jacobi_factors(), dt.space,
                                      n_harvest=4, extra_modal=3)
    Cj, invj = jblock.prepare_coarse(Aj, C)
    return {"coarse_basis": Cj, "coarse_inv": invj}, {"coarse_basis": T(Cj),
                                                      "coarse_inv": T(invj)}


@pytest.mark.parametrize("level", ["two_level", "constant_inv", "harvested"])
def test_solve_pcg_coarse_levels_match_jax(models, level):
    dj, dt, Aj, At, b = models
    if level == "two_level":
        kj = kt = {"two_level": True}
    elif level == "constant_inv":
        inv = np.linalg.inv(np.asarray(Aj.coarse_matrix()))          # [K, K], no basis
        kj, kt = {"coarse_inv": jnp.asarray(inv)}, {"coarse_inv": T(inv)}
    else:
        kj, kt = _harvested(Aj, At, dt)
    xj, itj, xt, itt = _solve_both(Aj, At, b, kj, kt)
    assert itt == itj
    assert rel(xt, xj) <= 1e-10


@pytest.mark.parametrize("level", ["two_level", "harvested"])
def test_solve_pcg_coarse_f32_counts_near_jax(models, level):
    dj, dt, Aj, At, b = models
    kj, kt = ({"two_level": True}, {"two_level": True}) if level == "two_level" \
        else _harvested(Aj, At, dt)
    xj, itj, xt, itt = _solve_both(Aj, At, b, dict(kj, coarse_f32=True),
                                   dict(kt, coarse_f32=True), tol=1e-10)
    assert abs(itt - itj) <= 0.15 * itj, (itt, itj)
    assert rel(xt, xj) <= 1e-8


def test_solve_pcg_two_level_equals_the_ones_basis(models):
    """two_level is the subdomain-constant level: the ones basis with the
    same inverse gives the same iterations and U to 1e-12."""
    _, dt, _, At, b = models
    ci = torch.linalg.inv(At.coarse_matrix())
    ones = torch.ones((dt.space.K, dt.space.N, 1), dtype=f64)
    x1, it1 = At.solve_pcg(T(b), tol=1e-10, two_level=True, return_iters=True)
    x2, it2 = At.solve_pcg(T(b), tol=1e-10, coarse_inv=ci, coarse_basis=ones,
                           return_iters=True)
    assert int(it1) == int(it2)
    assert rel(x1.numpy(), x2.numpy()) <= 1e-12


def test_geneo_basis_spans_jax_subspace_and_Q(models):
    dj, dt, Aj, At, _ = models
    M = np.asarray(dj.products["l2"])
    Cj = np.asarray(Aj.geneo_basis(jnp.asarray(M), modes=4))
    Ct = At.geneo_basis(T(M), modes=4)
    assert Ct.shape == Cj.shape

    def proj(C):
        Q = np.stack([np.linalg.qr(c)[0] for c in C])
        return np.einsum("kim,kjm->kij", Q, Q)

    assert rel(proj(Ct), proj(Cj)) <= 1e-8
    assert dt.op.Q == dj.op.Q == len(dt.components)


def test_from_space3_equals_from_space():
    dt3, _ = discretize3(academic3d(CFG3), device="cpu")
    a = tblock.BlockOpStatic.from_space3(dt3.space)
    b = tblock.BlockOpStatic.from_space(dt3.space)
    for f in ("K", "N", "s", "nb", "kx", "ky", "kz"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("left_k", "right_k", "low_k", "up_k", "near_k", "far_k"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.side_rows.keys() == b.side_rows.keys()
    for side in a.side_rows:
        np.testing.assert_array_equal(a.side_rows[side], b.side_rows[side])


# ------------------------------------------------------------- make_precond_f32

K, S, CB = 4, 3, 2
N = S * S * CB


def _precond_inputs():
    rng = np.random.default_rng(1)
    return {"r": rng.standard_normal((K, N)).astype(np.float32),
            "block": rng.standard_normal((K, N, N)),
            "cells": rng.standard_normal((K, S, S, CB, CB)),
            "basis": rng.standard_normal((K, N, 3)),
            "inv_basis": rng.standard_normal((K * 3, K * 3)),
            "inv_const": rng.standard_normal((K, K))}


@pytest.mark.parametrize("fine", ["block_f32", "block_bf16", "cells", "none"])
@pytest.mark.parametrize("coarse", [None, "constant", "basis"])
def test_make_precond_f32_matches_jax(fine, coarse):
    from pylrbms_tpu.ops.ir import make_precond_f32 as jax_make
    from pylrbms_tpu_torch.ops.ir import make_precond_f32
    x = _precond_inputs()
    kj, kt = {}, {}
    if fine.startswith("block"):
        bf = fine.endswith("bf16")
        kj["block_factors"] = jnp.asarray(x["block"], jnp.bfloat16 if bf else jnp.float64)
        kt["block_factors"] = T(x["block"], torch.bfloat16 if bf else f64)
    elif fine == "cells":
        kj["factors"], kt["factors"] = jnp.asarray(x["cells"]), T(x["cells"])
        kj["cell_shape"] = kt["cell_shape"] = (K, S, S, CB)
    if coarse == "constant":
        kj["coarse_inv"], kt["coarse_inv"] = jnp.asarray(x["inv_const"]), T(x["inv_const"])
    elif coarse == "basis":
        kj["coarse_inv"], kt["coarse_inv"] = jnp.asarray(x["inv_basis"]), T(x["inv_basis"])
        kj["coarse_basis"], kt["coarse_basis"] = jnp.asarray(x["basis"]), T(x["basis"])
    zj = np.asarray(jax_make(**kj)(jnp.asarray(x["r"])))
    zt = make_precond_f32(**kt)(torch.tensor(x["r"]))
    assert zt.dtype == torch.float32 and zt.shape == (K, N)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-6, atol=1e-6 * np.abs(zj).max())


# ------------------------------------------------------------------- stragglers

def test_scatter_vec_matches_jax():
    from pylrbms_tpu.ops.assembly import scatter_vec as jax_scatter_vec
    from pylrbms_tpu_torch.ops.assembly import scatter_vec
    rng = np.random.default_rng(2)
    b = rng.standard_normal((2, 10))
    rows = np.array([[0, 3, 3], [9, 0, 5]])                  # repeated rows accumulate
    vals = rng.standard_normal((2, 2, 3))
    got = scatter_vec(T(b), T(vals), rows)
    assert rel(got.numpy(), jax_scatter_vec(jnp.asarray(b), jnp.asarray(vals), rows)) <= 1e-15


@pytest.mark.parametrize("pts", [(), (None,), ({},), ({"a": 1}, None, {"a": (2,), "b": None}),
                                 ({"diffusion": [1]}, {"switch": ()})])
def test_merge_parameter_types_matches_jax(pts):
    from pylrbms_tpu.parameters import merge_parameter_types as jax_merge
    from pylrbms_tpu_torch.parameters import merge_parameter_types
    assert merge_parameter_types(*pts) == jax_merge(*pts)


def test_dtype_keywords_match_jax(models):
    """``dtype=`` is accepted and, as in the reference, keeps the
    components' dtype."""
    dj, dt, _, _, _ = models
    if getattr(dt.space, "dim", 2) == 3:
        from pylrbms_tpu.ops.swipdg3d import fold_diag3 as jfold
        from pylrbms_tpu_torch.ops.swipdg3d import fold_diag3 as tfold
    else:
        from pylrbms_tpu.ops.swipdg import fold_diag as jfold
        from pylrbms_tpu_torch.ops.swipdg import fold_diag as tfold
        op = tblock.AffineBlockOp.from_components(dt.space, dt.components, dtype=f64)
        opj = jblock.AffineBlockOp.from_components(dj.space, dj.components, dtype=jnp.float64)
        assert rel(op.A_diag.numpy(), opj.A_diag) <= 1e-14
        assert op.Q == opj.Q
    for cj, ct in zip(dj.components, dt.components):
        got = tfold(dt.space, ct, dtype=f64)
        assert got.dtype == f64
        assert rel(got.numpy(), jfold(dj.space, cj, dtype=jnp.float64)) <= 1e-14


def test_solve_only_model_dtype_keyword_matches_jax():
    from pylrbms_tpu.truth import SolveOnlyModel as JaxSolveOnlyModel
    from pylrbms_tpu_torch.truth import SolveOnlyModel
    mj = JaxSolveOnlyModel(jax_academic3d(CFG3), dtype=jnp.float64)
    mt = SolveOnlyModel(academic3d(CFG3), dtype=f64, device="cpu")
    mu = {"diffusion": 0.5}
    assert mt.rhs(mu).dtype == f64
    assert rel(mt.rhs(mu).numpy(), mj.rhs(mu)) <= 1e-14
    assert rel(mt.theta(mu).numpy(), mj.theta(mu)) <= 1e-15


def test_reductor_num_cpus_is_accepted_and_unused():
    from pylrbms_tpu_torch.reductor import LRBMSReductor
    cfg = dict(CFG2, num_subdomains=[2, 2])
    d, _ = discretize(os2015(cfg), device="cpu")
    U = d.solve(0.5)
    rds = []
    for kw in ({}, {"num_cpus": 2}):
        red = LRBMSReductor(d, order=0, **kw)
        red.extend_basis(U.numpy())
        rds.append(red.reduce())
    assert [int(s) for s in rds[0].sizes] == [int(s) for s in rds[1].sizes]
    c0, c1 = rds[0].solve(0.3), rds[1].solve(0.3)
    assert torch.equal(c0, c1)


def test_timers_trace_writes_a_chrome_trace(tmp_path):
    from pylrbms_tpu_torch.utils.timers import trace
    a = torch.randn(64, 64, dtype=f64)
    with trace(str(tmp_path)):
        torch.linalg.inv(a @ a.T + 64 * torch.eye(64, dtype=f64))
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("linalg_inv" in e.get("name", "") for e in events)
