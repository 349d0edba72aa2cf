"""Port kernels (pylrbms_tpu_torch.ops.hopper_kernels) against the Pallas
kernels and float64 numpy.

On the CPU the wrappers run their plain PyTorch versions; those are held
to ``block_matvec_pallas`` / ``precond_dot_pallas`` in interpret mode (the
way tests/test_pallas.py runs them) and to float64 numpy for the lane, coef
and ragged-N cases.  The CUDA kernels themselves are checked against the
plain versions in tests/test_torch_cuda.py (marked ``cuda``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.ops.pallas_kernels import (block_matvec_pallas,  # noqa: E402
                                            precond_dot_pallas)
from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402


def test_block_matvec_matches_pallas_interpret():
    # tolerances of tests/test_pallas.py: f32 products over N=128 terms
    rng = np.random.default_rng(5)
    K, N = 8, 128
    A = rng.normal(size=(K, N, N)).astype(np.float32)
    x = rng.normal(size=(K, N)).astype(np.float32)
    y_pl = np.asarray(block_matvec_pallas(jnp.asarray(A), jnp.asarray(x), interpret=True))
    y = hk.block_matvec(torch.tensor(A)[None], torch.tensor(x)[None])
    assert y.shape == (1, K, N) and y.dtype == torch.float32
    np.testing.assert_allclose(y[0].numpy(), y_pl, rtol=2e-5, atol=2e-4)


def test_precond_dot_matches_pallas_interpret():
    # rz is [B, K] in the port (the Pallas kernel writes a 1-D (K,) block);
    # tolerances of tests/test_pallas.py (rz sums N products: looser)
    rng = np.random.default_rng(7)
    K, N = 8, 128
    F = rng.normal(size=(K, N, N)).astype(np.float32)
    r = rng.normal(size=(K, N)).astype(np.float32)
    z_pl, rz_pl = precond_dot_pallas(jnp.asarray(F), jnp.asarray(r), interpret=True)
    z, rz = hk.precond_dot(torch.tensor(F), torch.tensor(r)[None])
    assert z.shape == (1, K, N) and rz.shape == (1, K)
    np.testing.assert_allclose(z[0].numpy(), np.asarray(z_pl), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(rz[0].numpy(), np.asarray(rz_pl), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("G,K,N,B,with_coef", [
    (1, 3, 24, 1, False),      # the entry config's N, one vector
    (1, 4, 24, 5, False),      # lanes
    (2, 4, 24, 5, True),       # affine stack with per-lane theta
    (2, 3, 130, 3, True),      # ragged N (not a tile multiple)
])
def test_block_matvec_against_numpy_f64(G, K, N, B, with_coef):
    # float64 throughout: agreement to summation-order rounding
    rng = np.random.default_rng(11)
    A = rng.normal(size=(G, K, N, N))
    x = rng.normal(size=(B, K, N))
    coef = rng.normal(size=(B, G)) if with_coef else None
    ref = np.einsum("gkij,bkj->bgki", A, x)
    ref = ref[:, 0] if coef is None else np.einsum("bg,bgki->bki", coef, ref)
    y = hk.block_matvec(torch.tensor(A), torch.tensor(x),
                        None if coef is None else torch.tensor(coef))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("fdtype", [torch.float64, torch.bfloat16])
def test_precond_dot_against_numpy_f64(fdtype):
    # bf16 factors widen exactly to f64: the reference uses the same
    # widened values, so the float64 tolerance applies to both storages
    rng = np.random.default_rng(13)
    K, N, B = 4, 24, 6
    F = torch.tensor(rng.normal(size=(K, N, N))).to(fdtype)
    r = rng.normal(size=(B, K, N))
    Fw = F.to(torch.float64).numpy()
    z_ref = np.einsum("kij,bkj->bki", Fw, r)
    z, rz = hk.precond_dot(F, torch.tensor(r))
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-12, atol=1e-12 * np.abs(z_ref).max())
    np.testing.assert_allclose(rz.numpy(), np.sum(r * z_ref, axis=-1), rtol=1e-12,
                               atol=1e-12 * np.abs(z_ref).max())


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    hk.reset_launch_counts()
    A = torch.ones((1, 2, 3, 3), dtype=torch.float64)
    x = torch.ones((1, 2, 3), dtype=torch.float64)
    hk.block_matvec(A, x)
    hk.precond_dot(A[0], x)
    assert hk.launch_counts() == {"block_matvec": 0, "precond_dot": 0}


def test_wrappers_reject_bad_shapes():
    A = torch.ones((2, 2, 3, 3), dtype=torch.float64)
    x = torch.ones((1, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        hk.block_matvec(A, x)                     # G > 1 needs coef
    with pytest.raises(ValueError):
        hk.block_matvec(A, x, torch.ones((2, 2), dtype=torch.float64))
    with pytest.raises(ValueError):
        hk.precond_dot(A[0], torch.ones((1, 3, 3), dtype=torch.float64))
