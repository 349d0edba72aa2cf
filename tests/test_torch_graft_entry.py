"""``pylrbms_tpu_torch.graft_entry`` against the repository's JAX
``__graft_entry__`` on the CPU.

* ``entry(device="cpu")``: the same configuration (OS2015 2x2, half 1,
  nref 1, f32, tol 1e-8, maxiter 500) and example args as JAX's
  ``entry()``; U and the indicators of one step to rel 1e-4 of JAX's f32
  step (both f32 solves converge here, in equal iterations, so the f32
  runs are compared with each other, not with an f64 reference);
* an f64 variant of the same configuration against JAX's ``_build`` /
  ``_online_step`` in f64: 1e-9;
* ``dryrun_multichip(n)`` calls ``scripts/dryrun_multichip.run`` with n
  ranks (the run itself is held in tests/test_torch_dryrun_multichip.py);
* without a device and without CUDA, ``entry()`` raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jax_entry  # noqa: E402
from pylrbms_tpu_torch import graft_entry  # noqa: E402


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_entry_matches_jax_entry_f32():
    fj, aj = jax_entry.entry()
    Uj, indj = fj(*aj)
    ft, at = graft_entry.entry(device="cpu")
    assert [a.dtype for a in at] == [torch.float32, torch.float32]
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    U, ind = ft(*at)
    assert U.dtype == torch.float32 and U.shape == tuple(Uj.shape)
    assert ind.shape == tuple(indj.shape)
    assert rel(U.numpy(), Uj) <= 1e-4
    assert rel(ind.numpy(), indj) <= 1e-4
    its = ft.iters_probe(*at)
    assert 0 < its < 500


def test_entry_f64_matches_jax():
    dj = jax_entry._build(2, 2, 1, 1, jnp.float64)
    fj = jax_entry._online_step(dj)
    Uj, indj = fj(jnp.asarray([1.0, 0.5]), jnp.asarray([1.0]))
    ft, at = graft_entry.entry(device="cpu", dtype=torch.float64)
    U, ind = ft(*at)
    assert U.dtype == torch.float64
    assert rel(U.numpy(), Uj) <= 1e-9
    assert rel(ind.numpy(), indj) <= 1e-9


def test_dryrun_multichip_runs_the_dry_run(monkeypatch):
    from pylrbms_tpu_torch.scripts import dryrun_multichip
    calls = []

    def run(world, device=None, backend=None):
        calls.append((world, device, backend))
        return ["payload"]

    monkeypatch.setattr(dryrun_multichip, "run", run)
    assert graft_entry.dryrun_multichip(4, device="cpu") == ["payload"]
    assert graft_entry.dryrun_multichip(2, device="cpu", backend="gloo") == ["payload"]
    assert calls == [(4, "cpu", None), (2, "cpu", "gloo")]


def test_entry_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
