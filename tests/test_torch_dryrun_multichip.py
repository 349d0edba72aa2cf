"""The port's multi-rank dry run (``scripts/dryrun_multichip``: the port of
``__graft_entry__.dryrun_multichip``) on gloo ranks on the CPU, at the
reference's sizes.  Every leg holds itself against the unsharded
computation on rank 0 with the reference's tolerances (U, indicators, eta,
SPMD, corrector, solve_sharded, matrix-free and trajectories 1e-8; reduced
arrays rtol 1e-12 / atol 1e-14; sweep 1e-12); a leg that fails raises in
its rank and the launcher fails the run.
"""
import pytest

torch = pytest.importorskip("torch")

from pylrbms_tpu_torch.scripts import dryrun_multichip  # noqa: E402

LEGS = ("online step", "SPMD solver", "reduce(mesh=)", "corrector(mesh=)", "solve_sharded",
        "batched_estimates(mesh=) x8", "3D matrix-free single-level",
        "parabolic trajectory f64", "parabolic trajectory mixed",
        "parabolic batched sweep B=2")


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip_on_cpu(world):
    payloads = dryrun_multichip.run(world, device="cpu", preset="small", timeout_s=300)
    assert len(payloads) == world
    legs = payloads[0]["result"]
    assert tuple(leg["leg"] for leg in legs) == LEGS
    for leg in legs:
        assert all(err <= 1e-8 for err in leg["errors"].values()), leg
    assert legs[0]["errors"]["U"] <= 1e-8 and legs[0]["iters"] > 0
    # every leg of a rank has its counterpart on the others, with its exchanges
    for p in payloads[1:]:
        assert [leg["leg"] for leg in p["result"]] == list(LEGS)
    assert all(p["result"][0]["exchanges"] > 0 for p in payloads)
    assert len(dryrun_multichip.format_legs(payloads)) == len(LEGS)
