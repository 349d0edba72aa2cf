"""Port kernels (pylrbms_tpu_torch.ops.hopper_kernels) against the Pallas
kernels and float64 numpy.

On the CPU the wrappers run their plain PyTorch versions; those are held
to ``block_matvec_pallas`` / ``precond_dot_pallas`` in interpret mode (the
way tests/test_pallas.py runs them) and to float64 numpy for the lane, coef
and ragged-N cases.  The CUDA kernels themselves are checked against the
plain versions in tests/test_torch_cuda.py (marked ``cuda``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.ops.pallas_kernels import (block_matvec_pallas,  # noqa: E402
                                            precond_dot_pallas)
from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402


# the Pallas kernels take one lane ([K, N] vectors): run them in interpret
# mode lane by lane and stack the lanes; B = 12 and 16 are the ring's lane
# counts, N = 216 its ragged N
PALLAS_LANES = pytest.mark.parametrize("B", [1, 12, 16])
PALLAS_N = pytest.mark.parametrize("N", [128, 216])


@PALLAS_N
@PALLAS_LANES
def test_block_matvec_matches_pallas_interpret(B, N):
    # tolerances of tests/test_pallas.py: the Pallas kernel accumulates in f32
    rng = np.random.default_rng(5)
    K = 8
    A = rng.normal(size=(K, N, N)).astype(np.float32)
    x = rng.normal(size=(B, K, N)).astype(np.float32)
    y_pl = np.stack([np.asarray(block_matvec_pallas(jnp.asarray(A), jnp.asarray(x[b]),
                                                    interpret=True)) for b in range(B)])
    y = hk.block_matvec(torch.tensor(A)[None], torch.tensor(x))
    assert y.shape == (B, K, N) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_pl, rtol=2e-5, atol=2e-4)


@PALLAS_N
@PALLAS_LANES
def test_precond_dot_matches_pallas_interpret(B, N):
    # rz is [B, K] in the port (the Pallas kernel writes a 1-D (K,) block a
    # lane); tolerances of tests/test_pallas.py (rz sums N products: looser)
    rng = np.random.default_rng(7)
    K = 8
    F = rng.normal(size=(K, N, N)).astype(np.float32)
    r = rng.normal(size=(B, K, N)).astype(np.float32)
    lanes = [precond_dot_pallas(jnp.asarray(F), jnp.asarray(r[b]), interpret=True)
             for b in range(B)]
    z_pl = np.stack([np.asarray(z) for z, _ in lanes])
    rz_pl = np.stack([np.asarray(rz) for _, rz in lanes])
    z, rz = hk.precond_dot(torch.tensor(F), torch.tensor(r))
    assert z.shape == (B, K, N) and rz.shape == (B, K)
    np.testing.assert_allclose(z.numpy(), z_pl, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(rz.numpy(), rz_pl, rtol=2e-4, atol=2e-3)


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
    assert hk.launch_counts() == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                                  "stencil2_apply": 0}


def test_wrappers_reject_bad_shapes():
    A = torch.ones((2, 2, 3, 3), dtype=torch.float64)
    x = torch.ones((1, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        hk.block_matvec(A, x)                     # G > 1 needs coef
    with pytest.raises(ValueError):
        hk.block_matvec(A, x, torch.ones((2, 2), dtype=torch.float64))
    with pytest.raises(ValueError):
        hk.precond_dot(A[0], torch.ones((1, 3, 3), dtype=torch.float64))


# ---------------------------------------------------------------------------
# the tensor-core routes' split arithmetic, emulated in plain torch (the
# kernels themselves run only on the card), and the routing of plan()
# ---------------------------------------------------------------------------

def _bits(v, add, mask):
    u = v.numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(add)) & np.uint32(mask)).view(np.float32))


def bf16_trunc(v):
    """f32 -> bf16 (as f32) by truncation: the low 16 bits cleared."""
    return _bits(v, 0, 0xFFFF0000)


def split_bf16x3(r):
    """f32 r -> three bf16 terms (as f32), each the truncation of what the
    terms before it left, as ``split_bf16x3`` in the CUDA source."""
    r1 = bf16_trunc(r)
    r2 = bf16_trunc(r - r1)
    r3 = bf16_trunc(r - r1 - r2)
    return r1, r2, r3


def tf32_rna(v):
    """f32 -> the nearest TF32 (10 stored mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    return _bits(v, 0x1000, 0xFFFFE000)


def tf32_trunc(v):
    return _bits(v, 0, 0xFFFFE000)


def _normwise(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_bf16_three_way_split_is_exact_and_products_stay_f32_accurate():
    rng = np.random.default_rng(17)
    K, N, B = 4, 384, 8
    r = torch.tensor(rng.normal(size=(B, K, N)), dtype=torch.float32)
    edges = torch.tensor([1.0 + 2.0**-23, -(1.0 + 2.0**-23), 3.0 * 2.0**-100, -0.0, 0.0,
                          np.float32(np.pi), 65504.0, 1e-30], dtype=torch.float32)
    r.view(-1)[:len(edges)] = edges
    r1, r2, r3 = split_bf16x3(r)
    for t in (r1, r2, r3):                               # each term is a bf16
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert torch.equal(r1.double() + r2.double() + r3.double(), r.double())
    F = torch.tensor(rng.normal(size=(K, N, N)), dtype=torch.float32).to(torch.bfloat16)
    Ff = F.float()
    z = torch.zeros_like(r)
    for t in (r3, r2, r1):                               # small terms first, f32 sums
        z = z + torch.einsum("kij,bkj->bki", Ff, t)
    z_ref = torch.einsum("kij,bkj->bki", F.double(), r.double())
    assert _normwise(z, z_ref) <= 2e-5                   # phase 3's f32 tolerance


def test_3xtf32_products_match_f64():
    # observed on the CPU: 6.1e-7 normwise at N=384 (plain f32 einsum on the
    # same inputs: 8.1e-7; one TF32 product alone: 3.2e-4); the dropped
    # a_small x_small term is ~2^-22 relative
    rng = np.random.default_rng(19)
    G, K, N, B = 2, 4, 384, 8
    A = torch.tensor(rng.normal(size=(G, K, N, N)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(B, K, N)), dtype=torch.float32)
    coef = torch.tensor(rng.normal(size=(B, G)), dtype=torch.float32)
    cx = coef.T[:, :, None, None] * x[None]              # [G, B, K, N]: coef * x staged
    a_big = tf32_rna(A)
    a_small = tf32_trunc(A - a_big)
    x_big = tf32_rna(cx)
    x_small = tf32_trunc(cx - x_big)
    y = torch.zeros((B, K, N), dtype=torch.float32)
    for a, v in ((a_small, x_big), (a_big, x_small), (a_big, x_big)):
        y = y + torch.einsum("gkij,gbkj->bki", a, v)
    y_ref = torch.einsum("bg,gkij,bkj->bki", coef.double(), A.double(), x.double())
    err = _normwise(y, y_ref)
    assert err <= 2e-5, err
    # one TF32 product alone loses the digits CG needs
    y1 = torch.einsum("gkij,gbkj->bki", a_big, x_big)
    assert _normwise(y1, y_ref) > 1e-4


def _f32_toward_zero(v):
    """f64 -> f32 rounded toward zero: the tensor cores' f32 sums drop low
    bits rather than round to nearest, the worse case for a long chain."""
    r = v.float()
    over = r.double().abs() > v.abs()
    r[over] = torch.nextafter(r[over], torch.zeros_like(r[over]))
    return r


def _chain(products, N, depth):
    """y = sum of ``products`` ((matrix [K, N, N], vector [B, K, N]) pairs,
    f32 values exact in their split type) accumulated as one f32 chain in
    steps of ``depth`` columns (the wgmma k step), each product of a step
    added in order and the sum rounded toward zero after every add."""
    a0, v0 = products[0]
    acc = torch.zeros((v0.shape[0], a0.shape[0], N), dtype=torch.float64)
    for j0 in range(0, N, depth):
        for a, v in products:
            part = torch.einsum("kij,bkj->bki", a[:, :, j0:j0 + depth].double(),
                                v[:, :, j0:j0 + depth].double())
            acc = _f32_toward_zero(acc + part).double()
    return acc.float()


@pytest.mark.parametrize("kind", ["block_matvec", "precond_dot"])
def test_split_products_keep_the_harvest_chain_depth_within_tol(kind):
    """The tensor route's products at the 442k harvest filter's depth
    (N=1728, one chain of 216 wgmma k8 steps for 3xTF32, 108 k16 steps for
    the bf16 terms), f32 sums rounded toward zero after every product of a
    step: within phase 3's f32 tolerance (2e-5 normwise) of f64.  One TF32
    product alone is not (the reason for the split)."""
    rng = np.random.default_rng(23)
    K, N, B = 2, 1728, 6
    x = torch.tensor(rng.normal(size=(B, K, N)), dtype=torch.float32)
    if kind == "block_matvec":
        A = torch.tensor(rng.normal(size=(K, N, N)), dtype=torch.float32)
        a_big, x_big = tf32_rna(A), tf32_rna(x)
        a_small, x_small = tf32_trunc(A - a_big), tf32_trunc(x - x_big)
        y = _chain([(a_small, x_big), (a_big, x_small), (a_big, x_big)], N, 8)
        ref = torch.einsum("kij,bkj->bki", A.double(), x.double())
        assert _normwise(_chain([(a_big, x_big)], N, 8), ref) > 1e-4
    else:
        F = torch.tensor(rng.normal(size=(K, N, N)), dtype=torch.float32).to(torch.bfloat16)
        r1, r2, r3 = split_bf16x3(x)
        y = _chain([(F.float(), r3), (F.float(), r2), (F.float(), r1)], N, 16)
        ref = torch.einsum("kij,bkj->bki", F.double(), x.double())
    err = _normwise(y, ref)
    assert err <= 2e-5, err


f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
MAIN_PATH_SHAPES = [
    # (kernel, G, K, N, B, matrix dtype, vector dtype, route, bound ms, limit)
    ("precond_dot", 1, 64, 1536, 1, f32, f32, hk.STREAM, 0.180, "bytes"),    # scale solve M
    ("block_matvec", 1, 64, 1536, 1, f64, f64, hk.STREAM, 0.361, "bytes"),   # scale harvest
    ("block_matvec", 1, 64, 1536, 16, f64, f64, hk.RING, 0.368, "bytes"),
    ("precond_dot", 1, 64, 384, 256, bf16, f32, hk.TENSOR, 0.0207, "bytes"),  # serving M
    ("block_matvec", 2, 64, 384, 256, f32, f32, hk.TENSOR, 0.0586,          # serving apply
     "operations"),
    ("precond_dot", 1, 64, 512, 256, bf16, f32, hk.TENSOR, 0.0301, "bytes"),  # 3D serving M
    ("block_matvec", 2, 64, 512, 256, f32, f32, hk.TENSOR, 0.1041,          # 3D serving apply
     "operations"),
    ("block_matvec", 1, 256, 512, 32, f32, f32, hk.TENSOR, 0.0901, "bytes"),  # truth harvest
    ("block_matvec", 1, 256, 1728, 32, f32, f32, hk.TENSOR, 0.9465, "bytes"),
    ("block_matvec", 2, 64, 384, 1, f32, f32, hk.STREAM, 0.0225, "bytes"),
    ("block_matvec", 1, 64, 384, 12, f32, f32, hk.RING, 0.0118, "bytes"),    # serving harvest
    ("block_matvec", 1, 64, 384, 1, f32, f32, hk.STREAM, 0.0113, "bytes"),
    ("precond_dot", 1, 64, 384, 1, bf16, f32, hk.STREAM, 0.0057, "bytes"),   # single query M
    # f64 vectors above the stream take the f64 tensor cores, charged at
    # their rate (67e12)
    ("block_matvec", 1, 64, 384, 128, f64, f64, hk.DMMA, 0.0376, "bytes"),  # Gramian applies
    ("precond_dot", 1, 256, 384, 256, f64, f64, hk.DMMA, 0.2885, "operations"),
]


@pytest.mark.parametrize("kind,G,K,N,B,mdt,vdt,route,bound_ms,limit", MAIN_PATH_SHAPES)
def test_plan_routes_main_path_shapes(kind, G, K, N, B, mdt, vdt, route, bound_ms, limit):
    p = hk.plan(kind, G, K, N, B, mdt, vdt)
    assert p.route == route, p
    if route in (hk.STREAM, hk.RING):                    # the stream route, both forms
        assert p.lanes >= B and p.lanes in hk.STREAM_LANES
        assert p.blocks >= 2 * 132                       # >= 2 waves on the H100
    if route == hk.TENSOR:                               # wgmma tiles: no empty 32-lane tile
        assert p.lanes == (32 if B <= 32 else 128) and p.lanes in hk.TENSOR_LANES
        assert p.blocks == K * math.ceil(N / hk.TENSOR_ROWS) * math.ceil(B / p.lanes)
        assert p.blocks >= 2 * 132
    assert hk.bound(kind, G, K, N, B, mdt, vdt) == (pytest.approx(bound_ms, rel=0.02), limit)


F64_PAIRS = [("block_matvec", f64), ("block_matvec", bf16), ("precond_dot", f64),
             ("precond_dot", bf16)]


@pytest.mark.parametrize("N", [24, 96, 216, 384, 512])
@pytest.mark.parametrize("kind,mdt", F64_PAIRS)
def test_plan_sends_every_f64_vector_launch_above_16_lanes_to_dmma(kind, mdt, N):
    """Every f64-vector pair above 16 lanes takes the f64 tensor cores, at
    any N, lane tail and alignment; 64 x 64 blocks only with four blocks an
    SM, 32-row blocks only where 64 rows leave fewer than two waves on the
    132 SMs, so the grid has two waves wherever 32-row blocks give them."""
    for K in (16, 32, 64, 256):
        for B in (17, 20, 32, 101, 128, 256):
            for aligned in (True, False):
                p = hk.plan(kind, 1, K, N, B, mdt, f64, aligned)
                assert p.route == hk.DMMA and p.name == "dmma", (K, B, aligned, p)
                assert (32 * p.chunks, p.lanes) in hk.DMMA_TILES
                if B <= 32:
                    assert p.lanes == 32
                lane_tiles = math.ceil(B / p.lanes)
                assert p.blocks == K * lane_tiles * math.ceil(N / (32 * p.chunks))
                if K * lane_tiles * math.ceil(N / 32) >= 2 * 132:
                    assert p.blocks >= 2 * 132, (K, B, p)
                if p.chunks == 1 and N > 32:                 # 32-row blocks only for waves
                    assert K * lane_tiles * math.ceil(N / 64) < 2 * 132
                if (32 * p.chunks, p.lanes) == (64, 64):     # 64 x 64 only with 4 an SM
                    assert p.blocks >= 4 * 132
    # at 1-16 lanes an f64 vector streams or, past the stream's ridge (a
    # bf16 matrix at 11-16 lanes), takes the dmma route: never the SIMT tiles
    for B in range(1, 17):
        assert hk.plan(kind, 1, 64, N, B, mdt, f64).route in (hk.STREAM, hk.RING, hk.DMMA)


@pytest.mark.parametrize("kind,G,N,B,mdt,vdt,aligned,route", [
    ("precond_dot", 1, 384, 256, f32, f32, True, hk.TILES),    # no tensor route for the pair
    ("block_matvec", 1, 384, 256, bf16, f32, True, hk.TILES),
    ("precond_dot", 1, 400, 256, bf16, f32, True, hk.TILES),   # the tensor route needs N % 32
    ("block_matvec", 2, 384, 256, f32, f32, False, hk.TILES),  # ... and aligned operands
    ("precond_dot", 1, 384, 256, bf16, f32, True, hk.TENSOR),
    ("block_matvec", 2, 384, 256, f32, f32, True, hk.TENSOR),
])
def test_plan_keeps_simt_tiles_for_other_pairs_at_many_lanes(kind, G, N, B, mdt, vdt, aligned,
                                                              route):
    """Only f32-vector pairs without a tensor route stay on the SIMT tiles."""
    assert hk.plan(kind, G, 64, N, B, mdt, vdt, aligned).route == route


@pytest.mark.parametrize("B", range(1, 17))
def test_plan_streams_every_lane_count_up_to_16(B):
    # the tail shapes of chip_smoke: the stream, in its ring form at 5-16
    # lanes (N = 24 f32 rows are 96 bytes, a 16-byte multiple)
    p = hk.plan("block_matvec", 2, 4, 24, B, f32, f32)
    assert p.route == (hk.RING if B > 4 else hk.STREAM)
    assert p.lanes == min(n for n in hk.STREAM_LANES if n >= B)


@pytest.mark.parametrize("K,N,B,mdt", [(32, 512, 32, f64), (64, 384, 256, f64),
                                       (256, 384, 256, f64), (64, 216, 17, bf16),
                                       (64, 24, 128, f64), (16, 384, 101, bf16)])
def test_pd_scratch_covers_the_dmma_tiles(K, N, B, mdt):
    """precond_dot on the dmma route: a ticket per (k, lane tile) and an rz
    partial per (lane, k, row tile), indexed as the kernel indexes them."""
    p = hk.plan("precond_dot", 1, K, N, B, mdt, f64)
    assert p.route == hk.DMMA
    tickets, partials = hk._pd_scratch(p, K, N, B)
    lane_tiles, row_tiles = math.ceil(B / p.lanes), math.ceil(N / (32 * p.chunks))
    assert p.blocks == K * lane_tiles * row_tiles
    assert (lane_tiles - 1) * K + (K - 1) < tickets              # blockIdx.x * K + k
    assert ((B - 1) * K + K - 1) * row_tiles + row_tiles - 1 < partials
    assert partials == B * K * row_tiles


@pytest.mark.parametrize("N", [32, 384, 512, 1728])
@pytest.mark.parametrize("B", [1, 13, 32, 33, 200, 256])
def test_pd_scratch_covers_the_tensor_tiles(B, N):
    """precond_dot on the tensor route: a ticket per (k, lane tile) and an rz
    partial per (lane, k, 128-row tile), indexed as the kernel indexes them
    (tickets[blockIdx.x K + k], partials[(b K + k) tiles + row tile]), at
    both lane tiles of :data:`TENSOR_LANES`; plan() picks 32 lanes up to
    B = 32, else 128 (the route's own choice where B > 16; below, the
    stream takes the launch)."""
    for K in (3, 64, 256):
        p = hk.plan("precond_dot", 1, K, N, B, bf16, f32)
        if B > 16:
            assert p.route == hk.TENSOR and p.lanes == (32 if B <= 32 else 128)
        for lanes in hk.TENSOR_LANES:
            p = hk.Plan(hk.TENSOR, lanes, 1, 0)
            tickets, partials = hk._pd_scratch(p, K, N, B)
            lane_tiles, row_tiles = math.ceil(B / lanes), math.ceil(N / hk.TENSOR_ROWS)
            assert tickets == K * lane_tiles
            assert (lane_tiles - 1) * K + (K - 1) < tickets
            assert ((B - 1) * K + K - 1) * row_tiles + row_tiles - 1 < partials
            assert partials == B * K * row_tiles


@pytest.mark.parametrize("kind,mdt", [("block_matvec", f32), ("precond_dot", bf16)])
def test_plan_sends_every_tensor_pair_launch_to_wgmma(kind, mdt):
    """Every launch the tensor route takes (its pairs, N % 32 == 0, aligned,
    above the stream) goes to the wgmma kernels (route 1) at a lane tile
    that holds B, or 128 lanes a tile above that."""
    for K in (3, 16, 64, 256):
        for N in (32, 96, 384, 512, 1728):
            for B in (17, 32, 33, 64, 65, 100, 200, 256):
                p = hk.plan(kind, 1, K, N, B, mdt, f32)
                assert p.route == hk.TENSOR == 1 and p.name == "tensor", (K, N, B, p)
                assert p.lanes in hk.TENSOR_LANES and p.lanes >= min(B, 128)
                assert p.chunks == 1


KINDS = ("block_matvec", "precond_dot")
RING_ROUTING = [
    # (kind, N, matrix dtype, vector dtype, aligned, B, route)
    # both kernels' f64 and f32 pairs at 5-16 lanes: the ring
    *[(kind, 384, dt, dt, True, B, hk.RING) for kind in KINDS for dt in (f64, f32)
      for B in (5, 12, 16)],
    # ragged N with 16-byte rows (the copy zero-fills past N): the ring
    *[(kind, N, dt, dt, True, B, hk.RING) for kind in KINDS for N in (216, 104)
      for dt in (f64, f32) for B in (5, 16)],
    # bf16 x f32 (no path launches it at 5-16 lanes), rows that are no
    # 16-byte multiple, misaligned operands: the register stream, 16 lanes
    *[(kind, 384, bf16, f32, True, B, hk.STREAM) for kind in KINDS for B in (5, 16)],
    ("block_matvec", 130, f32, f32, True, 12, hk.STREAM),
    ("precond_dot", 131, f64, f64, True, 12, hk.STREAM),
    ("precond_dot", 102, f32, f32, True, 9, hk.STREAM),
    *[(kind, N, dt, dt, False, 12, hk.STREAM) for kind in KINDS for N in (384, 216)
      for dt in (f64, f32)],
    # 1-4 lanes stay in registers
    *[(kind, N, dt, dt, True, B, hk.STREAM) for kind in KINDS for N in (384, 216)
      for dt in (f64, f32) for B in (1, 4)],
    # f64 vectors above 16 lanes keep the dmma route
    *[(kind, N, f64, f64, True, B, hk.DMMA) for kind in KINDS for N in (384, 216)
      for B in (17, 32)],
]


@pytest.mark.parametrize("kind,N,mdt,vdt,aligned,B,route", RING_ROUTING)
def test_plan_routes_the_ring_at_5_to_16_lanes(kind, N, mdt, vdt, aligned, B, route):
    """The ring takes both kernels' f64 and f32 pairs at 5-16 lanes wherever
    rows are 16-byte multiples and the operands aligned: 64-row blocks of
    16 lanes, the last row tile part full at ragged N.  The register stream
    keeps the rest at 1-16 lanes; dmma keeps f64 vectors above 16."""
    K = 64
    p = hk.plan(kind, 1, K, N, B, mdt, vdt, aligned)
    assert p.route == route, p
    if route == hk.RING:
        assert (p.lanes, p.chunks, p.blocks) == (16, 1, K * math.ceil(N / 64))
    elif route == hk.STREAM:
        assert p.lanes == min(n for n in hk.STREAM_LANES if n >= B)


@pytest.mark.parametrize("K,N,B,dt", [(256, 384, 16, f32), (256, 384, 12, f64),
                                      (64, 216, 16, f64), (64, 384, 5, f64),
                                      (8, 104, 9, f32), (64, 768, 12, f32)])
def test_pd_scratch_covers_the_ring_tiles(K, N, B, dt):
    """precond_dot on the ring: a ticket per k and an rz partial per (lane,
    k, 64-row tile), indexed as the kernel indexes them (tickets[k],
    partials[(b K + k) tiles + row tile])."""
    p = hk.plan("precond_dot", 1, K, N, B, dt, dt)
    assert p.route == hk.RING
    tickets, partials = hk._pd_scratch(p, K, N, B)
    tiles = math.ceil(N / 64)
    assert p.blocks == K * tiles
    assert K - 1 < tickets == K
    assert ((B - 1) * K + K - 1) * tiles + tiles - 1 < partials
    assert partials == B * K * tiles


def test_launches_are_counted_per_signature():
    """The wrappers count launches in total and per (G, K, N, B, dtypes);
    CPU tensors launch nothing, so the counter is driven directly here."""
    hk.reset_launch_counts()
    hk.block_matvec(torch.ones((1, 2, 3, 3)), torch.ones((4, 2, 3)))
    assert hk.launch_counts() == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                                  "stencil2_apply": 0}
    sig = (1, 2, 3, 4, torch.float64, torch.float64)
    hk._count(hk.precond_dot, sig)
    hk._count(hk.precond_dot, sig)
    hk._count(hk.precond_dot, (1, 2, 3, 8, torch.float64, torch.float64))
    assert hk.launch_counts()["precond_dot"] == 3
    assert hk.launch_signature_counts()["precond_dot"][sig] == 2
    assert hk.launch_signatures() == {"block_matvec": set(),
                                      "precond_dot": {sig, sig[:3] + (8,) + sig[4:]},
                                      "stencil3_apply": set(), "stencil2_apply": set()}
    hk.reset_launch_counts()
    assert hk.launch_signature_counts() == {"block_matvec": {}, "precond_dot": {},
                                            "stencil3_apply": {}, "stencil2_apply": {}}
