"""Port on the card: the CUDA kernels against their plain versions, and the
online step (affine and stencil forms) and the matrix-free model solve on
CUDA against the port's own CPU run.

Every test is marked ``cuda`` and skips where CUDA is unavailable (the
kernels have no CPU mode).  The module imports no jax, so on a GPU machine
without JAX it runs with the JAX conftest switched off:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# (matrix dtype, vector dtype, tolerance on products, tolerance on rz):
# f64 summation-order rounding; f32 and bf16-stored matrices (widened
# exactly on both sides) at the normwise tests/test_pallas.py bounds
DTYPES = [(torch.float64, torch.float64, 1e-12, 1e-12),
          (torch.float32, torch.float32, 2e-5, 2e-4),
          (torch.bfloat16, torch.float32, 2e-5, 2e-4),
          (torch.bfloat16, torch.float64, 1e-12, 1e-12)]


@pytest.mark.parametrize("G,K,N,B", [(2, 8, 384, 1), (2, 8, 384, 64),
                                     (1, 4, 24, 3), (2, 3, 130, 9),
                                     (1, 8, 1536, 1), (1, 8, 1536, 16),
                                     (2, 8, 384, 256), (2, 8, 384, 100),
                                     (2, 3, 96, 40), (2, 3, 96, 9), (1, 8, 384, 12),
                                     (1, 8, 576, 1), (1, 8, 576, 12), (1, 8, 576, 16),
                                     (1, 8, 768, 1), (1, 8, 768, 12), (1, 8, 768, 16),
                                     (1, 8, 216, 1), (1, 8, 216, 16), (2, 8, 512, 256)])
def test_kernels_match_plain_versions(cuda, G, K, N, B):
    """Every route of each kernel (stream for B <= 16, in its ring form for
    both kernels' f64 and f32 pairs at 5-16 lanes, the f64 tensor cores
    for f64 vectors above that, tensor cores for the f32 serving pairs at
    many lanes, SIMT tiles for the other f32 pairs), the scale
    solve's N=1536 blocks, the serving batch and harvest, a ring with a
    half-empty row tile and masked lanes, ragged N (the ring's zero-filled
    columns where rows are 16-byte multiples, else scalar loads), and the
    order-2 blocks (Q2 quad N=576, P2 tri N=768; 96 KB of staged f64 x at
    16 lanes)."""
    rng = np.random.default_rng(3)
    hk.reset_launch_counts()
    for mdt, vdt, tol, tol_rz in DTYPES:
        A = torch.tensor(rng.normal(size=(G, K, N, N)), device=cuda).to(mdt)
        x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda).to(vdt)
        coef = torch.tensor(rng.normal(size=(B, G)), device=cuda).to(vdt) if G > 1 else None
        y, yp = hk.block_matvec(A, x, coef), hk.block_matvec_plain(A, x, coef)
        (z, rz), (zp, rzp) = hk.precond_dot(A[0].contiguous(), x), hk.precond_dot_plain(A[0], x)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= tol, (mdt, vdt)
        assert _rel(z, zp) <= tol, (mdt, vdt)
        assert _rel(rz, rzp) <= tol_rz, (mdt, vdt)
    assert hk.launch_counts() == {"block_matvec": len(DTYPES), "precond_dot": len(DTYPES),
                                  "stencil3_apply": 0,
                                  "stencil2_apply": 0}
    assert hk.launch_signatures() == {
        "block_matvec": {(G, K, N, B, mdt, vdt) for mdt, vdt, *_ in DTYPES},
        "precond_dot": {(1, K, N, B, mdt, vdt) for mdt, vdt, *_ in DTYPES},
        "stencil3_apply": set(), "stencil2_apply": set()}


@pytest.mark.parametrize("N,B,fdt,rdt", [(1536, 1, torch.float32, torch.float32),
                                         (384, 4, torch.bfloat16, torch.float32),
                                         (384, 256, torch.bfloat16, torch.float32),
                                         (384, 64, torch.float64, torch.float64),
                                         (512, 32, torch.float64, torch.float64),
                                         (216, 17, torch.bfloat16, torch.float64)])
def test_precond_dot_rz_is_bitwise_reproducible(cuda, N, B, fdt, rdt):
    """rz is summed in a fixed order on every route (the stream route's
    per-block partials by the last block of each subdomain): two launches
    on the same input give the same bits."""
    rng = np.random.default_rng(23)
    K = 16
    F = torch.tensor(rng.normal(size=(K, N, N)), device=cuda).to(fdt)
    r = torch.tensor(rng.normal(size=(B, K, N)), device=cuda).to(rdt)
    (z1, rz1), (z2, rz2) = hk.precond_dot(F, r), hk.precond_dot(F, r)
    torch.cuda.synchronize()
    assert torch.equal(rz1, rz2) and torch.equal(z1, z2)
    assert _rel(rz1, hk.precond_dot_plain(F, r)[1]) <= (1e-12 if rdt == torch.float64 else 2e-4)


@pytest.mark.parametrize("G,K,N,B", [(1, 32, 512, 32), (1, 256, 384, 128), (1, 32, 512, 128),
                                     (1, 64, 384, 128), (1, 16, 384, 128), (1, 64, 384, 21),
                                     (1, 64, 24, 100), (2, 64, 384, 128), (1, 64, 216, 32),
                                     (1, 64, 216, 17), (1, 64, 384, 256), (2, 8, 130, 40),
                                     (1, 8, 131, 33)])
@pytest.mark.parametrize("mdt", [torch.float64, torch.bfloat16])
def test_dmma_route_matches_plain_versions(cuda, G, K, N, B, mdt):
    """The dmma route (f64 vectors above the stream) at the shapes the
    paths launch, G=2 with coef, ragged N and lane tails, and rows that are
    no 16-byte multiple (N=130 bf16, N=131: the scalar loads): 1e-12 of the
    plain version; z and rz bitwise equal over two launches."""
    rng = np.random.default_rng(29)
    A = torch.tensor(rng.normal(size=(G, K, N, N)), device=cuda).to(mdt)
    x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda)
    coef = torch.tensor(rng.normal(size=(B, G)), device=cuda) if G > 1 else None
    assert hk.plan("block_matvec", G, K, N, B, mdt, x.dtype).route == hk.DMMA
    assert hk.plan("precond_dot", 1, K, N, B, mdt, x.dtype).route == hk.DMMA
    y, yp = hk.block_matvec(A, x, coef), hk.block_matvec_plain(A, x, coef)
    F = A[0].contiguous()
    (z, rz), (z2, rz2) = hk.precond_dot(F, x), hk.precond_dot(F, x)
    zp, rzp = hk.precond_dot_plain(F, x)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= 1e-12 and _rel(z, zp) <= 1e-12 and _rel(rz, rzp) <= 1e-12
    assert torch.equal(rz, rz2) and torch.equal(z, z2)


@pytest.mark.parametrize("N", [96, 216, 384, 768])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [5, 8, 12, 16])
def test_ring_route_matches_plain_versions(cuda, B, dt, N):
    """The ring at 5-16 lanes, both kernels: precond_dot's z and rz (f64
    1e-12; f32 2e-5 / 2e-4) with z and rz bitwise equal over two launches,
    and block_matvec with G=2 and coef; N=216 is ragged (the last stage's
    columns zero-filled), N=96 and 216 end in a part-full row tile."""
    rng = np.random.default_rng(37)
    K = 8
    tol, tol_rz = (1e-12, 1e-12) if dt == torch.float64 else (2e-5, 2e-4)
    A = torch.tensor(rng.normal(size=(2, K, N, N)), device=cuda).to(dt)
    x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda).to(dt)
    coef = torch.tensor(rng.normal(size=(B, 2)), device=cuda).to(dt)
    F = A[0].contiguous()
    assert hk.plan("precond_dot", 1, K, N, B, dt, dt).route == hk.RING
    assert hk.plan("block_matvec", 2, K, N, B, dt, dt).route == hk.RING
    (z, rz), (z2, rz2) = hk.precond_dot(F, x), hk.precond_dot(F, x)
    zp, rzp = hk.precond_dot_plain(F, x)
    y, yp = hk.block_matvec(A, x, coef), hk.block_matvec_plain(A, x, coef)
    torch.cuda.synchronize()
    assert _rel(z, zp) <= tol and _rel(rz, rzp) <= tol_rz and _rel(y, yp) <= tol
    assert torch.equal(rz, rz2) and torch.equal(z, z2)


def test_ring_scratch_grows_after_a_smaller_launch(cuda):
    """A ring launch with more lanes, subdomains and row tiles than the one
    before it on the stream: precond_dot's partials have to grow."""
    rng = np.random.default_rng(41)
    for K, N, B in ((4, 96, 5), (64, 768, 16), (256, 384, 12)):
        F = torch.tensor(rng.normal(size=(K, N, N)), device=cuda)
        r = torch.tensor(rng.normal(size=(B, K, N)), device=cuda)
        (z, rz), (z2, rz2) = hk.precond_dot(F, r), hk.precond_dot(F, r)
        zp, rzp = hk.precond_dot_plain(F, r)
        torch.cuda.synchronize()
        assert _rel(z, zp) <= 1e-12 and _rel(rz, rzp) <= 1e-12
        assert torch.equal(rz, rz2) and torch.equal(z, z2)
    ws = hk._PD_WORKSPACE[(r.device, torch.cuda.current_stream().cuda_stream)]
    assert ws[torch.float64].numel() >= 16 * 64 * 12


def test_ring_route_refuses_what_it_does_not_take(cuda):
    """Route 3 of the C entry refuses (cudaErrorInvalidValue) more than 16
    lanes, rows that are no 16-byte multiple, misaligned operands and
    precond_dot without its scratch: nothing is sent to another route."""
    lib, stream = hk._lib(), torch.cuda.current_stream().cuda_stream
    K, N = 2, 64
    F = torch.ones((K, N + 1, N + 1), dtype=torch.float64, device=cuda)
    r = torch.ones((17, K, N + 1), dtype=torch.float64, device=cuda)
    z, rz = torch.empty_like(r), torch.empty((17, K), dtype=torch.float64, device=cuda)
    t, p = torch.zeros(K, dtype=torch.int32, device=cuda), torch.empty(17 * K * 2, device=cuda,
                                                                       dtype=torch.float64)

    def pd(n, b, f=F, scratch=True):
        return lib.pylrbms_precond_dot(hk.RING, 16, 1, 0, 0, f.data_ptr(), r.data_ptr(),
                                       z.data_ptr(), rz.data_ptr(),
                                       p.data_ptr() if scratch else None,
                                       t.data_ptr() if scratch else None, K, n, b, stream)
    assert pd(N, 16) == 0                                     # taken: N=64, 16 lanes
    assert pd(N, 17) != 0                                     # lanes
    assert pd(N + 1, 16) != 0                                 # 65 f64 = 520 bytes a row
    assert pd(N, 16, f=F.view(-1)[1:]) != 0                  # misaligned F
    assert pd(N, 16, scratch=False) != 0
    torch.cuda.synchronize()


def test_dmma_route_takes_misaligned_operands(cuda):
    """Operands 8 bytes off a 16-byte boundary stay on the dmma route (its
    scalar loads), f64 and bf16 matrices."""
    rng = np.random.default_rng(31)
    K, N, B = 8, 96, 40
    for mdt in (torch.float64, torch.bfloat16):
        buf = torch.tensor(rng.normal(size=K * N * N + 8), device=cuda).to(mdt)
        F = buf[1:1 + K * N * N].view(K, N, N)
        xb = torch.tensor(rng.normal(size=B * K * N + 1), device=cuda)
        x = xb[1:].view(B, K, N)
        assert F.data_ptr() % 16 != 0 and x.data_ptr() % 16 != 0
        y, yp = hk.block_matvec(F[None], x), hk.block_matvec_plain(F[None], x)
        (z, rz), (zp, rzp) = hk.precond_dot(F, x), hk.precond_dot_plain(F, x)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= 1e-12 and _rel(z, zp) <= 1e-12 and _rel(rz, rzp) <= 1e-12


def test_dmma_route_refuses_f32_vectors(cuda):
    """Route 4 of the C entry takes f64 vectors only: an f32 pair is refused
    (cudaErrorInvalidValue), never sent to another route."""
    lib, stream = hk._lib(), torch.cuda.current_stream().cuda_stream
    A = torch.ones((1, 2, 64, 64), device=cuda)
    x, y = torch.ones((40, 2, 64), device=cuda), torch.empty((40, 2, 64), device=cuda)
    assert lib.pylrbms_block_matvec(hk.DMMA, 64, 2, 1, 1, A.data_ptr(), x.data_ptr(), None,
                                    y.data_ptr(), 1, 2, 64, 40, stream) != 0


def test_cuda_tensors_never_take_the_plain_path(cuda):
    A = torch.ones((1, 2, 3, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):          # f64 matrix x f32 vector: no kernel
        hk.block_matvec(A.double(), torch.ones((1, 2, 3), device=cuda))
    with pytest.raises(ValueError):         # non-contiguous input
        hk.precond_dot(A[0].transpose(1, 2), torch.ones((1, 2, 3), device=cuda))



def test_cuda_tensors_on_the_tensor_route_never_take_the_plain_path(cuda, monkeypatch):
    """Serving-batch shapes on the tensor route launch the wgmma kernels:
    the plain versions are never called for CUDA tensors, and a launch the
    route refuses raises instead of falling back (here the C entry stands
    in for a failed launch by returning an error)."""
    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor took the plain path")
    rng = np.random.default_rng(43)
    K, N, B = 4, 96, 40
    A = torch.tensor(rng.normal(size=(2, K, N, N)), device=cuda, dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda, dtype=torch.float32)
    coef = torch.tensor(rng.normal(size=(B, 2)), device=cuda, dtype=torch.float32)
    F = A[0].to(torch.bfloat16)
    yp, (zp, rzp) = hk.block_matvec_plain(A, x, coef), hk.precond_dot_plain(F, x)
    monkeypatch.setattr(hk, "block_matvec_plain", no_plain)
    monkeypatch.setattr(hk, "precond_dot_plain", no_plain)
    assert hk.plan("block_matvec", 2, K, N, B, A.dtype, x.dtype).route == hk.TENSOR
    assert hk.plan("precond_dot", 1, K, N, B, F.dtype, x.dtype).route == hk.TENSOR
    hk.reset_launch_counts()
    y, (z, rz) = hk.block_matvec(A, x, coef), hk.precond_dot(F, x)
    torch.cuda.synchronize()
    assert hk.launch_counts() == {"block_matvec": 1, "precond_dot": 1, "stencil3_apply": 0,
                                  "stencil2_apply": 0}
    assert _rel(y, yp) <= 2e-5 and _rel(z, zp) <= 2e-5 and _rel(rz, rzp) <= 2e-4

    class Refusing:
        pylrbms_block_matvec = pylrbms_precond_dot = staticmethod(lambda *a: 1)
    monkeypatch.setattr(hk, "_lib", lambda: Refusing)
    with pytest.raises(RuntimeError):
        hk.block_matvec(A, x, coef)
    with pytest.raises(RuntimeError):
        hk.precond_dot(F, x)


def _tensor_entry(kind, A, x, coef, lanes):
    """One launch through the C entry on the tensor route at ``lanes`` lanes
    a block, with precond_dot's scratch sized for that tile."""
    lib, stream = hk._lib(), torch.cuda.current_stream().cuda_stream
    G, K, N, _ = A.shape
    B = x.shape[0]
    y = torch.empty_like(x)
    if kind == "block_matvec":
        rc = lib.pylrbms_block_matvec(hk.TENSOR, lanes, 1, 1, 1, A.data_ptr(),
                                      x.data_ptr(), None if coef is None else coef.data_ptr(),
                                      y.data_ptr(), G, K, N, B, stream)
        assert rc == 0
        return y, None
    nt, npart = hk._pd_scratch(hk.Plan(hk.TENSOR, lanes, 1, 0), K, N, B)
    t = torch.zeros(nt, dtype=torch.int32, device=x.device)
    part = torch.empty(npart, dtype=torch.float32, device=x.device)
    rz = torch.empty((B, K), dtype=torch.float32, device=x.device)
    F = A[0].to(torch.bfloat16)
    rc = lib.pylrbms_precond_dot(hk.TENSOR, lanes, 1, 2, 1, F.data_ptr(), x.data_ptr(),
                                 y.data_ptr(), rz.data_ptr(), part.data_ptr(), t.data_ptr(),
                                 K, N, B, stream)
    assert rc == 0
    return y, rz


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("N", [32, 96, 384])
@pytest.mark.parametrize("K", [3, 64])
@pytest.mark.parametrize("B", [13, 32, 33, 200])
def test_tensor_route_matches_plain_versions(cuda, B, K, N, G):
    """The wgmma tensor route (C entry, route 1) at the lanes plan() picks
    for the shape, with tails: lanes past B in the last lane tile (13, 33,
    200), rows past N in the last 128-row tile (N=32 and 96), G=2 with coef
    (block_matvec), one stage (N=32) and many; f32 tolerance 2e-5 on the
    products, 2e-4 on rz, and z and rz equal over two launches.  Where plan() takes the route (B > 16), the wrapper too."""
    rng = np.random.default_rng(47)
    A = torch.tensor(rng.normal(size=(G, K, N, N)), device=cuda, dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda, dtype=torch.float32)
    coef = torch.tensor(rng.normal(size=(B, G)), device=cuda, dtype=torch.float32) \
        if G > 1 else None
    tile = hk.TENSOR_LANES[0] if B <= hk.TENSOR_LANES[0] else hk.TENSOR_LANES[1]
    y, _ = _tensor_entry("block_matvec", A, x, coef, tile)
    assert _rel(y, hk.block_matvec_plain(A, x, coef)) <= 2e-5
    if B > 16:
        hk.reset_launch_counts()
        assert hk.plan("block_matvec", G, K, N, B, A.dtype, x.dtype).route == hk.TENSOR
        assert _rel(hk.block_matvec(A, x, coef), hk.block_matvec_plain(A, x, coef)) <= 2e-5
        assert hk.launch_counts()["block_matvec"] == 1
    if G == 1:
        F = A[0].to(torch.bfloat16)
        (z, rz), (z2, rz2) = (_tensor_entry("precond_dot", A, x, None, tile),
                              _tensor_entry("precond_dot", A, x, None, tile))
        zp, rzp = hk.precond_dot_plain(F, x)
        torch.cuda.synchronize()
        assert _rel(z, zp) <= 2e-5 and _rel(rz, rzp) <= 2e-4
        assert torch.equal(z, z2) and torch.equal(rz, rz2)


@pytest.mark.parametrize("lanes", hk.TENSOR_LANES)
def test_tensor_route_every_tile_matches_plain_versions(cuda, lanes):
    """Every block tile of the tensor route (32 lanes also at B > 32, where
    plan() takes 128) at a shape with lane, row and stage tails: both
    kernels at the f32 tolerances, rz equal over two launches."""
    rng = np.random.default_rng(53)
    G, K, N, B = 2, 5, 160, 70
    A = torch.tensor(rng.normal(size=(G, K, N, N)), device=cuda, dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda, dtype=torch.float32)
    coef = torch.tensor(rng.normal(size=(B, G)), device=cuda, dtype=torch.float32)
    y, _ = _tensor_entry("block_matvec", A, x, coef, lanes)
    assert _rel(y, hk.block_matvec_plain(A, x, coef)) <= 2e-5
    (z, rz), (z2, rz2) = (_tensor_entry("precond_dot", A, x, None, lanes),
                          _tensor_entry("precond_dot", A, x, None, lanes))
    zp, rzp = hk.precond_dot_plain(A[0].to(torch.bfloat16), x)
    torch.cuda.synchronize()
    assert _rel(z, zp) <= 2e-5 and _rel(rz, rzp) <= 2e-4
    assert torch.equal(z, z2) and torch.equal(rz, rz2)


def test_tensor_route_refuses_what_it_does_not_take(cuda):
    """Route 1 of the C entry refuses (cudaErrorInvalidValue) N % 32 != 0,
    misaligned operands, f64 vectors, a tile it has no kernel for and
    precond_dot without its scratch: nothing is sent to another route."""
    lib, stream = hk._lib(), torch.cuda.current_stream().cuda_stream
    K, B = 2, 40
    A = torch.ones((1, K, 65, 65), device=cuda)
    x, y = torch.ones((B, K, 65), device=cuda), torch.empty((B, K, 65), device=cuda)
    bm = lib.pylrbms_block_matvec
    assert bm(hk.TENSOR, 128, 1, 1, 1, A.data_ptr(), x.data_ptr(), None, y.data_ptr(), 1, K, 64,
              B, stream) == 0                                    # N = 64 over the first rows
    assert bm(hk.TENSOR, 128, 1, 1, 1, A.data_ptr(), x.data_ptr(), None, y.data_ptr(), 1, K, 65,
              B, stream) != 0                                    # N % 32
    assert bm(hk.TENSOR, 128, 1, 1, 1, A.data_ptr() + 4, x.data_ptr(), None, y.data_ptr(), 1,
              K, 64, B, stream) != 0                             # misaligned A
    assert bm(hk.TENSOR, 64, 1, 1, 1, A.data_ptr(), x.data_ptr(), None, y.data_ptr(), 1, K, 64,
              B, stream) != 0                                    # no 64-lane kernel
    xd, yd = x.double(), y.double()
    assert bm(hk.TENSOR, 128, 1, 1, 0, A.data_ptr(), xd.data_ptr(), None, yd.data_ptr(), 1, K,
              64, B, stream) != 0                                # f64 vectors
    F = torch.ones((K, 64, 64), device=cuda, dtype=torch.bfloat16)
    rz = torch.empty((B, K), device=cuda)
    assert lib.pylrbms_precond_dot(hk.TENSOR, 128, 1, 2, 1, F.data_ptr(), x.data_ptr(),
                                   y.data_ptr(), rz.data_ptr(), None, None, K, 64, B,
                                   stream) != 0                  # no scratch
    torch.cuda.synchronize()


def test_online_step_on_cuda_matches_cpu(cuda):
    """Entry config, f64: the CUDA step (bf16 Jacobi factors by default)
    against the CPU f64 step at tol=1e-10, to 1e-8 relative."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.model import make_online_step

    cfg = {"num_subdomains": [2, 2],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    mus = np.array([0.2, 0.7])
    th = torch.tensor(np.stack([np.ones(2), mus], 1))
    tf = torch.ones((2, 1), dtype=torch.float64)
    mu = {"diffusion": torch.tensor(mus[:, None])}
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev)
        step = make_online_step(d, tol=1e-10, maxiter=500, matrix_free="affine",
                                coarse_space="harvested", coarse_modes=4)
        hk.reset_launch_counts()
        U, ind = step(th, tf, mu)
        outs.append((U.cpu(), ind.cpu(), hk.launch_counts()))
    (U0, i0, n0), (U1, i1, n1) = outs
    assert _rel(U1, U0) <= 1e-8 and _rel(i1, i0) <= 1e-8
    assert n0 == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                  "stencil2_apply": 0}
    assert n1["block_matvec"] > 0 and n1["precond_dot"] > 0


@pytest.mark.parametrize("path", ["stencil_step", "mf_solve"])
def test_stencil_path_on_cuda_matches_cpu(cuda, path):
    """f64 model (2x2 subdomains, half 1, nref 2): the stencil online step
    (two lanes) and the matrix-free model solve on CUDA against the same on
    the CPU, to 1e-8 relative; on CUDA the block-Jacobi M of the stencil PCG
    launches precond_dot and the step's applies stencil2_apply, on the CPU
    nothing is launched."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.model import make_online_step

    cfg = {"num_subdomains": [2, 2],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2}
    mus = np.array([0.2, 0.7])
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev)
        if path == "stencil_step":
            step = make_online_step(d, tol=1e-10, maxiter=500, matrix_free=True,
                                    coarse_space="harvested", coarse_modes=4)
            hk.reset_launch_counts()
            U, _ = step(torch.tensor(np.stack([np.ones(2), mus], 1)),
                        torch.ones((2, 1), dtype=torch.float64),
                        {"diffusion": torch.tensor(mus[:, None])})
        else:
            hk.reset_launch_counts()
            U = d.solve(0.7, {"type": "mf_pcg", "precision": 1e-10, "coarse_modes": 4})
        outs.append((U.cpu(), hk.launch_counts()))
    (U0, n0), (U1, n1) = outs
    assert _rel(U1, U0) <= 1e-8
    assert n0 == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                  "stencil2_apply": 0}
    assert n1["precond_dot"] > 0
    # the step's two lanes take the tri P1 lane kernel; the solve's one theta not
    assert (n1["stencil2_apply"] > 0) == (path == "stencil_step")


# CUDA runtime calls that block the host until the device has caught up
# (a copy from pageable host memory ends in one)
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")


@pytest.mark.parametrize("form", [True, "affine"], ids=["stencil", "affine"])
def test_estimate_on_cuda_makes_no_host_sync(cuda, form):
    """f64 model (2x2 subdomains, half 1, nref 2), 8 lanes: the step's
    estimator, its tables built with the step, blocks the host nowhere
    (sync debug mode "error" around the estimator's call; no blocking CUDA
    runtime call inside the step's ``estimate`` span under the profiler),
    and the step's indicators on the card equal the CPU step's to 1e-8."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.model import make_online_step

    cfg = {"num_subdomains": [2, 2],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2}
    mus = np.linspace(0.15, 0.95, 8)
    th, tf = np.stack([np.ones(8), mus], 1), np.ones((8, 1))
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev)
        step = make_online_step(d, tol=1e-10, maxiter=500, matrix_free=form,
                                coarse_space="harvested", coarse_modes=4)
        mu = {"diffusion": torch.tensor(mus[:, None], device=dev)}
        U, ind = step(th, tf, mu)
        outs.append(ind.cpu())
    U = U.contiguous()
    tensors = {"E_bar": step.arrays["E_bar"]}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q = d.estimator.local_quantities_positive(U, mu, tensors=tensors)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _rel((q[0] + q[1] + q[2]).cpu(), outs[1]) <= 1e-12   # the Oswald sums' atomics

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(th, tf, mu)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [e.time_range for e in events if e.name == "estimate"]
    blocking = [e for e in events if e.name in BLOCKING
                and any(s.start <= e.time_range.start <= s.end for s in spans)]
    assert len(spans) == 1 and blocking == []
    assert _rel(outs[1], outs[0]) <= 1e-8


@pytest.mark.parametrize("B", [2, 8, 32, 256])
def test_corrector_shapes_match_plain_versions(cuda, B):
    """The batched corrector's launches at the north-star width: f64 x f64,
    G=1, K=256, N=384, B marked patches (the stream at 2 lanes, its ring
    form at 8; dmma at 32 and 256), after a K=64 launch so precond_dot's
    scratch has to grow."""
    rng = np.random.default_rng(5)
    f64 = torch.float64
    for K in (64, 256):
        A = torch.tensor(rng.normal(size=(1, K, 384, 384)), device=cuda)
        x = torch.tensor(rng.normal(size=(B, K, 384)), device=cuda)
        y, yp = hk.block_matvec(A, x), hk.block_matvec_plain(A, x)
        (z, rz), (zp, rzp) = hk.precond_dot(A[0], x), hk.precond_dot_plain(A[0], x)
        (z2, rz2) = hk.precond_dot(A[0], x)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= 1e-12 and _rel(z, zp) <= 1e-12 and _rel(rz, rzp) <= 1e-12
        assert torch.equal(rz, rz2) and torch.equal(z, z2)
        assert (1, K, 384, B, f64, f64) in hk.launch_signatures()["precond_dot"]


@pytest.mark.parametrize("stencil", [False, True], ids=["dense", "stencil"])
def test_corrector_on_cuda_matches_dense_patch_solve(cuda, stencil, monkeypatch):
    """3x3 subdomains, half 1, nref 2 (N=96), f64: the batched corrector on
    the card against the port's dense patch solve (1e-8 at PCG tol 1e-10);
    the dense apply launches both kernels, the stencil apply precond_dot.
    The PCG body replayed as a CUDA graph against the eager body: 1e-12
    (the dense apply's ``index_add_`` sums with atomics, in no fixed
    order)."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.ops.corrector import BatchedCorrector

    cfg = {"num_subdomains": [3, 3],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2}
    d, _ = discretize(init_grid_and_problem(cfg), device=cuda)
    mu = d.parse_parameter(0.6)
    U0 = 0.4 * d.solve(mu)
    bc = BatchedCorrector(d)
    if stencil:
        bc.enable_stencil()
    marked = [0, 4, 5]
    hk.reset_launch_counts()
    W = bc.solve(marked, mu, current_solution=U0)
    n = hk.launch_counts()
    # the body is one CUDA graph: the host launches it once eagerly and once
    # in the capture, then replays it (r0 takes one launch, a restart one)
    assert 3 <= n["precond_dot"] <= 4 < bc.last_iters
    # the residual rhs takes one block apply; the dense patch apply one per
    # body launched and one for the true residual that confirms the stop
    assert n["block_matvec"] == (1 if stencil else n["precond_dot"] + 1)
    # the eager body: one launch per PCG body evaluation (and one for r0);
    # the body runs in chunks of 16 between convergence checks, frozen once
    # converged
    monkeypatch.setattr(BatchedCorrector, "_graph", lambda self, body, state: (body(*state), body))
    hk.reset_launch_counts()
    W_eager = bc.solve(marked, mu, current_solution=U0)
    n = hk.launch_counts()
    assert bc.last_iters + 1 <= n["precond_dot"] <= bc.last_iters + 16
    assert n["block_matvec"] == (1 if stencil else n["precond_dot"] + 1)
    assert _rel(W, W_eager) <= 1e-12
    for i, k in enumerate(marked):
        w = d.solve_for_local_correction(k, None, mu, current_solution=U0)
        assert _rel(W[i], w) <= 1e-8


def test_reduce_and_greedy_on_cuda_match_cpu(cuda):
    """2x2 subdomains, f64: the reduced tensors (1e-10), the greedy's
    selections and max_etas (1e-6) on the card against the CPU run; the
    Gramians' operator applies launch block_matvec."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.greedy import weak_greedy
    from pylrbms_tpu_torch.reductor import ReducedModel

    cfg = {"num_subdomains": [2, 2],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    out = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev)
        hk.reset_launch_counts()
        res = weak_greedy(d, d.parameter_space.sample_uniformly(6), target_error=1e-12,
                          max_extensions=3)
        out.append((res, hk.launch_counts()))
    (r0, n0), (r1, n1) = out
    assert n0["block_matvec"] == 0 and n1["block_matvec"] > 0
    assert r1.rd.A_red.is_cuda
    assert [float(m["diffusion"]) for m in r1.chosen_mus] == \
        [float(m["diffusion"]) for m in r0.chosen_mus]
    np.testing.assert_allclose(r1.max_etas, r0.max_etas, rtol=1e-6)
    for name in ReducedModel._ARRAY_FIELDS:
        assert _rel(getattr(r1.rd, name).cpu(), getattr(r0.rd, name)) <= 1e-10, name


@pytest.mark.parametrize("kind,N,B,fdt,rdt,route", [
    ("precond_dot", 384, 8, "float64", "float64", hk.RING),
    ("precond_dot", 768, 8, "float64", "float64", hk.RING),
    ("precond_dot", 384, 8, "bfloat16", "float64", hk.STREAM),
    ("precond_dot", 768, 8, "bfloat16", "float64", hk.STREAM),
    ("precond_dot", 384, 256, "bfloat16", "float32", hk.TENSOR),
    ("precond_dot", 1728, 32, "bfloat16", "float32", hk.TENSOR),
    ("block_matvec", 384, 256, "float32", "float32", hk.TENSOR),
    ("block_matvec", 512, 32, "float32", "float32", hk.TENSOR)])
def test_first_launch_of_a_process_may_need_48_kb_of_shared_memory(cuda, kind, N, B, fdt, rdt,
                                                                    route):
    """A kernel as the first launch of a fresh process (a kernel's opt-in to
    more than 48 KB of shared memory sticks for the life of a process):
    precond_dot at 8 lanes, f64 vectors, takes the ring with an f64 F (64
    KB of stages) and the register stream at 16 lanes with a bf16 F, which
    stages 64 KB (N=384) or 96 KB (N=768, the P2 blocks) of x beside its
    static reduction scratch; the tensor route (f32 vectors, 32 and 256
    lanes) takes 96-193 KB of TMA stages.  All have to opt in."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tol = (1e-12, 1e-12) if rdt == "float64" else (2e-5, 2e-4)
    code = (
        "import torch\n"
        "from pylrbms_tpu_torch.ops import hopper_kernels as hk\n"
        "g = torch.Generator(device='cuda').manual_seed(1)\n"
        f"F = torch.randn((1, 8, {N}, {N}), generator=g, device='cuda', "
        f"dtype=torch.float64).to(torch.{fdt})\n"
        f"r = torch.randn(({B}, 8, {N}), generator=g, device='cuda', "
        f"dtype=torch.float64).to(torch.{rdt})\n"
        f"p = hk.plan('{kind}', 1, 8, {N}, {B}, F.dtype, r.dtype)\n"
        f"assert p.route == {route} and (p.route == hk.TENSOR or p.lanes == 16), p\n"
        f"if '{kind}' == 'precond_dot':\n"
        "    z, rz = hk.precond_dot(F[0], r)\n"
        "    zp, rzp = hk.precond_dot_plain(F[0], r)\n"
        "else:\n"
        "    z, rz = hk.block_matvec(F, r), None\n"
        "    zp, rzp = hk.block_matvec_plain(F, r), None\n"
        "torch.cuda.synchronize()\n"
        f"assert float((z - zp).abs().max() / zp.abs().max()) <= {tol[0]}\n"
        "if rz is not None:\n"
        f"    assert float((rz - rzp).abs().max() / rzp.abs().max()) <= {tol[1]}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         env=dict(os.environ, PYTHONPATH=repo), text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_parabolic_paths_on_cuda_match_cpu(cuda):
    """Artificial channels, 3x2 subdomains, f64, nt=4: the dense and the
    matrix-free trajectories, solve_batch with exact per-mu factors (one
    precond_dot launch over B*K blocks), the parabolic reductor's tensors and
    the reduced estimate on the card against the CPU run.  The matrix-free
    routes apply f32 block factors: U to 1e-8 (solve tolerance 1e-10)."""
    from pylrbms_tpu_torch.problems.artificial_channels import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize
    from pylrbms_tpu_torch.reductor import ParabolicLRBMSReductor

    cfg = {"num_subdomains": [3, 2],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    mus = [{"switch": s} for s in (0.2, 0.5, 0.9)]
    out = []
    for dev in ("cpu", cuda):
        im, _ = discretize(init_grid_and_problem(cfg), T=1.0, nt=4, device=dev)
        hk.reset_launch_counts()
        U = im.solve(mus[1])
        U_mf = im._solve_mf(im.parse_parameter(mus[1]), 0.25, two_level=True, coarse_modes=4)
        Ub = im.solve_batch(mus, shared_preconditioner=False, two_level=True, coarse_modes=4)
        red = ParabolicLRBMSReductor(im.stationary)
        red.extend_basis(U[1::2])
        rd = red.reduce().attach_instationary(im)
        eta, _ = rd.estimate(rd.solve(mus[0]), mus[0])
        out.append((U, U_mf, Ub, rd, eta, hk.launch_counts()))
    (U0, M0, B0, rd0, e0, n0), (U1, M1, B1, rd1, e1, n1) = out
    assert n0 == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                  "stencil2_apply": 0}
    assert n1["block_matvec"] > 0 and n1["precond_dot"] > 0
    assert U1.is_cuda and _rel(U1.cpu(), U0) <= 1e-10
    assert _rel(M1.cpu(), M0) <= 1e-8 and _rel(B1.cpu(), B0) <= 1e-8
    for name, t in rd0.parabolic.items():
        assert _rel(rd1.parabolic[name].cpu(), t) <= 1e-10, name
    assert abs(float(e1) - float(e0)) <= 1e-9 * abs(float(e0))


@pytest.mark.parametrize("gt,order", [("crisscross", 1), ("tri", 2), ("crisscross", 2),
                                      ("quad", 2)])
def test_stencil_apply_and_estimate_on_cuda_match_cpu(cuda, gt, order):
    """2x2 subdomains, half 1, nref 1, f64: the stencil apply of the
    crisscross and order-2 families (parity masks, nb = 6 and 9), the
    matrix-free solve and the estimate (per-cell tables, RT1) on the card
    against the same on the CPU (apply 1e-12, solve and estimate 1e-8)."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize

    cfg = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1, "grid_type": gt}
    x = None
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev, order=order)
        mu = d.parse_parameter(0.6)
        if x is None:
            x = np.random.default_rng(9).normal(size=(3, d.space.K, d.space.N))
        A = d.mf_operator().assemble(d.theta(mu))
        hk.reset_launch_counts()
        U = d.solve(mu, {"type": "mf_pcg", "precision": 1e-10, "coarse_modes": 4})
        n = hk.launch_counts()
        y = A.apply(torch.tensor(x, device=dev))
        eta = d.estimate(U, mu)
        outs.append((y.cpu(), U.cpu(), float(eta), n))
    (y0, U0, e0, n0), (y1, U1, e1, n1) = outs
    assert _rel(y1, y0) <= 1e-12
    assert _rel(U1, U0) <= 1e-8 and abs(e1 - e0) <= 1e-8 * abs(e0)
    assert n0 == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                  "stencil2_apply": 0} and n1["precond_dot"] > 0


def test_halo_apply_and_trajectory_on_cuda_match_cpu(cuda):
    """SPE10 4x4 subdomains, half 1, nref 1, f64: the halo-dense apply
    (torch.matmul of [K, N, Nh] blocks) and the mixed trajectory with the
    halo inner operator on the card against the CPU (1e-12, 1e-8)."""
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize
    from pylrbms_tpu_torch.ops.halodense import halo_from_assembled

    cfg = {"num_subdomains": [4, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    gpd = init_grid_and_problem(cfg, raster=(4, 4), raster_mode="nearest", max_contrast=1e3)
    outs = []
    for dev in ("cpu", cuda):
        im, _ = discretize(gpd, T=0.5, nt=4, device=dev)
        st = im.stationary
        mu = im.parse_parameter([0.7])
        x = torch.tensor(np.random.default_rng(4).normal(size=(2, st.space.K, st.space.N)),
                         device=dev)
        y = halo_from_assembled(st.assemble(mu)).apply(x)
        hk.reset_launch_counts()
        traj = im._solve_mf(mu, 0.125, tol=1e-10, two_level=False, precision="mixed",
                            inner="halo")
        outs.append((y.cpu(), traj.cpu(), hk.launch_counts()))
    (y0, t0, n0), (y1, t1, n1) = outs
    assert _rel(y1, y0) <= 1e-12 and _rel(t1, t0) <= 1e-8
    assert n0 == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                  "stencil2_apply": 0} and n1["precond_dot"] > 0


@pytest.mark.parametrize("order", [1, 2])
def test_hex3d_stencil_solve_and_estimate_on_cuda_match_cpu(cuda, order):
    """academic3d, 2x1x2 subdomains, half 1 (Q1 nref 1: N=64; Q2 nref 0:
    N=27), f64: the hex stencil apply, the mf_pcg solve, the estimate
    (RT0 / RT_[1] hex) and a dense-corrector batch on the card against the
    CPU (apply 1e-12, solve, estimate and corrector 1e-8)."""
    from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu_torch.ops.corrector import BatchedCorrector

    cfg = {"num_subdomains": [2, 1, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2 - order}
    x = None
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev, order=order)
        mu = d.parse_parameter(0.6)
        if x is None:
            x = np.random.default_rng(9).normal(size=(3, d.space.K, d.space.N))
        A = d.mf_operator().assemble(d.theta(mu))
        hk.reset_launch_counts()
        U = d.solve(mu, {"type": "mf_pcg", "precision": 1e-10, "coarse_modes": 4})
        W = BatchedCorrector(d).solve([0, 3], mu, current_solution=0.5 * U, tol=1e-12,
                                      maxiter=1000)
        n = hk.launch_counts()
        y = A.apply(torch.tensor(x, device=dev))
        eta = d.estimate(U, mu)
        outs.append((y.cpu(), U.cpu(), W.cpu(), float(eta), n))
    (y0, U0, W0, e0, n0), (y1, U1, W1, e1, n1) = outs
    assert _rel(y1, y0) <= 1e-12
    assert _rel(U1, U0) <= 1e-8 and _rel(W1, W0) <= 1e-8 and abs(e1 - e0) <= 1e-8 * abs(e0)
    assert n0 == {"block_matvec": 0, "precond_dot": 0, "stencil3_apply": 0,
                  "stencil2_apply": 0}
    assert n1["block_matvec"] > 0 and n1["precond_dot"] > 0


# the lane-batched 3D hex stencil kernel: the SPE10 3D cell's configuration
# (4x4x2 subdomains of 4^3 cells, K=32, Q=2) and grids with one subdomain
# along an axis and s = 1, 2, 4 (random components)
SPE10_3D = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
            "num_refinements": 2, "grid_type": "hex"}
S3_GRIDS = [(1, 1, 1, 1), (1, 1, 1, 4), (2, 1, 1, 2), (1, 3, 1, 1), (1, 1, 2, 4),
            (2, 3, 2, 2), (3, 2, 1, 1)]


@pytest.fixture(scope="module")
def spe10_3d_ops():
    """{dtype: the SPE10 3D cell's StencilOperator3 on the card}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from pylrbms_tpu_torch.problems.spe10_3d import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    return {dt: discretize(init_grid_and_problem(SPE10_3D), device="cuda", dtype=dt)[0]
            .mf_operator() for dt in (torch.float32, torch.float64)}


def _stencil_against_plain(op, B, dtype, seed):
    """The lane kernel of op (``stencil3_apply`` on hex Q1, ``stencil2_apply``
    on tri P1) on its folded components against the gather in f64 and the
    per-lane assembled apply, as max |diff| over the |.|-sum max sum_q
    |theta_bq| |S_q| |x_b| (A x cancels at contrast 1e4); y bitwise equal
    over two launches."""
    sp, dev = op.space, op.stencils[0].vol.device
    if op.lane_kernel == "stencil3_apply":
        grid = (sp.grid.kz, sp.grid.ky, sp.grid.kx)
        kernel, gather = hk.stencil3_apply, hk.stencil3_apply_plain
    else:
        grid = (sp.grid.ky, sp.grid.kx)
        kernel, gather = hk.stencil2_apply, hk.stencil2_apply_plain
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    theta = (0.1 + 0.9 * torch.rand((B, len(op.stencils)), generator=g, device=dev,
                                    dtype=torch.float64)).to(dtype)
    x = torch.randn((B, sp.K, sp.N), generator=g, device=dev, dtype=torch.float64).to(dtype)
    P, P64 = op.folded(dtype, dev), op.folded(torch.float64, dev)
    y, y2 = kernel(P, theta, x, grid), kernel(P, theta, x, grid)
    ref = gather(P64, theta.double(), x.double(), grid)
    scale = gather(P64.abs(), theta.double().abs(), x.double().abs(), grid).max()
    plain = op.assemble(theta).materialize().apply(x)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    return (float((y.double() - ref).abs().max() / scale),
            float((y - plain).double().abs().max() / scale))


@pytest.mark.parametrize("B", [1, 7, 128, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil3_apply_matches_plain_versions_on_spe10_3d(cuda, spe10_3d_ops, B, dtype):
    """The SPE10 3D cell's shape, lane tails included: f32 within 2e-5 of
    the |.|-sum (the tensor route's 3xTF32 products and f32 sums), f64
    within 1e-12; one launch an apply."""
    hk.reset_launch_counts()
    errs = _stencil_against_plain(spe10_3d_ops[dtype], B, dtype, seed=B)
    assert max(errs) <= (2e-5 if dtype == torch.float32 else 1e-12), errs
    assert hk.launch_signature_counts()["stencil3_apply"] == {(2, 2, 4, 4, 4, B, dtype): 2}


@pytest.mark.parametrize("kz,ky,kx,s", S3_GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil3_apply_matches_plain_versions_on_small_grids(cuda, kz, ky, kx, s, dtype):
    import chip_smoke
    op = chip_smoke.random_stencil_op3(torch, cuda, kz, ky, kx, s, 3, dtype)
    for B in (1, 7, 33):
        errs = _stencil_against_plain(op, B, dtype, seed=B)
        assert max(errs) <= (2e-5 if dtype == torch.float32 else 1e-12), (B, errs)


def test_stencil3_apply_refuses_what_it_does_not_take(cuda):
    import chip_smoke
    op = chip_smoke.random_stencil_op3(torch, cuda, 1, 2, 1, 2, 2, torch.float32)
    P, grid = op.folded(torch.float32, cuda), (1, 2, 1)
    theta = torch.rand((4, 2), device=cuda)
    x = torch.randn((4, 2, 64), device=cuda)
    with pytest.raises(TypeError):                      # f32 stencils, f64 vectors
        hk.stencil3_apply(P, theta.double(), x.double(), grid)
    with pytest.raises(TypeError):                      # vector dtypes differ
        hk.stencil3_apply(P, theta, x.double(), grid)
    with pytest.raises(TypeError):                      # bf16
        hk.stencil3_apply(P.bfloat16(), theta.bfloat16(), x.bfloat16(), grid)
    with pytest.raises(ValueError):                     # shapes
        hk.stencil3_apply(P, theta[:3], x, grid)
    with pytest.raises(ValueError):
        hk.stencil3_apply(P, theta, x, (1, 1, 1))
    with pytest.raises(ValueError):                     # not contiguous
        hk.stencil3_apply(P, theta, torch.randn((4, 2, 128), device=cuda)[..., ::2], grid)
    with pytest.raises(ValueError):                     # misaligned
        hk.stencil3_apply(P, theta, torch.randn(4 * 2 * 64 + 1, device=cuda)[1:]
                          .view(4, 2, 64), grid)
    with pytest.raises(ValueError):                     # one tensor on the CPU
        hk.stencil3_apply(P, theta.cpu(), x, grid)
    lib, stream = hk._lib(), torch.cuda.current_stream(cuda).cuda_stream
    assert lib.pylrbms_stencil3_apply(hk._DTYPE_CODE[torch.bfloat16], P.data_ptr(),
                                      theta.data_ptr(), x.data_ptr(), torch.empty_like(x)
                                      .data_ptr(), 2, *grid, 2, 4, stream) != 0
    torch.cuda.synchronize()


def test_3d_stencil_step_on_cuda_launches_the_kernel_every_apply(cuda, monkeypatch):
    """The SPE10 3D block (2x2x2, nref 1, f32) online step with 3 lanes on
    the card: every operator apply is one stencil3_apply launch
    (``stencil.applies`` = the wrapper's launches, stencil2_apply none), no
    per-lane stencil is built, no blocking CUDA call happens inside an
    ``operator.apply`` span, the components are folded at set-up
    and never in a call, and U and the indicators are the CPU step's to
    1e-4 (f32 solves at tol 1e-6, sums in another order)."""
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu_torch.model import make_online_step
    from pylrbms_tpu_torch.ops import matrixfree3d
    from pylrbms_tpu_torch.problems.spe10_3d import init_grid_and_problem

    cfg = dict(SPE10_3D, num_subdomains=[2, 2, 2], num_refinements=1)
    mus = np.array([0.15, 0.55, 0.95])
    th, tf = np.stack([np.ones(3), mus], 1), np.ones((3, 1))
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev, dtype=torch.float32)
        step = make_online_step(d, tol=1e-6, maxiter=400, matrix_free=True,
                                coarse_space="harvested", coarse_modes=4)
        mu = {"switch": torch.tensor(mus[:, None], dtype=torch.float32, device=dev)}
        outs.append([t.double().cpu() for t in step(th, tf, mu)])

    counters, launches, blocking = _counted_step(step, (th, tf, mu), monkeypatch, matrixfree3d,
                                                 "fold_stencils3")
    assert counters["stencil.applies"] > 0
    assert counters["stencil.applies"] == launches["stencil3_apply"]
    assert launches["stencil2_apply"] == 0
    assert blocking == []
    (U0, i0), (U1, i1) = outs
    assert _rel(U1, U0) <= 1e-4 and _rel(i1, i0) <= 1e-4


# the lane-batched 2D tri P1 stencil kernel: the OS2015 stencil cell's
# configuration (8x8 subdomains of 8^2 cells of two triangles, K=64, Q=2)
# and ragged grids (one subdomain along an axis, s = 1, 2, 3, 4; s = 12
# and 36, more triangles than a block's threads, s = 36 too large for 8
# lanes' rows in shared memory: one lane a block; random components)
OS2015_STENCIL = {"num_subdomains": [8, 8], "half_num_fine_elements_per_subdomain_and_dim": 2,
                  "num_refinements": 2}
S2_GRIDS = [(1, 1, 1), (1, 1, 4), (2, 1, 2), (1, 3, 1), (1, 2, 3), (2, 3, 2), (3, 2, 1),
            (2, 1, 12), (1, 1, 36)]


@pytest.fixture(scope="module")
def os2015_stencil_ops():
    """{dtype: the OS2015 stencil cell's StencilOperator on the card}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    return {dt: discretize(init_grid_and_problem(OS2015_STENCIL), device="cuda", dtype=dt)[0]
            .mf_operator() for dt in (torch.float32, torch.float64)}


@pytest.mark.parametrize("B", [1, 7, 256, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil2_apply_matches_plain_versions_on_os2015(cuda, os2015_stencil_ops, B, dtype):
    """The OS2015 stencil cell's shape, lane tails included: f32 within 2e-5
    of the |.|-sum (f32 sums of 4 x 3 x Q terms), f64 within 1e-12; one
    launch an apply."""
    hk.reset_launch_counts()
    errs = _stencil_against_plain(os2015_stencil_ops[dtype], B, dtype, seed=B)
    assert max(errs) <= (2e-5 if dtype == torch.float32 else 1e-12), errs
    assert hk.launch_signature_counts()["stencil2_apply"] == {(2, 8, 8, 8, B, dtype): 2}
    assert hk.launch_counts()["stencil3_apply"] == 0


@pytest.mark.parametrize("ky,kx,s", S2_GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil2_apply_matches_plain_versions_on_small_grids(cuda, ky, kx, s, dtype):
    import chip_smoke
    op = chip_smoke.random_stencil_op2(torch, cuda, ky, kx, s, 3, dtype)
    for B in (1, 7, 33):
        errs = _stencil_against_plain(op, B, dtype, seed=B)
        assert max(errs) <= (2e-5 if dtype == torch.float32 else 1e-12), (B, errs)


def test_stencil2_apply_refuses_what_it_does_not_take(cuda):
    import chip_smoke
    op = chip_smoke.random_stencil_op2(torch, cuda, 2, 1, 2, 2, torch.float32)
    P, grid = op.folded(torch.float32, cuda), (2, 1)
    theta = torch.rand((4, 2), device=cuda)
    x = torch.randn((4, 2, 24), device=cuda)
    with pytest.raises(TypeError):                      # f32 stencils, f64 vectors
        hk.stencil2_apply(P, theta.double(), x.double(), grid)
    with pytest.raises(TypeError):                      # vector dtypes differ
        hk.stencil2_apply(P, theta, x.double(), grid)
    with pytest.raises(TypeError):                      # bf16
        hk.stencil2_apply(P.bfloat16(), theta.bfloat16(), x.bfloat16(), grid)
    with pytest.raises(ValueError):                     # shapes
        hk.stencil2_apply(P, theta[:3], x, grid)
    with pytest.raises(ValueError):
        hk.stencil2_apply(P, theta, x, (1, 1))
    with pytest.raises(ValueError):                     # not contiguous
        hk.stencil2_apply(P, theta, torch.randn((4, 2, 48), device=cuda)[..., ::2], grid)
    with pytest.raises(ValueError):                     # misaligned
        hk.stencil2_apply(P, theta, torch.randn(4 * 2 * 24 + 1, device=cuda)[1:]
                          .view(4, 2, 24), grid)
    with pytest.raises(ValueError):                     # one tensor on the CPU
        hk.stencil2_apply(P, theta.cpu(), x, grid)
    lib, stream = hk._lib(), torch.cuda.current_stream(cuda).cuda_stream
    assert lib.pylrbms_stencil2_apply(hk._DTYPE_CODE[torch.bfloat16], P.data_ptr(),
                                      theta.data_ptr(), x.data_ptr(), torch.empty_like(x)
                                      .data_ptr(), 2, *grid, 2, 4, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("dim", [2, 3])
def test_lane_form_takes_lanes_of_any_strides_on_cuda(cuda, dim):
    """The lane form hands its kernel a dense x: lanes that are a view (the
    greedy's reconstructed U, an einsum's output) give the per-lane apply's
    result (f64, 1e-12 of the |.|-sum), one launch."""
    import chip_smoke
    op = (chip_smoke.random_stencil_op2(torch, cuda, 2, 1, 2, 2, torch.float64) if dim == 2
          else chip_smoke.random_stencil_op3(torch, cuda, 1, 2, 1, 2, 2, torch.float64))
    theta = torch.rand((3, 2), device=cuda, dtype=torch.float64)
    x = torch.randn((op.space.K, op.space.N, 3), device=cuda,
                    dtype=torch.float64).permute(2, 0, 1)
    assert not x.is_contiguous()
    hk.reset_launch_counts()
    A = op.assemble(theta)
    y = A.apply(x)
    assert hk.launch_counts()[op.lane_kernel] == 1
    ref = A.materialize().apply(x)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-12


def _counted_step(step, args, monkeypatch, fold_module, fold_name):
    """One call of ``step(*args)`` on the card with the timings on, no
    per-lane stencil allowed (``LaneStencil.materialize`` raises) and no fold
    (``fold_module.fold_name`` raises): (counters, launch counts, the names
    of blocking CUDA runtime calls inside ``operator.apply`` spans of a
    profiled second call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pylrbms_tpu_torch.ops.matrixfree import LaneStencil
    from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS

    def no_plain(self):
        raise AssertionError("a per-lane stencil was built on the card")

    def no_fold(*a):
        raise AssertionError("the components were folded in a call")
    monkeypatch.setattr(LaneStencil, "materialize", no_plain)
    monkeypatch.setattr(fold_module, fold_name, no_fold)
    hk.reset_launch_counts()
    GLOBAL_TIMINGS.clear()
    GLOBAL_TIMINGS.enable()
    try:
        step(*args)
        torch.cuda.synchronize()
        counters = dict(GLOBAL_TIMINGS.counters)
    finally:
        GLOBAL_TIMINGS.disable()
        GLOBAL_TIMINGS.clear()
    launches = hk.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [e.time_range for e in events if e.name == "operator.apply"]
    assert spans
    blocking = [e.name for e in events if e.name in BLOCKING
                and any(sp.start <= e.time_range.start <= sp.end for sp in spans)]
    return counters, launches, blocking


def test_2d_stencil_step_on_cuda_matches_cpu(cuda):
    """The OS2015 block (2x2 subdomains, half 1, nref 2: tri P1, s=4), f32,
    3 lanes: the default (stencil) online step on the card, whose applies
    are stencil2_apply launches, against the CPU step (per-lane stencils)
    to 1e-4 (f32 solves at tol 1e-6, sums in another order)."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.model import make_online_step

    cfg = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2}
    mus = np.array([0.15, 0.55, 0.95])
    th, tf = np.stack([np.ones(3), mus], 1), np.ones((3, 1))
    outs = []
    for dev in ("cpu", cuda):
        d, _ = discretize(init_grid_and_problem(cfg), device=dev, dtype=torch.float32)
        step = make_online_step(d, tol=1e-6, maxiter=400, matrix_free=True,
                                coarse_space="harvested", coarse_modes=4)
        mu = {"diffusion": torch.tensor(mus[:, None], dtype=torch.float32, device=dev)}
        hk.reset_launch_counts()
        outs.append([t.double().cpu() for t in step(th, tf, mu)] + [hk.launch_counts()])
    (U0, i0, n0), (U1, i1, n1) = outs
    assert _rel(U1, U0) <= 1e-4 and _rel(i1, i0) <= 1e-4
    assert n0["stencil2_apply"] == 0 and n1["stencil2_apply"] > 0
    assert n1["stencil3_apply"] == 0


def test_2d_stencil_step_at_the_cells_configuration_launches_the_kernel_every_apply(
        cuda, monkeypatch):
    """The OS2015 stencil cell's step (8x8 subdomains, half 2, nref 2, f32,
    the step's default form and preconditioner), 8 lanes on the card: every
    operator apply is one stencil2_apply launch (``stencil.applies`` = its
    launches, stencil3_apply none), no per-lane stencil is built, no
    blocking CUDA call happens inside an ``operator.apply`` span, and the
    components are folded at set-up, never in a call."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.model import make_online_step
    from pylrbms_tpu_torch.ops import matrixfree

    d, _ = discretize(init_grid_and_problem(OS2015_STENCIL), device=cuda, dtype=torch.float32)
    step = make_online_step(d, tol=1e-6, maxiter=400, coarse_space="harvested",
                            coarse_modes=12)
    assert "stencils" in step.arrays
    mus = np.linspace(0.1, 1.0, 8)
    args = (np.stack([np.ones(8), mus], 1), np.ones((8, 1)),
            {"diffusion": torch.tensor(mus[:, None], dtype=torch.float32, device=cuda)})
    counters, launches, blocking = _counted_step(step, args, monkeypatch, matrixfree,
                                                 "fold_stencils2")
    assert counters["stencil.applies"] > 0
    assert counters["stencil.applies"] == launches["stencil2_apply"]
    assert launches["stencil3_apply"] == 0 and launches["block_matvec"] == 0
    assert blocking == []


@pytest.mark.parametrize("N,B,mdt", [(1728, 1, torch.float32), (1728, 32, torch.float32),
                                     (1728, 1, torch.bfloat16), (512, 32, torch.float32)],
                         ids=["pcg-f32", "harvest-f32", "pcg-bf16", "harvest-131k"])
def test_block_matvec_at_the_truth_shapes(cuda, N, B, mdt):
    """The truth solver's block-factor applies at K=256 (the 442k Q2 blocks
    N=1728 and the 131k Q1 blocks N=512): one lane in the PCG, 32 in the
    harvest filter (the tensor route, 32-lane blocks: one chain of the
    full depth), f32 or bf16-stored factors with f32 vectors, against the
    plain version (f32 tolerance 2e-5, normwise)."""
    rng = np.random.default_rng(11)
    K = 256
    A = torch.tensor(rng.normal(size=(1, K, N, N)), device=cuda, dtype=torch.float32).to(mdt)
    x = torch.tensor(rng.normal(size=(B, K, N)), device=cuda, dtype=torch.float32)
    p = hk.plan("block_matvec", 1, K, N, B, mdt, torch.float32)
    if B == 32:                               # the harvest filter: wgmma, 32-lane blocks
        assert p.route == hk.TENSOR and p.lanes == 32, p
    hk.reset_launch_counts()
    y, yp = hk.block_matvec(A, x), hk.block_matvec_plain(A, x)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= 2e-5
    assert hk.launch_signatures()["block_matvec"] == {(1, K, N, B, mdt, torch.float32)}


def test_truth_solve_on_cuda_matches_cpu(cuda):
    """truth_solve (block route, f64 recurrence and f32 IR) on the card
    against the CPU on the fixture of tests/test_truth.py: relres <= 1e-9,
    U to 1e-8, and block_matvec launched on the card only."""
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu_torch.truth import truth_solve

    cfg = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    gpd = init_grid_and_problem_3d(cfg, raster=(2, 4, 4), raster_mode="nearest",
                                   max_contrast=1e3)
    for rec in ("f64", "f32ir"):
        outs = []
        for dev in ("cpu", cuda):
            d, _ = discretize(gpd, device=dev)
            hk.reset_launch_counts()
            U, info = truth_solve(d, {"switch": 0.6}, tol=1e-10, n_harvest=8, extra_modal=3,
                                  recurrence=rec, verbose=False)
            outs.append((U, info["relres"], hk.launch_counts()["block_matvec"]))
        (U0, r0, n0), (U1, r1, n1) = outs
        assert r0 <= 1e-9 and r1 <= 1e-9
        assert float(np.abs(U1 - U0).max() / np.abs(U0).max()) <= 1e-8
        assert n0 == 0 and n1 > 0


def test_distributed_dryrun_two_gloo_ranks_on_the_card(cuda):
    """The multi-rank dry run (``scripts/dryrun_multichip``, the reference's
    sizes) with two gloo ranks sharing the card: every leg held to its
    unsharded reference on rank 0 (1e-8; reduced arrays rtol 1e-12), the
    halo strips staged through host buffers, the kernels launched in the
    ranks on band shapes (K = 2, the band of 2 x 2 subdomains)."""
    from pylrbms_tpu_torch.scripts import dryrun_multichip
    hk.load()                     # the ranks only load the library
    payloads = dryrun_multichip.run(2, device="cuda", backend="gloo", preset="small",
                                    timeout_s=600)
    for p in payloads:
        assert all(p["launches"][k] for k in ("block_matvec", "precond_dot")), p["launches"]
        assert p["peak_bytes"] > 0
    for leg in payloads[0]["result"]:
        assert all(err <= 1e-8 for err in leg["errors"].values()), leg


def test_demo_script_on_cuda_matches_cpu(cuda):
    """The README demo (``scripts/online_adaptive_lrbms``, its own config)
    on the card against the same run on the CPU: detailed and reduced eta
    and each online mu's final eta to 1e-8, the RB sizes equal; both
    kernels launched on the card."""
    from pylrbms_tpu_torch.scripts import online_adaptive_lrbms as demo
    cpu = demo.main(2, 3, device="cpu")
    hk.reset_launch_counts()
    card = demo.main(2, 3, device="cuda")
    assert all(hk.launch_counts()[k] for k in ("block_matvec", "precond_dot")), \
        hk.launch_counts()
    for k in ("eta", "eta_red"):
        assert abs(card[k] - cpu[k]) <= 1e-8 * abs(cpu[k]), k
    assert [n for _, n in card["online"]] == [n for _, n in cpu["online"]]
    for (e, _), (e_c, _) in zip(card["online"], cpu["online"]):
        assert abs(e - e_c) <= 1e-8 * abs(e_c)


def test_os2015_study_script_on_cuda_matches_cpu(cuda):
    """``scripts/OS2015_convergence_study`` (Tables 1-3, two levels) on the
    card against the same run on the CPU: every norm, indicator and
    estimate of the four tables to 1e-8, the level infos equal."""
    from pylrbms_tpu_torch.scripts import OS2015_convergence_study as os2015
    cpu = os2015.main(1, device="cpu")
    card = os2015.main(1, device="cuda")
    for t, t_c in zip(card, cpu):
        assert t["levels"] == t_c["levels"]
        for lvl, data in t_c["data"].items():
            for group in ("norm", "indicator", "estimate"):
                assert t["data"][lvl].get(group, {}).keys() == data.get(group, {}).keys()
                for k, v in data.get(group, {}).items():
                    assert abs(t["data"][lvl][group][k] - v) <= 1e-8 * abs(v), (lvl, k)
