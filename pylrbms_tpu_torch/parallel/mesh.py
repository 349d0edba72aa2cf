"""The subdomain mesh: one rank per process, a band of K per rank.

The port of ``pylrbms_tpu/parallel/mesh.py``.  JAX runs one controller over
n devices and lets GSPMD insert the collectives; here every rank is a
process (``torch.distributed``), every rank builds the full host model (as
JAX's multi-process ``SubdomainMesh.put`` materializes each process's
shards from the replicated host value) and keeps its contiguous band of the
K subdomains on its device.  K is row-major over the subdomain grid, so a
band is whole subdomain rows in 2D and whole z-layers in 3D.  What XLA
would insert is written out:

* halo rows go by point-to-point exchange (:meth:`SubdomainMesh.exchange`,
  ``ppermute`` -> ``dist.batch_isend_irecv``);
* dot products go by ``all_reduce`` (:meth:`SubdomainMesh.sum`, ``psum``);
* replicated results go by ``all_gather`` (:meth:`SubdomainMesh.gather`).

Backends: :func:`initialize_distributed` takes ``nccl`` for a CUDA device
and ``gloo`` for the CPU unless told otherwise; ``gloo`` with a CUDA device
is used only when the caller passes it (several ranks sharing one card,
where NCCL refuses two ranks on one device).  In that case the
point-to-point halo strips are staged through the host explicitly: gloo's
``send``/``recv`` take host memory (a CUDA tensor aborts the rank, "writev
... Bad address"); its ``all_reduce``, ``all_gather`` and ``broadcast``
take the CUDA tensors and stage them themselves.  The NCCL branch keeps
every tensor on the device.  Nothing switches backend or device on its
own, and a failed init or collective raises.
"""
from __future__ import annotations

import contextlib
import datetime
import inspect
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils.precision import device as _device
from .stencil import BandedBlockOp, BandedStencil

_STATE: dict = {}


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: Optional[str] = None, device=None,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the default process group (<-> ``jax.distributed.initialize``).

    ``init_method`` is a rendezvous URL (``file://...`` or
    ``tcp://localhost:<port>``).  ``backend`` None picks ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU; ``device`` None is the current CUDA
    device (raises without CUDA).  ``timeout_s`` bounds the rendezvous and
    every blocking collective, so a rank that died does not hang the rest
    forever.  Returns the rank's device."""
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl" and "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = dev          # create the communicator now: a failure raises here
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _STATE["device"] = dev
    return dev


class ShardSpec(NamedTuple):
    """Where the K axis of a tensor is: ``k_dim`` (None: replicated)."""
    k_dim: Optional[int]


@dataclass(eq=False)
class SubdomainMesh:
    """1D mesh over the subdomain axis: ``size`` ranks of ``group`` (None:
    the default group), this process being ``rank``, its band on
    ``device``.  ``stats`` counts the collectives (and, with ``timed``,
    their seconds, the device synchronized around each)."""
    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    timed: bool = False
    stats: dict = field(default_factory=dict)

    def __post_init__(self):
        self.reset_stats()
        # gloo's send/recv take host memory: stage the halo strips explicitly
        self._host_p2p = self.backend == "gloo" and self.device.type == "cuda"

    @staticmethod
    def create(n: Optional[int] = None, device=None) -> Optional["SubdomainMesh"]:
        """Mesh over the first ``n`` ranks of the initialized default group
        (default: all of them).  For ``n`` below the world size every rank
        must call it (it creates a subgroup); ranks outside get None."""
        if not dist.is_initialized():
            raise RuntimeError("SubdomainMesh.create needs an initialized process group "
                               "(initialize_distributed)")
        world, rank = dist.get_world_size(), dist.get_rank()
        n = world if n is None else int(n)
        if not 1 <= n <= world:
            raise ValueError(f"mesh size {n} outside 1..{world}")
        group = None if n == world else dist.new_group(list(range(n)))
        if rank >= n:
            return None
        if device is None and "device" in _STATE:
            device = _STATE["device"]
        dev = _device(device)
        return SubdomainMesh(group=group, size=n, rank=rank if group is None
                             else dist.get_rank(group), device=dev,
                             backend=dist.get_backend(group))

    @property
    def axis(self) -> str:
        return "k"

    def shard_k(self, ndim_before_k: int = 0) -> ShardSpec:
        """The spec of a tensor whose K axis is at position ``ndim_before_k``."""
        return ShardSpec(ndim_before_k)

    def replicated(self) -> ShardSpec:
        return ShardSpec(None)

    def reset_stats(self) -> None:
        self.stats.update(exchanges=0, exchange_s=0.0, exchange_bytes=0,
                          allreduces=0, allreduce_s=0.0, gathers=0, gather_s=0.0)

    # ------------------------------------------------------------------
    def band(self, K: int):
        """(k0, k1): this rank's contiguous band of the K subdomains."""
        if K % self.size:
            raise ValueError(f"K={K} not divisible by mesh size {self.size}")
        b = K // self.size
        return self.rank * b, (self.rank + 1) * b

    def put(self, x, spec: ShardSpec):
        """This rank's band of ``x`` (a tensor or array) along ``spec.k_dim``
        on the rank's device (replicated specs: all of ``x``)."""
        x = torch.as_tensor(x)
        if spec.k_dim is None:
            return x.to(self.device)
        k0, k1 = self.band(x.shape[spec.k_dim])
        return x.narrow(spec.k_dim, k0, k1 - k0).to(self.device).contiguous()

    def globalize(self, x):
        """Replicate a host value onto every rank's device."""
        return self.put(x, self.replicated())

    def gather(self, x, spec: ShardSpec):
        """The full tensor from the ranks' bands along ``spec.k_dim``
        (all_gather), on this rank's device; replicated specs return x."""
        if spec.k_dim is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        with self._timer("gather"):
            dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=spec.k_dim)

    def to_host(self, x, spec: Optional[ShardSpec] = None):
        """Full host (CPU) value of a banded (``spec``) or replicated tensor."""
        return (x if spec is None else self.gather(x, spec)).cpu()

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _timer(self, kind):
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats[kind + "s"] += 1
        self.stats[kind + "_s"] += time.perf_counter() - t0

    def sum(self, t):
        """Sum of ``t`` over the ranks (all_reduce; a new tensor)."""
        t = t.contiguous().clone()
        with self._timer("allreduce"):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, t):
        """Elementwise maximum of ``t`` over the ranks (all_reduce)."""
        t = t.contiguous().clone()
        with self._timer("allreduce"):
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t, src: int = 0):
        """Rank ``src``'s value of ``t`` on every rank (a new tensor): makes
        a host-side input, computed on every rank, bitwise the same."""
        t = t.contiguous().clone()
        with self._timer("allreduce"):
            dist.broadcast(t, self._peer(src), group=self.group)
        return t

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def exchange(self, first=None, last=None):
        """Halo exchange with the mesh neighbors: ``first`` (this band's
        first row) goes to rank - 1 and ``last`` (its last row) to rank + 1.
        Returns ``(from_below, from_above)``: rank - 1's ``last`` and rank +
        1's ``first`` (None where there is no neighbor or nothing is sent
        that way).  One ``batch_isend_irecv``; over gloo with CUDA tensors
        the strips go through host buffers."""
        below = self.rank > 0 and last is not None
        above = self.rank < self.size - 1 and first is not None
        send_down = self.rank > 0 and first is not None
        send_up = self.rank < self.size - 1 and last is not None
        if not (below or above or send_down or send_up):
            return None, None
        stage = self._host_p2p
        ref = first if first is not None else last

        def buf(t):
            t = t.contiguous()
            return t.cpu() if stage else t

        ops, recv = [], {}
        if send_down:
            ops.append(dist.P2POp(dist.isend, buf(first), self._peer(self.rank - 1), self.group))
        if send_up:
            ops.append(dist.P2POp(dist.isend, buf(last), self._peer(self.rank + 1), self.group))
        if below:
            recv["below"] = torch.empty(last.shape, dtype=last.dtype,
                                        device="cpu" if stage else last.device)
            ops.append(dist.P2POp(dist.irecv, recv["below"], self._peer(self.rank - 1),
                                  self.group))
        if above:
            recv["above"] = torch.empty(first.shape, dtype=first.dtype,
                                        device="cpu" if stage else first.device)
            ops.append(dist.P2POp(dist.irecv, recv["above"], self._peer(self.rank + 1),
                                  self.group))
        with self._timer("exchange"):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            out = tuple(recv[k].to(ref.device) if k in recv else None
                        for k in ("below", "above"))
        self.stats["exchange_bytes"] += sum(v.numel() * v.element_size()
                                            for v in recv.values())
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    # ------------------------------------------------------------------
    def distribute_model(self, d) -> dict:
        """This rank's bands of the big per-subdomain tensors of a
        ``StationaryBlockModel``: ``A_diag`` [Q, Kb, N, N], ``rhs_q``
        [Qf, Kb, N], every product with a leading K axis (``products``)
        and the estimator tensors (``estimator``; a lean model's ``None``
        tensors are skipped).  The model itself is left as it is (the JAX
        version shards it in place; here the unsharded port keeps running
        on ``d``).  K must be divisible by the mesh size."""
        K = d.space.K
        self.band(K)
        out = {"A_diag": self.put(d.op.A_diag, self.shard_k(1)),
               "rhs_q": self.put(d.rhs_q, self.shard_k(1)),
               "products": {key: self.put(v, self.shard_k(0)) for key, v in d.products.items()
                            if isinstance(v, torch.Tensor) and v.ndim >= 1
                            and v.shape[0] == K},
               "estimator": {}}
        ed = d.estimator.data if d.estimator is not None else None
        if ed is not None:
            from ..estimators import K_AXIS
            for name, k_dim in K_AXIS.items():
                v = getattr(ed, name)
                if v is not None:
                    out["estimator"][name] = self.put(v, self.shard_k(k_dim))
        return out

    def shard_stencil(self, sop):
        """This rank's band of a matrix-free stencil operator (2D or 3D
        family) with one halo subdomain row (2D) or z-layer (3D) on each
        side that has a neighbor: a
        :class:`~pylrbms_tpu_torch.parallel.stencil.BandedStencil`, whose
        assembled ``apply`` exchanges the halo rows of x and applies the
        unsharded stencil on band + halo.  The number of subdomain rows
        (z-layers) must be divisible by the mesh size."""
        return BandedStencil(self, sop)

    def mf_solve(self, bsop, theta, b, block_factors=None, coarse_basis=None,
                 coarse_inv=None, tol: float = 1e-10, maxiter: int = 2000,
                 coarse_f32: bool = False, x0=None):
        """K-sharded matrix-free PCG (<-> ``jit_mf_solve``): ``bsop`` from
        :meth:`shard_stencil`, ``b`` and ``block_factors`` this rank's bands
        ([Kb, N], [Kb, N, N]), and optionally the coarse level:
        ``coarse_basis`` banded [Kb, N, m] with ``coarse_inv`` replicated
        [K*m, K*m].  The coarse step is ``C^T r`` all-reduced, the coarse
        solve replicated and ``C e`` local.  Pass no block factors for the
        cell-block Jacobi; ``x0`` (this rank's band) warm-starts it.
        Returns ``(U band, iterations)``."""
        return bsop.assemble(theta).solve_pcg(
            b, tol=tol, maxiter=maxiter, block_factors=block_factors,
            coarse_basis=coarse_basis, coarse_inv=coarse_inv, coarse_f32=coarse_f32,
            return_iters=True, x0=x0)

    def online_step(self, d, tol: float = 1e-8, maxiter: int = 500,
                    positive_form: bool = False):
        """K-sharded online step (<-> ``jit_online_step``): ``(theta,
        theta_f, mu) -> (U band [Kb, N], indicators band [Kb])``.

        Assembly, the block-Jacobi PCG (the diagonal blocks through
        ``block_matvec``, the preconditioner through ``precond_dot``, one
        halo exchange per matvec) and the per-subdomain estimator einsums
        run on the rank's band.  The Oswald interpolation and the flux
        reconstruction need neighbor values across the band's edges: U is
        all-gathered (K N numbers, 0.2 MB at the 24 576-dof serving grid),
        both operators run on the full U and only the band's rows of their
        results enter the local quantities.  ``positive_form`` takes the
        manifestly non-negative quantities (the lean models' form) instead
        of the matrix form.  The step keeps the last PCG count in
        ``step.last_iters`` and the band's squared local quantities (nc, r,
        df) [1, Kb] in ``step.last_quantities``, from which
        ``estimators.aggregate_eta(..., norm=psum_norm)`` forms eta."""
        band_t = self.distribute_model(d)
        bop = BandedBlockOp.from_affine(self, d.op, band_t["A_diag"])
        k0, k1 = self.band(d.space.K)
        est = d.estimator
        rhs_q = band_t["rhs_q"]

        def step(theta, theta_f, mu):
            theta = torch.as_tensor(theta, device=self.device).to(d.dtype)
            theta_f = torch.as_tensor(theta_f, device=self.device).to(d.dtype)
            A = bop.assemble(theta)
            b = torch.einsum("q,qkn->kn", theta_f, rhs_q)
            U, it = A.solve_pcg(b, tol=tol, maxiter=maxiter, return_iters=True)
            step.last_iters = int(it)
            U_full = self.gather(U, self.shard_k(0))[None]
            quantities = (est.local_quantities_positive if positive_form
                          else est.local_quantities)
            nc, r, df = quantities(U_full, mu, tensors=band_t["estimator"], band=(k0, k1))
            step.last_quantities = (nc, r, df)
            return U, (nc + r + df)[0]

        step.last_iters = step.last_quantities = None
        return step


def psum_norm(local_sq, mesh: SubdomainMesh):
    """Global 2-norm of rank-local squared contributions (<->
    ``pymor.parallel.mpi.norm``): one all-reduce of their sum."""
    return torch.sqrt(mesh.sum(torch.sum(local_sq)))
