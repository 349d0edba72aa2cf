"""Guard: the port does all that the JAX package does, except what it names.

For every module of ``pylrbms_tpu`` the port's module of the same path
must exist and hold every public function and class the JAX module
defines; every public member of such a class (inherited ones included)
must exist on the port's class; and every parameter name of a JAX
function or method must be accepted by its port (``inspect.signature``;
a ``**kwargs`` accepts any name).  ``ALLOWLIST`` names each deliberate
difference with its reason — the reference's XLA/TPU machinery, the
``torch.distributed`` mesh and the banded signatures, and attributes the
port sets in ``__init__`` instead of on the class.  An entry without a
reason fails, and so does one that no difference needs any more.

``docs/torch/API.md`` lists the signatures of the port's user-facing
modules; each of its ``### `module` `` sections must equal
:func:`render` of that module (regenerate a section with
``python -c "from tests.test_torch_api_complete import render;
print(render('pylrbms_tpu_torch.la.block'))"``).
"""
import importlib
import inspect
import pathlib
import pkgutil
import re

import pytest

pytest.importorskip("torch")

import pylrbms_tpu  # noqa: E402
import pylrbms_tpu_torch  # noqa: E402

_XLA = "XLA/TPU compile machinery (bucketed jit prefetch); torch runs eagerly"
_CPU_BRANCH = ("TPU f64 emulation: on the CPU branch, which the port takes at every "
               "backend gate, it is a plain inverse / solve (torch.linalg)")
_MESH = ("parallel/mesh.py is torch.distributed, one process per rank: the jax Mesh, "
         "device counts and axis names have no counterpart")
_BANDED = ("the port's banded layout takes the BlockOpStatic and the dict of coupling "
           "families, which also carries the 3D W family")

# qualified JAX name (module, module.name, module.Class.member or
# module.function:parameter) -> why the port has no counterpart
ALLOWLIST = {
    # do not port
    "pylrbms_tpu.ops.pallas_kernels": ("the Pallas kernels; their port is the hand-written "
                                       "CUDA of ops/hopper_kernels.py (csrc/block_kernels.cu)"),
    "pylrbms_tpu.reference_impl": "numpy oracles of the JAX package's own tests",
    "pylrbms_tpu.reference_impl.estimator_np": "numpy oracle of the JAX package's own tests",
    "pylrbms_tpu.reference_impl.greedy_np": "numpy oracle of the JAX package's own tests",
    "pylrbms_tpu.reference_impl.swipdg_np": "numpy oracle of the JAX package's own tests",
    "pylrbms_tpu.utils.cache": "the JAX persistent compilation cache",
    "pylrbms_tpu.utils.precision.hp": ("jax.default_matmul_precision('highest') at trace time; "
                                       "the port pins torch's matmul precision once "
                                       "(utils/precision.pin_precision)"),
    "pylrbms_tpu.reductor.LRBMSReductor.prefetch_bucket": _XLA,
    "pylrbms_tpu.reductor.ParallelLRBMSReductor.prefetch_bucket": _XLA,
    "pylrbms_tpu.reductor.ParabolicLRBMSReductor.prefetch_bucket": _XLA,
    "pylrbms_tpu.ops.corrector.BatchedCorrector.prefetch_buckets": _XLA,
    "pylrbms_tpu.parallel.mesh.SubdomainMesh.jit_mf_solve": _XLA + " (mesh.mf_solve runs it)",
    "pylrbms_tpu.parallel.mesh.SubdomainMesh.jit_online_step": _XLA + " (mesh.online_step runs it)",
    "pylrbms_tpu.la.block.dense_inv_mixed": _CPU_BRANCH,
    "pylrbms_tpu.la.block.dense_solve_mixed": _CPU_BRANCH,
    "pylrbms_tpu.la.block.AssembledBlockOp.solve_refined": _CPU_BRANCH,
    "pylrbms_tpu.parallel.mesh.initialize_distributed:coordinator_address": _MESH,
    "pylrbms_tpu.parallel.mesh.initialize_distributed:num_processes": _MESH,
    "pylrbms_tpu.parallel.mesh.initialize_distributed:process_id": _MESH,
    "pylrbms_tpu.parallel.mesh.SubdomainMesh.__init__:mesh": _MESH,
    "pylrbms_tpu.parallel.mesh.SubdomainMesh.create:n_devices": _MESH,
    "pylrbms_tpu.parallel.mesh.SubdomainMesh.create:axis": _MESH,
    "pylrbms_tpu.parallel.mesh.SubdomainMesh.put:sharding": _MESH,
    "pylrbms_tpu.parallel.mesh.psum_norm:axis_name": _MESH,
    "pylrbms_tpu.ops.banded.banded_layout:space": _BANDED,
    "pylrbms_tpu.ops.banded.extract_bands:space": _BANDED,
    "pylrbms_tpu.ops.banded.extract_bands:strip_meta": _BANDED,
    "pylrbms_tpu.ops.banded.extract_bands:C_R_io": _BANDED,
    "pylrbms_tpu.ops.banded.extract_bands:C_R_oi": _BANDED,
    "pylrbms_tpu.ops.banded.extract_bands:C_U_io": _BANDED,
    "pylrbms_tpu.ops.banded.extract_bands:C_U_oi": _BANDED,
    # attributes the port sets in __init__
    "pylrbms_tpu.ops.oswald.OswaldOperator.vertex_ids_block": "set in __init__ (a device tensor)",
    "pylrbms_tpu.ops.oswald3d.Oswald3D.vertex_ids_block": "set in __init__ (a device tensor)",
    "pylrbms_tpu.ops.corrector.BatchedCorrector.SIDES": ("set in __init__ as ``sides`` "
                                                         "(the 2D or 3D sides)"),
    "pylrbms_tpu.model.InstationaryBlockModel.estimator": (
        "a property over ``_estimator``, which nothing in the reference sets: every "
        "access raises AttributeError; the port's estimator is ``stationary.estimator``"),
}


def _jax_modules():
    return sorted(m.name for m in pkgutil.walk_packages(pylrbms_tpu.__path__, "pylrbms_tpu."))


JAX_MODULES = _jax_modules()


def _public(mod):
    for name, obj in vars(mod).items():
        if (not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
                and getattr(obj, "__module__", None) == mod.__name__):
            yield name, obj


def _members(cls):
    for name, obj in inspect.getmembers(cls):
        if name == "__init__" and obj is not object.__init__:
            yield name, obj
        elif not name.startswith("_"):
            yield name, obj


def _param_gaps(qual, jax_obj, port_obj):
    """``qual:parameter`` for each JAX parameter name the port does not take."""
    try:
        js = inspect.signature(jax_obj)
    except (TypeError, ValueError):
        return []
    ts = inspect.signature(port_obj)
    if any(p.kind == p.VAR_KEYWORD for p in ts.parameters.values()):
        return []
    return [f"{qual}:{name}" for name, p in js.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and name not in ts.parameters]


def api_gaps(mname):
    """Every difference of the port from the JAX module ``mname``."""
    jm = importlib.import_module(mname)
    tname = "pylrbms_tpu_torch" + mname[len("pylrbms_tpu"):]
    try:
        tm = importlib.import_module(tname)
    except ModuleNotFoundError as e:
        if not (tname == e.name or tname.startswith(e.name + ".")):
            raise
        return [mname]
    gaps = []
    for name, obj in _public(jm):
        qual = f"{mname}.{name}"
        port = getattr(tm, name, None)
        if port is None:
            gaps.append(qual)
        elif not inspect.isclass(obj):
            gaps += _param_gaps(qual, obj, port)
        else:
            for mem, mobj in _members(obj):
                mqual = f"{qual}.{mem}"
                if not hasattr(port, mem):
                    gaps.append(mqual)
                elif callable(mobj) and not inspect.isclass(mobj):
                    gaps += _param_gaps(mqual, mobj, getattr(port, mem))
    return gaps


@pytest.mark.parametrize("mname", JAX_MODULES)
def test_port_has_the_modules_api(mname):
    gaps = api_gaps(mname)
    missing = [g for g in gaps if g not in ALLOWLIST]
    assert not missing, f"the port lacks {missing}"
    stale = [k for k in ALLOWLIST if _owner(k) == mname and k not in gaps]
    assert not stale, f"allowlist entries no difference needs: {stale}"


def _owner(key):
    """The JAX module an allowlist key belongs to (the longest module name
    that prefixes it)."""
    base = key.split(":")[0]
    return max((m for m in JAX_MODULES if base == m or base.startswith(m + ".")),
               key=len, default=None)


def test_allowlist_entries_have_reasons_and_owners():
    for key, reason in ALLOWLIST.items():
        assert isinstance(reason, str) and reason.strip(), f"{key} has no reason"
        assert _owner(key) is not None, f"{key} names no module of pylrbms_tpu"



# ------------------------------------------------------------ docs/torch/API.md

API_MD = pathlib.Path(__file__).resolve().parent.parent / "docs" / "torch" / "API.md"


def _sig(obj):
    """The call signature without annotations (and without the addresses
    in the repr of a default)."""
    sig = inspect.signature(obj)
    text = str(sig.replace(parameters=[p.replace(annotation=p.empty)
                                       for p in sig.parameters.values()],
                           return_annotation=sig.empty))
    return re.sub(r" at 0x[0-9a-f]+>", ">", text)


def render(mname):
    """The signature list of module ``mname`` as docs/torch/API.md holds it:
    each public function, each public class with its constructor and its
    own public methods and properties."""
    mod = importlib.import_module(mname)
    lines = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mname:
            continue
        if inspect.isfunction(obj):
            lines.append(f"- `{name}{_sig(obj)}`")
        elif inspect.isclass(obj) and issubclass(obj, BaseException):
            lines.append(f"- `{name}` (a `{obj.__bases__[0].__name__}`)")
        elif inspect.isclass(obj):
            lines.append(f"- `{name}{_sig(obj)}`")
            for mem, mobj in vars(obj).items():
                if mem.startswith("_"):
                    continue
                if isinstance(mobj, (staticmethod, classmethod)):
                    mobj = mobj.__func__
                if inspect.isfunction(mobj):
                    lines.append(f"  - `.{mem}{_sig(mobj)}`")
                elif isinstance(mobj, property):
                    lines.append(f"  - `.{mem}` (property)")
    return "\n".join(lines)


def _api_md_sections():
    parts = re.split(r"^### `([\w.]+)`$", API_MD.read_text(), flags=re.M)
    return {mname: "\n".join(line for line in body.splitlines()
                             if line.startswith(("- `", "  - `")))
            for mname, body in zip(parts[1::2], parts[2::2])}


API_MD_SECTIONS = _api_md_sections()


def test_api_md_names_port_modules():
    assert len(API_MD_SECTIONS) >= 15
    assert all(m.startswith("pylrbms_tpu_torch.") for m in API_MD_SECTIONS)


@pytest.mark.parametrize("mname", sorted(API_MD_SECTIONS))
def test_api_md_signatures_are_the_codes(mname):
    assert API_MD_SECTIONS[mname] == render(mname)
