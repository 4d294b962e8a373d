"""The port's public surface against the JAX package's, read from both
packages' sources with ``ast``: nothing of either package is imported, so
the listing needs no JAX.

For every module of ``cudagaussianrenderer_tpu/``, the module at the same
path under ``cudagaussianrenderer_torch/`` must bind every public function,
class and UPPER constant (and, for a package's ``__init__``, every public
name it imports); every public method of a JAX class must be a method of
the port's class, every field (a NamedTuple's or dataclass's annotated
attribute) one of its fields in the same order; and every parameter of a
JAX function or method must be accepted by the port's.  The port may take
more (``device=``, ``generator=``).  The JAX repository's scripts that
run the package (``__graft_entry__.py``, ``bench.py`` and the tools) are
held the same way against their counterparts in the port, by the map
SCRIPTS.  Exceptions are the TPU's own layout and mode knobs and the JAX
scripts' own plumbing, listed below with their reasons."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "cudagaussianrenderer_tpu"
PORT_PKG = ROOT / "cudagaussianrenderer_torch"

# The JAX repository's scripts that run the package -> their counterparts
# in the port, both relative to the repository's root.
SCRIPTS = {
    "__graft_entry__.py": "cudagaussianrenderer_torch/graft_entry.py",
    "bench.py": "cudagaussianrenderer_torch/bench.py",
    **{f"tools/{name}.py": f"cudagaussianrenderer_torch/tools/{name}.py"
       for name in ("bench_suite", "fit_artifact", "make_artifact", "measure", "smoke_batch")},
    "tools/tpu_selfcheck.py": "cudagaussianrenderer_torch/tools/selfcheck.py",
}

# (module, name) of the JAX package, or of a script of SCRIPTS, with no
# counterpart in the port.
ALLOWED_NAMES = {
    ("ops/expand.py", "WINDOW"):
        "the emit kernel's DMA window of 512 splats a VMEM copy; K3 on the card "
        "searches the prefix row for a block's first owner instead",
    ("ops/expand.py", "BLOCKS_PER_STEP"):
        "slot blocks a Pallas grid step, to spread the TPU's per-step cost; a "
        "CUDA grid has no sequential steps",
    ("ops/raster.py", "LANE"): "the TPU's 128-lane vector width",
    ("ops/raster.py", "PREFETCH_DEPTH"):
        "chunks the TPU kernel DMAs ahead; K4 double-buffers its batches with cp.async",
    ("ops/raster.py", "QUAD_BF16"):
        "the TPU blend's bf16 MXU operands; K4 blends in f32 on the CUDA cores",
    ("ops/raster.py", "SCAN_LIMBS"):
        "bf16 limbs of the TPU's log-domain transmittance scan; K4 multiplies T "
        "pair by pair",
    ("ops/raster.py", "SCAN_MODE"): "the TPU's choice of scan form; K4 runs no scan",
    ("ops/raster.py", "SCAN_WIDTH"): "the TPU scan's matrix width; K4 runs no scan",
    ("tools/measure.py", "timed"):
        "jit, a compile and the best of 3 runs of a lax.scan; Harness.timed replays a "
        "CUDA graph of REPS calls instead",
    ("tools/measure.py", "scanned"):
        "a body repeated REPS times by lax.scan inside one jit; Harness.timed captures "
        "REPS calls in one CUDA graph",
    ("tools/measure.py", "dispatch_baseline"):
        "Harness.dispatch_baseline, a method of the harness that keeps the baseline",
    ("tools/smoke_batch.py", "ROOT"):
        "the repository root, to load the JAX tools by file path; the port's tools are "
        "modules of its package",
    ("tools/tpu_selfcheck.py", "FAILURES"):
        "a module-level list that check() fills; the port's selfcheck.run returns the "
        "drifting cases",
    ("tools/tpu_selfcheck.py", "check"):
        "prints a case and appends a drift to FAILURES; the port's selfcheck.compare "
        "returns the bad share and the largest difference, and run prints them",
}
# Parameters of JAX functions that the port's need not accept, by name
# (anywhere) or by (module, function, name).
ALLOWED_PARAMS = {
    "interpret": "runs a Pallas kernel in the JAX interpreter on a CPU; the port's "
                 "wrappers take their plain versions for CPU tensors instead",
    "xp": "NumPy or jax.numpy for the same code; the port has torch, and its "
          "NumPy callers keep their own copies",
}
ALLOWED_FUNCTION_PARAMS = {
    ("ops/expand.py", "emit_pairs", "unsafe_sel_limbs"):
        "fewer bf16 limbs in the TPU emit's selection matmuls; K3 selects by "
        "integer search, exactly",
}


def _bindings(tree):
    """Names a module binds at its top level (in if/try blocks too) -> node."""
    out = {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out[node.name] = node
            elif isinstance(node, ast.Assign):
                for name in _assigned(node):
                    out[name] = node
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                out[node.target.id] = node
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    out[(alias.asname or alias.name).split(".")[0]] = node
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)
                visit(node.orelse)
                visit(getattr(node, "finalbody", []))

    visit(tree.body)
    return out


def _assigned(node):
    """Names an assignment binds (``f.attr = x`` binds none)."""
    names = []
    stack = list(node.targets)
    while stack:
        t = stack.pop()
        if isinstance(t, ast.Name):
            names.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            stack += t.elts
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
    return names


def _public(name):
    return not name.startswith("_")


def _constant(name):
    return _public(name) and name.isupper()


def _params(fn):
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}, a.kwarg is not None


def _methods(cls):
    return {n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _fields(cls):
    return [n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]


def _surface(tree, is_init):
    """The public names of a JAX module: [(name, node)]."""
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if _public(node.name):
                names.append((node.name, node))
        elif isinstance(node, ast.Assign):
            names += [(n, node) for n in _assigned(node) if _constant(n)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if _constant(node.target.id):
                names.append((node.target.id, node))
        elif is_init and isinstance(node, ast.ImportFrom):
            names += [(a.asname or a.name, node) for a in node.names if _public(a.asname or a.name)]
    return names


def _missing_params(rel, qualname, jfn, pfn):
    want, _ = _params(jfn)
    have, takes_kwargs = _params(pfn)
    if takes_kwargs:
        return []
    return [f"{qualname}({p}=)" for p in sorted(want - have)
            if p not in ALLOWED_PARAMS and (rel, qualname, p) not in ALLOWED_FUNCTION_PARAMS]


def _paths(rel: str):
    """(the JAX file, the port's) of a module of the JAX package or a
    script of SCRIPTS."""
    if rel in SCRIPTS:
        return ROOT / rel, ROOT / SCRIPTS[rel]
    return JAX_PKG / rel, PORT_PKG / rel


def surface_gaps(rel: str):
    """What the port's counterpart of ``rel`` (a module of the JAX package
    or a script of SCRIPTS) lacks of its surface."""
    jax_path, port_path = _paths(rel)
    if not port_path.exists():
        return ["<module>"]
    jtree = ast.parse(jax_path.read_text())
    port = _bindings(ast.parse(port_path.read_text()))
    gaps = []
    for name, node in _surface(jtree, rel.endswith("__init__.py")):
        if (rel, name) in ALLOWED_NAMES:
            continue
        if name not in port:
            gaps.append(name)
            continue
        pnode = port[name]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(pnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                gaps += _missing_params(rel, name, node, pnode)
            else:
                gaps.append(f"{name} (not a function in the port)")
        elif isinstance(node, ast.ClassDef):
            if not isinstance(pnode, ast.ClassDef):
                gaps.append(f"{name} (not a class in the port)")
                continue
            jfields, pfields = _fields(node), _fields(pnode)
            if pfields[:len(jfields)] != jfields:
                gaps.append(f"{name} fields {jfields} (port: {pfields})")
            pmethods = _methods(pnode)
            for mname, method in _methods(node).items():
                if not (_public(mname) or mname == "__init__"):
                    continue
                if mname not in pmethods:
                    # A dataclass or NamedTuple makes its own __init__.
                    if mname != "__init__":
                        gaps.append(f"{name}.{mname}")
                    continue
                gaps += _missing_params(rel, f"{name}.{mname}", method, pmethods[mname])
    return gaps


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_module_has_the_jax_surface(rel):
    assert surface_gaps(rel) == [], f"the port's {rel} lacks these of the JAX package's"


@pytest.mark.parametrize("rel", sorted(SCRIPTS))
def test_port_script_has_the_jax_surface(rel):
    assert surface_gaps(rel) == [], f"the port's {SCRIPTS[rel]} lacks these of the JAX {rel}"


def test_allow_list_names_only_real_gaps():
    """Each allowed name is in the JAX module and absent from the port's,
    and each allowed function parameter is one the JAX function takes and
    the port's does not: an entry that no longer excuses anything goes."""
    for rel, name in ALLOWED_NAMES:
        jax_path, port_path = _paths(rel)
        assert name in dict(_surface(ast.parse(jax_path.read_text()), False)), (rel, name)
        assert name not in _bindings(ast.parse(port_path.read_text())), (rel, name)
    for rel, fn, param in ALLOWED_FUNCTION_PARAMS:
        jax_path, port_path = _paths(rel)
        jfn = _bindings(ast.parse(jax_path.read_text()))[fn]
        pfn = _bindings(ast.parse(port_path.read_text()))[fn]
        assert param in _params(jfn)[0] and param not in _params(pfn)[0], (rel, fn, param)
    for param in ALLOWED_PARAMS:
        assert any(
            isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and param in _params(n)[0]
            for rel in JAX_MODULES for n in ast.walk(ast.parse((JAX_PKG / rel).read_text()))
        ), param


def test_the_check_sees_a_gap():
    """The walk itself: a port module without a JAX name, a method, a
    parameter or a field in order is reported."""
    jax_src = ("X_MAX = 1\n"
               "class C:\n    a: int\n    b: int\n    def m(self, k, interpret=False): ...\n"
               "def f(a, b=1, *, c=2): ...\n")
    port_src = "class C:\n    b: int\n    a: int\n    def m(self): ...\ndef f(a, b=1): ...\n"
    jtree, port = ast.parse(jax_src), _bindings(ast.parse(port_src))
    assert "X_MAX" in dict(_surface(jtree, False)) and "X_MAX" not in port
    jc, pc = dict(_surface(jtree, False))["C"], port["C"]
    assert _fields(jc) != _fields(pc)[:2]
    assert _missing_params("m.py", "C.m", _methods(jc)["m"], _methods(pc)["m"]) == ["C.m(k=)"]
    assert _missing_params("m.py", "f", dict(_surface(jtree, False))["f"], port["f"]) == ["f(c=)"]
