"""The port offers the JAX package's public API: an ast scan, no import.

For every module of ``hypersonic_rle_kit_tpu`` with a counterpart at the
same path under ``hypersonic_rle_kit_tpu_torch``, every public top-level
function, class and constant exists in the port module (defined there, or
bound to a definition of a sibling module), and each port function accepts
the JAX parameters by name, in JAX's positional order: a JAX parameter with
a default has one in the port too, and a parameter the port adds has a
default.  What the port leaves out on purpose is in ``EXCLUDED``, each with
its reason.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "hypersonic_rle_kit_tpu"
PORT = ROOT / "hypersonic_rle_kit_tpu_torch"

# Pallas interpret mode and stage profiling: the port's kernels run on the
# card, their plain versions on the CPU tensors the tests pass, and a
# kernel's time is measured by CUDA events and graphs, not by stages
EXCLUDED_KEYWORDS = ("interpret", "stage")
_TPU_TILE = ("a TPU limit, not a contract: the Hopper kernels take every "
             "block size and run length (ROADMAP)")
EXCLUDED = {
    ("ops/shuffle.py", None): "the roll networks that stand in for gathers "
                              "on the TPU; the Hopper kernels gather",
    ("ops/decode_sup.py", "fits_kernel"): _TPU_TILE,
    ("ops/decode_sup.py", "MIN_RUN"): _TPU_TILE,
    ("ops/decode_sup.py", "MAX_COLUMNS"): _TPU_TILE,
    ("ops/decode_sup.py", "STRIPE_BYTES"): _TPU_TILE,
    ("ops/decode_sup.py", "WQ"): _TPU_TILE,
    ("ops/decode_sup.py", "ROW"): _TPU_TILE,
    ("ops/encode_sup.py", "ROW"): _TPU_TILE,
    ("ops/unpack_device.py", "ROW"): _TPU_TILE,
}
# (module, function) -> (JAX parameter, the port's): the device lane's
# ``backend`` chose the JAX decoder; the port's lane names the torch device
RENAMED = {
    ("fuzz.py", "fuzz_device_one"): ("backend", "device"),
    ("fuzz.py", "run_device"): ("backend", "device"),
}


def _modules() -> list[str]:
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _public(tree: ast.Module) -> dict[str, ast.AST]:
    """Top-level public names: defs, classes, assigned constants, and (as
    the import node) names bound by ``from`` imports."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = node
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _defs(path: pathlib.Path) -> dict[str, ast.AST]:
    tree = ast.parse(path.read_text(), str(path))
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _relative(path: pathlib.Path, node: ast.ImportFrom) -> pathlib.Path:
    base = path.parent
    for _ in range(node.level - 1):
        base = base.parent
    for part in node.module.split(".") if node.module else ():
        base = base / part
    return base


def _resolve(path: pathlib.Path, name: str):
    """The def or class that ``name`` of the port module ``path`` is bound
    to, following ``name = module.attr`` and ``from .m import name`` to a
    sibling module; None where it is bound to something else."""
    tree = ast.parse(path.read_text(), str(path))
    modules, names = {}, {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level:
            base = _relative(path, node)
            for a in node.names:
                bound = a.asname or a.name
                if (base / f"{a.name}.py").exists():
                    modules[bound] = base / f"{a.name}.py"
                elif base.with_suffix(".py").exists():
                    names[bound] = (base.with_suffix(".py"), a.name)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node.name == name:
            return node
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            v = node.value
            if (isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name)
                    and v.value.id in modules):
                return _defs(modules[v.value.id]).get(v.attr)
            if isinstance(v, ast.Name) and v.id in names:
                return _defs(names[v.id][0]).get(names[v.id][1])
            return None
    if name in names:
        return _defs(names[name][0]).get(names[name][1])
    return None


def _params(fn, drop=()):
    """(positional names, keyword-only names, names with a default, has
    *args, has **kwargs), without the names in ``drop``."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    kw = [x.arg for x in a.kwonlyargs]
    with_default = set(pos[len(pos) - len(a.defaults):])
    with_default |= {x.arg for x, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None}
    return ([p for p in pos if p not in drop], [k for k in kw
                                                 if k not in drop],
            with_default, a.vararg is not None, a.kwarg is not None)


def _signature_faults(module: str, name: str, jfn, pfn) -> list[str]:
    jdrop, pdrop = set(EXCLUDED_KEYWORDS), set()
    if (module, name) in RENAMED:
        old, new = RENAMED[module, name]
        jdrop.add(old)
        pdrop.add(new)
    jpos, jkw, jdef, jvar, jkwargs = _params(jfn, jdrop)
    ppos, pkw, pdef, pvar, pkwargs = _params(pfn, pdrop)
    where = f"{module} {name}"
    faults = []
    if ppos[:len(jpos)] != jpos:
        faults.append(f"{where}: positional {ppos}, JAX's {jpos}")
    for p in jkw:
        if p not in ppos + pkw:
            faults.append(f"{where}: no parameter {p!r}")
    for p in jpos + jkw:
        if p in jdef and p in ppos + pkw and p not in pdef:
            faults.append(f"{where}: {p!r} has no default (JAX's has one)")
    for p in ppos + pkw:
        if p not in jpos + jkw and p not in pdef:
            faults.append(f"{where}: added parameter {p!r} has no default")
    if (jvar and not pvar) or (jkwargs and not pkwargs):
        faults.append(f"{where}: *args / **kwargs of JAX's missing")
    return faults


@pytest.mark.parametrize("module", _modules())
def test_port_module_has_the_jax_api(module):
    if (module, None) in EXCLUDED:
        assert not (PORT / module).exists(), f"{module} is ported now"
        return
    port = PORT / module
    assert port.exists(), f"no counterpart of {module}"
    jnames = _public(ast.parse((JAX / module).read_text()))
    pnames = _public(ast.parse(port.read_text()))
    faults = []
    for name, node in jnames.items():
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue                    # the JAX module's own imports
        if (module, name) in EXCLUDED:
            assert name not in pnames, f"{module} {name} is ported now"
            continue
        if name not in pnames:
            faults.append(f"{module}: {name} missing")
            continue
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        pfn = _resolve(port, name)
        if not isinstance(pfn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            faults.append(f"{module}: {name} is no function in the port")
            continue
        faults += _signature_faults(module, name, node, pfn)
    assert not faults, "\n".join(faults)


def test_every_exclusion_names_a_jax_name():
    """A stale entry (the name gone from the JAX package) would hide
    nothing; every exclusion carries its reason."""
    for (module, name), why in EXCLUDED.items():
        assert why and (JAX / module).exists(), module
        if name is not None:
            assert name in _public(ast.parse((JAX / module).read_text()))
    for (module, name), (old, new) in RENAMED.items():
        jfn = _defs(JAX / module)[name]
        pfn = _defs(PORT / module)[name]
        assert old in _params(jfn)[0] + _params(jfn)[1]
        assert new in _params(pfn)[0] + _params(pfn)[1]


@pytest.mark.parametrize("jax_sig, port_sig, fault", [
    ("def f(a, b=1): pass", "def f(a, b=1, *, device='cuda'): pass", None),
    ("def f(a, b=1): pass", "def f(a, *, b=1): pass", "positional"),
    ("def f(a, b=1): pass", "def f(a, b): pass", "no default"),
    ("def f(pk): pass", "def f(pk, device): pass", "added parameter"),
    ("def f(pk, *, x): pass", "def f(pk): pass", "no parameter"),
    ("def f(pk, *, interpret=False): pass", "def f(pk): pass", None),
])
def test_signature_rule(jax_sig, port_sig, fault):
    """The rule itself, on small cases: a required ``device`` added, a
    parameter out of JAX's order, a default dropped."""
    got = _signature_faults("m.py", "f", ast.parse(jax_sig).body[0],
                            ast.parse(port_sig).body[0])
    if fault is None:
        assert got == []
    else:
        assert len(got) == 1 and fault in got[0], got
