"""Name coverage of the port against the JAX package.

For every module of the JAX package outside `ops/pallas/` (the Pallas
kernels, whose counterparts are the CUDA kernels of `ops/cuda/` and
`csrc/`), the public top-level functions and classes and the public
methods of its classes must exist under the same names in the module of
the same path in the port. Two explicit lists hold the exceptions:

- NO_COUNTERPART: JAX-only plumbing with nothing to port (pytree
  registrations, the persistent compile cache);
- TO_PORT: modules still to be ported, each with the number of its item
  in ROADMAP.md's Queue 1 (whose text must name the module).

So "what is left" is something the suite checks, not a hand count. The
names are read with `ast`, so no module is imported.

The entry points are covered the same way: `bench.py` has `bench_torch.py`
and each `examples/X.py` has `examples/torch_X.py`, with the JAX script's
argparse flags (the examples add `--device`; FLAG_EXCEPTIONS lists the
flags left out, with the reason). No file of the port (the package,
`chip_smoke.py`, `bench_torch.py`, `examples/torch_*.py`, `tools/torch_*.py`)
imports jax or the JAX package.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "ilgpu_raytracing_tpu")
PORT_PKG = os.path.join(REPO, "ilgpu_raytracing_tpu_torch")

NO_COUNTERPART = {
    "__init__.py": {
        "_enable_compile_cache": "XLA's persistent compile cache; the port compiles "
                                 "its kernels with nvcc into _build/",
    },
    "models/camera.py": {
        "_cam_flatten": "JAX pytree registration of Camera",
        "_cam_unflatten": "JAX pytree registration of Camera",
    },
}

TO_PORT: dict[str, int] = {}


def _modules() -> list[str]:
    out = []
    for root, dirs, files in os.walk(JAX_PKG):
        dirs[:] = sorted(d for d in dirs if d not in ("pallas", "__pycache__"))
        out += [os.path.relpath(os.path.join(root, f), JAX_PKG)
                for f in sorted(files) if f.endswith(".py")]
    return out


def _names(path: str, public: bool = True) -> set[str]:
    """Top-level functions and classes and the methods of the classes
    (`Class.method`); with `public`, only names without a leading
    underscore."""
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = (lambda n: not n.startswith("_")) if public else (lambda n: True)
    out = set()
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    for node in tree.body:
        if isinstance(node, defs) and keep(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, defs[:2]) and keep(m.name)}
    return out


MODULES = _modules()


@pytest.mark.parametrize("module", MODULES)
def test_port_has_every_public_name(module):
    want = _names(os.path.join(JAX_PKG, module))
    port_path = os.path.join(PORT_PKG, module)
    if module in TO_PORT:
        # still to port: the list must stay true until the module lands
        have = _names(port_path) if os.path.exists(port_path) else set()
        assert not os.path.exists(port_path) or want - have, (
            f"{module} is ported: take it off TO_PORT")
        return
    assert os.path.exists(port_path), f"the port has no {module}"
    missing = sorted(want - _names(port_path))
    assert not missing, f"the port's {module} lacks {missing}"


def test_exception_lists_are_current():
    """Every NO_COUNTERPART name exists in the JAX module and not in the
    port's; every TO_PORT module exists in the JAX package, and ROADMAP.md's
    Queue 1 names it."""
    for module, names in NO_COUNTERPART.items():
        jax_names = _names(os.path.join(JAX_PKG, module), public=False)
        port_names = _names(os.path.join(PORT_PKG, module), public=False)
        for name in names:
            assert name in jax_names, f"{module}: {name} is gone from the JAX package"
            assert name not in port_names, f"{module}: the port has {name}"
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    items = dict((int(m.group(1)), m.group(2)) for m in re.finditer(
        r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", queue1, re.S | re.M))
    for module, item in TO_PORT.items():
        assert module in MODULES
        package = os.path.dirname(module) or module
        assert package + "/" in items.get(item, ""), (
            f"ROADMAP Queue 1 item {item} does not name {module}")


# ---------------------------------------------------------------- entry points

ENTRY_POINTS = {"bench.py": "bench_torch.py", **{
    f"examples/{f}": f"examples/torch_{f}"
    for f in sorted(os.listdir(os.path.join(REPO, "examples")))
    if f.endswith(".py") and not f.startswith("torch_")}}

# flags of a JAX entry point that its port leaves out
FLAG_EXCEPTIONS = {
    "examples/render_cornell.py": {
        "--pallas": "on the card the port always traces with its kernels (the "
                    "Renderer refuses the plain walk on CUDA), on the CPU with "
                    "their plain versions",
    },
}
ADDED_FLAGS = {"bench.py": set()}  # every example adds --device


def _flags(path: str) -> set[str]:
    """The option strings of every `add_argument` call in the file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args if isinstance(a, ast.Constant) and a.value.startswith("-")}


def test_entry_points_are_listed():
    assert len(ENTRY_POINTS) == 8  # bench.py and the seven examples
    for jax_entry, names in FLAG_EXCEPTIONS.items():
        assert set(names) <= _flags(os.path.join(REPO, jax_entry)), jax_entry


@pytest.mark.parametrize("jax_entry", sorted(ENTRY_POINTS))
def test_port_has_every_entry_point(jax_entry):
    port_path = os.path.join(REPO, ENTRY_POINTS[jax_entry])
    assert os.path.exists(port_path), f"the port has no {ENTRY_POINTS[jax_entry]}"
    want = (_flags(os.path.join(REPO, jax_entry)) - set(FLAG_EXCEPTIONS.get(jax_entry, {}))
            | ADDED_FLAGS.get(jax_entry, {"--device"}))
    assert _flags(port_path) == want


def _port_files() -> list[str]:
    out = ["chip_smoke.py", "bench_torch.py"]
    out += [f"examples/{f}" for f in sorted(os.listdir(os.path.join(REPO, "examples")))
            if f.startswith("torch_") and f.endswith(".py")]
    out += [f"tools/{f}" for f in sorted(os.listdir(os.path.join(REPO, "tools")))
            if f.startswith("torch_") and f.endswith(".py")]
    for root, dirs, files in os.walk(PORT_PKG):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in sorted(files) if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "ilgpu_raytracing_tpu"))
    assert not bad, f"{path} imports {bad}"
