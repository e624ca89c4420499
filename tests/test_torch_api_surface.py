"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed with ``ast``; neither is imported.  For each module
of ``gkl_tpu/`` the port's module of the same path must hold every public
top-level name (functions, classes, constants, and the names an
``__init__.py`` re-exports), every public method of a public class (its
``__init__`` included), and every parameter name of those functions and
methods.  The port may have more names and parameters (``device=``).

The four Pallas modules are left out on purpose.  Their public names are TPU
launchers and VMEM constants (``pl``, ``pltpu``, ``LANE_BLOCK``,
``default_r_chunk``, ``SW_M_SLAB``, ``pdhmm_chunked_fits`` and the like).
Their CUDA counterparts (``ops/pairhmm_cuda.py``, ``ops/pairhmm_cols.py``,
``ops/pdhmm_cuda.py``, ``ops/sw_cuda.py``) are held by PERF.md §6's kernel
table and by ``chip_smoke.py`` phase 16e (each kernel bit for bit against
its kernel-order twin), not by name.

``BY_DESIGN`` is the one list of deliberate differences: ROADMAP.md's "Not
worth porting", in code.  Its keys are ``module:name`` or
``module:function(parameter)``, with ``*`` matching any run of characters.
"""

import ast
import fnmatch
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "gkl_tpu"
PORT = ROOT / "gkl_tpu_torch"

PALLAS_MODULES = {"ops/pairhmm_pallas.py", "ops/pairhmm_pallas_cols.py",
                  "ops/pdhmm_pallas.py", "ops/sw_pallas.py"}

BY_DESIGN = {
    "utils.py:is_tpu_available": "there is no TPU; the port's engines run where their "
                                 "device says",
    "utils.py:f64_scope": "a JAX x64 switch: PyTorch takes the dtype of each call, and the "
                          "H100 runs f64 at full range",
    "utils.py:x32_scope": "a JAX x64 switch: PyTorch takes the dtype of each call",
    "batch.py:default_lane_multiple": "asks JAX for the backend (128 lanes on a TPU); the "
                                      "port's default is batch.LANE_MULTIPLE, since its kernels "
                                      "mask ragged lane counts",
    "api_sw.py:DEVICE_MAX_LEN": "the jnp engine's length ceiling; the CUDA kernel takes any "
                                "pair up to MAX_SW_SEQUENCE_LENGTH",
    "native_lib.py:native_enabled": "a switch for hosts without a compiler; a failed build "
                                    "raises in the port (native_lib.load)",
    "compression/__init__.py:is_native_available": "the pure-Python codec fallback's probe; "
                                                   "the port's codec is native only",
    "parallel/mesh.py:lane_sharding": "returns a jax.sharding object; the port's lane split "
                                      "is parallel.mesh.lane_slices",
    "parallel/mesh.py:vec_sharding": "returns a jax.sharding object; the port's lane split "
                                     "is parallel.mesh.lane_slices",
    "parallel/mesh.py:*_sharded(lane_block)": "the Pallas kernels' 128-lane block; the CUDA "
                                              "kernels have none",
    "parallel/mesh.py:*_sharded(interpret)": "Pallas interpret mode; on the CPU the port runs "
                                             "its plain twins",
    "parallel/distributed.py:*_global(lane_block)": "the Pallas kernels' 128-lane block; the "
                                                    "CUDA kernels have none",
    "parallel/distributed.py:*_global(interpret)": "Pallas interpret mode; on the CPU the port "
                                                   "runs its plain twins",
    "parallel/*.py:*_relay_*(seg)": "the SW relay kernel's segment length, a VMEM chunk; "
                                    "the CUDA kernel's passes are its own geometry "
                                    "(ops.sw_cuda.sw_geometry)",
    "parallel/*.py:*_chunked_*(r_chunk)": "the chunked PDHMM kernel's read chunk, a VMEM "
                                          "chunk; the CUDA kernel's passes are its own "
                                          "geometry (ops.pdhmm_cuda.pdhmm_geometry)",
    "parallel/mesh.py:replicate_to_host(arr)": "the JAX global array it all-gathers; the "
                                                "port's first parameter is this process's "
                                                "lanes, gathered over gloo",
}

MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                 if p.relative_to(REF).as_posix() not in PALLAS_MODULES)


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name: str) -> bool:
    return not name.startswith("_")


def surface(path: pathlib.Path) -> dict:
    """A module's public names: ``{name: ("def", params) | ("class",
    {method: params}) | ("alias", target) | ("value", None)}``.  A class's
    methods include those of its bases defined in the same module."""
    tree = ast.parse(path.read_text())
    out = {}
    classes = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef):
            methods = {}
            for base in node.bases:
                if isinstance(base, ast.Name) and base.id in classes:
                    methods.update(classes[base.id])
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        _public(item.name) or item.name == "__init__"):
                    methods[item.name] = _params(item)
            classes[node.name] = methods
            out[node.name] = ("class", methods)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if isinstance(target, ast.Name):
                    alias = node.value.id if isinstance(node.value, ast.Name) else None
                    out[target.id] = ("alias", alias) if alias else ("value", None)
        elif isinstance(node, ast.ImportFrom) and node.level and path.name == "__init__.py":
            for a in node.names:  # a package's re-exports
                out[a.asname or a.name] = ("value", None)
    return {k: v for k, v in out.items() if _public(k)}


def _resolve(names: dict, entry):
    """An alias's target entry within its module, followed to the end."""
    seen = set()
    while entry[0] == "alias" and entry[1] in names and entry[1] not in seen:
        seen.add(entry[1])
        entry = names[entry[1]]
    return entry


def _def_params(names: dict, name: str) -> list[str]:
    """The parameters of function ``name`` of a surface, aliases followed."""
    kind, params = _resolve(names, names[name])
    return params if kind == "def" else []


def _by_design(module: str, name: str, param: str | None = None) -> bool:
    key = f"{module}:{name}" if param is None else f"{module}:{name}({param})"
    return any(fnmatch.fnmatchcase(key, pattern) for pattern in BY_DESIGN)


def gaps(module: str, ref_root: pathlib.Path = REF, port_root: pathlib.Path = PORT) -> list[str]:
    """What ``module`` of the reference has and its port lacks, less the
    by-design differences."""
    port_path = port_root / module
    if not port_path.exists():
        return [f"{module}: no such module in the port"]
    ref, port = surface(ref_root / module), surface(port_path)
    missing = []

    def params(qual, want, have):
        missing.extend(f"{module}:{qual}({p})" for p in want
                       if p not in have and not _by_design(module, qual, p))

    for name, entry in ref.items():
        if name not in port:
            if not _by_design(module, name):
                missing.append(f"{module}:{name}")
            continue
        entry, mine = _resolve(ref, entry), _resolve(port, port[name])
        if entry[0] == "def" and mine[0] == "def":
            params(name, entry[1], mine[1])
        elif entry[0] == "def" and mine[0] == "class":
            params(name, entry[1], mine[1].get("__init__", []))
        elif entry[0] == "class":
            if mine[0] != "class":
                missing.append(f"{module}:{name} (a class in the reference)")
                continue
            for method, want in entry[1].items():
                if method not in mine[1]:
                    if not _by_design(module, f"{name}.{method}"):
                        missing.append(f"{module}:{name}.{method}")
                    continue
                params(f"{name}.{method}", want, mine[1][method])
    return missing


def test_every_reference_module_is_covered():
    """Every module of the JAX package is a case below, save the four
    Pallas modules, which exist."""
    assert all((REF / m).exists() for m in PALLAS_MODULES)
    assert len(MODULES) == len(list(REF.rglob("*.py"))) - len(PALLAS_MODULES)


def test_by_design_entries_are_still_differences():
    """Each entry of BY_DESIGN names something the reference has and the
    port lacks, so the list cannot outlive the differences it excuses."""
    for pattern in BY_DESIGN:
        module_pattern, rest = pattern.split(":", 1)
        name, _, param = rest.partition("(")
        param = param.rstrip(")") or None
        hit = False
        for module in fnmatch.filter(MODULES, module_pattern):
            ref, port = surface(REF / module), surface(PORT / module)
            for n in fnmatch.filter(ref, name):
                if param is None:
                    hit |= n not in port
                elif n in port:
                    hit |= (param in _def_params(ref, n)
                            and param not in _def_params(port, n))
        assert hit, pattern


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_reference_surface(module):
    assert gaps(module) == []
