"""The port is complete: every public name of ``amps_tpu`` has its
counterpart in ``amps_tpu_torch``.

Each module of ``amps_tpu/`` is parsed with ``ast`` (nothing of the JAX
package is imported): its public functions, classes, their public
methods and its module constants must exist under the same name in the
same module of ``amps_tpu_torch``, and every keyword a JAX function
takes must be accepted by its port.  What is left out on purpose is
listed in ``DIVERGENCES``, one entry a symbol with its reason; nothing
else may be missing, no entry may be stale, and every entry also stands
under ROADMAP.md's "Known divergences by design".
"""

import ast
import importlib
import inspect
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "amps_tpu"

# "module.symbol", "module.function(keyword)" or a whole "module", each
# relative to amps_tpu
DIVERGENCES = {
    "pallas.enabled": "the TPU kernels' opt-in switch: the port's kernels "
                      "(kernels/) run whenever a tensor is on the card",
    "pallas.channelizer_kernel.analyze_chmajor_pallas":
        "ported as kernels/analysis.py::analyze_block (csrc/analysis.cu)",
    "pallas.rx_front_kernel.analyze_demod_pallas":
        "ported as kernels/rx_front.py::analyze_demod (csrc/rx_front.cu)",
    "pallas.rx_phases_kernel.analyze_phases_pallas":
        "ported as kernels/rx_phases.py::analyze_phases (csrc/rx_phases.cu)",
    "pallas.synthesizer_kernel.synthesize_pallas":
        "ported as kernels/synth.py::synthesize_block (csrc/synth.cu)",
    "parallel.pipeline.rx_multichannel_block(use_pallas)":
        "the TPU v1/v2/v2pad kernel switch: the CUDA kernel is the "
        "default front end",
    "runtime.streamer.make_closed_loop_stream(chunks)":
        "a TPU dispatch split rejected on chip; the card runs the loop "
        "under one CUDA graph",
    "parallel.mesh.time_sharding": "a JAX NamedSharding: the port's mesh "
                                   "holds one tensor a worker",
    "parallel.mesh.chan_sharding": "a JAX NamedSharding: the port's mesh "
                                   "holds one tensor a worker",
    "utils.profiling.start_server": "a jax.profiler server; torch has "
                                    "none and nothing calls it",
    "utils.profiling.trace(device)": "jax.profiler's device-trace switch; "
                                     "torch.profiler traces the card",
    "ref": "the JAX-free NumPy oracle, which the tests import directly",
}


def _modules():
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = path.relative_to(JAX_PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append((".".join(parts), path))
    return out


MODULES = _modules()


def _public_symbols(tree: ast.Module):
    """(name, FunctionDef or None) of the module's public functions,
    classes with their public methods (and __init__), and constants."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.append((node.name, node))
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            out.append((node.name, None))
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not sub.name.startswith("_")
                             or sub.name == "__init__"):
                    out.append((f"{node.name}.{sub.name}", sub))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out += [(t.id, None) for t in targets
                    if isinstance(t, ast.Name) and not t.id.startswith("_")]
    return out


def _keywords(fn: ast.FunctionDef):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _excused(mod: str, key: str) -> bool:
    return key in DIVERGENCES or any(
        mod == m or mod.startswith(m + ".") for m in DIVERGENCES
        if "." not in m and "(" not in m)


def _gaps(mod: str, path: pathlib.Path):
    """What the port lacks of module ``mod``, as DIVERGENCES keys, and
    what of it is excused."""
    missing, excused = [], []
    syms = _public_symbols(ast.parse(path.read_text()))
    try:
        port = importlib.import_module(
            "amps_tpu_torch" + (f".{mod}" if mod else ""))
    except ModuleNotFoundError:
        port = None
    for name, fn in syms:
        key = f"{mod}.{name}" if mod else name
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None) if obj is not None else None
        if obj is None:
            (excused if _excused(mod, key) else missing).append(key)
            continue
        if fn is None:
            continue
        try:
            params = inspect.signature(obj).parameters
        except (TypeError, ValueError):   # a property, a builtin
            continue
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            continue
        for kw in _keywords(fn):
            if kw not in params:
                k = f"{key}({kw})"
                (excused if _excused(mod, k) else missing).append(k)
    if port is None and not syms and not _excused(mod, mod):
        missing.append(mod)
    return missing, excused


@pytest.mark.parametrize("mod,path", MODULES,
                         ids=[m or "amps_tpu" for m, _ in MODULES])
def test_module_has_its_counterpart(mod, path):
    """Every public function, class, method and constant of the JAX
    module exists in the port's module of the same name, and takes
    every keyword the JAX function takes, unless DIVERGENCES lists it."""
    missing, _ = _gaps(mod, path)
    assert not missing, f"amps_tpu.{mod}: the port lacks {missing}"


def test_every_divergence_is_still_one():
    """Each DIVERGENCES entry names a public symbol of the JAX package that
    the port does not have: an entry the port has caught up with goes."""
    excused = set()
    for mod, path in MODULES:
        excused.update(_gaps(mod, path)[1])
    whole = {m for m in DIVERGENCES if "." not in m and "(" not in m}
    assert whole <= {m for m, _ in MODULES}
    assert not (set(DIVERGENCES) - whole) - excused


def test_divergences_stand_in_the_roadmap():
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**Known divergences by design:**")
    section = text[start:text.index("\n### ", start)]
    for key in DIVERGENCES:
        assert f"`{key}`" in section, key


def test_the_port_imports_no_jax():
    """amps_tpu_torch and chip_smoke.py import neither JAX nor anything of
    the JAX package: the GPU machine has no JAX."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|amps_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "amps_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    found = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
             for f in files for m in pat.finditer(f.read_text())]
    assert not found, found
