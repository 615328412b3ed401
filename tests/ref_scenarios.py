"""The reference's own test scenarios, run on either package.

`scenario_module(name, pkg)` executes tests/<name>.py as a module whose
`fabric_tpu.` imports name `pkg` (`fabric_tpu` or `fabric_tpu_torch`),
strings included, so a chaincode script a scenario writes to disk
imports the same package as the scenario (`fabric_tpu.testing.adversary`
becomes the port's own `fabric_tpu_torch.testing.adversary`).

`scenario_module(name, pkg, edit=...)` applies `edit(src)` after the
rewrite, e.g. to keep one import on the reference's side (the
reference's `OrdererNode` behind the port's peers); the edited module is
cached apart from the plain one.

`run_scenario(mod, name, request)` calls one test function with its
arguments resolved the way pytest would: the module's own fixtures
(module-scoped ones cached per module, function-scoped and autouse ones
made anew for each call, generator fixtures finalised after it; a
module-scoped generator fixture stays up for the module's later calls
until `close_module(mod)` finalises it), and pytest's built-in ones
(`tmp_path`, `monkeypatch`, `tmp_path_factory`, ...) through
`request`.  A package's factory default that was set before the call is
put back after it, so a scenario's `init_factories(...)` does not
replace another test's provider; one set where there was none stays,
as the reference's own test modules leave it.

Used by tests/test_torch_endorse.py, test_torch_extcc.py,
test_torch_scc.py, test_torch_byzantine.py, test_torch_gateway.py,
test_torch_provision.py, test_torch_raft.py, test_torch_orderer.py,
test_torch_admin.py, test_torch_chaos.py and test_torch_network.py.
"""
import ast
import importlib
import inspect
import re
import types
from pathlib import Path

import pytest

PKGS = ("fabric_tpu", "fabric_tpu_torch")
TESTS_DIR = Path(__file__).resolve().parent
_modules: dict = {}
_module_fixtures: dict = {}
_module_finalizers: dict = {}


def scenario_names(name: str, skip=()) -> list:
    tree = ast.parse((TESTS_DIR / f"{name}.py").read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and n.name not in skip]


def rewrite(src: str, pkg: str) -> str:
    if pkg == "fabric_tpu":
        return src
    return re.sub(r"\bfabric_tpu\.", f"{pkg}.", src)


def scenario_module(name: str, pkg: str, edit=None) -> types.ModuleType:
    tag = f"_{edit.__name__}" if edit is not None else ""
    key = (name, pkg, tag)
    if key not in _modules:
        path = TESTS_DIR / f"{name}.py"
        mod = types.ModuleType(f"_{pkg}_{name}{tag}")
        mod.__file__ = str(path)
        src = rewrite(path.read_text(), pkg)
        if edit is not None:
            src = edit(src)
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _modules[key] = mod
    return _modules[key]


def _fixtures(mod) -> dict:
    return {k: v for k, v in vars(mod).items()
            if type(v).__name__ == "FixtureFunctionDefinition"}


def run_scenario(mod, name: str, request) -> None:
    fixtures = _fixtures(mod)
    cached = _module_fixtures.setdefault(mod.__name__, {})
    local, finalizers = {}, []

    def value(arg):
        if arg in local:
            return local[arg]
        fx = fixtures.get(arg)
        if fx is None:
            return request.getfixturevalue(arg)
        marker = fx._fixture_function_marker
        module_scoped = marker.scope == "module" and not marker.autouse
        if module_scoped and arg in cached:
            return cached[arg]
        fn = fx._get_wrapped_function()
        out = fn(**{a: value(a)
                    for a in inspect.signature(fn).parameters})
        if inspect.isgenerator(out):
            gen, out = out, next(out)
            (_module_finalizers.setdefault(mod.__name__, [])
             if module_scoped else finalizers).append(gen)
        (cached if module_scoped else local)[arg] = out
        return out

    factories = [importlib.import_module(f"{p}.bccsp.factory")
                 for p in PKGS]
    defaults = [f._default for f in factories]
    try:
        for arg, fx in fixtures.items():
            if fx._fixture_function_marker.autouse:
                value(arg)
        fn = getattr(mod, name)
        fn(**{a: value(a) for a in inspect.signature(fn).parameters})
    finally:
        _finalise(finalizers)
        for f, d in zip(factories, defaults):
            if d is not None:
                f._default = d


def _finalise(gens) -> None:
    for gen in reversed(gens):
        with pytest.raises(StopIteration):
            next(gen)


def close_module(mod) -> None:
    """Finalise `mod`'s module-scoped generator fixtures and drop its
    cached fixture values."""
    _module_fixtures.pop(mod.__name__, None)
    _finalise(_module_finalizers.pop(mod.__name__, []))
