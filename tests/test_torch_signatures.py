"""The port keeps the JAX package's public names and signatures.

For every public name of the port's ``workloads``, ``ft`` and ``data``
modules, and for the repaired ``models.attention`` names, the port's
``inspect.signature`` must match the reference's: the same parameter
names in the same order, of the same kinds, with the same defaults (a
JAX dtype default matches the torch dtype of that name).  The only
difference allowed is a trailing keyword-only ``device`` on an entry
point that builds a monitor service or monitor state, or the port's
``impl`` last on ``attention``.  A class is held by its constructor and
by each public method it defines; a constant by its value.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

MODULES = ("workloads.arrivals", "workloads.sim", "workloads.scenario",
           "workloads.trace", "workloads.harness", "ft.inject",
           "ft.failures", "ft.supervisor", "data.pipeline")
PACKAGES = ("workloads", "ft", "data")
ATTENTION = ("attention", "init_cache_spec", "attn_param_defs", "KVCache")
# the port's extra trailing parameter, by name
EXTRA = {"attention": "impl"}
DEVICE = {"run_cell", "run_matrix", "replay", "FleetRateTracker",
          "DataPipeline"}


def _pair(mod):
    return (importlib.import_module(f"repro_torch.{mod}"),
            importlib.import_module(f"repro.{mod}"))


def _cases():
    cases = []
    for mod in MODULES:
        t_mod, j_mod = _pair(mod)
        for name in j_mod.__all__:
            cases.append((mod, name))
            obj = getattr(j_mod, name)
            if inspect.isclass(obj) and obj.__module__ == j_mod.__name__:
                for attr, val in vars(obj).items():
                    if attr.startswith("_"):
                        continue
                    if isinstance(val, (classmethod, staticmethod)):
                        val = val.__func__
                    if inspect.isfunction(val):
                        cases.append((mod, f"{name}.{attr}"))
    cases += [("models.attention", n) for n in ATTENTION]
    return cases


def _get(mod, dotted):
    for part in dotted.split("."):
        mod = getattr(mod, part)
    return mod


def _same_default(a, b):
    if a is b:
        return True
    if isinstance(a, torch.dtype):
        return str(a).removeprefix("torch.") == np.dtype(b).name
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    try:
        return bool(a == b)
    except Exception:
        return False


def _signature(obj):
    """The parameters, or None for a class with no Python signature (an
    exception type: held by its bases instead)."""
    try:
        return list(inspect.signature(obj).parameters.values())
    except ValueError:
        return None


def _same_value(a, b):
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(_same_value(a[k], b[k]) for k in a))
    return _same_default(a, b)


def test_package_names_match():
    for pkg in PACKAGES:
        t_pkg, j_pkg = _pair(pkg)
        assert t_pkg.__all__ == j_pkg.__all__, pkg
    for mod in MODULES:
        t_mod, j_mod = _pair(mod)
        assert t_mod.__all__ == j_mod.__all__, mod


@pytest.mark.parametrize("mod,name", _cases(),
                         ids=[f"{m}:{n}" for m, n in _cases()])
def test_signature_matches_the_reference(mod, name):
    t_mod, j_mod = _pair(mod)
    got, want = _get(t_mod, name), _get(j_mod, name)
    if not callable(want) or isinstance(want, (tuple, dict)):
        if name == "SCENARIOS":          # values hold lambdas: by shape
            assert list(got) == list(want)
            for k in want:
                for f in ("name", "periods", "quick_periods",
                          "decide_every", "settle_frac"):
                    assert getattr(got[k], f) == getattr(want[k], f), (k, f)
        else:
            assert _same_value(got, want), name
        return
    ps, ref = _signature(got), _signature(want)
    if ref is None:
        assert ps is None
        assert ([c.__name__ for c in got.__mro__]
                == [c.__name__ for c in want.__mro__])
        return
    last = name.rsplit(".", 1)[-1]
    if (last in DEVICE and ps and ps[-1].name == "device"
            and ps[-1].kind is inspect.Parameter.KEYWORD_ONLY
            and all(p.name != "device" for p in ref)):
        assert ps[-1].default == "cuda"
        ps = ps[:-1]
    if last in EXTRA and ps and ps[-1].name == EXTRA[last]:
        ps = ps[:-1]
    assert [p.name for p in ps] == [p.name for p in ref]
    for p, r in zip(ps, ref):
        assert p.kind == r.kind, p.name
        assert _same_default(p.default, r.default), (
            p.name, p.default, r.default)


def test_entry_points_take_device():
    """Every monitor-building entry point named by the port has the
    trailing device keyword."""
    found = set()
    for mod, name in _cases():
        obj = _get(_pair(mod)[0], name)
        if callable(obj) and not isinstance(obj, (tuple, dict)):
            ps = _signature(obj)
            if ps and ps[-1].name == "device":
                found.add(name.rsplit(".", 1)[-1])
    assert DEVICE <= found
