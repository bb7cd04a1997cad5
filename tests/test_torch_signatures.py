"""The port keeps the JAX package's public names and signatures.

For every public name of the modules in ``MODULES`` (``workloads``,
``ft``, ``data``, ``train``, ``ckpt``, ``models``, the kernel ops,
``core``, ``control``, ``streams``, ``serve``, ``obs``, ``dist``,
``roofline`` and ``launch``), for the repaired ``models.attention``
names and for the public functions outside the reference's ``__all__``
in ``BEYOND_ALL``, the port's ``inspect.signature`` must match the
reference's: the same parameter names in the same order, of the same
kinds, with the same defaults (a JAX dtype default matches the torch
dtype of that name).  The only differences allowed are a trailing
keyword-only ``device`` on an entry point that builds a monitor service,
monitor state, parameters, a cache, a trainer's state or a mesh; the
port's trailing parameters named in ``EXTRA`` (``impl``,
``kernel_impl``, ``ssd_impl``, a positional ``device``, and the few
others it lists with their reason); the defaults in ``OWN_DEFAULT``; a
``jax.random`` key taken as a ``torch.Generator`` named ``generator``;
and the names listed in ``PORT_ONLY`` and ``NOT_PORTED``.
A class is held by its constructor and by each public method it defines;
a constant by its value, except the constants in ``OWN_VALUE`` (the
card's own figures), held by their keys (the reference's, then the
port's additions).  A module of the reference
with no twin of the same name has one in ``TWINS``.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

MODULES = ("workloads.arrivals", "workloads.sim", "workloads.scenario",
           "workloads.trace", "workloads.harness", "ft.inject",
           "ft.failures", "ft.supervisor", "data.pipeline",
           "train.optimizer", "train.step", "train.trainer", "ckpt.manager",
           "models.api", "models.whisper", "models.moe", "dist.sharding",
           "dist.api", "dist.compression", "roofline.analytic",
           "roofline.analysis", "launch.mesh", "launch.dryrun",
           "launch.sweep", "models.layers", "models.transformer",
           "models.ssm", "kernels.attention.ops", "kernels.ssd.ops",
           "core.controller", "core.filters", "core.monitor",
           "core.queueing", "core.simulate", "core.stats", "control.group",
           "control.log", "control.loop", "control.policy", "streams.arena",
           "streams.fleet", "streams.monitor_thread", "streams.pipeline",
           "streams.queue", "serve.engine", "serve.qos", "obs.exporter")
PACKAGES = ("workloads", "ft", "data", "train", "ckpt", "dist")
ATTENTION = ("attention", "init_cache_spec", "attn_param_defs", "KVCache")
# public functions the reference leaves out of its ``__all__``
BEYOND_ALL = (("models.moe", "moe_block_ep"),
              ("launch.mesh", "make_moe_mesh"))
# the port's extra trailing parameters, by name: the kernel route
# (``impl``, ``kernel_impl``, ``ssd_impl``: the plain version beside the
# hand-written kernel), the flash op's softcap, window and explicit scale
# (the reference reaches them through ``models.attention`` only), the
# leading dims of a batched monitor or statistics state, the fleet
# scan's sub-tile length, and a ``device`` that is not keyword-only
# (``control_decide``'s ``None`` means the state's own device)
EXTRA = {"attention": ("impl",), "Model": ("kernel_impl",),
         "build_model": ("kernel_impl",), "whisper_encode": ("kernel_impl",),
         "whisper_forward": ("kernel_impl",),
         "whisper_loss": ("kernel_impl",), "lm_forward": ("kernel_impl",),
         "lm_loss": ("kernel_impl",), "mamba_block": ("ssd_impl",),
         "ssd_chunked": ("impl",),
         "flash_attention": ("scale", "softcap", "window", "impl"),
         "attention_ref": ("softcap", "window"),
         "monitor_init": ("batch", "device"),
         "welford_init": ("shape", "device"),
         "moments_init": ("shape", "device"), "run_monitor_fleet": ("sub_t",),
         "control_init": ("device",), "control_decide": ("device",),
         "Pipeline": ("device",), "Engine": ("device",)}
DEVICE = {"run_cell", "run_matrix", "replay", "FleetRateTracker",
          "DataPipeline", "Trainer", "init_params", "init_cache",
          "make_production_mesh", "make_local_mesh", "make_moe_mesh",
          "init_creator", "run_monitor", "fleet_monitor_init",
          "run_monitor_fleet", "ControlGroup", "FleetMonitorService"}
# the port's own defaults: the fleet's fused kernel on the card, where
# the reference defaults to its host fast path
OWN_DEFAULT = {("run_monitor_fleet", "impl"): ("cuda", "rounds"),
               ("FleetMonitorService", "impl"): ("cuda", "rounds")}
# module constants that are bare sentinels: held by their type
SENTINELS = {("streams.pipeline", "STOP")}
# a jax.random key is a torch.Generator in the port
RENAMED = {"key": "generator"}
# public names only the port has: the JAX parameter tree as tensors, the
# port's own PartitionSpec and its DTensor placements, the fake world
PORT_ONLY = {"models.api": ["params_from_numpy"],
             "dist.sharding": ["PartitionSpec", "placements_for"],
             "launch.mesh": ["fake_world"],
             "models.layers": ["shape_creator", "target_logits",
                               "logsumexp_last"],
             "models.transformer": ["check_family"],
             "models.ssm": ["F32_LEAVES"],
             "kernels.attention.ops": ["FlashAttentionFn",
                                       "flash_attention_fwd",
                                       "flash_attention_bwd", "IMPLS"],
             "kernels.ssd.ops": ["ssd_chunked", "IMPLS"],
             "core.monitor": ["gated_rate_arrays", "fleet_state_from_numpy",
                              "fleet_state_to_numpy", "resolve_device"]}
# the reference's HLO text parse, which has no input in PyTorch (its
# twin counts at run time)
NOT_PORTED = {("roofline.analysis", "parse_collective_bytes")}
# constants whose values are the port's own: the H100's peaks, held by
# the reference's keys and the port's added ones
OWN_VALUE = {("roofline.analysis", "HW"): ["hbm_bytes"]}
# port module -> the reference module it stands in for
TWINS = {"roofline.counters": "roofline.hlo"}


def _pair(mod):
    return (importlib.import_module(f"repro_torch.{mod}"),
            importlib.import_module(f"repro.{mod}"))


def _public(j_mod) -> list:
    """The reference module's ``__all__``, or, for a script module that
    has none (``launch.dryrun``, ``launch.sweep``), the public functions
    and classes it defines, in order."""
    if hasattr(j_mod, "__all__"):
        return list(j_mod.__all__)
    return [n for n, v in vars(j_mod).items()
            if not n.startswith("_") and (inspect.isfunction(v)
                                          or inspect.isclass(v))
            and v.__module__ == j_mod.__name__]


def _cases():
    cases = []
    for mod in MODULES:
        t_mod, j_mod = _pair(mod)
        for name in _public(j_mod):
            if (mod, name) in NOT_PORTED:
                continue
            cases.append((mod, name))
            obj = getattr(j_mod, name)
            if inspect.isclass(obj) and obj.__module__ == j_mod.__name__:
                for attr, val in vars(obj).items():
                    if attr.startswith("_"):
                        continue
                    if isinstance(val, (classmethod, staticmethod)):
                        val = val.__func__
                    if (inspect.isfunction(val) and (mod, f"{name}.{attr}")
                            not in NOT_PORTED):
                        cases.append((mod, f"{name}.{attr}"))
    cases += [("models.attention", n) for n in ATTENTION]
    return cases + list(BEYOND_ALL)


def _get(mod, dotted):
    for part in dotted.split("."):
        mod = getattr(mod, part)
    return mod


def _same_default(a, b):
    if a is b:
        return True
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
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
        ported = [n for n in _public(j_mod) if (mod, n) not in NOT_PORTED]
        assert t_mod.__all__ == ported + PORT_ONLY.get(mod, []), mod


def test_twins_stand_in_for_the_reference_modules():
    """Each twin and the module it replaces exist, and the port has no
    module of the replaced one's name."""
    for mod, ref in TWINS.items():
        assert importlib.import_module(f"repro_torch.{mod}").__all__
        assert importlib.import_module(f"repro.{ref}").__all__
        with pytest.raises(ImportError):
            importlib.import_module(f"repro_torch.{ref}")


def test_unported_methods_are_absent():
    """The listed exceptions stay true: a method ported later must come
    off ``NOT_PORTED`` and be held to the reference."""
    for mod, dotted in NOT_PORTED:
        t_mod, j_mod = _pair(mod)
        _get(j_mod, dotted)
        with pytest.raises(AttributeError):
            _get(t_mod, dotted)


@pytest.mark.parametrize("mod,name", _cases(),
                         ids=[f"{m}:{n}" for m, n in _cases()])
def test_signature_matches_the_reference(mod, name):
    t_mod, j_mod = _pair(mod)
    got, want = _get(t_mod, name), _get(j_mod, name)
    if not callable(want) or isinstance(want, (tuple, dict)):
        if (mod, name) in OWN_VALUE:
            assert list(got) == list(want) + OWN_VALUE[(mod, name)]
        elif (mod, name) in SENTINELS:
            assert type(got) is type(want) is object
        elif name == "SCENARIOS":        # values hold lambdas: by shape
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
    extra = EXTRA.get(last, ())
    if extra and tuple(p.name for p in ps[-len(extra):]) == extra:
        ps = ps[:-len(extra)]
    assert ([p.name for p in ps]
            == [RENAMED.get(r.name, r.name) for r in ref])
    for p, r in zip(ps, ref):
        assert p.kind == r.kind, p.name
        if (last, p.name) in OWN_DEFAULT:
            assert ((p.default, r.default)
                    == OWN_DEFAULT[(last, p.name)]), p.name
            continue
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
