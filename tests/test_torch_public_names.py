"""The port's public names against the JAX package's, module by module.

Every module of ``hamilton_tpu`` (``pkgutil.walk_packages``) has its
counterpart in ``hamilton_tpu_torch`` with every name of its ``__all__``;
each public function takes every keyword the reference's takes, and each
public class has every public member of the reference's class (its methods
every keyword).  What the port lacks is exactly ``NOT_PORTED``: each entry a
deliberate omission with its reason, each still missing (a ported entry
leaves the map).  The port's ``__all__`` names all exist, and its
``__version__`` is the reference's.
"""

import importlib
import inspect
import pkgutil

import pytest

import hamilton_tpu
import hamilton_tpu_torch

#: What the port deliberately lacks, keyed ``"<module suffix>"`` for a
#: module, ``"<module suffix>.<name>"`` for a name of its ``__all__``,
#: ``"<function>(<keyword>)"`` for a keyword and ``"<Class>.<member>"`` for a
#: class member (wherever the function or class is exported): the reason.
NOT_PORTED = {
    ".ops.df32": "TPU workaround (double-float32 arithmetic): the port samples drift in "
                 "float64 (hamilton_tpu_torch/ensemble.py)",
    ".ops.pallas_step": "the Pallas fused step: replaced by ops/fused_step.py and the "
                        "hand-written kernels of csrc/ (kernels/)",
    ".ops.pallas_solve": "the Pallas batched solves: replaced by ops/batched_spd.py and "
                         "csrc/batched_spd.cu",
    ".utils.roofline.count_ops": "walks a jaxpr; the port counts with utils/roofline.py's "
                                 "OpCounter",
    "make_stepper(group_unroll)": "TPU workaround (ROADMAP: deliberately not ported)",
    "evolve_ensemble_final(group_unroll)": "TPU workaround (ROADMAP: deliberately not ported)",
    "evolve_ensemble_chunked(group_unroll)": "TPU workaround (ROADMAP: deliberately not "
                                             "ported)",
    "System.tree_flatten": "JAX's pytree protocol",
    "System.tree_unflatten": "JAX's pytree protocol",
    "System.params_axes_tree": "JAX's pytree protocol (vmap axes of the params)",
    "LyapunovPairs.pair_ensemble(key)": "a JAX PRNG key: the port draws from a "
                                        "torch.Generator (generator=)",
}

#: Every module of the reference, as a suffix of its package name.
ALL_MODULES = [""] + [info.name[len("hamilton_tpu"):] for info in
                      pkgutil.walk_packages(hamilton_tpu.__path__, "hamilton_tpu.")]

MODULES = ["", ".ops", ".utils", ".integrators", ".models", ".parallel",
           ".utils.poincare", ".utils.diagnostics", ".utils.checkpoint", ".render", ".cli",
           ".native", ".utils.roofline"]


def _unported_names(suffix):
    return {key.rsplit(".", 1)[1] for key in NOT_PORTED
            if key.startswith(f"{suffix}.") and key.count(".") == suffix.count(".") + 1
            and "(" not in key and key not in ALL_MODULES}


def _keywords(fn):
    try:
        return {p.name for p in inspect.signature(fn).parameters.values()
                if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    except (TypeError, ValueError):
        return set()


def omissions(suffix):
    """What ``hamilton_tpu_torch<suffix>`` lacks of ``hamilton_tpu<suffix>``,
    as keys of the form of :data:`NOT_PORTED`."""
    ref = importlib.import_module(f"hamilton_tpu{suffix}")
    try:
        port = importlib.import_module(f"hamilton_tpu_torch{suffix}")
    except ModuleNotFoundError:
        return {suffix}
    missing = set()
    for name in ref.__all__:
        if not hasattr(port, name) or name not in port.__all__:
            missing.add(f"{suffix}.{name}")
            continue
        r, p = getattr(ref, name), getattr(port, name)
        if inspect.isclass(r):
            members = {m for m in dir(r) if not m.startswith("_")}
            have = {m for m in dir(p) if not m.startswith("_")} if inspect.isclass(p) else set()
            missing |= {f"{name}.{m}" for m in members - have}
            for m in members & have:
                rm, pm = getattr(r, m), getattr(p, m)
                if callable(rm) and not inspect.isclass(rm):
                    missing |= {f"{name}.{m}({k})" for k in _keywords(rm) - _keywords(pm)}
        elif callable(r) and not isinstance(r, type(importlib)):
            missing |= {f"{name}({k})" for k in _keywords(r) - _keywords(p)}
    return missing


@pytest.mark.parametrize("suffix", ALL_MODULES, ids=[m or "top" for m in ALL_MODULES])
def test_every_module_names_keywords_and_members(suffix):
    """The port lacks nothing of the module but what NOT_PORTED lists."""
    unexpected = omissions(suffix) - set(NOT_PORTED)
    assert not unexpected, sorted(unexpected)


def test_every_not_ported_entry_is_still_missing():
    found = set().union(*(omissions(suffix) for suffix in ALL_MODULES))
    assert set(NOT_PORTED) <= found, sorted(set(NOT_PORTED) - found)
    assert all(reason for reason in NOT_PORTED.values())


@pytest.mark.parametrize("suffix", MODULES, ids=[m or "top" for m in MODULES])
def test_the_port_exports_the_reference_names(suffix):
    ref = importlib.import_module(f"hamilton_tpu{suffix}")
    port = importlib.import_module(f"hamilton_tpu_torch{suffix}")
    want = set(ref.__all__) - _unported_names(suffix)
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in want:
        assert hasattr(port, name), name
        exec(f"from hamilton_tpu_torch{suffix} import {name}", {})
    for name in port.__all__:
        assert hasattr(port, name), f"hamilton_tpu_torch{suffix}.__all__ names {name}"
    # a name left out stays out of the port's __all__ until it is ported,
    # and then leaves NOT_PORTED
    left_out = _unported_names(suffix)
    assert not left_out & set(port.__all__), sorted(left_out & set(port.__all__))


def test_every_unported_name_is_a_reference_name():
    for suffix in ALL_MODULES:
        names = _unported_names(suffix)
        if names:
            ref = importlib.import_module(f"hamilton_tpu{suffix}")
            assert names <= set(ref.__all__), sorted(names - set(ref.__all__))


def test_version_is_the_reference_version():
    assert hamilton_tpu_torch.__version__ == hamilton_tpu.__version__
