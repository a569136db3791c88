"""The port's public names against the JAX package's.

For the top level, ``ops``, ``utils``, ``integrators``, ``models``,
``parallel``, the Poincaré, diagnostics and checkpoint utilities, ``render``
and ``cli``, every name in the reference's ``__all__`` is in the port's
``__all__`` and importable from the port; no reference name is left
unported (``UNPORTED`` is empty).  The port's ``__all__`` names all exist,
and its ``__version__`` is the reference's.
"""

import importlib

import pytest

import hamilton_tpu
import hamilton_tpu_torch

#: Reference names the port does not have yet: name → ROADMAP §1 item.
#: Empty since the sharded path (M13) was ported.
UNPORTED = {}

MODULES = ["", ".ops", ".utils", ".integrators", ".models", ".parallel",
           ".utils.poincare", ".utils.diagnostics", ".utils.checkpoint", ".render", ".cli"]


@pytest.mark.parametrize("suffix", MODULES, ids=[m or "top" for m in MODULES])
def test_the_port_exports_the_reference_names(suffix):
    ref = importlib.import_module(f"hamilton_tpu{suffix}")
    port = importlib.import_module(f"hamilton_tpu_torch{suffix}")
    want = set(ref.__all__) - set(UNPORTED)
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in want:
        assert hasattr(port, name), name
        exec(f"from hamilton_tpu_torch{suffix} import {name}", {})
    for name in port.__all__:
        assert hasattr(port, name), f"hamilton_tpu_torch{suffix}.__all__ names {name}"
    # an unported name stays out of the port until its module is ported,
    # and then leaves the list above
    missing = set(ref.__all__) & set(UNPORTED)
    assert not missing & set(port.__all__), sorted(missing & set(port.__all__))


def test_every_unported_name_is_a_reference_name():
    names = set()
    for suffix in MODULES:
        names |= set(importlib.import_module(f"hamilton_tpu{suffix}").__all__)
    assert set(UNPORTED) <= names, sorted(set(UNPORTED) - names)


def test_version_is_the_reference_version():
    assert hamilton_tpu_torch.__version__ == hamilton_tpu.__version__
