"""Example physical systems (counterpart of :mod:`hamilton_tpu.models`).

=============  ======================  ===============
reference      here                    System (m, n)
=============  ======================  ===============
``pendulum``   :mod:`pendulum`         (2, 1)
``doublePendulum``  :mod:`double_pendulum`  (4, 2)
``room``       :mod:`room`             (2, 2)
``twoBody``    :mod:`two_body`         (4, 2)
``spring``     :mod:`spring`           (3, 3)
``bezier``     :mod:`bezier`           (2, 1)
(none)         :mod:`chain`            (2N, N)
(none)         :mod:`ellipse`          (2, 1)
(none)         :mod:`spherical`        (3, 2)
=============  ======================  ===============

Every factory takes keyword-only ``device`` and ``dtype``.
"""

from hamilton_tpu_torch.models.base import Example, logistic
from hamilton_tpu_torch.models.bezier import DEFAULT_POINTS, bezier, bezier_curve
from hamilton_tpu_torch.models.chain import chain
from hamilton_tpu_torch.models.double_pendulum import double_pendulum
from hamilton_tpu_torch.models.ellipse import ellipse
from hamilton_tpu_torch.models.pendulum import pendulum
from hamilton_tpu_torch.models.room import room
from hamilton_tpu_torch.models.spherical import spherical_pendulum
from hamilton_tpu_torch.models.spring import spring
from hamilton_tpu_torch.models.two_body import two_body

#: Registry keyed by the reference CLI subcommand names, plus ``chain``,
#: ``ellipse`` and ``spherical``.
REGISTRY = {
    "pend": pendulum,
    "doublepend": double_pendulum,
    "room": room,
    "twobody": two_body,
    "spring": spring,
    "bezier": bezier,
    "chain": chain,
    "ellipse": ellipse,
    "spherical": spherical_pendulum,
}


def get_example(name: str, **params) -> Example:
    """Construct a registered example by CLI name with keyword parameters
    (``device`` and ``dtype`` among them)."""
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown example {name!r}; choose from {sorted(REGISTRY)}")
    return factory(**params)


__all__ = [
    "Example",
    "logistic",
    "pendulum",
    "double_pendulum",
    "room",
    "two_body",
    "spring",
    "bezier",
    "bezier_curve",
    "DEFAULT_POINTS",
    "chain",
    "ellipse",
    "spherical_pendulum",
    "REGISTRY",
    "get_example",
]
