"""The package's former name, kept as an alias of ``particle_filters_jax``.

Importing this package, or any module under it, gives the module of the
same path under ``particle_filters_jax`` (the same objects, not copies), so
code written against the old name keeps working. New code should import
``particle_filters_jax``.
"""

import importlib
import pkgutil
import sys
import warnings

import particle_filters_jax as _target

ALIAS_OF = _target.__name__

warnings.warn(
    f"{__name__} is now {ALIAS_OF}; import {ALIAS_OF} instead.",
    DeprecationWarning,
    stacklevel=2,
)
for _info in pkgutil.walk_packages(_target.__path__, ALIAS_OF + "."):
    sys.modules[__name__ + _info.name[len(ALIAS_OF):]] = (
        importlib.import_module(_info.name)
    )
sys.modules[__name__] = _target
