"""Importable alias for the `3dgvrt_lightfield_tpu_torch` package.

The package directory name starts with a digit, which is not a valid Python
identifier for `import` statements.  ``import gvrt_tpu_torch`` resolves to
the real package; the aliasing loop below also makes
`import gvrt_tpu_torch.x.y` forms hit the same module objects instead of
double-importing.
"""

import importlib
import sys

_pkg = importlib.import_module("3dgvrt_lightfield_tpu_torch")
for _name, _mod in list(sys.modules.items()):
    if _name.startswith("3dgvrt_lightfield_tpu_torch"):
        sys.modules[_name.replace("3dgvrt_lightfield_tpu_torch",
                                  "gvrt_tpu_torch", 1)] = _mod
sys.modules[__name__] = _pkg
