"""The parts of the reference that a configuration picks by name.

A descriptor family is a module of `frontend/families/`, a keyframe mode
one of `vo/keyframe_modes/`, named as the configuration names the option
(`FrontendConfig.descriptor`, `PipelineConfig.keyframe_mode`). A cell whose
configuration picks an option the reference does not have yet brings its
module as a new file; no file of the reference is edited for it.
"""

from __future__ import annotations

import importlib


def part(package: str, name: str, what: str):
    """The module `<package>.<name>`. A name with no module raises a
    ValueError that names the file to add."""
    module = f"{package}.{name}"
    file = module.replace(".", "/") + ".py"
    if not (isinstance(name, str) and name.isidentifier()):
        raise ValueError(f"the reference has no {what} {name!r}: its module would be {file}, "
                         "and a module's name is a Python identifier")
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"the reference has no {what} {name!r}: add {file}") from None
