"""Boolean env-flag parsing for the EGS_* route flags.

Port of easygaussiansplatting_tpu/utils/envflag.py, so the port reads the
same flags with the same meaning: "", "0", "false", "no" and "off" mean off,
and an unset variable means the default. The flags are read on each call.
"""

import os

_FALSY = {"", "0", "false", "no", "off"}


def env_flag(name: str, default: bool = False) -> bool:
    """`default` applies when the variable is UNSET; an explicit empty/falsy
    value always means off (so default-on flags keep an off switch)."""
    if name not in os.environ:
        return default
    return os.environ[name].strip().lower() not in _FALSY
