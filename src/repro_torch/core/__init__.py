"""Protocol core: flat plane, topology, events, channel, DRACO windows.

The reference's names are exported lazily (PEP 562): `core.flat` is a
leaf that the optimizers and the task layer import, while
`core.protocol` imports both, so loading the protocol here, as the
reference's ``__init__`` does, would make that a cycle.
"""
import importlib

_FLAT = ("FlatSpec", "ravel_clients", "spec_for", "spec_of", "unravel_clients")
_PROTOCOL = ("DracoConfig", "DracoState", "DracoStateLegacy", "build_graph",
             "draco_window", "draco_window_legacy", "init_state", "init_state_legacy",
             "local_step", "run_windows", "run_windows_legacy", "task_local_updates",
             "virtual_global_model")
_HOME = {**{name: "repro_torch.core.flat" for name in _FLAT},
         **{name: "repro_torch.core.protocol" for name in _PROTOCOL}}

__all__ = sorted(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_HOME[name]), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
