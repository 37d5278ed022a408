"""Logical-axis sharding context (port of `repro.sharding.axes`).

Model code may call ``constrain(x, 'batch', 'seq', 'heads', None)`` with
*logical* axis names; the active `AxisRules` maps those to mesh axes.
The port shards explicitly: the client axis is split over ranks by the
mesh steps (`repro_torch.launch.steps`), each rank holding its clients'
rows, and a "model" axis larger than 1 is not built yet (ROADMAP item
20). So `constrain` never moves data and returns ``x`` itself, with or
without rules.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from repro_torch.sharding.specs import PartitionSpec

MeshAxis = Union[None, str, Tuple[str, ...]]

_TLS = threading.local()


@dataclass(frozen=True)
class AxisRules:
    mesh: object  # repro_torch.launch.mesh.Mesh (or anything with axis_names, shape)
    rules: dict  # logical name -> mesh axis (str | tuple | None)

    def to_mesh_axes(self, names) -> PartitionSpec:
        return PartitionSpec(*(None if n is None else self.rules.get(n) for n in names))


# Production logical->mesh mapping. "clients" is the DRACO agent axis.
def default_rules(mesh) -> AxisRules:
    multi_pod = "pod" in mesh.axis_names
    client_axes = ("pod", "data") if multi_pod else ("data",)
    return AxisRules(
        mesh=mesh,
        rules={
            "clients": client_axes if multi_pod else "data",
            "batch": client_axes if multi_pod else "data",  # serving batch
            "seq": None,
            "cache_seq": None,  # 'data' for long-context decode (ROADMAP item 20)
            "heads": "model",
            "kv_heads": "model",
            "ff": "model",
            "experts": "model",
            "vocab": "model",
            "embed": None,
            "state": None,
            "ssm_heads": "model",
        },
    )


def train_rules(mesh, seq_parallel: bool = False) -> AxisRules:
    """Rules for code running on one client: the client axis is split
    over ranks by the step, so logical batch and clients stay unsharded
    and only model-parallel axes constrain.

    ``seq_parallel=True`` maps the residual stream's 'seq' axis onto
    "model" (Megatron-style sequence parallelism), which needs tensor
    parallelism inside one model: it raises `NotImplementedError`."""
    if seq_parallel:
        raise NotImplementedError(
            "seq_parallel maps 'seq' onto the 'model' axis; sharding inside one "
            "model is ROADMAP item 20, not ported yet")
    rules = dict(default_rules(mesh).rules)
    rules["batch"] = None
    rules["clients"] = None
    return AxisRules(mesh=mesh, rules=rules)


def current_rules() -> Optional[AxisRules]:
    return getattr(_TLS, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        yield rules
    finally:
        _TLS.rules = prev


def constrain(x, *names):
    """``x`` itself. Under active rules the names must cover every dim of
    ``x`` (as the reference asserts); no layout changes, since the port
    has no "model" axis to constrain to yet."""
    rules = current_rules()
    if rules is not None and len(names) != x.dim():
        raise ValueError(f"constrain got {len(names)} names for a {x.dim()}-d tensor "
                         f"{tuple(x.shape)}")
    return x
