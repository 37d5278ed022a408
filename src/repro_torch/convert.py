"""Carry the JAX package's objects, given as numpy, into the port.

Everything here takes array-likes that ``numpy.asarray`` accepts (numpy
arrays, or the reference's arrays, which convert without this module
importing JAX) and returns the port's tensors on `device` (None means
CUDA). With these, both packages compute the same thing from the same
inputs:

  - `params_from_numpy`: a parameter pytree -> dict in jax flatten order
    (sorted keys at every level); bf16 leaves stay bf16, bit for bit;
  - `state_from_numpy`: the reference's `DracoState` -> the port's (the
    ring, ``w_ring``, ``delay_ring``, counters, window index, positions
    and the ``(N, Dopt)`` optimizer plane; the JAX key becomes a fresh
    generator seeded by `seed`);
  - `legacy_state_from_numpy`: the reference's `DracoStateLegacy` -> the
    port's (per-leaf params, pending and ring buffers, counters, window
    index, the positions drawn at init and the optimizer plane; a fresh
    generator seeded by `seed`);
  - `data_from_numpy`: ``(xs, ys)`` shards (integer inputs, tiny-lm's
    tokens, stay integers);
  - `draws_from_numpy`: one window's draws -> `WindowDraws`;
  - `baseline_state_from_numpy`: the reference's `BaselineState` -> the
    port's (params, push weights, round index, positions, optimizer
    plane; a fresh generator seeded by `seed` for the JAX key);
  - `round_draws_from_numpy`: one baseline round's draws -> `RoundDraws`;
  - `schedule_from_numpy`: the reference's scenario `Schedule` -> the
    port's;
  - `event_state_from_numpy`: the reference's `EventState` -> the port's
    (rings, deadlines, send times, counters; ``tx_count``, the cursor
    and the clock as host values; a fresh generator seeded by `seed`);
  - `event_draws_from_numpy`: one event's draws -> `EventDraws`;
  - `tape_from_numpy`: the reference's `EventTape` -> the port's (host
    numpy arrays).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import as_generator, resolve_device
from repro_torch.core.baselines import BaselineState, RoundDraws
from repro_torch.core.flat import tree_from_items
from repro_torch.core.protocol import DracoState, DracoStateLegacy, WindowDraws
from repro_torch.events.engine import EventDraws, EventState
from repro_torch.events.tape import EventTape
from repro_torch.scenarios.base import Schedule


def _tensor(x, device, dtype=None) -> torch.Tensor:
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        # JAX's bf16 (an ml_dtypes numpy type) has no torch counterpart
        # that as_tensor knows: carry the bit pattern over as 16-bit ints
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def params_from_numpy(tree, device=None):
    """Nested mapping of arrays -> nested dict of tensors, sorted keys."""
    dev = resolve_device(device)

    def items(node, prefix):
        if isinstance(node, Mapping):
            for k in sorted(node):
                yield from items(node[k], prefix + (k,))
        else:
            yield prefix, _tensor(node, dev)

    return tree_from_items(items(tree, ()))


def _getter(obj):
    return obj.get if isinstance(obj, Mapping) else obj.__getattribute__


def _opt_plane(get, n: int, dev) -> torch.Tensor:
    """The reference's (N, Dopt) optimizer plane (an empty ``()`` or a
    missing one is (N, 0))."""
    try:
        plane = get("opt_state")
    except AttributeError:
        plane = None
    plane = np.asarray(() if plane is None else plane, np.float32)
    return _tensor(plane.reshape(n, -1), dev, torch.float32)


def state_from_numpy(state, *, seed: int = 0, device=None) -> DracoState:
    """The reference's `DracoState` (any object with its field names as
    attributes or keys) -> the port's `DracoState`."""
    dev = resolve_device(device)
    get = _getter(state)
    pending = _tensor(get("pending"), dev, torch.float32)
    return DracoState(
        params=params_from_numpy(get("params"), dev),
        pending=pending,
        buffer=_tensor(get("buffer"), dev, torch.float32),
        w_ring=_tensor(get("w_ring"), dev, torch.float32),
        delay_ring=_tensor(get("delay_ring"), dev, torch.int32),
        accept_count=_tensor(get("accept_count"), dev, torch.int32),
        total_accept=_tensor(get("total_accept"), dev, torch.int32),
        window_idx=int(np.asarray(get("window_idx"))),
        generator=as_generator(seed, dev),
        positions=_tensor(get("positions"), dev, torch.float32),
        opt_state=_opt_plane(get, pending.shape[0], dev),
    )


def legacy_state_from_numpy(state, *, seed: int = 0, device=None) -> DracoStateLegacy:
    """The reference's `DracoStateLegacy` (any object with its field names
    as attributes or keys) -> the port's `DracoStateLegacy`."""
    dev = resolve_device(device)
    get = _getter(state)
    accept_count = _tensor(get("accept_count"), dev, torch.int32)
    return DracoStateLegacy(
        params=params_from_numpy(get("params"), dev),
        pending=params_from_numpy(get("pending"), dev),
        buffer=params_from_numpy(get("buffer"), dev),
        accept_count=accept_count,
        total_accept=_tensor(get("total_accept"), dev, torch.int32),
        window_idx=int(np.asarray(get("window_idx"))),
        generator=as_generator(seed, dev),
        positions=_tensor(get("positions"), dev, torch.float32),
        opt_state=_opt_plane(get, accept_count.shape[0], dev),
    )


def baseline_state_from_numpy(state, *, seed: int = 0, device=None) -> BaselineState:
    """The reference's `BaselineState` (any object with its field names
    as attributes or keys) -> the port's `BaselineState`."""
    dev = resolve_device(device)
    get = _getter(state)
    push_weight = _tensor(get("push_weight"), dev, torch.float32)
    return BaselineState(
        params=params_from_numpy(get("params"), dev),
        push_weight=push_weight,
        round_idx=int(np.asarray(get("round_idx"))),
        generator=as_generator(seed, dev),
        positions=_tensor(get("positions"), dev, torch.float32),
        opt_state=_opt_plane(get, push_weight.shape[0], dev),
    )


def round_draws_from_numpy(draws: Mapping, device=None) -> RoundDraws:
    """Mapping with the `RoundDraws` field names -> `RoundDraws`."""
    dev = resolve_device(device)
    fading = draws.get("fading")
    return RoundDraws(
        active=_tensor(draws["active"], dev, torch.bool),
        batch_idx=_tensor(draws["batch_idx"], dev, torch.int64),
        fading=None if fading is None else _tensor(fading, dev, torch.float32))


def data_from_numpy(data, device=None):
    """``(xs, ys)`` -> (f32 tensor, int64 tensor) on `device`; integer
    inputs (token ids) become int64 too."""
    dev = resolve_device(device)
    xs, ys = data
    x_dtype = torch.int64 if np.issubdtype(np.asarray(xs).dtype, np.integer) \
        else torch.float32
    return _tensor(xs, dev, x_dtype), _tensor(ys, dev, torch.int64)


def schedule_from_numpy(schedule, device=None) -> Schedule:
    """The reference's `Schedule` (any object with its field names as
    attributes or keys) -> the port's, rings on `device`."""
    dev = resolve_device(device)
    get = _getter(schedule)
    dtypes = {"adj": torch.bool}
    fields = {}
    for name in Schedule._fields:
        ring = get(name)
        fields[name] = None if ring is None else _tensor(
            ring, dev, dtypes.get(name, torch.float32))
    return Schedule(**fields)


def draws_from_numpy(draws: Mapping, device=None) -> WindowDraws:
    """Mapping with the `WindowDraws` field names -> `WindowDraws`."""
    dev = resolve_device(device)
    opt = {k: None if draws.get(k) is None else _tensor(draws[k], dev, dt)
           for k, dt in (("fading", torch.float32), ("perm", torch.int64))}
    return WindowDraws(
        grad_mask=_tensor(draws["grad_mask"], dev, torch.bool),
        batch_idx=_tensor(draws["batch_idx"], dev, torch.int64),
        tx_mask=_tensor(draws["tx_mask"], dev, torch.bool),
        **opt)


def event_state_from_numpy(state, *, seed: int = 0, device=None) -> EventState:
    """The reference's `EventState` (any object with its field names as
    attributes or keys) -> the port's `EventState`."""
    dev = resolve_device(device)
    get = _getter(state)
    pending = _tensor(get("pending"), dev, torch.float32)
    return EventState(
        params=params_from_numpy(get("params"), dev),
        pending=pending,
        buffer=_tensor(get("buffer"), dev, torch.float32),
        w_ring=_tensor(get("w_ring"), dev, torch.float32),
        deadline_ring=_tensor(get("deadline_ring"), dev, torch.float32),
        send_time=_tensor(get("send_time"), dev, torch.float32),
        accept_count=_tensor(get("accept_count"), dev, torch.int32),
        total_accept=_tensor(get("total_accept"), dev, torch.int32),
        tx_sent=_tensor(get("tx_sent"), dev, torch.int32),
        tx_count=int(np.asarray(get("tx_count"))),
        event_idx=int(np.asarray(get("event_idx"))),
        time=np.float32(np.asarray(get("time"))),
        generator=as_generator(seed, dev),
        positions=_tensor(get("positions"), dev, torch.float32),
        opt_state=_opt_plane(get, pending.shape[0], dev),
    )


def event_draws_from_numpy(draws: Mapping, device=None) -> EventDraws:
    """Mapping with (some of) the `EventDraws` field names -> `EventDraws`."""
    dev = resolve_device(device)
    return EventDraws(**{k: None if draws.get(k) is None else _tensor(draws[k], dev, dt)
                         for k, dt in (("batch_idx", torch.int64),
                                       ("fading", torch.float32))})


def tape_from_numpy(tape) -> EventTape:
    """The reference's `EventTape` (any object with its field names as
    attributes or keys) -> the port's host-numpy tape, dtypes kept."""
    get = _getter(tape)
    return EventTape(t=np.asarray(get("t"), np.float32),
                     client=np.asarray(get("client"), np.int32),
                     kind=np.asarray(get("kind"), np.int32),
                     valid=np.asarray(get("valid"), bool))
