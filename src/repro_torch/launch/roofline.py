"""Roofline terms of one step on one card (port of `repro.launch.roofline`).

    compute    = FLOPs_per_device / peak FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_bytes_per_device / link bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
the collective bytes from the compiled HLO text, and divides by its
accelerator's peaks. The port counts them on the step itself, run on
``meta`` tensors (`count_work`): FLOPs by
`torch.utils.flop_counter.FlopCounterMode`, bytes by a dispatch mode
that adds each aten op's input and output bytes (eager's device-memory
traffic), each hand-written kernel as one op with the work its bound
counts (`repro_torch.kernels.work`), and the collective bytes from the
`Mesh`'s own tally (`collective_bytes`): the *result* bytes of every
reduce-scatter, all-gather, broadcast and ring exchange over the client
ranks and of every all-reduce and all-gather over the "model" ranks
(tensor parallelism's, `repro_torch.sharding.tp`), the per-rank receive
volume, as the reference sums the results in its HLO. The same
dispatch mode tracks the live bytes of the tensors the step makes, whose
peak is the dry run's ``temp_size_in_bytes``.

The peaks are a field, `Roofline.peaks`; its default, `H100_SXM`, is the
card the port runs on.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work as work_lib


@dataclass(frozen=True)
class Peaks:
    """A card's peak rates: ``flops`` (FLOP/s of the step's dtype on the
    matrix units, the compute term's), ``hbm_bw`` (device-memory
    bytes/s), ``link_bw`` (bytes/s one way on one link to a peer), and
    the rates a hand-written kernel's issued products may run at
    (`repro_torch.kernels.work.KernelWork.rate`): ``f32_flops`` (f32
    outside the matrix units) and ``tf32_flops`` (TF32 on them)."""

    flops: float
    hbm_bw: float
    link_bw: float
    f32_flops: float
    tf32_flops: float


# NVIDIA H100 SXM 80GB at its 700 W power limit, the datasheet figures:
H100_SXM = Peaks(
    flops=989e12,  # dense bf16 on the tensor cores (f32 accumulation)
    hbm_bw=3.35e12,  # HBM3
    link_bw=450e9,  # NVLink 4, 900 GB/s both ways, 450 GB/s each way
    f32_flops=67e12,  # f32 outside the tensor cores
    tf32_flops=495e12,  # dense TF32 on the tensor cores
)


def collective_bytes(mesh) -> Dict[str, object]:
    """Per-collective-kind result bytes a `Mesh` has tallied (the client
    axes' kinds and the model axis's ``model_all_reduce`` and
    ``model_all_gather``), and their counts under ``"_counts"`` (the
    reference's dict shape)."""
    return mesh.collective_tally()


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    mode: str  # train | prefill | decode
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0  # 6*N*D (analytic, global)
    peak_memory_bytes: float = 0.0
    n_devices: int = 256
    peaks: Peaks = H100_SXM
    # `count_work`'s kernels, whose operations are part of
    # flops_per_device but run at their own rates
    kernel_work: Dict[str, Dict] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        """The step's aten FLOPs at ``peaks.flops``, each kernel's issued
        products at the rate its work names."""
        aten = self.flops_per_device - sum(k["flops"] for k in self.kernel_work.values())
        return aten / self.peaks.flops + sum(
            n / getattr(self.peaks, rate)
            for k in self.kernel_work.values() for rate, n in k["issued"].items())

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.peaks.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / self.peaks.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "mode": self.mode,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_memory_bytes": self.peak_memory_bytes,
            "n_devices": self.n_devices,
        }


def model_flops_analytic(cfg, shape) -> float:
    """6*N_active*D for train (fwd+bwd), 2*N_active*D for inference."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Counting a step's work
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that move no data: allocations, aliases and metadata
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten.lift_fresh.default, _aten._unsafe_view.default,
    _aten._reshape_alias.default, _aten.set_.source_Storage_storage_offset,
}
# gathers read the rows they return, not their whole table
_GATHERS = {_aten.embedding.default, _aten.index_select.default, _aten.index.Tensor,
            _aten.gather.default}
# Under any dispatch mode autograd's formulas take their functional form
# (`isTensorSubclassLike` holds): a gather's backward scatters into a fresh
# zero tensor out of place, where eager scatters into it in place. Such an
# op's output takes its fresh input's place
_ZEROS = {_aten.new_zeros.default, _aten.zeros_like.default, _aten.zeros.default}
_IN_PLACE_IN_EAGER = {_aten.scatter_add.default, _aten.index_put.default,
                      _aten.index_add.default}
# CUDA's softmax backward forms ``grad * output`` in a temporary while its
# output lives, then runs its kernel on it (the meta kernel makes none):
# the op's temporary bytes from its arguments
_CARD_TEMPS = {_aten._softmax_backward_data.default:
               lambda grad, output, *_: grad.numel() * torch.promote_types(
                   grad.dtype, output.dtype).itemsize}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op touches in `t`: its elements, at most its storage's
    (an expanded view reads each stored element once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def tensors_of(tree) -> list:
    """The tensors among the leaves of `tree` (dicts, tuples, named tuples)."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _BytesAndLive(TorchDispatchMode):
    """Adds each aten op's input and output bytes (views and allocations
    move nothing; a gather reads the rows it returns), and tracks the live bytes of the
    storages ops make on ``meta``: one ``weakref.finalize`` per storage
    (a storage's Python object lives as long as the storage, so the
    finalizer runs when the last tensor on it dies), the peak kept. An
    op that eager runs in place on the zero tensor the op before made
    (`_IN_PLACE_IN_EAGER`) hands that tensor's bytes to its output; one
    whose card kernel makes a temporary (`_CARD_TEMPS`) counts it beside
    its output at the peak."""

    def __init__(self, keep=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = {id(s) for s in keep}
        self._keep = list(keep)  # holds the pre-existing storages' ids valid
        self._counted = set()  # storages whose bytes `live` holds
        self._fresh = None  # the storage of the last op's zero tensor

    def _free(self, key, nbytes):
        self._known.discard(key)
        if key in self._counted:
            self._counted.discard(key)
            self.live -= nbytes

    def _hand_over(self, t):
        """Stop counting `t`'s storage: an in-place-in-eager op's output
        takes its place (see `_IN_PLACE_IN_EAGER`)."""
        st = t.untyped_storage()
        if id(st) in self._counted:
            self._counted.discard(id(st))
            self.live -= st.nbytes()

    def _track(self, out):
        for t in out:
            if t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            self._known.add(key)
            self._counted.add(key)
            nbytes = st.nbytes()
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        out = tensors_of(result)
        fresh, self._fresh = self._fresh, None
        if (func in _IN_PLACE_IN_EAGER and args and args[0].device.type == "meta"
                and id(args[0].untyped_storage()) == fresh):
            self._hand_over(args[0])
        elif func in _ZEROS and len(out) == 1 and out[0].device.type == "meta":
            self._fresh = id(out[0].untyped_storage())
        if func not in _FREE and not getattr(func, "is_view", False):
            outs = sum(tensor_bytes(t) for t in out)
            if func in _GATHERS:
                idx = tensors_of((args[1:], kwargs))
                self.bytes += 2 * outs + sum(tensor_bytes(t) for t in idx)
            else:
                self.bytes += outs + sum(tensor_bytes(t) for t in tensors_of((args, kwargs)))
        self._track(out)
        if func in _CARD_TEMPS and out and out[0].device.type == "meta":
            self.peak = max(self.peak, self.live + _CARD_TEMPS[func](*args))
        return result


@dataclass
class Work:
    """What `count_work` counted: ``flops`` (the aten ops' by
    FlopCounterMode plus the kernels'), ``bytes`` (likewise),
    ``kernels`` ({name: {"calls", "flops", "bytes", "issued": {rate:
    products}}}, from `repro_torch.kernels.work`), ``temp_peak``
    (the peak live bytes of the tensors the step made) and ``result``."""

    flops: float
    bytes: float
    kernels: Dict[str, Dict[str, float]]
    temp_peak: int
    result: object = None


def count_work(fn, *args, **kwargs) -> Work:
    """Run ``fn(*args, **kwargs)`` once under the counters on ``meta``
    tensors (no memory, no device) and return its `Work`. The storages
    of `args` and `kwargs` exist before the step and are not its
    temporaries."""
    kernels: Dict[str, Dict] = {}

    def on_kernel(name, w):
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "issued": {}})
        k["calls"] += 1
        k["flops"] += w.ops
        k["bytes"] += w.bytes
        k["issued"][w.rate] = k["issued"].get(w.rate, 0.0) + w.issued

    flop_mode = FlopCounterMode(display=False)
    byte_mode = _BytesAndLive([t.untyped_storage() for t in tensors_of((args, kwargs))])
    with flop_mode, byte_mode, work_lib.sink(on_kernel):
        result = fn(*args, **kwargs)
    kflops = sum(k["flops"] for k in kernels.values())
    kbytes = sum(k["bytes"] for k in kernels.values())
    return Work(flops=float(flop_mode.get_total_flops()) + kflops,
                bytes=float(byte_mode.bytes) + kbytes, kernels=kernels,
                temp_peak=int(byte_mode.peak), result=result)
