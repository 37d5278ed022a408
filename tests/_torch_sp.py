"""Rank functions of `tests/test_torch_sequence_parallel.py` (a helper, not
a test module). Each runs in one process of a gloo world spawned by
`repro_torch.launch.mesh.spawn_ranks`, on the CPU, laid over ("data",
"model"), and returns what the test compares; this module imports no
JAX, so a rank starts quickly.

A world runs, for each of `_torch_tp.ARCHS` (reduced qwen2, dense;
qwen3-moe-30b-a3b, moe; mamba2-2.7b, ssm; zamba2-2.7b, hybrid;
llama-3.2-vision-11b, vlm, its cross gate at `_torch_tp.GATE`;
musicgen-large, audio): the train step in the dense and none mix modes
from the reference's whole parameters, with ``seq_parallel`` and
without, back to whole parameters; and/or `lm_loss` and its gradients
in f64 under the flag's context at each of `F64_SEQS` (both loss forms
and the flash path), for the test to hold against one process.
"""
import numpy as np
import torch

import _torch_tp as T
from repro_torch import convert
from repro_torch.configs.base import get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.sharding import tp as tp_lib

MODES = ("dense", "none")
# the f64 checks' sequence lengths: _torch_dist.SEQ (16) and 24, one of
# which the model axis of a world of 2 or 3 ranks leaves undivided
F64_SEQS = (16, 24)


def f64_batch(cfg, seq, seed=11):
    """One client's numpy batch of `seq` positions for `cfg`."""
    rng = np.random.default_rng(seed + seq)
    tokens = rng.integers(0, cfg.vocab_size, (1, 2, seq))
    return {k: v[0] for k, v in T.model_batch(cfg, tokens, rng).items()}


def f64_forms():
    """(name, `lm_loss` keywords) of the f64 checks."""
    return (("f64_0", {}), (f"f64_{T.CHUNK}", {"vocab_chunk": T.CHUNK}),
            ("f64_flash", {"blocked_attn_threshold": T.FLASH_FROM}))


def _train(mesh, cfg, train, out):
    n = T.N
    sl = mesh.client_slice(n)
    batch = {k: torch.as_tensor(v)[sl] for k, v in train["batches"][cfg.name].items()}
    for mode in MODES:
        for sp in (False, True):
            params = convert.shard_params(train["params"][cfg.name], mesh)
            step = steps.make_train_step(cfg, mesh, lr=T.LR, mix_mode=mode, seq_parallel=sp)
            mesh.reset_tally()
            params, loss = step(params, batch, torch.as_tensor(train["q_eff"]))
            out[f"{mode}_{sp}"] = dict(
                loss=float(loss), local=params, routes=dict(mesh.tp_routes),
                counts=dict(mesh.collective_tally()["_counts"]),
                whole=convert.gather_params(params, mesh, cfg))


def _f64(mesh, cfg, train, out):
    tp = tp_lib.context(mesh, seq_parallel=True)
    cfg64 = cfg.with_(dtype="float64", remat=T.arch_remat(cfg))
    whole = flat_lib.tree_map(lambda p: p[0].double(), train["params"][cfg.name])
    for seq in F64_SEQS:
        batch = {k: torch.as_tensor(v) for k, v in f64_batch(cfg, seq).items()}
        for name, kw in f64_forms():
            params = flat_lib.tree_map(lambda p: p.requires_grad_(),
                                       convert.shard_params(whole, mesh, clients=False))
            mesh.reset_tally()
            with tp_lib.use(tp):
                loss = M.lm_loss(params, cfg64, batch, **kw)
            grads = torch.autograd.grad(loss, flat_lib.tree_leaves(params),
                                        materialize_grads=True)
            routes = {k: mesh.tp_routes[k] for k in ("seq", "seq_whole")}
            grads = flat_lib.tree_from_items(zip([p for p, _ in flat_lib.tree_items(params)],
                                                 grads))
            out[f"{name}_{seq}"] = dict(
                loss=float(loss.detach()), routes=routes,
                grads=convert.gather_params(grads, mesh, cfg64, clients=False))


def world(rank, world_size, shape, train, with_steps, with_f64):
    """The checks of one ("data", "model") layout `shape`: the train steps
    with `with_steps`, the f64 ones with `with_f64`; returns this rank's
    results."""
    mesh = mesh_lib.make_test_mesh(shape)
    out = {"coords": (mesh.rank, mesh.model_rank)}
    for arch in T.ARCHS:
        cfg = get_reduced(arch)
        out[arch] = {}
        if with_steps:
            _train(mesh, cfg, train, out[arch])
        if with_f64:
            _f64(mesh, cfg, train, out[arch])
    return out
