"""End-to-end DRACO trainer for a decoder LM, on one device or a client mesh.

Port of `repro.launch.train` with its single-device step
(`train.py:119-129` of the reference) and its mesh path (`:93-117`,
``--mesh-backend`` under ``torchrun``: `steps.make_train_step` over the
ranks' clients, see `main`): per-client local gradients of
`lm_loss`, row-stochastic gossip (`mixing.mix_plane`, the flat form of
`mix_dense`) under per-step event and Psi masks, periodic unification
on a rotating hub, and checkpoints in the reference's layout. The graph and its row-stochastic
Q come from `repro_torch.api.make_context`, as in the reference.

Memory. The reference vmaps the clients' gradients, which at
qwen2-1.5b width with 4 clients would hold four bf16 gradient sets and
a bf16 copy of the mixed plane beside the params and two f32 planes,
more than one card has. `train_step` computes the same thing client by
client: client i's gradient is scaled by ``-lr`` in the leaf's dtype
and written straight into row i of the f32 (N, Dflat) delta plane (in
`FlatSpec` column order, which is the reference's ravel), the gradient
is freed, the plane is mixed by one gossip-mix launch, and the mixed
plane is added into the params leaf by leaf, in place.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 12 --clients 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --reduced --device cpu --steps 12 --clients 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --reduced --device cpu --steps 3     # also zamba2-2.7b, musicgen-large, ...
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 20 --clients 4 --psi 1 --unify-every 10     # on the card
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --mesh-backend gloo --device cpu --reduced \
      --steps 4 --clients 4 --seq 32 --mix dense   # 2 ranks of 2 clients
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import as_generator, resolve_device
from repro_torch import checkpoint as ckpt_lib
from repro_torch.api import make_context
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.core import mixing
from repro_torch.core.events import sample_event_masks
from repro_torch.core.protocol import DracoConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M

# independent random streams of one run, each seeded from (--seed, stream)
STREAM_INIT, STREAM_DATA, STREAM_EVENTS, STREAM_GRAPH = range(4)


def stream_seed(seed: int, stream: int, step: int = 0) -> int:
    """A 63-bit seed for one random stream (and step) of a run."""
    state = np.random.SeedSequence([seed, stream, step]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))


def make_batches(key, cfg, n_clients: int, per_client: int, seq: int,
                 device=None):
    """Synthetic LM shards per client, as the reference's `make_batches`:
    ``{"tokens": (N, P, S)}`` int64 uniform over the vocabulary; an
    ``embeds_in`` model (audio) gets ``{"embeds": (N, P, S, d)}`` N(0, 1)
    in ``cfg.dtype`` and ``"labels": (N, P, S)`` in its place; a vlm also
    ``"cross_embeds": (N, P, num_patch_tokens, d)`` N(0, 1) in
    ``cfg.dtype``. Drawn from one generator in that order."""
    gen = as_generator(key, device)
    dev = gen.device
    shape = (n_clients, per_client, seq)
    data = {}
    if cfg.embeds_in:
        data["embeds"] = torch.randn(shape + (cfg.d_model,), generator=gen,
                                     device=dev).to(cfg.torch_dtype)
        data["labels"] = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    else:
        data["tokens"] = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    if cfg.family == "vlm":
        data["cross_embeds"] = torch.randn(
            (n_clients, per_client, cfg.num_patch_tokens, cfg.d_model), generator=gen,
            device=dev).to(cfg.torch_dtype)
    return data


def select_batch(data, idx: int, batch_per_client: int):
    """Step `idx`'s ``batch_per_client`` rows of every client's shard,
    starting at ``(idx * b) % max(per_client - b + 1, 1)``."""
    per_client = next(iter(data.values())).shape[1]
    start = (idx * batch_per_client) % max(per_client - batch_per_client + 1, 1)
    return {k: v[:, start:start + batch_per_client] for k, v in data.items()}


def mixing_weights(q: torch.Tensor, psi: int, *,
                   generator: Optional[torch.Generator] = None,
                   lambda_tx: float = 1.0,
                   tx: Optional[torch.Tensor] = None,
                   psi_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step's effective weights ``q_eff`` (N, N): the rows of senders
    that fire in a unit window (Poisson thinning at `lambda_tx`) kept,
    then at most `psi` incoming edges per receiver (``psi=0``: no cap).

    The tx mask (N,) and the Psi tie-break noise (N, N) are drawn from
    `generator`, in that order, unless given (tests inject the
    reference's draws)."""
    n = q.shape[0]
    if tx is None:
        tx = sample_event_masks(generator, lambda_tx, 1.0, n)
    q_eff = q * tx[:, None].to(q.dtype)
    if psi > 0:
        q_eff = mixing.psi_cap_mask(q_eff, psi, generator=generator,
                                    noise=psi_noise)
    return q_eff


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype`, as JAX rounds a Python scalar to the
    array's dtype in ``scalar * array``."""
    return float(torch.tensor(x, dtype=dtype))


def train_step_clients(params, batch, q_eff: torch.Tensor, cfg, lr: float, *,
                       mix: Optional[mixing.MixFn] = None, chunk_fn=None,
                       blocked_attn_threshold: int = 8192, vocab_chunk: int = 0):
    """`train_step` returning each client's loss: ``(params, losses (N,)
    f32)``. The mesh step (`steps.make_train_step`) runs it on a rank's
    clients with a collective `mix` and gathers the losses."""
    spec = flat_lib.spec_of(params)
    n = spec.num_clients
    plane = torch.empty((n, spec.dim), dtype=torch.float32, device=q_eff.device)
    unused = M.unused_leaves(cfg)
    losses = []
    for i in range(n):
        p_i = flat_lib.tree_map(lambda p: p[i].detach().requires_grad_(), params)
        loss = M.lm_loss(p_i, cfg, {k: v[i] for k, v in batch.items()},
                         chunk_fn=chunk_fn, blocked_attn_threshold=blocked_attn_threshold,
                         vocab_chunk=vocab_chunk)
        items = list(zip(flat_lib.tree_items(p_i), spec.offsets, spec.sizes))
        used = [(leaf, off, size) for (path, leaf), off, size in items if path not in unused]
        grads = torch.autograd.grad(loss, [leaf for leaf, _, _ in used])
        for g, (_, off, size) in zip(grads, used):
            plane[i, off:off + size].copy_(g.reshape(-1).mul_(_in_dtype(-lr, g.dtype)))
        for (path, _), off, size in items:
            if path in unused:
                plane[i, off:off + size].zero_()
        losses.append(loss.detach())
        del p_i, loss, grads, items, used
    mixed = mixing.mix_plane(q_eff, plane, mix)
    del plane
    with torch.no_grad():
        mixing.add_plane_(params, mixed, spec)
    return params, torch.stack(losses)


def train_step(params, batch, q_eff: torch.Tensor, cfg, lr: float, *,
               mix: Optional[mixing.MixFn] = None, chunk_fn=None,
               blocked_attn_threshold: int = 8192, vocab_chunk: int = 0):
    """One DRACO step on one device; returns ``(params, mean loss)``.

    params: dict of (N, ...) leaves, updated in place; batch a dict of
    (N, B, ...) tensors (`make_batches`' keys), each sliced per client;
    q_eff (N, N) this step's masked weights. The leaves of
    `M.unused_leaves` (an audio model's token embedding) get a zero
    gradient, as in the reference; any other leaf the loss does not reach
    raises.
    For each client in turn: `lm_loss` and its gradient, ``-lr * g`` in
    the leaf's dtype written into that client's row of the f32 delta
    plane. Then one `mix_plane` (the gossip-mix kernel, or `mix`) and
    ``p += mixed.to(p.dtype)`` leaf by leaf. The loss is the mean of the
    clients' f32 losses, as a 0-d tensor (no host read). `chunk_fn`
    replaces the SSD intra-chunk kernel of an ssm or hybrid model (see
    `M.apply_model`); `blocked_attn_threshold` and `vocab_chunk` go to
    `M.lm_loss`."""
    params, losses = train_step_clients(
        params, batch, q_eff, cfg, lr, mix=mix, chunk_fn=chunk_fn,
        blocked_attn_threshold=blocked_attn_threshold, vocab_chunk=vocab_chunk)
    return params, losses.mean()


def init_client_params(seed: int, cfg, n_clients: int, device=None):
    """One init (`init_params` from ``(seed, STREAM_INIT)``) copied to
    every client: a dict of (N, ...) leaves."""
    params0 = M.init_params(stream_seed(seed, STREAM_INIT), cfg, device)
    return flat_lib.tree_map(
        lambda p: p[None].expand(n_clients, *p.shape).clone(), params0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    # the mesh step's gossip (--mesh-backend): dense, ring or none; one
    # device always mixes densely, as the reference's single-device step
    ap.add_argument("--mix", default="dense", choices=["dense", "ring", "none"])
    ap.add_argument("--psi", type=int, default=0)
    ap.add_argument("--topology", default="cycle")
    ap.add_argument("--unify-every", type=int, default=50)
    ap.add_argument("--lambda-tx", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    ap.add_argument("--mesh-backend", default=None, choices=["nccl", "gloo"],
                    help="train on a client mesh over the torchrun world with this "
                         "backend: each rank holds clients / world of the clients")
    ap.add_argument("--mix-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the mesh step's dense mix dtype (bfloat16 halves the "
                         "collective's bytes)")
    return ap.parse_args(argv)


def check_seq(cfg, seq: int) -> None:
    """An ssm or hybrid model's SSD runs in chunks of ``min(ssm_chunk,
    seq)`` tokens, so `seq` must be a multiple of ``ssm_chunk`` or no
    longer than it (the reference asserts this in ``ssd_chunked``)."""
    if cfg.family in ("ssm", "hybrid") and seq > cfg.ssm_chunk and seq % cfg.ssm_chunk:
        raise ValueError(
            f"--seq {seq} does not fit {cfg.name}'s SSD chunk of {cfg.ssm_chunk} "
            f"tokens: give a multiple of {cfg.ssm_chunk}, or at most {cfg.ssm_chunk}")


def _mesh_setup(args):
    """The mesh path's (mesh, device, whether this call started the
    process group): the torchrun world laid over ("data", "model") as
    (world, 1); on CUDA the drain kernel is built on rank 0 before the
    others load it."""
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib

    started = not dist.is_initialized()
    mesh_lib.init_world(args.mesh_backend)
    mesh = mesh_lib.make_mesh((dist.get_world_size(), 1), ("data", "model"),
                              backend=args.mesh_backend, device=args.device)
    if mesh.device.type == "cuda":
        if mesh.rank == 0:
            build.build(("drain",))
        mesh.barrier()
    return mesh, mesh.device, started


def _save(args, step, params, mesh):
    """A checkpoint in the reference's layout: on a mesh every leaf is
    gathered N-wide and rank 0 writes it."""
    if mesh is not None:
        params = flat_lib.tree_map(mesh.all_gather, params)
        if mesh.rank != 0:
            return
    ckpt_lib.save(args.ckpt_dir, step, params)
    print(f"saved checkpoint @ {step}")


def _restore(args, params, step, n, mesh):
    """Restore step `step`; on a mesh every rank reads the N-wide file
    and keeps its rows (ranks of one machine share its disk)."""
    if mesh is None:
        return ckpt_lib.restore(args.ckpt_dir, params, step)
    template = flat_lib.tree_map(
        lambda p: torch.empty((), dtype=p.dtype).expand((n,) + tuple(p.shape[1:])), params)
    full = ckpt_lib.restore(args.ckpt_dir, template, step)
    sl = mesh.client_slice(n)
    return flat_lib.tree_map(lambda f, p: f[sl].to(p.device).contiguous(), full, params)


def main(argv=None, *, cfg=None):
    """Run the trainer with the CLI's arguments. `cfg` trains that model
    config instead of the one ``--arch`` / ``--reduced`` name (for
    example a depth cut of it, ``get_config(arch).with_(num_layers=32)``).
    Returns the per-step losses.

    With ``--mesh-backend`` (under ``torchrun``) the clients are laid over
    the world's ranks (`steps.make_train_step`): each rank initialises
    its N / ranks clients, draws the data and every step's ``q_eff``
    N-wide from the run's seeds (alike on every rank) and keeps its rows,
    so the run is the single-process one with the mix as a collective;
    checkpoints are gathered to rank 0 in the reference's layout. Every
    rank returns the same losses (the mean over all N clients); rank 0
    prints."""
    args = parse_args(argv)
    if not args.mesh_backend:
        return _train(args, cfg, None, resolve_device(args.device))
    import torch.distributed as dist

    mesh, dev, started = _mesh_setup(args)
    try:
        return _train(args, cfg, mesh, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, mesh, dev):
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_seq(cfg, args.seq)
    n = args.clients
    sl = slice(0, n) if mesh is None else mesh.client_slice(n)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    params = init_client_params(args.seed, cfg, sl.stop - sl.start, dev)
    # protocol-plane context: the graph and Q built once, by the same
    # path as `repro_torch.api.simulate`
    proto_cfg = DracoConfig(num_clients=n, topology=args.topology,
                            psi=args.psi, unify_period=args.unify_every,
                            lambda_tx=args.lambda_tx, channel=None)
    ctx = make_context(proto_cfg, graph_seed=stream_seed(args.seed, STREAM_GRAPH),
                       device=dev)
    q = ctx.q
    data = make_batches(stream_seed(args.seed, STREAM_DATA), cfg, n,
                        per_client=8 * args.batch_per_client, seq=args.seq,
                        device=dev)
    data = {k: v[sl] for k, v in data.items()}
    if mesh is None:
        def step_fn(params, batch, q_eff):
            return train_step(params, batch, q_eff, cfg, args.lr)
    else:
        step_fn = steps_lib.make_train_step(cfg, mesh, lr=args.lr, mix_mode=args.mix,
                                            psi=args.psi,
                                            mix_dtype=getattr(torch, args.mix_dtype))
    unify_fn = steps_lib.make_unify_step(cfg, mesh)

    start = 0
    if args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            params = _restore(args, params, latest, n, mesh)
            start = latest
            say(f"restored step {latest}")

    gen_ev = torch.Generator(device=dev)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        gen_ev.manual_seed(stream_seed(args.seed, STREAM_EVENTS, step))
        q_eff = mixing_weights(q, args.psi, generator=gen_ev,
                               lambda_tx=args.lambda_tx)
        batch = select_batch(data, step, args.batch_per_client)
        params, loss = step_fn(params, batch, q_eff)
        losses.append(float(loss))
        if args.unify_every and (step + 1) % args.unify_every == 0:
            params = unify_fn(params, (step // args.unify_every) % n)
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            say(f"step {step+1:5d} loss {np.mean(losses[-args.log_every:]):.4f} "
                f"({dt/args.log_every:.2f}s/step)")
            t0 = time.time()
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            _save(args, step + 1, params, mesh)

    say(f"final loss {np.mean(losses[-10:]):.4f} (first 10: {np.mean(losses[:10]):.4f})")
    return losses


if __name__ == "__main__":
    main()
