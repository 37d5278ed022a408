"""Rank functions of `tests/test_torch_distributed.py` (a helper, not a
test module). Each runs in one process of a gloo world spawned by
`repro_torch.launch.mesh.spawn_ranks`, on the CPU, and returns what the
test compares; this module imports no JAX, so a rank starts quickly.

A world does every check of its size in one run: the sharded drain, the
mesh train step in each mode, the ring mix, unification, the serve step
and the sharded sweep.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.core import mixing
from repro_torch.kernels.gossip import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M

ARCH, N, B, SEQ, LR = "qwen2-1.5b", 4, 2, 16, 0.05
SERVE_BATCH, SERVE_PROMPT = 4, 8
# (name, mix_mode, mix_dtype) of the train steps; ring only at N == ranks
MODES = (("dense", "dense", None), ("dense-bf16", "dense", torch.bfloat16),
         ("ring", "ring", None), ("none", "none", None))
SWEEP_N = 8


def train_inputs(seed=0):
    """The train step's inputs, made once in the test process: one init
    of reduced qwen2 copied to N clients, numpy tokens (N, B, S), and a
    masked cycle q_eff (N, N)."""
    cfg = get_reduced(ARCH)
    params0 = M.init_params(seed, cfg, "cpu")
    params = flat_lib.tree_map(lambda p: p[None].expand(N, *p.shape).clone(), params0)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (N, B, SEQ))
    q = np.zeros((N, N), np.float32)
    for i in range(N):
        q[i, (i + 1) % N] = q[i, (i - 1) % N] = 0.5
    tx = np.array([True, False, True, True])
    q_eff = q * tx[:, None].astype(np.float32)
    ring_deltas = {"a": rng.standard_normal((N, 16)).astype(np.float32),
                   "b": rng.standard_normal((N, 3, 5)).astype(np.float32)}
    return dict(params=params, tokens=tokens, q_eff=q_eff, cycle=q,
                ring_deltas=ring_deltas)


def drain_inputs(seed=0):
    """`tests/test_sweep_mesh.py`'s case: J 3, S 4, N 16, K 37, about 30%
    of the weights live, slots [1, 3, 0]; and the same with bucket 1 empty."""
    rng = np.random.default_rng(seed)
    J, S, n, K = 3, 4, 16, 37
    w = (rng.standard_normal((J, n, n)) * (rng.random((J, n, n)) < 0.3)).astype(np.float32)
    ring = rng.standard_normal((S, n, K)).astype(np.float32)
    w0 = w.copy()
    w0[1] = 0.0
    return dict(w=w, w0=w0, ring=ring, slots=[1, 3, 0])


def sweep_setup():
    """The grid of `tests/test_sweep_mesh.py:92-123` in the port: N 8,
    a 6-8-3 MLP, Psi in {0, 2}, 2 seeds, 8 windows, evals every 4."""
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.data.synthetic import federated_classification, make_mlp

    train, test = federated_classification(0, SWEEP_N, 6, 3, per_client=32, device="cpu")
    params0, _, loss, acc = make_mlp(1, 6, (8,), 3, device="cpu")
    cfg = DracoConfig(num_clients=SWEEP_N, lr=0.1, local_batches=1, batch_size=8,
                      lambda_grad=0.8, lambda_tx=0.8, unify_period=5, psi=2,
                      topology="complete", max_delay_windows=3, channel=None)
    grid = [cfg.replace(psi=p) for p in (0, 2)]
    kw = dict(keys=[7, 8], eval_every=4, eval_fn=acc, eval_data=test, device="cpu")
    return grid, params0, loss, train, kw


def run_sweep(mesh=None):
    from repro_torch.api import simulate_sweep

    grid, params0, loss, train, kw = sweep_setup()
    finals, trace = simulate_sweep("draco", grid, params0, loss, train, 8, mesh=mesh, **kw)
    return {"params": finals.params, "total_accept": finals.total_accept,
            "accuracy": trace.metrics["accuracy"], "consensus": trace.metrics["consensus"]}


def _rows(tree, sl):
    return flat_lib.tree_map(lambda p: p[sl].clone(), tree)


def world(rank, world_size, train, drain):
    """Every check of one world size; returns this rank's results."""
    mesh = mesh_lib.make_sweep_mesh(backend="gloo", device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size}

    # the sharded drain on this rank's senders: (J, N_loc, N) and (S, N_loc, K)
    n = drain["w"].shape[-1]
    sl = mesh.client_slice(n)
    for key in ("w", "w0"):
        w = torch.as_tensor(drain[key])[:, sl]
        ring = torch.as_tensor(drain["ring"])[:, sl].contiguous()
        out[f"drain_{key}"] = ops.gossip_drain_sharded(w, ring, drain["slots"], mesh, ("data",))
    try:
        ops.gossip_drain_sharded(torch.zeros(2, 9 // world_size, 9), torch.zeros(3, 9 // world_size, 4),
                                 [0, 1], mesh, ("data",))
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)

    # the mesh train step in each mode on this rank's clients
    cfg = get_reduced(ARCH)
    sl = mesh.client_slice(N)
    batch = {"tokens": torch.as_tensor(train["tokens"])[sl]}
    q_eff = torch.as_tensor(train["q_eff"])
    for name, mode, md in MODES:
        if mode == "ring" and world_size != N:
            continue
        step = steps.make_train_step(cfg, mesh, lr=LR, mix_mode=mode, mix_dtype=md)
        params, loss = step(_rows(train["params"], sl), batch, q_eff)
        out[f"train_{name}"] = (params, loss)

    # unification from client 1 (on rank 1 // (N / ranks)), on a copy
    unify = steps.make_unify_step(cfg, mesh)
    out["unify"] = unify(_rows(out["train_dense"][0], slice(None)), 1)

    # the ring on one client per rank against the dense cycle mix
    if world_size == N:
        deltas = {k: torch.as_tensor(v)[sl] for k, v in train["ring_deltas"].items()}
        out["ring_mix"] = mixing.mix_ring_shardmap(mesh, ("data",), deltas)

    # the serve step on this rank's rows of the batch
    shape = ShapeConfig("serve", SERVE_PROMPT + 2, SERVE_BATCH, "decode")
    rows = mesh.client_slice(SERVE_BATCH)
    params0 = _rows(train["params"], 0)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen)
    serve = steps.make_serve_step(cfg, shape, mesh)
    state = M.init_decode_state(cfg, rows.stop - rows.start, shape.seq_len, device="cpu")
    logits = []
    for t in range(SERVE_PROMPT):
        lg, state = serve(params0, prompt[rows, t], state)
        logits.append(lg)
    out["serve"] = torch.stack(logits, dim=1)

    out["sweep"] = run_sweep(mesh)
    out["collective_s"] = mesh.collective_s
    return out
