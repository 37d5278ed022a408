"""Rank function of `tests/test_torch_roofline.py` (a helper, not a test
module): one process of a gloo world spawned by
`repro_torch.launch.mesh.spawn_ranks`, on the CPU, that runs the mesh
train step in each mix mode and returns the mesh's collective tally
after each. Imports no JAX, so a rank starts quickly."""
from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

ARCH = "qwen2-1.5b"
SHAPE = ShapeConfig("tiny_train", 16, 4, "train")
# (name, mix_mode, mix_dtype): dense in f32 and bf16, ring (one client a rank), none
MODES = (("dense", "dense", None), ("dense-bf16", "dense", "bf16"),
         ("ring", "ring", None), ("none", "none", None))
# a served batch of 1 on every client rank, its ring of 8 slots over "data"
# (the decode cache's layout at long_500k): 2 decode steps
SERVE_SHAPE, SERVE_WINDOW, SERVE_STEPS = ShapeConfig("tiny_long", 16, 1, "decode"), 8, 2


def tallies(rank, world):
    mesh = mesh_lib.make_sweep_mesh(world, backend="gloo", device="cpu")
    cfg = get_reduced(ARCH)
    out = {}
    for name, mode, dtype in MODES:
        mesh.reset_tally()
        step, args = dryrun.build(cfg, SHAPE, mesh, device="cpu", mix_mode=mode,
                                  mix_dtype=dtype)
        step(*args)
        out[name] = mesh.collective_tally()
    mesh.reset_tally()
    step, (params, tok, state) = dryrun.build(cfg.with_(sliding_window=SERVE_WINDOW),
                                              SERVE_SHAPE, mesh, device="cpu")
    for _ in range(SERVE_STEPS):
        _, state = step(params, tok, state)
    out["serve"] = mesh.collective_tally()
    return out
