"""repro_torch's serving entry points against the JAX package:
`launch.serve.serve_batch` (greedy tokens equal to the reference's on the
same parameters and prompts, for the six families) and its `main`, the
registry's decode fields, `launch.steps.serve_config`,
`make_prefill_step` and `make_serve_step`, and the refusal to run
without a card.

The reduced configs in f32, the reference's own parameters carried over
with `convert.params_from_numpy`; prompts from numpy seeds. Logits at
rtol = atol = 1e-5 (f32 sums in another order); greedy tokens exactly.
The reference's steps take a mesh; they run here on a 1 x 1 mesh of the
CPU device, where their sharding constraints change nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.configs import base as jbase  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import as_generator, convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SIX = ["qwen2-1.5b", "mamba2-2.7b", "olmoe-1b-7b", "zamba2-2.7b", "llama-3.2-vision-11b",
       "musicgen-large"]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _setup(arch, b=3, p=6, seed=0):
    jcfg, tcfg = jbase.get_reduced(arch), tbase.get_reduced(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, jcfg.vocab_size, (b, p)).astype(np.int32)
    cross = None
    if jcfg.family == "vlm":
        cross = rng.standard_normal((b, jcfg.num_patch_tokens, jcfg.d_model)).astype(
            np.float32)
    return jcfg, tcfg, jp, tp, prompts, cross


@pytest.mark.parametrize("arch", SIX)
def test_serve_batch_greedy_tokens_equal_reference(arch):
    jcfg, tcfg, jp, tp, prompts, cross = _setup(arch)
    want = jserve.serve_batch(jcfg, jp, jnp.asarray(prompts), 5,
                              cross_embeds=None if cross is None else jnp.asarray(cross))
    got = tserve.serve_batch(tcfg, tp, torch.as_tensor(prompts).long(), 5,
                             cross_embeds=None if cross is None else torch.as_tensor(cross))
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_samples_from_its_generator():
    _, tcfg, _, tp, prompts, _ = _setup("qwen2-1.5b")
    prompts = torch.as_tensor(prompts).long()

    def sample(seed):
        return tserve.serve_batch(tcfg, tp, prompts, 8, greedy=False,
                                  generator=torch.Generator().manual_seed(seed))

    a, b = sample(1), sample(1)
    assert torch.equal(a, b) and not torch.equal(a, sample(2))
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size
    with pytest.raises(ValueError, match="generator"):
        tserve.serve_batch(tcfg, tp, prompts, 2, greedy=False)
    vlm = tbase.get_reduced("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="cross_embeds"):
        tserve.serve_batch(vlm, tmodel.init_params(0, vlm, "cpu"), prompts, 2)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b", "llama-3.2-vision-11b",
                                  "musicgen-large"])
def test_serve_main_runs_reduced_on_the_cpu(arch, capsys):
    toks = tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "5", "--new-tokens", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "tok/s aggregate" in out and "sample:" in out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_serve_main_takes_a_depth_cut_config(arch):
    """`main(argv, cfg=)` serves the given config (as `train.main` takes one):
    the same tokens as the CLI's own config cut to the same depth."""
    import torch

    cfg = tbase.get_reduced(arch).with_(num_layers=1)
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "5", "--new-tokens", "4"]
    toks = tserve.main(argv, cfg=cfg)
    gen = as_generator(0, "cpu")  # main's draws: the params, then the prompts
    params = tmodel.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen, device="cpu")
    assert torch.equal(toks, tserve.serve_batch(cfg, params, prompts, 4))


def test_serve_main_defaults_are_the_reference_flags():
    args = tserve.parse_args([])
    assert (args.arch, args.batch, args.prompt_len, args.new_tokens, args.seed) == (
        "qwen2-1.5b", 4, 32, 16, 0)
    assert args.device is None and not args.reduced


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b", "llama-3.2-vision-11b"])
def test_registry_decode_fields_match_reference(arch):
    jm, tm = jregistry.build_reduced(arch), tregistry.build_reduced(arch)
    assert [f.name for f in dataclasses.fields(tm)] == [f.name for f in dataclasses.fields(jm)]
    jp = jm.init(jax.random.PRNGKey(3))
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(3)
    jcross = tcross = None
    if jm.cfg.family == "vlm":
        pe = rng.standard_normal((2, jm.cfg.num_patch_tokens, jm.cfg.d_model)).astype(
            np.float32)
        jcross, tcross = jm.init_cross_kv(jp, jnp.asarray(pe)), tm.init_cross_kv(
            tp, torch.as_tensor(pe))
        _close(tcross["k"], jcross["k"])
    jst = jm.init_decode_state(2, 8)
    tst = tm.init_decode_state(2, 8, device="cpu")
    tok = rng.integers(0, jm.cfg.vocab_size, (2,)).astype(np.int32)
    for _ in range(3):
        want, jst = jm.decode_step(jp, jnp.asarray(tok), jst, jcross)
        got, tst = tm.decode_step(tp, torch.as_tensor(tok), tst, tcross)
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    assert int(tst.pos) == 3


@pytest.mark.parametrize("shape", list(jbase.SHAPES))
@pytest.mark.parametrize("arch", list(jbase.ARCH_IDS))
def test_serve_config_equals_reference(arch, shape):
    jcfg = jsteps.serve_config(jbase.get_config(arch), jbase.SHAPES[shape])
    tcfg = tsteps.serve_config(tbase.get_config(arch), tbase.SHAPES[shape])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("shape", ["prefill_32k", "long_500k"])
def test_prefill_and_serve_steps_match_reference(shape):
    """The steps under `serve_config`: at long_500k qwen2 gets its 8192
    window (no effect on 16 tokens)."""
    jcfg, tcfg, jp, tp, prompts, _ = _setup("qwen2-1.5b", b=2, p=16)
    jshape, tshape = jbase.SHAPES[shape], tbase.SHAPES[shape]
    want = jsteps.make_prefill_step(jcfg, jshape, _mesh())(jp, {"tokens": jnp.asarray(prompts)})
    got = tsteps.make_prefill_step(tcfg, tshape)(tp, {"tokens": torch.as_tensor(prompts)})
    assert got.shape == (2, tcfg.vocab_size) and not got.requires_grad
    _close(got, want)

    scfg = jsteps.serve_config(jcfg, jshape)
    jst = jmodel.init_decode_state(scfg, 2, 32)
    tst, _ = convert.decode_state_from_numpy(jax.device_get(jst), device="cpu")
    jstep = jsteps.make_serve_step(jcfg, jshape, _mesh())
    tstep = tsteps.make_serve_step(tcfg, tshape)
    for t in range(4):
        want, jst = jstep(jp, jnp.asarray(prompts[:, t]), jst)
        got, tst = tstep(tp, torch.as_tensor(prompts[:, t]), tst)
        _close(got, want)


class _Ranks:
    def __init__(self, size):
        self.size = size
        self.axis_names, self.shape = ("data", "model"), {"data": size, "model": 1}


def test_steps_on_a_mesh_raise():
    """A batch that does not divide by the mesh's client ranks: the prefill
    keeps the reference's refusal (jax will not lower the batch laid over
    the client ranks); the serve step serves the whole batch on every
    client rank, the cache's sequence axis over "data" where it divides
    (32,768 slots over 2 ranks) and whole where it does not (over 3: the
    reference's `filter_divisible` keeps it so)."""
    cfg, shape = tbase.get_reduced("qwen2-1.5b"), tbase.SHAPES["decode_32k"]
    odd = shape.__class__("b3", shape.seq_len, 3, "decode")
    with pytest.raises(ValueError, match="the reference's prefill"):
        tsteps.make_prefill_step(cfg, shape, mesh=_Ranks(3))
    assert tsteps.make_serve_step(cfg, shape, mesh=_Ranks(3)).layout is None
    assert tsteps.serving_rows(shape, _Ranks(3)) == shape.global_batch
    assert tsteps.make_serve_step(cfg, odd, mesh=_Ranks(2)).layout.slot_block() == (0, 2)
    for make in (tsteps.make_prefill_step, tsteps.make_serve_step):
        assert callable(make(cfg, shape, mesh=_Ranks(4)))
        # a "model" axis builds for the dense family
        assert callable(make(cfg, shape, mesh=tmesh.Mesh.dry((4, 2), ("data", "model"))))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("entry", ["serve.main", "init_decode_state", "registry"])
def test_serving_entry_points_raise_without_cuda(no_cuda, entry):
    cfg = tbase.get_reduced("qwen2-1.5b")
    calls = {
        "serve.main": lambda: tserve.main(["--reduced"]),
        "init_decode_state": lambda: tmodel.init_decode_state(cfg, 1, 4),
        "registry": lambda: tregistry.build_model(cfg).init_decode_state(1, 4),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
