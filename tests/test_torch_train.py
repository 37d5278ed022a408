"""repro_torch LM trainer (the single-device DRACO step, checkpoints and
the CLI) against the JAX package, for the dense (qwen2) and ssm (mamba2)
families.

The JAX side of the trainer step is rebuilt here from `M.lm_loss`,
`mixing.mix_dense` (through the Pallas mix kernel in interpret mode)
and `steps.make_unify_step`, as the reference's `train.py:119-131`
does; both sides get the same params (the reference's init), the same
numpy tokens, the same tx masks and the same Psi tie-break noise.
Three steps with one unification agree within 1e-4 (f32 sums of a
gradient in another order, carried through three updates). A
checkpoint crosses between the packages bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.api import make_context as jmake_context
from repro.configs.base import get_reduced as jget_reduced
from repro.core import mixing as jmixing
from repro.core.protocol import DracoConfig as JDracoConfig
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.api import make_context
from repro_torch.configs.base import get_reduced
from repro_torch.core import flat as tflat
from repro_torch.core.protocol import DracoConfig
from repro_torch.kernels.gossip import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ARCH = "qwen2-1.5b"
N, B, SEQ, LR, PSI = 4, 2, 16, 0.05, 1


def _jax_step(jcfg, lr):
    """The reference's single-device step (train.py:119-129)."""
    def step_fn(params, batch, q_eff):
        def client_loss(p_i, b_i):
            return jmodel.lm_loss(p_i, jcfg, b_i)

        loss, grads = jax.vmap(jax.value_and_grad(client_loss))(params, batch)
        delta = jax.tree_util.tree_map(lambda g: -lr * g, grads)
        add = jmixing.mix_dense(q_eff, delta, use_kernel=True, interpret=True)
        new_params = jax.tree_util.tree_map(
            lambda p, a: p + a.astype(p.dtype), params, add)
        return new_params, loss.mean()

    return jax.jit(step_fn)


def test_cycle_graph_matches_reference():
    cfg = dict(num_clients=N, topology="cycle", psi=PSI, unify_period=3)
    q = make_context(DracoConfig(**cfg, channel=None), device="cpu").q
    jq = jmake_context(JDracoConfig(**cfg, channel=None)).q
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # each client of the undirected 4-cycle has two in-neighbours, so
    # Psi = 1 binds
    assert (q > 0).sum(dim=0).tolist() == [2, 2, 2, 2]


def _three_steps_with_one_unify(arch, seq):
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    q = make_context(DracoConfig(num_clients=N, channel=None), device="cpu").q
    jp0 = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
    jparams = jax.tree_util.tree_map(
        lambda p: jnp.broadcast_to(p[None], (N,) + p.shape), jp0)
    tparams = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (N, 8 * B, seq))
    jdata, tdata = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.as_tensor(tokens)}
    jstep = _jax_step(jcfg, LR)
    junify = jsteps.make_unify_step(jcfg, None)
    tunify = tsteps.make_unify_step(tcfg, None)
    unify_every, k_ev = 3, jax.random.PRNGKey(4)
    for step in (4, 5, 6):  # a resumed run: the unify after step 5 takes hub 1
        tx = rng.random(N) < 0.7
        tx[step % N] = True  # at least one sender
        k_s = jax.random.fold_in(k_ev, step)
        noise = np.array(jax.random.uniform(k_s, (N, N), minval=0.0, maxval=1e-6))
        jq_eff = jnp.asarray(q.numpy()) * jnp.asarray(tx)[:, None].astype(jnp.float32)
        jq_eff = jmixing.psi_cap_mask(k_s, jq_eff, PSI)
        q_eff = ttrain.mixing_weights(q, PSI, tx=torch.as_tensor(tx),
                                      psi_noise=torch.as_tensor(noise))
        np.testing.assert_array_equal(q_eff.numpy(), np.asarray(jq_eff))
        jparams, jloss = jstep(jparams, jtrain.select_batch(jdata, step, B), jq_eff)
        tparams, tloss = ttrain.train_step(
            tparams, ttrain.select_batch(tdata, step, B), q_eff, tcfg, LR)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, atol=1e-4)
        if (step + 1) % unify_every == 0:
            hub = (step // unify_every) % N
            assert hub == 1
            jparams = junify(jparams, jnp.asarray(hub, jnp.int32))
            tparams = tunify(tparams, hub)
    for t, j in zip(tflat.tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_three_steps_with_one_unify_match_reference():
    _three_steps_with_one_unify(ARCH, SEQ)


def test_mamba2_three_steps_with_one_unify_match_reference():
    """Reduced mamba2 at seq 64: two SSD chunks of 32 per sequence."""
    _three_steps_with_one_unify("mamba2-2.7b", 64)


def test_train_step_mixes_once_through_the_injected_mix():
    tcfg = get_reduced(ARCH).with_(num_layers=1)
    params = ttrain.init_client_params(0, tcfg, 3, "cpu")
    data = ttrain.make_batches(1, tcfg, 3, 2, 8, device="cpu")
    q = torch.full((3, 3), 0.5) - 0.5 * torch.eye(3)
    calls = []

    def spy(qq, plane):
        calls.append(tuple(plane.shape))
        return tops.gossip_mix_reference(qq, plane)

    before = {k: v.clone() for k, v in params.items() if k != "groups"}
    _, loss = ttrain.train_step(params, ttrain.select_batch(data, 0, 1), q, tcfg,
                                0.1, mix=spy)
    assert calls == [(3, tflat.spec_of(params).dim)]
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert not torch.equal(before["embed"], params["embed"])  # updated in place


def test_mixing_weights_mask_senders_and_cap_receivers():
    q = make_context(DracoConfig(num_clients=6, channel=None), device="cpu").q
    tx = torch.tensor([True, False, True, True, False, True])
    q_tx = ttrain.mixing_weights(q, 0, tx=tx)
    torch.testing.assert_close(q_tx, q * tx[:, None].float(), rtol=0, atol=0)
    gen = torch.Generator().manual_seed(1)
    capped = ttrain.mixing_weights(q, 1, generator=gen, lambda_tx=50.0)
    assert int((capped > 0).sum(dim=0).max()) <= 1


def test_make_batches_layout():
    cfg = get_reduced(ARCH)
    data = ttrain.make_batches(5, cfg, 3, 4, 6, device="cpu")
    again = ttrain.make_batches(5, cfg, 3, 4, 6, device="cpu")
    assert data["tokens"].shape == (3, 4, 6) and data["tokens"].dtype == torch.int64
    assert 0 <= int(data["tokens"].min()) and int(data["tokens"].max()) < cfg.vocab_size
    assert torch.equal(data["tokens"], again["tokens"])


def _mixed_tree():
    rng = np.random.default_rng(9)
    return {"embed": rng.standard_normal((2, 5, 3)).astype(np.float32),
            "groups": {"0:attn": {"norm": (rng.standard_normal((2, 2, 3))
                                           .astype(jnp.bfloat16))}},
            "scalar": np.float32(1.5)}


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    tree = _mixed_tree()
    jckpt.save(str(tmp_path), 12, jax.tree_util.tree_map(jnp.asarray, tree))
    assert tckpt.latest_step(str(tmp_path)) == 12
    template = convert.params_from_numpy(tree, "cpu")
    template = tflat.tree_map(torch.zeros_like, template)
    got = tckpt.restore(str(tmp_path), template)
    for (path, want), leaf in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0], tflat.tree_leaves(got)):
        want = np.asarray(want)
        assert leaf.shape == want.shape, path
        if want.dtype.name == "bfloat16":
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), want)


def test_port_checkpoint_restores_into_reference(tmp_path):
    tree = convert.params_from_numpy(_mixed_tree(), "cpu")
    path = tckpt.save(str(tmp_path), 7, tree)
    assert path.endswith("step_00000007.npz")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000007.npz"]
    like = jax.tree_util.tree_map(jnp.asarray, _mixed_tree())
    back = jckpt.restore(str(tmp_path), like)
    for leaf, got in zip(tflat.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        if leaf.dtype == torch.bfloat16:
            np.testing.assert_array_equal(np.asarray(got).view(np.int16),
                                          leaf.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(np.asarray(got), leaf.numpy())
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)


CLI = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--clients", "4",
       "--seq", "16", "--batch-per-client", "1", "--unify-every", "3", "--psi", "1"]


def test_trainer_cli_runs_and_resumes_from_its_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    losses = ttrain.main(CLI + ["--steps", "6", "--ckpt-dir", ckpt,
                                "--ckpt-every", "3", "--log-every", "3"])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert tckpt.latest_step(ckpt) == 6
    resumed = ttrain.main(CLI + ["--steps", "8", "--ckpt-dir", ckpt, "--log-every", "2"])
    assert len(resumed) == 2  # only steps 6 -> 8 ran
    out = capsys.readouterr().out
    assert "restored step 6" in out and "saved checkpoint @ 6" in out
    # per-step draws are seeded by step, so a resumed run continues the
    # uninterrupted one exactly
    full = ttrain.main(CLI + ["--steps", "8", "--log-every", "4"])
    assert full[:6] == losses and full[6:] == resumed


MAMBA_CLI = ["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu", "--clients", "4",
             "--seq", "64", "--batch-per-client", "1", "--unify-every", "3", "--psi", "1"]


def test_mamba2_trainer_cli_runs(capsys):
    losses = ttrain.main(MAMBA_CLI + ["--steps", "4", "--log-every", "2"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    # uniform tokens over V = 512 start near ln V
    assert abs(losses[0] - np.log(512)) < 1.0
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("seq", [48, 80])
def test_trainer_rejects_seq_off_the_ssd_chunk(seq):
    with pytest.raises(ValueError, match="multiple of 32"):
        ttrain.main(MAMBA_CLI[:5] + ["--seq", str(seq), "--steps", "1"])


def test_main_trains_a_given_config():
    """`cfg=` trains a cut of the named architecture, as chip_smoke.py
    drives mamba2-2.7b at 32 of its 64 layers."""
    cfg = get_reduced("mamba2-2.7b").with_(num_layers=1)
    a = ttrain.main(MAMBA_CLI + ["--steps", "2", "--seq", "32"], cfg=cfg)
    b = ttrain.main(MAMBA_CLI + ["--steps", "2", "--seq", "32"])
    assert len(a) == len(b) == 2 and np.isfinite(a).all()
    assert a != b  # one layer is another model than the reduced two
