"""repro_torch's trainer on the moe, hybrid, vlm and audio families,
against the JAX package.

Three DRACO steps with one unification against the JAX single-device
step (as tests/test_torch_train.py, the tx masks and Psi noise injected;
1e-4: f32 sums of a gradient in another order carried through three
updates), zamba2's empty shared sub-block through the port's tree
helpers and checkpoints, the audio and vlm batches, and the CLI at each
reduced config on the CPU. Parameters and inputs as in
tests/test_torch_families.py, whose helpers this file uses.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_families import FAMILIES, _batch, _both, _params, _seq  # noqa: E402
from test_torch_train import _jax_step  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import make_context  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.core.protocol import DracoConfig  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

N, B, LR, PSI = 4, 2, 0.05, 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_steps_with_one_unify_match_reference(arch):
    """As tests/test_torch_train.py: steps 4-6 of a resumed run, the tx
    masks and Psi tie-break noise injected, one unification (hub 1)."""
    jcfg, tcfg = jbase.get_reduced(arch), tbase.get_reduced(arch)
    q = make_context(DracoConfig(num_clients=N, channel=None), device="cpu").q
    jp0, _ = _params(jcfg, seed=3)
    jparams = jax.tree_util.tree_map(lambda p: jnp.broadcast_to(p[None], (N,) + p.shape), jp0)
    tparams = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    jdata, tdata = _both(_batch(tcfg, lead=(N, 8 * B), s=_seq(tcfg), seed=3))
    jstep = _jax_step(jcfg, LR)
    junify, tunify = jsteps.make_unify_step(jcfg, None), tsteps.make_unify_step(tcfg, None)
    rng = np.random.default_rng(3)
    k_ev = jax.random.PRNGKey(4)
    for step in (4, 5, 6):
        tx = rng.random(N) < 0.7
        tx[step % N] = True
        k_s = jax.random.fold_in(k_ev, step)
        noise = np.array(jax.random.uniform(k_s, (N, N), minval=0.0, maxval=1e-6))
        jq_eff = jnp.asarray(q.numpy()) * jnp.asarray(tx)[:, None].astype(jnp.float32)
        jq_eff = jmixing.psi_cap_mask(k_s, jq_eff, PSI)
        q_eff = ttrain.mixing_weights(q, PSI, tx=torch.as_tensor(tx),
                                      psi_noise=torch.as_tensor(noise))
        jparams, jloss = jstep(jparams, jtrain.select_batch(jdata, step, B), jq_eff)
        tparams, tloss = ttrain.train_step(
            tparams, ttrain.select_batch(tdata, step, B), q_eff, tcfg, LR)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, atol=1e-4)
        if step == 5:
            jparams = junify(jparams, jnp.asarray(1, jnp.int32))
            tparams = tunify(tparams, 1)
    jleaves = jax.tree_util.tree_leaves(jparams)
    assert len(tflat.tree_leaves(tparams)) == len(jleaves)
    for t, j in zip(tflat.tree_leaves(tparams), jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_carried_mapped_and_restored_zamba2_trees_train(tmp_path):
    """zamba2's empty ``"2:shared"`` sub-block vanishes from a tree the
    port's helpers rebuild (a carried-across JAX tree, a `tree_map` of
    it, a checkpoint round trip). Each trains, to the same loss and
    parameters as the port's own init layout."""
    jcfg, tcfg = jbase.get_reduced("zamba2-2.7b"), tbase.get_reduced("zamba2-2.7b")
    jp0 = jmodel.init_params(jax.random.PRNGKey(6), jcfg)
    jstack = jax.tree_util.tree_map(lambda p: jnp.broadcast_to(p[None], (2,) + p.shape), jp0)
    carried = convert.params_from_numpy(jax.device_get(jstack), "cpu")
    assert "2:shared" not in carried["groups"]
    mapped = tflat.tree_map(lambda p: p.clone(), carried)
    tckpt.save(str(tmp_path), 1, carried)
    restored = tckpt.restore(str(tmp_path), tflat.tree_map(torch.zeros_like, carried))
    own = {**tflat.tree_map(lambda p: p.clone(), carried)}
    own["groups"] = {**own["groups"], "2:shared": {}}  # the init's layout
    data = _both(_batch(tcfg, lead=(2, 2), s=64, seed=6))[1]
    q_eff = torch.tensor([[0.5, 0.5], [0.5, 0.5]])
    runs = []
    for tree in (carried, mapped, restored, own):
        tree, loss = ttrain.train_step(tree, data, q_eff, tcfg, 0.05)
        runs.append((float(loss), tflat.ravel_clients(tree)))
    assert math.isfinite(runs[0][0])
    # equal up to the order of f32 sums: CPU BLAS may take another kernel
    # for another buffer's alignment
    for loss, plane in runs[1:]:
        assert loss == pytest.approx(runs[0][0], rel=1e-6)
        torch.testing.assert_close(plane, runs[0][1], rtol=1e-6, atol=1e-7)
    assert not torch.equal(runs[0][1], tflat.ravel_clients(
        convert.params_from_numpy(jax.device_get(jstack), "cpu")))


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b"])
def test_make_batches_layout(arch):
    cfg = tbase.get_reduced(arch)
    data = ttrain.make_batches(5, cfg, 3, 4, 6, device="cpu")
    again = ttrain.make_batches(5, cfg, 3, 4, 6, device="cpu")
    jdata = jtrain.make_batches(jax.random.PRNGKey(5), jbase.get_reduced(arch), 3, 4, 6)
    assert data.keys() == jdata.keys()
    for k, v in data.items():
        assert tuple(v.shape) == jdata[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jdata[k].dtype).replace("int32", "int64"), k
        assert torch.equal(v, again[k])
    ints = data["labels"] if cfg.embeds_in else data["tokens"]
    assert 0 <= int(ints.min()) and int(ints.max()) < cfg.vocab_size
    floats = data["embeds"] if cfg.embeds_in else data["cross_embeds"]
    assert abs(float(floats.std()) - 1.0) < 0.1
    if cfg.family == "vlm":
        assert data["cross_embeds"].shape == (3, 4, cfg.num_patch_tokens, cfg.d_model)
    one = ttrain.select_batch(data, 1, 2)
    assert all(v.shape[:2] == (3, 2) for v in one.values())


@pytest.mark.parametrize("arch", FAMILIES + ["stablelm-3b"])
def test_trainer_cli_runs(arch, capsys):
    """`python -m repro_torch.launch.train --arch <a> --reduced --device
    cpu --steps 3`: finite losses, the first near ln V."""
    losses = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                          "--log-every", "3"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert abs(losses[0] - math.log(tbase.get_reduced(arch).vocab_size)) < 1.0
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("seq", [48, 80])
def test_trainer_rejects_a_hybrid_seq_off_the_ssd_chunk(seq):
    with pytest.raises(ValueError, match="multiple of 32"):
        ttrain.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                     "--seq", str(seq), "--steps", "1"])


@pytest.mark.parametrize("arch", FAMILIES + ["stablelm-3b"])
def test_train_step_zeroes_only_the_config_unused_leaves(arch):
    """The audio model's token embedding gets a zero update; a leaf that
    a change cuts off the loss's graph (here an extra one) raises rather
    than train with a zero update."""
    tcfg = tbase.get_reduced(arch)
    assert tmodel.unused_leaves(tcfg) == ({("embed",)} if tcfg.embeds_in else set())
    params = ttrain.init_client_params(7, tcfg, 2, "cpu")
    data = _both(_batch(tcfg, lead=(2, 2), s=_seq(tcfg), seed=7))[1]
    q_eff = torch.tensor([[0.5, 0.5], [0.5, 0.5]])
    embed = params["embed"].clone()
    params, loss = ttrain.train_step(params, data, q_eff, tcfg, 0.05)
    assert math.isfinite(float(loss))
    assert torch.equal(params["embed"], embed) == bool(tcfg.embeds_in)
    params["extra"] = torch.ones(2, 3)
    with pytest.raises(RuntimeError, match="not have been used"):
        ttrain.train_step(params, data, q_eff, tcfg, 0.05)
