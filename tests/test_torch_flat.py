"""repro_torch flat plane and config mirrors against the JAX reference.

Ravel/unravel are reshape + concat only, so they must match exactly;
the FlatSpec offsets must follow jax.tree_util's sorted-key order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.core import flat as jflat
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.protocol import DracoConfig as JDracoConfig
from repro.data.synthetic import make_mlp
from repro_torch import convert
from repro_torch.core import flat as tflat
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.protocol import DracoConfig as TDracoConfig


def _stacked_mlp(n=4, hidden=(32,)):
    params0, *_ = make_mlp(jax.random.PRNGKey(0), 16, hidden, 5)
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal((n,) + v.shape).astype(np.float32)
            for k, v in params0.items()}


def test_spec_follows_jax_flatten_order():
    stacked = _stacked_mlp()
    jspec = jflat.spec_of({k: jnp.asarray(v) for k, v in stacked.items()})
    # insertion order w0, b0, w1, b1 must not leak into the layout
    tspec = tflat.spec_of({k: torch.as_tensor(v) for k, v in stacked.items()})
    assert [p[0] for p in tspec.paths] == ["b0", "b1", "w0", "w1"]
    assert tspec.offsets == jspec.offsets
    assert tspec.sizes == jspec.sizes
    assert tspec.shapes == jspec.shapes
    assert tspec.dim == jspec.dim
    assert tspec.num_clients == jspec.num_clients


def test_spec_for_matches_reference():
    params0, *_ = make_mlp(jax.random.PRNGKey(0), 16, (8, 8), 5)
    jspec = jflat.spec_for(params0, 6)
    tspec = tflat.spec_for(convert.params_from_numpy(params0, "cpu"), 6)
    assert (tspec.offsets, tspec.sizes, tspec.shapes, tspec.dim) == (
        jspec.offsets, jspec.sizes, jspec.shapes, jspec.dim)


def test_ravel_matches_reference_exactly():
    stacked = _stacked_mlp()
    jx = np.asarray(jflat.ravel_clients({k: jnp.asarray(v) for k, v in stacked.items()}))
    tx = tflat.ravel_clients({k: torch.as_tensor(v) for k, v in stacked.items()})
    np.testing.assert_array_equal(tx.numpy(), jx)


def test_unravel_round_trip_is_exact_and_matches_reference():
    stacked = {"layer": _stacked_mlp(), "scale": np.arange(4, dtype=np.float32)}
    jtree = jax.tree_util.tree_map(jnp.asarray, stacked)
    jspec = jflat.spec_of(jtree)
    jx = jflat.ravel_clients(jtree)
    ttree = convert.params_from_numpy(stacked, "cpu")
    tspec = tflat.spec_of(ttree)
    assert tspec.offsets == jspec.offsets and tspec.dim == jspec.dim
    tx = tflat.ravel_clients(ttree)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    back = tflat.unravel_clients(tx, tspec)
    jback = jflat.unravel_clients(jx, jspec)
    for (path, leaf), jleaf in zip(tflat.tree_items(back),
                                   jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf), err_msg=str(path))
    for (_, a), (_, b) in zip(tflat.tree_items(back), tflat.tree_items(ttree)):
        assert torch.equal(a, b)


def test_ravel_casts_and_unravel_restores_dtype():
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(3, 2),
            "b": torch.ones(3, 2, 2, dtype=torch.bfloat16)}
    spec = tflat.spec_of(tree)
    x = tflat.ravel_clients(tree)
    assert x.dtype == torch.float32 and x.shape == (3, spec.dim)
    back = tflat.unravel_clients(x, spec)
    assert back["a"].dtype == torch.int32 and torch.equal(back["a"], tree["a"])
    assert back["b"].dtype == torch.bfloat16 and torch.equal(back["b"], tree["b"])


@pytest.mark.parametrize("ref,port", [(JDracoConfig, TDracoConfig),
                                      (JChannelConfig, TChannelConfig)],
                         ids=["DracoConfig", "ChannelConfig"])
def test_config_fields_and_defaults_match(ref, port):
    rf = [(f.name, f.default) for f in dataclasses.fields(ref)]
    pf = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert pf == rf


def test_channel_config_derived_powers_match():
    assert TChannelConfig().tx_power_w == JChannelConfig().tx_power_w
    assert TChannelConfig().noise_w == JChannelConfig().noise_w


@pytest.mark.parametrize("bad", [
    {"num_clients": 0}, {"window": 0.0}, {"max_delay_windows": 1},
    {"psi": -1}, {"unify_period": -2}])
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        JDracoConfig(**bad)
    with pytest.raises(ValueError):
        TDracoConfig(**bad)


def test_config_replace():
    cfg = TDracoConfig().replace(psi=4, channel=TChannelConfig(gamma_max=3.0))
    assert cfg.psi == 4 and cfg.channel.gamma_max == 3.0
