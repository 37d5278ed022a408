"""The port's sharding rules (`repro_torch.sharding`), its abstract inputs
and spec trees (`repro_torch.launch.steps`), and the mesh's refusals,
against the JAX package; no process group.

`param_spec`, `filter_divisible` and `tree_param_specs` equal the
reference's, compared as tuples, on `tests/test_sharding.py`'s cases and
on every architecture's full-width parameters (meta tensors here,
``jax.eval_shape`` there) under a fake mesh; the meta-device input specs
have the reference's shapes (the port's dtypes are its own: int64
tokens); `make_shardings` and `serve_shardings` give the reference's
specs on a one-device mesh.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_reduced as jget_reduced
from repro.launch import steps as jsteps
from repro.sharding import axes as jaxes
from repro.sharding import specs as jspecs
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.core.protocol import DracoConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.sharding import axes, constrain, param_spec, tree_param_specs
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.sharding.specs import filter_divisible


class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"data": 4, "model": 8, "pod": 2}


class OneMesh:
    """The port's stand-in for a (1, 1) mesh: what the spec functions read."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


PARAM_CASES = [
    ("groups/0:attn/attn/wq", (3, 128, 256), ()),
    ("groups/0:attn/attn/wo", (3, 256, 128), ()),
    ("embed", (1024, 64), ()),
    ("groups/0:moe/moe/experts_gate", (2, 8, 16, 32), ()),
    ("final_norm", (64,), ()),
    ("groups/0:mlp/mlp/w_up", (16, 3, 64, 128), ("data",)),
    ("groups/0:ssm/ssm/conv_b", (2, 64), ()),
    ("x", (), ("data",)),
]


@pytest.mark.parametrize("path,shape,prefix", PARAM_CASES)
def test_param_spec_matches_reference(path, shape, prefix):
    for mesh in (None, FakeMesh()):
        want = jspecs.param_spec(path, shape, mesh, prefix)
        got = param_spec(path, shape, mesh, prefix)
        assert isinstance(got, P) and tuple(got) == tuple(want)
        assert tuple(param_spec(tuple(path.split("/")), shape, mesh, prefix)) == tuple(want)


@pytest.mark.parametrize("spec,shape", [
    (("model", None), (64, 3)), (("model", None), (63, 3)),
    ((("pod", "data"), "model"), (8, 16)), ((("pod", "data"), None), (7, 16)),
    (("data",), (8, 5, 2))])
def test_filter_divisible_matches_reference(spec, shape):
    want = jspecs.filter_divisible(JP(*spec), shape, FakeMesh())
    assert tuple(filter_divisible(P(*spec), shape, FakeMesh())) == tuple(want)


def _reference_specs(tree):
    return {"/".join(p.key for p in path): tuple(s) for path, s in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, JP))}


def _port_specs(tree):
    return {"/".join(path): tuple(s) for path, s in flat_lib.tree_items(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_param_specs_match_reference(arch):
    """Every architecture at its published width: the meta params' paths,
    shapes and client-stacked specs against the reference's."""
    jparams = jsteps.stack_clients_abstract(jsteps.param_specs_abstract(jget_config(arch)), 8)
    tparams = steps.stack_clients_abstract(steps.param_specs_abstract(get_config(arch)), 8)
    jshapes = {"/".join(p.key for p in path): tuple(l.shape)
               for path, l in jax.tree_util.tree_leaves_with_path(jparams)}
    assert {"/".join(p): tuple(l.shape) for p, l in flat_lib.tree_items(tparams)} == jshapes
    assert all(l.device.type == "meta" for l in flat_lib.tree_leaves(tparams))
    for prefix in (("data",), (("pod", "data"),)):
        want = _reference_specs(jspecs.tree_param_specs(jparams, prefix=prefix,
                                                        mesh=FakeMesh()))
        got = _port_specs(tree_param_specs(tparams, prefix=prefix, mesh=FakeMesh()))
        assert got == want


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _shapes(getattr(tree, f)) for f in tree._fields}
    return None if tree is None else tuple(tree.shape)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b", "llama-3.2-vision-11b",
                                  "musicgen-large"])
def test_meta_input_specs_match_reference_shapes(arch):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES["train_4k"], JSHAPES["train_4k"]
    assert _shapes(steps.train_batch_specs(tcfg, shape, 16)) == _shapes(
        jsteps.train_batch_specs(jcfg, jshape, 16))
    shape, jshape = SHAPES["prefill_32k"], JSHAPES["prefill_32k"]
    assert _shapes(steps.prefill_batch_specs(tcfg, shape)) == _shapes(
        jsteps.prefill_batch_specs(jcfg, jshape))
    for name in ("decode_32k", "long_500k"):
        tok, state, cross = steps.serve_input_specs(tcfg, SHAPES[name])
        jtok, jstate, jcross = jsteps.serve_input_specs(jcfg, JSHAPES[name])
        assert tuple(tok.shape) == tuple(jtok.shape)
        assert _shapes(state) == _shapes(jstate)
        assert _shapes(cross) == _shapes(jcross)
    batch = steps.train_batch_specs(tcfg, SHAPES["train_4k"], 16)
    assert all(t.device.type == "meta" for t in batch.values())
    assert batch.get("tokens", batch.get("labels")).dtype == torch.int64
    assert steps.depth_config(tcfg, 2).num_layers == jsteps.depth_config(jcfg, 2).num_layers


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b", "llama-3.2-vision-11b"])
def test_spec_trees_match_reference(arch):
    tcfg, jcfg = get_reduced(arch), jget_reduced(arch)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    shape, jshape = SHAPES["decode_32k"], JSHAPES["decode_32k"]
    pspecs, bspecs, qspec = steps.make_shardings(OneMesh(), tcfg, SHAPES["train_4k"])
    jp, jb, jq = jsteps.make_shardings(jmesh, jcfg, JSHAPES["train_4k"])
    assert _port_specs(pspecs) == _reference_specs(jax.tree_util.tree_map(lambda s: s.spec, jp))
    assert {k: tuple(v) for k, v in bspecs.items()} == {k: tuple(v.spec) for k, v in jb.items()}
    assert tuple(qspec) == tuple(jq.spec)
    for cache_shard in ("kv_heads", "head_dim", "seq"):
        got = steps.serve_shardings(OneMesh(), tcfg, shape, cache_shard)
        want = jsteps.serve_shardings(jmesh, jcfg, jshape, cache_shard)
        assert _port_specs(got[0]) == _reference_specs(
            jax.tree_util.tree_map(lambda s: s.spec, want[0]))
        assert tuple(got[1]) == tuple(want[1].spec)
        assert _flat_specs(got[2]) == _flat_specs(
            jax.tree_util.tree_map(lambda s: s.spec, want[2]))
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:
            assert _port_specs(got[3]) == _reference_specs(
                jax.tree_util.tree_map(lambda s: s.spec, want[3]))


def _flat_specs(tree):
    if isinstance(tree, dict):
        return {k: _flat_specs(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _flat_specs(getattr(tree, f)) for f in tree._fields}
    return tuple(tree)


def test_constrain_returns_its_input():
    x = torch.zeros(4, 8)
    assert constrain(x, "batch", "ff") is x
    with axes.use_rules(axes.train_rules(OneMesh())) as rules:
        assert axes.current_rules() is rules
        assert constrain(x, "batch", "ff") is x
        with pytest.raises(ValueError):
            constrain(x, "batch")
    assert axes.current_rules() is None
    want = jaxes.AxisRules(mesh=None, rules=jaxes.default_rules(
        jax.make_mesh((1, 1), ("data", "model"))).rules)
    assert axes.default_rules(OneMesh()).rules == want.rules
    assert tuple(axes.default_rules(FakeMesh()).to_mesh_axes(("batch", None, "heads"))) == (
        ("pod", "data"), None, "model")


class SizedMesh(OneMesh):
    def __init__(self, size):
        self.size = size
        self.shape = {"data": size, "model": 1}


def test_model_axis_and_unported_paths_raise_naming_their_item():
    mesh = mesh_lib.Mesh.dry((2, 2), ("data", "model"))  # a "model" axis lays out now
    assert (mesh.size, mesh.model_size, mesh.rank, mesh.model_rank) == (2, 2, 0, 0)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_lib.make_production_mesh(multi_pod=True)  # (2, 16, 16) needs its 512 ranks
    pod = mesh_lib.Mesh.dry((2, 16, 16), ("pod", "data", "model"))
    assert (pod.size, pod.model_size) == (32, 16)
    steps.make_train_step(get_reduced("mamba2-2.7b"), pod)  # ssm splits over "model"
    steps.make_train_step(get_reduced("llama-3.2-vision-11b"), pod)  # and so does the vlm
    # sequence parallelism (item 20(e)) is ported: 'seq' on "model", as the reference's
    assert axes.train_rules(OneMesh(), seq_parallel=True).rules["seq"] == "model"
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for sp in (False, True):
        assert axes.train_rules(OneMesh(), seq_parallel=sp).rules == \
            jaxes.train_rules(jmesh, seq_parallel=sp).rules
    assert tp_lib.context(pod, seq_parallel=True).seq and tp_lib.context(pod).seq is False
    steps.make_train_step(get_reduced("mamba2-2.7b"), pod, seq_parallel=True)
    cfg = get_reduced("qwen2-1.5b")
    # the decode cache's other layouts (item 20(f)) are ported: a batch of 1
    # stays whole on both client ranks, its ring's slots over "data"
    serve = steps.make_serve_step(cfg, SHAPES["long_500k"], SizedMesh(2))
    assert serve.layout.describe() == {"slots": "data", "head_dim": None,
                                       "kv_heads": "the rank's"}
    assert steps.serving_rows(SHAPES["long_500k"], SizedMesh(2)) == 1
    # the prefill keeps the reference's own refusal: jax will not lower a
    # batch of 3 laid over 2 devices
    with pytest.raises(ValueError, match="jax refuses when it lowers the reference's prefill"):
        steps.make_prefill_step(cfg, SHAPES["decode_32k"].__class__("b3", 8, 3, "prefill"),
                                SizedMesh(2))
    assert steps.make_serve_step(cfg, SHAPES["decode_32k"], SizedMesh(2)).layout is None
    from repro_torch.api import simulate_sweep

    # every registered algorithm runs on a client mesh (ROADMAP item 21, done):
    # N must divide by its client ranks
    dry = mesh_lib.Mesh.dry((2, 1), ("data", "model"), device="cpu")
    for algo in ("sync-symm", "fedasync-window", "draco-event"):
        with pytest.raises(ValueError, match="divisible"):
            simulate_sweep(algo, DracoConfig(num_clients=3), task="mlp", num_steps=1,
                           key=0, device="cpu", mesh=dry)
    with pytest.raises(RuntimeError, match="init_world"):
        mesh_lib.make_sweep_mesh(2, backend="gloo", device="cpu")
    assert mesh_lib.client_axes(FakeMesh()) == ("pod", "data")
    assert mesh_lib.num_clients(FakeMesh()) == 8
    assert mesh_lib.num_clients(OneMesh()) == 1


@pytest.mark.parametrize("shape, axes", [((16, 16), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data", "model"))],
                         ids=["16x16", "2x16x16"])
def test_long_context_reckons_on_the_production_mesh(shape, axes):
    """A reduced config at long_500k on the reference's production mesh: the
    batch of 1 whole on every client rank, the ring's 8,192 slots over the
    16 "data" ranks (one pod's, with "pod"), the merge of each attention
    layer's partial softmaxes two client-axis all-reduces (the row max,
    the sums), and an SSM state whole over "data"."""
    from repro_torch.launch import dryrun

    for arch in ("qwen2-1.5b", "zamba2-2.7b"):
        cfg = get_reduced(arch)
        mesh = mesh_lib.Mesh.dry(shape, axes)
        step, (params, tok, state) = dryrun.build(cfg, SHAPES["long_500k"], mesh)
        assert step.layout.slot_block() == (0, 16) and tuple(tok.shape) == (1,)
        mesh.reset_tally()
        dryrun.count_work(step, params, tok, state)
        attn = [n for n in state.caches if not n.endswith(":ssm")]
        for name, cache in state.caches.items():
            assert cache[0].shape[1] == 1, name  # the whole batch
            if name in attn:
                assert cache.k.shape[2] == 8192 // 16, name
        layers = sum(len(state.caches[n].k) for n in attn)  # layer groups with a cache
        assert mesh.collective_counts["client_all_reduce"] == 2 * layers, arch
        assert mesh.collective_bytes["client_all_reduce"] > 0


def test_pack_round_trip_is_exact():
    parts = [torch.randn(3, 5), torch.randn(7).to(torch.bfloat16),
             torch.arange(5, dtype=torch.int32), torch.randn(2, 2, dtype=torch.float64)]
    back = mesh_lib.unpack(mesh_lib.pack(parts), parts)
    for a, b in zip(parts, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert np.all([b.data_ptr() % b.element_size() == 0 for b in back])
