"""The one-card sharded bank layout (``repro_torch.sharding``) against the
reference's ``repro.sharding`` on its one-device mesh (``make_host_mesh()``,
``data`` 1, ``model`` 1): the per-leaf specs, the flat spec's fields, the
bank (``flatten_to_bank``) and its inverse (``bank_to_param_tree``), bit for
bit, over leaves of every rule of the table (embed, lm_head, the attention
and MLP projections, MoE expert banks and router, MLA's latent
projections, the SSM's ``in_proj``/``out_proj``/``conv_w``, norms, the
paper CNN's layers), and the layout ``launch.steps.make_train_plan``
chooses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchSpec as JArchSpec
from repro.configs.base import InputShape as JInputShape
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import cnn_init as jax_cnn_init
from repro.models import transformer as JT
from repro.sharding import flatten as JF
from repro.sharding import partitioning as JP
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, InputShape
from repro_torch.core import AggregatorConfig, AttackConfig, SparsifierConfig
from repro_torch.launch import steps as S
from repro_torch.sharding import flatten as SF
from repro_torch.sharding import partitioning as SP
from repro_torch.utils import tree as T

ARCHS = ("stablelm_3b", "dbrx_132b", "deepseek_v2_lite_16b", "mamba2_1_3b",
         "zamba2_7b", "llama32_vision_11b")
CASES = ARCHS + ("mnist_cnn", "example")


def _jax_abstract(case):
    """The reference's abstract tree of ``case``: a reduced arch (2 layers,
    d_model 64, vocab 128), the paper CNN, or the two-leaf example (a
    ``[4, 6]`` ``wq/w`` behind a ``scale`` of 5)."""
    if case == "mnist_cnn":
        return jax.eval_shape(lambda: jax_cnn_init(jax.random.PRNGKey(0)))
    if case == "example":
        return {"scale": jax.ShapeDtypeStruct((5,), jnp.float32),
                "wq": {"w": jax.ShapeDtypeStruct((4, 6), jnp.float32)}}
    cfg = jax_get_arch(case).model.reduced(
        n_layers=2, d_model=64).with_overrides(vocab_size=128)
    return jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0), cfg))


def _trees(case, n=None, seed=0):
    """The same numpy values as a reference tree and a port tree (a
    leading worker axis ``n`` on every leaf, or none)."""
    ab = _jax_abstract(case)
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    vals = jax.tree.map(lambda x: rng.standard_normal(
        lead + tuple(x.shape)).astype(np.float32), ab)
    return (jax.tree.map(jnp.asarray, vals),
            T.tree_map(torch.from_numpy, vals))


def _paths(tree):
    return [JP._path_str(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture
def one_thread():
    """One intra-op thread, as the suite's other train steps run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_dim(jspec):
    """The index of the dim a reference spec puts on ``model``, else -1."""
    for i, ax in enumerate(jspec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i
    return -1


@pytest.mark.parametrize("case", CASES)
def test_specs_are_the_references(case):
    mesh = make_host_mesh()
    ab = _jax_abstract(case)
    jspecs = jax.tree_util.tree_leaves(
        JP.param_specs(ab, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    _, tree = _trees(case)
    assert [p for p, _ in SP.leaves_with_paths(tree)] == _paths(ab)
    assert SP.param_specs(tree) == tuple(_model_dim(s) for s in jspecs)
    assert SP.n_workers() == JP.n_workers(mesh) == 1


def test_every_rule_is_exercised():
    """The cases hold a leaf of every rule of the table: the model-sharded
    ones with a model dim, the replicated ones without."""
    seen = {}
    for case in CASES:
        _, tree = _trees(case)
        for (path, _), mdim in zip(SP.leaves_with_paths(tree),
                                   SP.param_specs(tree)):
            parts = path.split("/")
            key = parts[-2] if parts[-1] in ("w", "b") else parts[-1]
            seen.setdefault(key, set()).add(mdim >= 0)
    sharded = ("embed", "lm_head", "wq", "wk", "wv", "wo", "wi", "wg",
               "wukv", "in_proj", "out_proj", "conv_w")
    replicated = ("wdkv", "router", "scale", "A_log", "D", "conv_b",
                  "dt_bias", "fc1", "fc2", "conv1", "conv2", "gate")
    for key in sharded:
        assert True in seen[key], key
    for key in replicated:
        assert seen[key] == {False}, key


@pytest.mark.parametrize("case", CASES)
def test_flat_spec_is_the_references(case):
    jspec = JF.make_sharded_flat_spec(_jax_abstract(case), make_host_mesh())
    _, tree = _trees(case)
    spec = SF.make_sharded_flat_spec(tree)
    assert spec.shapes == jspec.shapes
    assert [str(d).replace("torch.", "") for d in spec.dtypes] == [
        str(d) for d in jspec.dtypes]
    assert spec.model_dims == jspec.model_dims
    assert spec.chunk_sizes == jspec.chunk_sizes
    assert spec.offsets == jspec.offsets
    assert (spec.padded_size, spec.unit) == (jspec.padded_size, jspec.unit)
    assert spec.size == sum(int(np.prod(s)) for s in jspec.shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_bank_and_its_inverse_are_the_references(case, dtype):
    """One worker (the reference's sharded bank holds one row a data
    group): the bank bitwise, the direction's tree bitwise, the round
    trip the identity."""
    mesh = make_host_mesh()
    jtree, tree = _trees(case, n=1, seed=1)
    jspec = JF.make_sharded_flat_spec(jax.tree.map(lambda x: x[0], jtree),
                                      mesh)
    spec = SF.make_sharded_flat_spec(T.tree_map(lambda x: x[0], tree))
    with mesh:
        jbank = np.asarray(jax.jit(lambda t: JF.flatten_to_bank(
            t, jspec, mesh, dtype=getattr(jnp, dtype)))(jtree)
            .astype(jnp.float32))
    bank = SF.flatten_to_bank(tree, spec, dtype=getattr(torch, dtype))
    assert bank.shape == jbank.shape == (1, spec.padded_size)
    np.testing.assert_array_equal(bank.float().numpy(), jbank)

    vec = np.random.default_rng(2).standard_normal(
        spec.padded_size).astype(np.float32)
    with mesh:
        jdir = jax.jit(lambda v: JF.bank_to_param_tree(v, jspec, mesh))(
            jnp.asarray(vec))
    got = SF.bank_to_param_tree(torch.from_numpy(vec), spec)
    for a, b in zip(T.tree_leaves(got), jax.tree_util.tree_leaves(jdir)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    back = SF.bank_to_param_tree(SF.flatten_to_bank(tree, spec)[0], spec)
    for a, b in zip(T.tree_leaves(back), T.tree_leaves(tree)):
        assert torch.equal(a, b[0])


def test_the_example_leaf_lands_column_major_behind_the_padded_scale():
    tree = {"scale": torch.arange(5.0) + 100, "wq": {"w": torch.arange(
        24.0).reshape(4, 6)}}
    spec = SF.make_sharded_flat_spec(tree)
    assert spec.model_dims == (-1, 1) and spec.offsets == (0, 8)
    row = SF.flatten_to_bank(T.tree_map(lambda x: x[None], tree), spec)[0]
    assert row[:8].tolist() == [100, 101, 102, 103, 104, 0, 0, 0]
    assert row[8:14].tolist() == [0, 6, 12, 18, 1, 7]
    assert row.shape == (32,)


def test_ravel_into_a_wide_row_zeroes_past_the_layout():
    _, tree = _trees("stablelm_3b")
    spec = SF.make_sharded_flat_spec(tree)
    row = torch.full((spec.padded_size + 512,), 7.0)
    SF.ravel_into(tree, row, spec)
    assert torch.equal(row, torch.cat([SF.flatten_to_bank(
        T.tree_map(lambda x: x[None], tree), spec)[0], torch.zeros(512)]))


def _plans(n):
    jmodel = jax_get_arch("stablelm_3b").model.reduced(
        n_layers=2, d_model=64).with_overrides(vocab_size=128)
    model = get_arch("stablelm_3b").model.reduced(
        n_layers=2, d_model=64).with_overrides(vocab_size=128)
    shape = ("host_train", 32, 8, "train")
    jplan = JS.make_train_plan(JArchSpec(jmodel, "t"), JInputShape(*shape),
                               make_host_mesh(), n_workers=n)
    plan = S.make_train_plan(ArchSpec(model, "t"), InputShape(*shape),
                             n_workers=n)
    return jplan, plan


@pytest.mark.parametrize("n", [1, 2, 8])
def test_make_train_plan_takes_the_references_layout(n):
    jplan, plan = _plans(n)
    assert plan.flatten == jplan.flatten == ("sharded" if n == 1
                                             else "naive")
    js, s = jplan.flat_spec, plan.flat_spec
    assert s.padded_size == js.padded_size and s.offsets == js.offsets
    assert s.shapes == js.shapes
    if n == 1:
        assert isinstance(s, SF.ShardedFlatSpec)
        assert s.model_dims == js.model_dims
    else:
        assert isinstance(s, T.FlatSpec) and s.size == js.size


def test_steps_in_the_sharded_layout_match_the_references(one_thread):
    """Two steps of reduced stablelm_3b (one layer, d_model 64) at one
    worker, where both packages take the sharded layout: RoSDHB on a global
    Block-RandK mask at 0.25 (512-wide blocks), the mean, no attack,
    float32 banks; the reference's train step on its one-device mesh, the
    port's on the same parameters, batches and block ids. The layout
    decides which parameters share a block: the coordinates no drawn
    block covers are the same in both and stay bitwise as they were; the
    loss within rtol 2e-3, |R| within 2e-2 and each leaf within 5e-2 of
    the reference's update (the bounds of ``test_torch_train.py``: bf16
    gradients rounded at other places)."""
    from repro.core import AggregatorConfig as JAgg
    from repro.core import AttackConfig as JAtk
    from repro.core import SparsifierConfig as JSp
    from repro.core import algorithms as JAlg
    from repro_torch.core import algorithms as Alg
    from repro_torch.launch import train as TR
    from repro_torch.testing import ReplayDraws, from_jax_params

    n, seq, steps, ratio = 1, 16, 2, 0.25

    def ov(sp, agg, atk):
        return {"f": 0, "gamma": 0.5, "momentum_dtype": "float32",
                "sparsifier": sp(kind="block", ratio=ratio, block_size=512),
                "aggregator": agg(name="mean", f=0),
                "attack": atk(name="none")}

    jmodel = jax_get_arch("stablelm_3b").model.reduced(
        n_layers=1, d_model=64).with_overrides(vocab_size=128,
                                               use_flash_attention=False)
    shape = ("host_train", seq, n, "train")
    mesh = make_host_mesh()
    jplan = JS.make_train_plan(JArchSpec(jmodel, "t"), JInputShape(*shape),
                               mesh, ov(JSp, JAgg, JAtk), n_workers=n)
    assert jplan.flatten == "sharded"
    jstep = jax.jit(JS.build_train_step(jplan, mesh))
    d = jplan.flat_spec.padded_size
    params = JT.model_init(jax.random.PRNGKey(0), jplan.model)
    p0 = jax.tree.map(np.asarray, params)
    key = jax.random.PRNGKey(1)
    jstate = JS.TrainState(params, JAlg.init_state(jplan.algo, d),
                           jnp.zeros((), jnp.int32), key)
    rng = np.random.default_rng(0)
    batches = [TR.make_batch(rng, jmodel.vocab_size, n, 1, seq)
               for _ in range(steps)]
    nb = -(-d // 512)
    kb = max(1, int(round(ratio * nb)))
    ids, ref = [], {"loss": [], "dir_norm": []}
    for b in batches:
        key, round_key = jax.random.split(key)
        mask_key, _ = jax.random.split(round_key)
        ids.append(np.asarray(jax.random.permutation(mask_key, nb)[:kb]))
        with mesh:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        ref["loss"].append(float(m["loss"]))
        ref["dir_norm"].append(float(m["dir_norm"]))
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate.params)]

    model = get_arch("stablelm_3b").model.reduced(
        n_layers=1, d_model=64).with_overrides(vocab_size=128)
    plan = S.make_train_plan(ArchSpec(model, "t"), InputShape(*shape),
                             ov(SparsifierConfig, AggregatorConfig,
                                AttackConfig), n_workers=n)
    assert plan.flatten == "sharded" and plan.flat_spec.padded_size == d
    step = S.build_train_step(plan, device="cpu")
    state = S.TrainState(from_jax_params(p0),
                         Alg.init_state(plan.algo, plan.bank_width,
                                        device="cpu"), 0,
                         ReplayDraws("cpu", permutations=ids))
    port = {"loss": [], "dir_norm": []}
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        port["loss"].append(float(m["loss"]))
        port["dir_norm"].append(float(m["dir_norm"]))
    assert state.draws.remaining == 0
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)
    got = [t.numpy() for t in T.tree_leaves(state.params)]
    moved = 0
    for g, w, a in zip(got, want, jax.tree_util.tree_leaves(p0)):
        np.testing.assert_array_equal(g == a, w == a)
        update = np.abs(w - a).max()
        assert np.abs(g - w).max() <= 5e-2 * update + 1e-7
        moved += int((w != a).sum())
    assert 0 < moved < sum(a.size for a in got)
