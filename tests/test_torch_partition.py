"""Port parity of ``apex_tpu_torch.partition`` (and the spec functions that
hang off it) against the JAX package on the CPU.

Every default table's spec tree equals the JAX package's, compared leaf
by leaf by path as tuples: GPT (learned positions and RoPE), the draft
GPT, BERT, the weight-only int8 GPT tree, the dense and paged KV caches
(bf16 and int8), the optimizer families and ``FusedAdam``'s state; so do
the hand-written spec functions (``gpt_partition_specs``,
``bert_partition_specs``, ``quant_partition_specs``), the tables
themselves and ``rule_match_table``. The JAX trees are
``jax.eval_shape`` trees of the JAX initializers; the port's are its own
initializers' trees on the CPU.

Placement runs in gloo ranks (``tests/_torch_ranks.py``), once at W = 2
(tp 2) and once at W = 4 (dp 2 x tp 2): ``make_mesh`` installs the mesh,
each rank's block from ``make_shard_and_gather_fns``' shard functions is
the JAX array's shard on the device at that rank's place, bit for bit,
and the gather functions give the whole value back bit for bit. This
module imports no JAX at its top."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch import partition as pt
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.quant import quantize_params
from apex_tpu_torch.quant.params import quant_partition_specs
from apex_tpu_torch.serving import (
    cache_partition_specs, paged_cache_partition_specs,
)
from apex_tpu_torch.transformer import parallel_state as ps

P = ps.PartitionSpec


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    from jax.sharding import PartitionSpec as JP

    from apex_tpu import partition as jpt
    from apex_tpu.transformer import parallel_state as jps
    return jax, JP, jpt, jps


def _by_path(tree, is_spec):
    """{path: leaf} with specs as plain tuples; dicts, NamedTuples (by
    field) and lists (by index); None is an empty subtree."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if is_spec(node):
            out[path] = tuple(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            names = getattr(node, "_fields", range(len(node)))
            for k, v in zip(names, node):
                walk(v, path + (str(k),))
        else:
            raise TypeError(f"{path}: {type(node).__name__}")

    walk(tree, ())
    return out


def _port_specs(tree):
    return _by_path(tree, lambda x: isinstance(x, P))


def _jax_specs(tree):
    _, JP, _, _ = _jax()
    return _by_path(tree, lambda x: isinstance(x, JP))


def _assert_same_specs(port_tree, jax_tree):
    got, want = _port_specs(port_tree), _jax_specs(jax_tree)
    assert got == want
    assert len(got) > 0


# ---------------------------------------------------------------------------
# the trees on both sides
# ---------------------------------------------------------------------------

GPT_CFGS = {"gpt_tiny": {}, "gpt_tiny_rope": {"use_rope": True},
            "draft_gpt_tiny": None}


def _gpt_cfgs(name):
    from apex_tpu.models import gpt as jax_gpt

    if name == "draft_gpt_tiny":
        return jax_gpt.draft_gpt_tiny(), port_gpt.draft_gpt_tiny()
    kw = GPT_CFGS[name]
    return (dataclasses.replace(jax_gpt.gpt_tiny(), **kw),
            dataclasses.replace(port_gpt.gpt_tiny(), **kw))


@functools.lru_cache(maxsize=None)
def _jax_gpt_tree(name, quantized=False):
    jax, _, _, _ = _jax()
    from apex_tpu.models import gpt as jax_gpt
    from apex_tpu.quant import quantize_params as jquant

    jcfg, _ = _gpt_cfgs(name)
    init = (lambda k: jquant(jax_gpt.init_gpt(k, jcfg))) if quantized \
        else (lambda k: jax_gpt.init_gpt(k, jcfg))
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _port_gpt_tree(name, quantized=False):
    _, pcfg = _gpt_cfgs(name)
    params = port_gpt.init_gpt(pcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return quantize_params(params) if quantized else params


def _jax_bert_tree():
    jax, _, _, _ = _jax()
    from apex_tpu.models import bert as jax_bert

    return jax.eval_shape(lambda k: jax_bert.init_bert(
        k, jax_bert.bert_tiny()), jax.random.PRNGKey(0))


def _port_bert_tree():
    return port_bert.init_bert(port_bert.bert_tiny(),
                               torch.Generator().manual_seed(0),
                               device="cpu")


# ---------------------------------------------------------------------------
# the tables and the spec trees
# ---------------------------------------------------------------------------

TABLES = ["gpt_rules", "gpt_quant_rules", "draft_gpt_rules", "bert_rules",
          "kv_cache_rules", "kv_cache_quant_rules"]


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_jax(table):
    _, _, jpt, _ = _jax()
    got = [(pat, tuple(spec)) for pat, spec in getattr(pt, table)()]
    want = [(pat, tuple(spec)) for pat, spec in getattr(jpt, table)()]
    assert got == want


@pytest.mark.parametrize("name", ["gpt_tiny", "gpt_tiny_rope"])
def test_gpt_table_and_hand_specs_equal_jax(name):
    """``gpt_rules`` matched on the GPT tree, and ``gpt_partition_specs``,
    on both sides; the two agree with each other."""
    _, _, jpt, _ = _jax()
    from apex_tpu.models import gpt as jax_gpt

    jcfg, pcfg = _gpt_cfgs(name)
    jtree, ptree = _jax_gpt_tree(name), _port_gpt_tree(name)
    assert pt.tree_paths(ptree) == jpt.tree_paths(jtree)
    got = pt.match_partition_rules(pt.gpt_rules(), ptree)
    _assert_same_specs(got, jpt.match_partition_rules(jpt.gpt_rules(), jtree))
    _assert_same_specs(port_gpt.gpt_partition_specs(pcfg),
                       jax_gpt.gpt_partition_specs(jcfg))
    assert _port_specs(got) == _port_specs(port_gpt.gpt_partition_specs(pcfg))


def test_draft_gpt_table_equals_jax():
    _, _, jpt, _ = _jax()
    jtree, ptree = _jax_gpt_tree("draft_gpt_tiny"), \
        _port_gpt_tree("draft_gpt_tiny")
    _assert_same_specs(pt.match_partition_rules(pt.draft_gpt_rules(), ptree),
                       jpt.match_partition_rules(jpt.draft_gpt_rules(),
                                                 jtree))


def test_bert_table_and_hand_specs_equal_jax():
    """BERT's encoder is a list: paths carry ``encoder/<i>/``."""
    _, _, jpt, _ = _jax()
    from apex_tpu.models import bert as jax_bert

    jtree, ptree = _jax_bert_tree(), _port_bert_tree()
    assert pt.tree_paths(ptree) == jpt.tree_paths(jtree)
    got = pt.match_partition_rules(pt.bert_rules(), ptree)
    _assert_same_specs(got, jpt.match_partition_rules(jpt.bert_rules(),
                                                      jtree))
    _assert_same_specs(port_bert.bert_partition_specs(ptree),
                       jax_bert.bert_partition_specs(jtree))
    assert _port_specs(got) == _port_specs(
        port_bert.bert_partition_specs(ptree))


def test_quant_table_and_specs_equal_jax():
    """The weight-only int8 tree: ``gpt_quant_rules`` and
    ``quant_partition_specs``."""
    _, _, jpt, _ = _jax()
    from apex_tpu.quant.params import quant_partition_specs as jqspecs

    jcfg, pcfg = _gpt_cfgs("gpt_tiny")
    jtree = _jax_gpt_tree("gpt_tiny", quantized=True)
    ptree = _port_gpt_tree("gpt_tiny", quantized=True)
    assert pt.tree_paths(ptree) == jpt.tree_paths(jtree)
    _assert_same_specs(
        pt.match_partition_rules(pt.gpt_quant_rules(), ptree),
        jpt.match_partition_rules(jpt.gpt_quant_rules(), jtree))
    _assert_same_specs(quant_partition_specs(pcfg), jqspecs(jcfg))


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_int8",
                                  "dense_custom"])
def test_kv_cache_specs_equal_jax(kind):
    from apex_tpu.serving import cache as jcache

    _, JP, _, jps = _jax()
    if kind == "dense":
        got, want = cache_partition_specs(), jcache.cache_partition_specs()
    elif kind == "dense_custom":
        flip = lambda Pk: ((r"(^|/)(k|v)$",  # noqa: E731
                            Pk(None, None, None, ps.TENSOR_AXIS, None)),
                           (r"(^|/)lengths$", Pk()))
        got = cache_partition_specs(flip(P))
        want = jcache.cache_partition_specs(flip(JP))
    else:
        q = kind == "paged_int8"
        got = paged_cache_partition_specs(quantized=q)
        want = jcache.paged_cache_partition_specs(quantized=q)
    assert type(got).__name__ == type(want).__name__
    _assert_same_specs(got, want)


def test_optimizer_and_adam_state_specs_equal_jax():
    _, JP, jpt, _ = _jax()
    from apex_tpu.optimizers import FusedAdam as JFusedAdam

    jtree, ptree = _jax_gpt_tree("gpt_tiny"), _port_gpt_tree("gpt_tiny")
    got = pt.optimizer_state_specs(pt.gpt_rules(), ptree)
    want = jpt.optimizer_state_specs(jpt.gpt_rules(), jtree)
    assert set(got) == set(want) == {"m", "v", "master"}
    for fam in want:
        _assert_same_specs(got[fam], want[fam])
    pspecs = pt.match_partition_rules(pt.gpt_rules(), ptree)
    jspecs = jpt.match_partition_rules(jpt.gpt_rules(), jtree)
    _assert_same_specs(FusedAdam().state_partition_specs(pspecs),
                       JFusedAdam().state_partition_specs(jspecs))
    with pytest.raises(ValueError, match="flat"):
        FusedAdam(use_flat_kernel=True).state_partition_specs(pspecs)


@pytest.mark.parametrize("tree", ["gpt", "bert"])
def test_rule_match_table_equals_jax(tree):
    """Every leaf's path and the indices of every rule that matches it,
    with an overlapping rule added so a leaf matches two."""
    _, JP, jpt, _ = _jax()
    if tree == "gpt":
        ptree, jtree = _port_gpt_tree("gpt_tiny"), _jax_gpt_tree("gpt_tiny")
        prules, jrules = pt.gpt_rules(), jpt.gpt_rules()
    else:
        ptree, jtree = _port_bert_tree(), _jax_bert_tree()
        prules, jrules = pt.bert_rules(), jpt.bert_rules()
    prules += (("kernel", P()),)
    jrules += (("kernel", JP()),)
    got = [(n, tuple(getattr(leaf, "shape", ())), hits)
           for n, leaf, hits in pt.rule_match_table(prules, ptree)]
    want = [(n, tuple(leaf.shape), hits)
            for n, leaf, hits in jpt.rule_match_table(jrules, jtree)]
    assert got == want
    assert any(len(h) == 2 for _, _, h in got)


def test_matching_semantics_equal_jax():
    """First match wins, unanchored search at any depth, 0-d leaves
    replicate without rules, an unmatched leaf raises the same message,
    ``spec_axis_names`` flattens tuple entries."""
    jax, JP, jpt, _ = _jax()

    def both(fn):
        got = fn(pt, P, lambda s: torch.empty(s, device="meta"))
        want = fn(jpt, JP, lambda s: jax.ShapeDtypeStruct(s, "float32"))
        return got, want

    got, want = both(lambda m, S, leaf: m.match_partition_rules(
        (("w$", S("model", None)), ("a/w", S(None, "model"))),
        {"a": {"w": leaf((4, 4))}, "m": {"a": {"w": leaf((4, 4))}},
         "step": leaf(())}))
    _assert_same_specs(got, want)
    assert got["m"]["a"]["w"] == P("model", None) and got["step"] == P()
    for m, S, leaf in ((pt, P, lambda s: torch.empty(s, device="meta")),
                       (jpt, JP, lambda s: jax.ShapeDtypeStruct(
                           s, "float32"))):
        with pytest.raises(ValueError) as e:
            m.match_partition_rules((("nope", S()),),
                                    {"a": {"w": leaf((4, 8))}})
        if m is pt:
            got_msg = str(e.value)
        else:
            assert got_msg == str(e.value)
    for spec in ((("model", "data"), None), (None, "model"), ()):
        assert pt.spec_axis_names(P(*spec)) == jpt.spec_axis_names(JP(*spec))


# ---------------------------------------------------------------------------
# placement over gloo ranks
# ---------------------------------------------------------------------------

MESHES = {2: dict(tp=2), 4: dict(dp=2, tp=2)}
PLACED_SPECS = {  # name -> spec entries
    "w_model_rows": (ps.TENSOR_AXIS, None),
    "w_model_cols": (None, ps.TENSOR_AXIS),
    "w_data_model": (ps.DATA_AXIS, ps.TENSOR_AXIS),
    "w_joint": ((ps.TENSOR_AXIS, ps.DATA_AXIS), None),
    "b_whole": (),
}


def placed_np():
    rng = np.random.RandomState(0)
    out = {name: rng.randn(8, 12).astype(np.float32)
           for name in PLACED_SPECS}
    out["b_whole"] = rng.randn(12).astype(np.float32)
    return out


def job(rank, world, tmp):
    mesh = pt.make_mesh(**MESHES[world], device="cpu")
    specs = {k: P(*v) for k, v in PLACED_SPECS.items()}
    tree = {k: torch.from_numpy(v) for k, v in placed_np().items()}
    shard_fns, gather_fns = pt.make_shard_and_gather_fns(specs)
    blocks = {k: shard_fns[k](v) for k, v in tree.items()}
    back = {k: gather_fns[k](v) for k, v in blocks.items()}
    with pytest.raises(ValueError) as e:
        pt.make_mesh(dp=4, tp=4, device="cpu")
    return {"shape": dict(mesh.shape), "blocks": blocks, "back": back,
            "tp_size": ps.get_tensor_model_parallel_world_size(),
            "oversubscribed": str(e.value)}


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return spawn(job, 2, tmp_path_factory.mktemp("part2"))


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return spawn(job, 4, tmp_path_factory.mktemp("part4"))


@functools.lru_cache(maxsize=None)
def _jax_shards(world):
    """Each device's shard of each placed array, by device index, and
    the JAX mesh's shape."""
    jax, JP, jpt, jps = _jax()
    mesh = jpt.make_mesh(**MESHES[world])
    try:
        specs = {k: JP(*v) for k, v in PLACED_SPECS.items()}
        shard_fns, _ = jpt.make_shard_and_gather_fns(specs, mesh)
        out = {}
        for k, v in placed_np().items():
            arr = shard_fns[k](v)
            out[k] = {s.device.id: np.asarray(s.data)
                      for s in arr.addressable_shards}
        return out, dict(mesh.shape)
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("world", [2, 4])
def test_shard_then_gather_round_trip(world, request):
    """Each rank's block is JAX's shard on the device at that rank's
    place (mesh device r is rank r), and gathering gives the whole
    value, both bit for bit."""
    res = request.getfixturevalue(f"w{world}")
    shards, shape = _jax_shards(world)
    whole = placed_np()
    for rank, r in enumerate(res):
        assert r["shape"] == shape
        assert r["tp_size"] == 2
        assert "needs 16 devices" in r["oversubscribed"]
        for k, v in whole.items():
            np.testing.assert_array_equal(r["blocks"][k].numpy(),
                                          shards[k][rank], err_msg=k)
            np.testing.assert_array_equal(r["back"][k].numpy(), v,
                                          err_msg=k)


def test_make_mesh_refuses_bad_degrees_like_jax():
    _, _, jpt, _ = _jax()
    for kw in (dict(dp=0), dict(tp=-1)):
        with pytest.raises(ValueError) as want:
            jpt.make_mesh(**kw)
        with pytest.raises(ValueError) as got:
            pt.make_mesh(**kw, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exactly"):
        pt.make_mesh(dp=2, tp=2, devices=[0, 1], device="cpu")
