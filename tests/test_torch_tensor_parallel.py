"""Port parity of ``apex_tpu_torch.transformer.tensor_parallel`` against the
JAX package on the CPU: each case of
``tests/L0/run_transformer/test_tensor_parallel.py`` at tp 2 and 4.

The JAX side runs in this process on ``jax.devices()[:tp]`` (the rig's
virtual CPU devices) through its ``parallel_state.shard_map``, as the
reference tests do, each run memoized for the module. The port side runs
in tp gloo ranks (``tests/_torch_ranks.py``), one spawn at W = 2 and one
at W = 4, each running every case through the port's
``parallel_state.shard_map``; the tests compare every rank's results
with JAX's. Inputs come from numpy seeds on both sides; biases are
non-zero (the reference's are zero) so the bias paths count.

Tolerances: the reference's, between the port and JAX (each side holds
to the dense computation within them): outputs 1e-5 (relative and
absolute), block gradients 1e-4, the vocab-parallel embedding 1e-6, the
cross entropy 1e-5 and its gradients 1e-5 / 1e-6. The sequence-parallel
round trip, ``broadcast_data``, the RNG keys and their uniform draws are
held bit for bit; replicated outputs are the same bits on every rank.
The fused weight gradient (``linear_with_grad_accumulation``) sums the
same bf16 products in fp32 on both sides: within 1e-6 of the largest
magnitude of JAX's."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_ranks import spawn
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.utils import prng

P = ps.PartitionSpec
M = P(ps.TENSOR_AXIS)
SEED_KEY = 0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs, from numpy seeds (both sides)
# ---------------------------------------------------------------------------

def _linear_np(seed, fan_in, fan_out):
    rng = np.random.RandomState(seed)
    return {"kernel": (rng.randn(fan_in, fan_out) / np.sqrt(fan_in))
            .astype(np.float32),
            "bias": (0.1 * rng.randn(fan_out)).astype(np.float32)}


def _x_np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ids_np(seed, shape, high):
    return np.random.RandomState(seed).randint(0, high, size=shape)


def inputs():
    return {
        "col": _linear_np(1, 32, 64), "x32": _x_np(2, 4, 32),
        "cp": _linear_np(3, 32, 64), "rp": _linear_np(4, 64, 32),
        "gcp": _linear_np(5, 16, 32), "grp": _linear_np(6, 32, 16),
        "x16": _x_np(7, 4, 16), "xs": _x_np(8, 16, 2, 16),
        "emb": {"embedding": _x_np(9, 64, 16, scale=0.02)},
        "ids": _ids_np(10, (4, 10), 64),
        "logits3": _x_np(11, 4, 10, 64, scale=3.0),
        "target3": _ids_np(12, (4, 10), 64),
        "logits2": _x_np(13, 4, 64), "target2": _ids_np(14, (4,), 64),
        "seq": _x_np(15, 16, 4), "batch": np.arange(8.0, dtype=np.float32)
        .reshape(2, 4),
    }


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


# ---------------------------------------------------------------------------
# the port side: every case in each rank
# ---------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _grads(loss_fn, *trees):
    """Gradients of ``loss_fn(*trees)`` w.r.t. every leaf of the dict
    trees, as trees like them."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in t.items()}
              for t in trees]
    flat = [v for t in leaves for v in t.values()]
    with torch.enable_grad():
        g = torch.autograd.grad(loss_fn(*leaves), flat)
    it = iter(g)
    return tuple({k: next(it) for k in t} for t in leaves)


def _port_cases(rank, world):
    n = world
    d = _t(inputs())
    smap = ps.shard_map
    out = {}

    col = tp.ColumnParallelLinear(32, 64, gather_output=True, tp_size=n)
    out["column"] = smap(col.apply, in_specs=(col.partition_specs(), P()),
                         out_specs=P())(d["col"], d["x32"])

    c = tp.ColumnParallelLinear(32, 64, gather_output=False, tp_size=n)
    r = tp.RowParallelLinear(64, 32, input_is_parallel=True, tp_size=n)
    out["compose"] = smap(
        lambda cp, rp, x: r.apply(rp, _gelu(c.apply(cp, x))),
        in_specs=(c.partition_specs(), r.partition_specs(), P()),
        out_specs=P())(d["cp"], d["rp"], d["x32"])

    for name, fused in (("block_grads", False), ("fusion_grads", True)):
        gc = tp.ColumnParallelLinear(16, 32, gather_output=False, tp_size=n,
                                     gradient_accumulation_fusion=fused)
        gr = tp.RowParallelLinear(32, 16, input_is_parallel=True, tp_size=n,
                                  gradient_accumulation_fusion=fused)

        def tp_grads(cp, rp, x, gc=gc, gr=gr):
            return _grads(lambda a, b: (gr.apply(b, _gelu(gc.apply(a, x)))
                                        ** 2).sum(), cp, rp)

        out[name] = smap(
            tp_grads, in_specs=(gc.partition_specs(), gr.partition_specs(),
                                P()),
            out_specs=(gc.partition_specs(), gr.partition_specs()))(
                d["gcp"], d["grp"], d["x16"])

    sc = tp.ColumnParallelLinear(16, 32, gather_output=False, tp_size=n,
                                 sequence_parallel_enabled=True)
    sr = tp.RowParallelLinear(32, 16, input_is_parallel=True, tp_size=n,
                              sequence_parallel_enabled=True)
    out["sp_mlp"] = smap(
        lambda cp, rp, x: sr.apply(rp, _gelu(sc.apply(cp, x))),
        in_specs=(sc.partition_specs(), sr.partition_specs(), M),
        out_specs=M)(d["gcp"], d["grp"], d["xs"])

    emb = tp.VocabParallelEmbedding(64, 16, tp_size=n)
    out["embedding"] = smap(emb.apply, in_specs=(emb.partition_specs(), P()),
                            out_specs=P())(d["emb"], d["ids"])

    out["xent"] = smap(tp.vocab_parallel_cross_entropy,
                       in_specs=(P(None, None, ps.TENSOR_AXIS), P()),
                       out_specs=P())(d["logits3"], d["target3"])

    def xent_grad(logits, target=d["target2"]):
        return _grads(lambda t: tp.vocab_parallel_cross_entropy(
            t["l"], target).mean(), {"l": logits})[0]["l"]

    out["xent_grads"] = smap(xent_grad, in_specs=P(None, ps.TENSOR_AXIS),
                             out_specs=P(None, ps.TENSOR_AXIS))(d["logits2"])

    def rt(x):
        local = tp.scatter_to_sequence_parallel_region(x)
        return tp.gather_from_sequence_parallel_region(local, False)

    out["sp_roundtrip"] = smap(rt, in_specs=P(), out_specs=P())(d["seq"])

    def bcast(batch):
        data = {"ids": batch if ps.get_tensor_model_parallel_rank() == 0
                else -batch}
        return tp.broadcast_data(["ids"], data)["ids"]

    out["broadcast"] = smap(bcast, in_specs=P(), out_specs=P())(d["batch"])

    def keys(key):
        k = tp.model_parallel_rng_key(key)
        return k[None], prng.uniform(k, (1, 4), device="cpu")

    out["rng_keys"], out["rng_uniform"] = smap(
        keys, in_specs=P(), out_specs=M)(prng.PRNGKey(SEED_KEY))
    out["rng_local_key"] = tp.model_parallel_rng_key(prng.PRNGKey(SEED_KEY))
    out["data_key"] = tp.data_parallel_rng_key(prng.PRNGKey(SEED_KEY))

    errors = []
    for make in (lambda: tp.ColumnParallelLinear(32, 64 * n + 1),
                 lambda: tp.RowParallelLinear(64 * n + 1, 32),
                 lambda: tp.VocabParallelEmbedding(64 * n + 1, 16)):
        with pytest.raises(ValueError) as e:
            make()
        errors.append(str(e.value))
    out["divisibility"] = errors
    return out


def job(rank, world, tmp):
    ps.initialize_model_parallel(world, device="cpu")
    return _port_cases(rank, world)


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return spawn(job, 2, tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return spawn(job, 4, tmp_path_factory.mktemp("tp4"))


@pytest.fixture(params=[2, 4], ids=["tp2", "tp4"])
def ranks(request):
    return request.param, request.getfixturevalue(f"w{request.param}")


# ---------------------------------------------------------------------------
# the JAX side (memoized: each case's run once a module)
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer import tensor_parallel as jtp
    return jax, jnp, JP, jps, jtp


@functools.lru_cache(maxsize=None)
def _jax_cases(n):
    """Every case at tp ``n``, as the reference test writes it."""
    jax, jnp, JP, jps, jtp = _jax()
    d = inputs()
    JM = JP(jps.TENSOR_AXIS)
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=n,
                                         devices=jax.devices()[:n])

    def smap(f, in_specs, out_specs, *args):
        return jax.tree.map(np.asarray, jax.jit(jps.shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs))(*args))

    out = {}
    try:
        col = jtp.ColumnParallelLinear(32, 64, gather_output=True, tp_size=n)
        out["column"] = smap(col.apply, (col.partition_specs(), JP()),
                             JP(), d["col"], d["x32"])
        c = jtp.ColumnParallelLinear(32, 64, gather_output=False, tp_size=n)
        r = jtp.RowParallelLinear(64, 32, input_is_parallel=True, tp_size=n)
        out["compose"] = smap(
            lambda cp, rp, x: r.apply(rp, jax.nn.gelu(c.apply(cp, x))),
            (c.partition_specs(), r.partition_specs(), JP()), JP(),
            d["cp"], d["rp"], d["x32"])
        for name, fused in (("block_grads", False), ("fusion_grads", True)):
            gc = jtp.ColumnParallelLinear(16, 32, gather_output=False,
                                          tp_size=n,
                                          gradient_accumulation_fusion=fused)
            gr = jtp.RowParallelLinear(32, 16, input_is_parallel=True,
                                       tp_size=n,
                                       gradient_accumulation_fusion=fused)

            def tp_grads(cp, rp, x, gc=gc, gr=gr):
                return jax.grad(lambda a, b: jnp.sum(gr.apply(
                    b, jax.nn.gelu(gc.apply(a, x))) ** 2),
                    argnums=(0, 1))(cp, rp)

            out[name] = smap(
                tp_grads, (gc.partition_specs(), gr.partition_specs(), JP()),
                (gc.partition_specs(), gr.partition_specs()), d["gcp"],
                d["grp"], d["x16"])
        sc = jtp.ColumnParallelLinear(16, 32, gather_output=False, tp_size=n,
                                      sequence_parallel_enabled=True)
        sr = jtp.RowParallelLinear(32, 16, input_is_parallel=True, tp_size=n,
                                   sequence_parallel_enabled=True)
        out["sp_mlp"] = smap(
            lambda cp, rp, x: sr.apply(rp, jax.nn.gelu(sc.apply(cp, x))),
            (sc.partition_specs(), sr.partition_specs(), JM), JM,
            d["gcp"], d["grp"], d["xs"])
        emb = jtp.VocabParallelEmbedding(64, 16, tp_size=n)
        out["embedding"] = smap(emb.apply, (emb.partition_specs(), JP()),
                                JP(), d["emb"], d["ids"])
        out["xent"] = smap(jtp.vocab_parallel_cross_entropy,
                           (JP(None, None, jps.TENSOR_AXIS), JP()), JP(),
                           d["logits3"], d["target3"])
        out["xent_grads"] = smap(
            lambda l: jax.grad(lambda t: jnp.mean(
                jtp.vocab_parallel_cross_entropy(t, d["target2"])))(l),
            JP(None, jps.TENSOR_AXIS), JP(None, jps.TENSOR_AXIS),
            d["logits2"])
        out["sp_roundtrip"] = smap(
            lambda x: jtp.gather_from_sequence_parallel_region(
                jtp.scatter_to_sequence_parallel_region(x), False),
            JP(), JP(), d["seq"])

        def bcast(batch):
            rank = jax.lax.axis_index(jps.TENSOR_AXIS)
            data = {"ids": jnp.where(rank == 0, batch, -batch)}
            return jtp.broadcast_data(["ids"], data)["ids"]

        out["broadcast"] = smap(bcast, JP(), JP(), d["batch"])

        def keys(key):
            k = jtp.model_parallel_rng_key(key)
            return k[None], jax.random.uniform(k, (1, 4))

        out["rng_keys"], out["rng_uniform"] = smap(
            keys, JP(), JM, jax.random.PRNGKey(SEED_KEY))
        errors = []
        for make in (lambda: jtp.ColumnParallelLinear(32, 64 * n + 1),
                     lambda: jtp.RowParallelLinear(64 * n + 1, 32),
                     lambda: jtp.VocabParallelEmbedding(64 * n + 1, 16)):
            with pytest.raises(ValueError) as e:
                make()
            errors.append(str(e.value))
        out["divisibility"] = errors
    finally:
        jps.destroy_model_parallel()
    return out


def _close(got, want, rtol, atol):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _same_on_every_rank(res, key):
    first = _np(res[0][key])
    for r in res[1:]:
        _bitwise(r[key], first)


def _bitwise(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _bitwise(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bitwise(g, w)
        return
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,rtol,atol", [
    ("column", 1e-5, 1e-5), ("compose", 1e-5, 1e-5),
    ("block_grads", 1e-4, 1e-4), ("fusion_grads", 1e-4, 1e-4),
    ("embedding", 1e-6, 1e-6), ("xent", 1e-5, 1e-5),
    ("xent_grads", 1e-5, 1e-6)])
def test_replicated_results_match_jax(ranks, case, rtol, atol):
    """Column (gathered), Column -> gelu -> Row, the block's gradients
    (plain and ``gradient_accumulation_fusion``), the vocab-parallel
    embedding, the vocab-parallel cross entropy and its gradient: every
    rank's whole result against JAX's, the same bits on every rank."""
    n, res = ranks
    want = _jax_cases(n)[case]
    for r in res:
        _close(r[case], want, rtol, atol)
    _same_on_every_rank(res, case)


def test_sequence_parallel_mlp_matches_jax(ranks):
    """SP: activations split on the sequence (dim 0, (s, b, h)) outside
    the block; Column gathers, Row reduce-scatters; the gathered output
    against JAX's."""
    n, res = ranks
    want = _jax_cases(n)["sp_mlp"]
    for r in res:
        _close(r["sp_mlp"], want, 1e-5, 1e-5)


def test_sequence_parallel_roundtrip_is_exact(ranks):
    n, res = ranks
    x = inputs()["seq"]
    for r in res:
        np.testing.assert_array_equal(_np(r["sp_roundtrip"]), x)
    np.testing.assert_array_equal(_jax_cases(n)["sp_roundtrip"], x)


def test_broadcast_data(ranks):
    """Ranks other than the source hold garbage; the broadcast gives
    every rank the source's batch."""
    n, res = ranks
    want = _jax_cases(n)["broadcast"]
    np.testing.assert_array_equal(want, inputs()["batch"])
    for r in res:
        np.testing.assert_array_equal(_np(r["broadcast"]), want)


def test_rng_keys_match_jax_bit_for_bit(ranks):
    """``model_parallel_rng_key`` folds in the rank: each rank's key and
    its uniform draw are JAX's device's bits, all ranks differ;
    ``data_parallel_rng_key`` is the key itself."""
    n, res = ranks
    want = _jax_cases(n)
    keys = want["rng_keys"].astype(np.int64)
    assert len({tuple(k) for k in keys}) == n
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(_np(r["rng_keys"]), keys)
        np.testing.assert_array_equal(_np(r["rng_uniform"]),
                                      want["rng_uniform"])
        np.testing.assert_array_equal(_np(r["rng_local_key"]), keys[rank])
        np.testing.assert_array_equal(_np(r["data_key"]),
                                      _np(prng.PRNGKey(SEED_KEY)))


def test_divisibility_errors_match_jax(ranks):
    n, res = ranks
    for r in res:
        assert r["divisibility"] == _jax_cases(n)["divisibility"]


def test_rng_tracker_matches_jax():
    """add / get_states / fork / set_states: the forked keys are JAX's
    bits, and a restored state forks the same key again."""
    jax, _, _, _, jtp = _jax()
    out = []
    for mod, key_np in ((tp, _np), (jtp, lambda k: np.asarray(k, np.int64))):
        tracker = mod.get_rng_tracker()
        tracker.reset()
        tracker.add("model-parallel-rng", 123)
        states = tracker.get_states()
        k1 = tracker.fork()
        k_next = tracker.fork()
        tracker.set_states(states)
        k2 = tracker.fork()
        np.testing.assert_array_equal(key_np(k1), key_np(k2))
        out.append((key_np(k1), key_np(k_next),
                    {n: key_np(v) for n, v in mod.model_parallel_seed(
                        7).items()}))
        tracker.reset()
    for a, b in zip(*out):
        _bitwise(a, b)


def test_vocab_utility_and_split_match_jax():
    _, jnp, _, _, jtp = _jax()
    for args in ((64, 3, 8), (50304, 1, 2), (32, 0, 4)):
        assert tp.VocabUtility.vocab_range_from_global_vocab_size(*args) \
            == jtp.VocabUtility.vocab_range_from_global_vocab_size(*args)
    per = "vocab_range_from_per_partition_vocab_size"
    assert getattr(tp.VocabUtility, per)(16, 2, 4) \
        == getattr(jtp.VocabUtility, per)(16, 2, 4)
    x = np.arange(64.0, dtype=np.float32).reshape(2, 32)
    got = tp.split_tensor_along_last_dim(torch.from_numpy(x), 8)
    want = jtp.split_tensor_along_last_dim(jnp.asarray(x), 8)
    assert len(got) == len(want) == 8 and got[0].shape == (2, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tp.split_tensor_along_last_dim(torch.from_numpy(x), 5)


def test_grad_accumulation_fusion_precision():
    """The reference's property: over 16 microbatches of bf16 activations
    and an fp32 kernel, the fused weight gradient (fp32 sums, no bf16
    round trip) stays within half the plain gradient's error of the
    exact fp32 accumulation; and it matches JAX's fused gradient."""
    jax, jnp, _, _, jtp = _jax()
    m, b, n_in, n_out = 16, 32, 64, 48
    xs = _x_np(20, m, b, n_in)
    dys = _x_np(21, m, b, n_out)
    kernel = _x_np(22, n_in, n_out)
    xs_t = torch.from_numpy(xs).to(torch.bfloat16)
    dys_t = torch.from_numpy(dys).to(torch.bfloat16)
    k_t = torch.from_numpy(kernel)

    def accumulate(layer_fn):
        acc = torch.zeros((n_in, n_out))
        for i in range(m):
            k = k_t.clone().requires_grad_(True)
            with torch.enable_grad():
                y = layer_fn(xs_t[i], k).float()
                (g,) = torch.autograd.grad((y * dys_t[i].float()).sum(), k)
            acc = acc + g
        return acc

    plain = accumulate(lambda x, k: torch.matmul(x, k.to(x.dtype)))
    fused = accumulate(tp.linear_with_grad_accumulation)
    exact = torch.einsum("mbi,mbo->io", xs_t.float(), dys_t.float())
    err_plain = float((plain - exact).abs().max())
    err_fused = float((fused - exact).abs().max())
    assert fused.dtype == torch.float32
    assert err_fused < 0.5 * err_plain, (err_fused, err_plain)

    xs_j = jnp.asarray(xs, jnp.bfloat16)
    dys_j = jnp.asarray(dys, jnp.bfloat16)

    def jwgrad(i):
        return jax.grad(lambda k: jnp.sum(
            jtp.linear_with_grad_accumulation(xs_j[i], k).astype(
                jnp.float32) * dys_j[i].astype(jnp.float32)))(
            jnp.asarray(kernel))

    want = np.asarray(sum(jwgrad(i) for i in range(m)))
    scale = float(np.abs(want).max())
    assert float(np.abs(fused.numpy() - want).max()) <= 1e-6 * scale
