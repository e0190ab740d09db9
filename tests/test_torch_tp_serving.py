"""Port parity of tensor-parallel serving (``serving.decode``'s
``make_tp_*_fn`` builders and their int8 twins, ``DraftModel`` over a
mesh, ``make_tile_transfer_fns``, ``make_reshard_extract_fn`` and
``PageReshard`` over a mesh) against the JAX package on the CPU.

Each case starts from one cache state (the port's unsharded prefill of
seeded prompts into a dense or paged fp32 cache, or an int8 pool, the
same bits on both sides) and runs one builder's calls: the reference's
cases (``tests/L0/run_serving/test_decode.py``'s tp verify and tree
verify, dense and paged; ``test_quant.py``'s tp 2 w8 decode, dense and
over the int8 pool), then prefill, decode, paged prefill, paged decode,
chunk prefill and paged chunk prefill. The JAX side runs the reference's
``make_tp_*_fn`` at the same tp on the forced host devices (memoized for
the module); the port's runs in four gloo ranks
(``tests/_torch_ranks.py``; tp 2 as two data-parallel pairs, then tp 4)
on each rank's blocks (``shard_tp_params``, ``shard_tp_cache``). Held:
every rank's logits against the JAX tensor-parallel logits and the
port's unsharded builder on the same cache within the reference's
rtol/atol 1e-4, the same argmax, every rank's logits the same bits, and
the gathered cache (``gather_tp_cache``) against the JAX cache within
1e-5. Also: the drafter over a mesh drafts the JAX tensor-parallel
drafter's tokens, linear and tree; the reshard extract equals the
extract of the gathered pool bit for bit and the tile pair's gather and
shard round-trip this rank's head block bit for bit (fp32 and bf16
pools); ``PageReshard(src_mesh=m, dst_mesh=m)`` under a pinned fault
schedule delivers the host-staged channel's bytes with its attempts and
counters. (Meshes over disjoint ranks: ``tests/test_torch_handoff.py``.)

Weights are the port's ``init_gpt`` from a seeded generator, its
biases and LayerNorm weights seeded too (and its ``quantize_params``),
handed to the JAX package as the same arrays; fp32 throughout. This module imports no JAX at its top."""

import dataclasses
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.serving import decode as port_decode
from apex_tpu_torch.serving.cache import (
    KVCache, PagedKVCache, init_paged_cache,
)
from apex_tpu_torch.transformer import parallel_state as ps

PROMPT, S_MAX, PAGE = 8, 32, 4
MAX_PAGES = S_MAX // PAGE
NUM_PAGES = 2 + 2 * MAX_PAGES
ROWS = [list(range(2, 2 + MAX_PAGES)),
        list(range(2 + MAX_PAGES, 2 + 2 * MAX_PAGES))]
SCRATCH_ROW = [1] * MAX_PAGES
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg():
    return dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)


def _jax():
    import jax
    import jax.numpy as jnp

    from apex_tpu import serving as jserving
    from apex_tpu.models import gpt as jgpt
    from apex_tpu.transformer import parallel_state as jps
    return jax, jnp, jserving, jgpt, jps


def _jcfg():
    _, _, _, jgpt, _ = _jax()
    return dataclasses.replace(jgpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)


def _seed_affine(tree, gen, name=""):
    """``tree`` with every bias drawn from N(0, 0.1) and every LayerNorm
    weight from 1 + N(0, 0.1) (``init_gpt`` sets them to zeros and
    ones), so a Row linear's bias added on each rank, or a Column bias
    taken from another rank's block, shows."""
    if isinstance(tree, dict):
        return {k: _seed_affine(v, gen, k) for k, v in tree.items()}
    if name not in ("bias", "weight"):
        return tree
    noise = torch.randn(tree.shape, generator=gen) * 0.1
    return noise + (1.0 if name == "weight" else 0.0)


@functools.lru_cache(maxsize=None)
def _port_params():
    """(fp32 params, their weight-only int8 tree), seeded, the biases
    and LayerNorm weights too."""
    from apex_tpu_torch.quant import quantize_params

    gen = torch.Generator().manual_seed(0)
    params = _seed_affine(port_gpt.init_gpt(_port_cfg(), gen, device="cpu"),
                          gen)
    return params, quantize_params(params)


def _to_jax(tree):
    jax, jnp = _jax()[:2]
    from apex_tpu_torch.utils.tree import tree_map

    return jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tree))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return tuple(_to_jax(t) for t in _port_params())


@functools.lru_cache(maxsize=None)
def _seq():
    return np.random.RandomState(1).randint(0, 512, size=(1, PROMPT + 8))


def _tree():
    from apex_tpu_torch.serving import tree_arrays

    root = int(_seq()[0, PROMPT])
    toks, depth, anc, _, _, _ = tree_arrays(
        [[root], [root]], [([101, 202, 303], [-1, -1, 0]),
                           ([11, 22, 33], [-1, 0, 1])], k1=4)
    return np.asarray(toks), np.asarray(depth), np.asarray(anc)


# ---------------------------------------------------------------------------
# the cases: (cache kind, pool dtype, int8 params, slots prefilled by the
# JAX unsharded prefill first, builder, its keywords, the calls)
# ---------------------------------------------------------------------------

def _calls(case):
    seq = _seq()
    prompt = seq[:, :PROMPT]
    ones = np.ones((PROMPT,), np.int32)
    pend = np.asarray([seq[0, PROMPT], 0])
    k1 = 3
    verify = np.concatenate([seq[:, PROMPT:PROMPT + k1],
                             np.zeros((1, k1), seq.dtype)])
    toks, depth, anc = _tree()
    half = PROMPT // 2
    write = np.asarray(ROWS[0][:PROMPT // PAGE], np.int32)
    row0 = np.asarray(ROWS[0], np.int32)
    return {
        "prefill": [dict(ids=prompt, mask=ones, slot=1)],
        "decode": [dict(tokens=pend, active=np.asarray([True, False]))],
        "verify": [dict(tokens=verify)],
        "tree_verify": [dict(tokens=toks, depth=depth, anc=anc)],
        "chunk_prefill": [
            dict(ids=prompt[:, :half], mask=ones[:half], slot=1, pos=0),
            dict(ids=prompt[:, half:], mask=ones[half:], slot=1,
                 pos=half)],
        "paged_prefill": [dict(ids=prompt, mask=ones, slot=0,
                               write_pages=write, table_row=row0)],
        "paged_decode": [dict(tokens=pend, active=np.asarray([True,
                                                              False]))],
        "paged_verify": [dict(tokens=verify)],
        "paged_tree_verify": [dict(tokens=toks, depth=depth, anc=anc)],
        "paged_chunk_prefill": [
            dict(ids=prompt[:, :half], mask=ones[:half], slot=0, pos=0,
                 write_pages=write[:1], gather_row=row0,
                 store_row=np.asarray(SCRATCH_ROW, np.int32)),
            dict(ids=prompt[:, half:], mask=ones[half:], slot=0, pos=half,
                 write_pages=write[1:], gather_row=row0, store_row=row0)],
    }[case]


# name -> (paged, pool dtype, int8 params, prefilled slots, builder, kw)
CASES = {
    "prefill": (False, "float32", False, (), "prefill", {}),
    "decode": (False, "float32", False, (0,), "decode", {}),
    "verify": (False, "float32", False, (0,), "verify", {}),
    "tree_verify": (False, "float32", False, (0, 1), "tree_verify", {}),
    "chunk_prefill": (False, "float32", False, (0,), "chunk_prefill", {}),
    "paged_prefill": (True, "float32", False, (), "paged_prefill", {}),
    "paged_decode": (True, "float32", False, (0,), "paged_decode", {}),
    "paged_verify": (True, "float32", False, (0,), "paged_verify", {}),
    "paged_tree_verify": (True, "float32", False, (0, 1),
                          "paged_tree_verify", {}),
    "paged_chunk_prefill": (True, "float32", False, (),
                            "paged_chunk_prefill", {}),
    "w8_decode": (False, "float32", True, (0,), "decode",
                  {"quantized": True}),
    "w8_paged_kv8_decode": (True, "int8", True, (0,), "paged_decode",
                            {"quantized": True, "kv_quantized": True}),
}
BUILDER_OF = {"w8_decode": "decode", "w8_paged_kv8_decode": "paged_decode"}


def _call_case(case):
    return _calls(BUILDER_OF.get(case, case))


@functools.lru_cache(maxsize=None)
def _start(case):
    """The case's starting cache (numpy leaves, None for absent scales),
    from the port's unsharded prefill."""
    from apex_tpu_torch.serving import init_cache

    paged, dt, w8, slots, _, _ = CASES[case]
    cfg = _port_cfg()
    params = _port_params()[w8]
    ids = torch.from_numpy(np.asarray(_seq()[:, :PROMPT], np.int64))
    ones = torch.ones((PROMPT,), dtype=torch.int32)
    if paged:
        cache = init_paged_cache(cfg, 2, S_MAX, NUM_PAGES, PAGE,
                                 getattr(torch, dt), "cpu")
        pre = port_decode.make_paged_prefill_fn(cfg, quantized=w8)
        for s in slots:
            cache, _ = pre(params, cache, ids, ones, s, torch.tensor(
                ROWS[s][:PROMPT // PAGE], dtype=torch.int32),
                torch.tensor(ROWS[s], dtype=torch.int32))
    else:
        cache = init_cache(cfg, 2, S_MAX, getattr(torch, dt), "cpu")
        pre = port_decode.make_prefill_fn(cfg, quantized=w8)
        for s in slots:
            cache, _ = pre(params, cache, ids, ones, s)
    return tuple(None if t is None else t.numpy() for t in cache)


def _jax_args(call):
    jnp = _jax()[1]
    return [jnp.int32(v) if isinstance(v, int) else jnp.asarray(
        v, jnp.bool_ if v.dtype == bool else jnp.int32)
        for v in call.values()]


@functools.lru_cache(maxsize=None)
def _jax_tp(case, tp):
    """The JAX package's tensor-parallel run of a case at ``tp``: (logits
    of each call, the cache after)."""
    jax, jnp, jserving, jgpt, jps = _jax()
    paged, _, w8, _, builder, kw = CASES[case]
    params = _jax_params()[w8]
    cls = jserving.PagedKVCache if paged else jserving.KVCache
    # copies: the steps donate the cache, and a host array may back it
    cache = cls(*(None if t is None else jnp.array(t, copy=True)
                  for t in _start(case)))
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                         devices=jax.devices()[:tp])
    try:
        model = jgpt.GPTModel(_jcfg(), tp_size=tp)
        fn = getattr(jserving, f"make_tp_{builder}_fn")(model, mesh, **kw)
        logits = []
        for call in _call_case(case):
            cache, lg = fn(params, cache, *_jax_args(call))
            logits.append(np.asarray(lg))
    finally:
        jps.destroy_model_parallel()
    return logits, tuple(None if t is None else np.asarray(t)
                         for t in cache)


def _port_args(call):
    out = []
    for name, v in call.items():
        if isinstance(v, int):
            out.append(v)
        elif v.dtype == bool:
            out.append(torch.from_numpy(v))
        elif name in ("ids", "tokens", "depth"):
            out.append(torch.from_numpy(np.asarray(v, np.int64)))
        else:
            out.append(torch.from_numpy(np.asarray(v, np.int32)))
    return out


def _port_cache(case):
    paged = CASES[case][0]
    cls = PagedKVCache if paged else KVCache
    return cls(*(None if t is None else torch.from_numpy(t.copy())
                 for t in _start(case)))


@functools.lru_cache(maxsize=None)
def _port_unsharded(case):
    """The port's unsharded builder on the case's starting cache: each
    call's logits."""
    _, _, w8, _, builder, _ = CASES[case]
    fn = getattr(port_decode, f"make_{builder}_fn")(_port_cfg(),
                                                    quantized=w8)
    cache = _port_cache(case)
    out = []
    for call in _call_case(case):
        cache, lg = fn(_port_params()[w8], cache,
                       *_port_args(call))
        out.append(lg.numpy())
    return out


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _draft_histories():
    seq = _seq()[0].tolist()
    return ([seq[:10], seq[:6]], [3, 2]), ([seq[:12], seq[:7]], [3, 3])


def _drafts(dm):
    (h1, k1), (h2, k2) = _draft_histories()
    return dm.draft(h1, k1), dm.draft_tree(h2, k2)


def _transfer():
    """The mesh transfer functions on this rank: the reshard extract and
    the tile round trip (fp32 and bf16 pools), and a PageReshard over
    the mesh beside the host-staged one under one fault schedule."""
    from apex_tpu_torch.serving import (
        FaultInjector, PageReshard, make_extract_pages_fn,
        make_reshard_extract_fn, make_tile_transfer_fns,
    )

    mesh = ps.get_mesh()
    pages = [3, 2, 9]
    gather_fn, shard_fn = make_tile_transfer_fns(mesh)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        whole = init_paged_cache(_port_cfg(), 2, S_MAX, NUM_PAGES, PAGE,
                                 dt, "cpu")
        g = torch.Generator().manual_seed(5)
        for t in (whole.k, whole.v):
            t.copy_(torch.randn(t.shape, generator=g).to(dt))
        local = port_decode.shard_tp_cache(whole)
        k, v = make_reshard_extract_fn(mesh)(local, pages)
        want = make_extract_pages_fn()(whole, pages)
        hk, hv = gather_fn(*make_extract_pages_fn()(local, pages))
        sk, sv = shard_fn(hk, hv)
        lk, lv = make_extract_pages_fn()(local, pages)
        out[str(dt)] = dict(
            extract=torch.equal(k, want[0]) and torch.equal(v, want[1]),
            round_trip=torch.equal(sk.view(dt), lk)
            and torch.equal(sv.view(dt), lv),
            host_bytes=bytes(np.ascontiguousarray(hk).tobytes()))
        if dt == torch.float32:
            sched = {"reshard_send": (0,), "reshard_recv": (0,)}
            res = {}
            for name, cache, kw in (
                    ("mesh", local, dict(src_mesh=mesh, dst_mesh=mesh)),
                    ("host", whole, {})):
                tier = PageReshard(FaultInjector(seed=3, schedule=sched),
                                   max_retries=3, **kw)
                eng = SimpleNamespace(cache=cache, page_size=PAGE)
                tk, tv, attempts = tier.ship(eng, list(range(12)), pages)
                dk, dv = tier.shard_fn(tk, tv)
                res[name] = dict(
                    attempts=attempts, bytes=(np.asarray(tk).tobytes(),
                                              np.asarray(tv).tobytes()),
                    stats={f: getattr(tier.stats, f) for f in (
                        "reshards", "reshard_retries", "reshard_corrupt")},
                    placed=(torch.as_tensor(dk), torch.as_tensor(dv)))
            out["reshard"] = dict(
                same_bytes=res["mesh"]["bytes"] == res["host"]["bytes"],
                attempts=(res["mesh"]["attempts"], res["host"]["attempts"]),
                stats=(res["mesh"]["stats"], res["host"]["stats"]),
                placed=torch.equal(res["mesh"]["placed"][0], lk)
                and torch.equal(res["mesh"]["placed"][1], lv))
    return out


def _at_tp(d, tp):
    """Every case, the drafter and the transfer at ``tp`` on this rank."""
    from apex_tpu_torch.models.gpt import draft_gpt_tiny
    from apex_tpu_torch.serving import DraftModel

    ps.initialize_model_parallel(tp, device="cpu")
    model = port_gpt.GPTModel(_port_cfg(), tp_size=tp)
    out = {}
    for case, (paged, _, w8, _, builder, kw) in CASES.items():
        params = port_decode.shard_tp_params(d["params"][w8], model, w8)
        # a copy: the replicated leaves (lengths, block tables) are not
        # cut, and the steps write them in place
        start = d["start"][case]
        cache = port_decode.shard_tp_cache(type(start)(*(
            None if t is None else t.clone() for t in start)))
        fn = getattr(port_decode, f"make_tp_{builder}_fn")(model, **kw)
        logits = []
        for args in d["calls"][case]:
            cache, lg = fn(params, cache, *args)
            logits.append(lg)
        # a plain tuple: the harness loads results with weights_only
        out[case] = (logits, tuple(port_decode.gather_tp_cache(cache)))
    dcfg = draft_gpt_tiny()
    dm = DraftModel(d["draft_params"], dcfg, 2, S_MAX, chunk=4,
                    model=port_gpt.GPTModel(dcfg, tp_size=tp),
                    cache_dtype=torch.float32, device="cpu")
    out["drafts"] = _drafts(dm)
    out["transfer"] = _transfer()
    ps.destroy_model_parallel()
    return out


def job(rank, world, tmp):
    # the file holds the caches as named tuples: this module wrote it
    d = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    return {tp: _at_tp(d, tp) for tp in (2, 4)}


@functools.lru_cache(maxsize=None)
def _draft_params():
    from apex_tpu_torch.models.gpt import draft_gpt_tiny

    gen = torch.Generator().manual_seed(3)
    return _seed_affine(port_gpt.init_gpt(draft_gpt_tiny(), gen,
                                          device="cpu"), gen)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks: tp 2 (two data-parallel pairs), then tp 4."""
    tmp = tmp_path_factory.mktemp("tp_serving")
    torch.save({
        "params": {False: _port_params()[0], True: _port_params()[1]},
        "start": {c: _port_cache(c) for c in CASES},
        "calls": {c: [_port_args(call) for call in _call_case(c)]
                  for c in CASES},
        "draft_params": _draft_params(),
    }, os.path.join(tmp, "inputs.pt"))
    return spawn(job, 4, tmp)


@functools.lru_cache(maxsize=None)
def _jax_drafts(tp):
    jax, jnp, _, jgpt, jps = _jax()
    from apex_tpu.serving.draft_model import DraftModel

    mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                         devices=jax.devices()[:tp])
    try:
        dcfg = jgpt.draft_gpt_tiny()
        dm = DraftModel(_to_jax(_draft_params()), dcfg, 2, S_MAX, chunk=4,
                        model=jgpt.GPTModel(dcfg, tp_size=tp), mesh=mesh,
                        cache_dtype=jnp.float32)
        return _drafts(dm)
    finally:
        jps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_step_matches_jax_and_unsharded(tp, case, ranks):
    res = [r[tp] for r in ranks]
    want, want_cache = _jax_tp(case, tp)
    plain = _port_unsharded(case)
    for r in res:
        logits, cache = r[case]
        assert len(logits) == len(want)
        for got, w, p in zip(logits, want, plain):
            got = got.numpy()
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, **TOL)
            np.testing.assert_allclose(got, p, **TOL)
            np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))
        for t, w in zip(cache, want_cache):
            assert (t is None) == (w is None)
            if t is None:
                continue
            if w.dtype == np.int8:
                # an int8 page may round one step apart where a value
                # sits on a rounding boundary; its scale holds the rest
                assert np.abs(t.numpy().astype(np.int32)
                              - w.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                           atol=CACHE_TOL)
    for r in res[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r[case][0],
                                                      res[0][case][0]))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_drafter_drafts_the_jax_drafters_tokens(tp, ranks):
    res = [r[tp] for r in ranks]
    want = _jax_drafts(tp)
    for r in res:
        assert r["drafts"] == want


@pytest.mark.parametrize("tp", [2, 4])
def test_reshard_extract_and_tile_round_trip_bitwise(tp, ranks):
    res = [r[tp] for r in ranks]
    for dt in ("torch.float32", "torch.bfloat16"):
        for r in res:
            assert r["transfer"][dt]["extract"]
            assert r["transfer"][dt]["round_trip"]
        assert len({r["transfer"][dt]["host_bytes"] for r in res}) == 1


@pytest.mark.parametrize("tp", [2, 4])
def test_page_reshard_over_a_mesh_under_faults(tp, ranks):
    res = [r[tp] for r in ranks]
    for r in res:
        rs = r["transfer"]["reshard"]
        assert rs["same_bytes"] and rs["placed"]
        assert rs["attempts"][0] == rs["attempts"][1] == 3
        assert rs["stats"][0] == rs["stats"][1]
        assert rs["stats"][0]["reshard_retries"] == 2
        assert rs["stats"][0]["reshard_corrupt"] == 1


def test_tp_int8_pool_refuses_tree_and_chunk_and_checks_the_switch():
    """As the reference: paged tree verify and paged chunk prefill
    refuse the int8 pool, and a kv_quantized switch that does not name
    the pool's kind raises (tp 1: no process group needed beyond one
    rank's mesh)."""
    cfg = _port_cfg()
    cache = init_paged_cache(cfg, 2, S_MAX, NUM_PAGES, PAGE, torch.int8,
                             "cpu")
    d = _calls("paged_tree_verify")[0]
    c = _calls("paged_chunk_prefill")[0]
    decode = _calls("paged_decode")[0]
    q = _port_params()[1]
    ps.initialize_model_parallel(1, device="cpu")   # a gloo world of one
    try:
        model = port_gpt.GPTModel(cfg, tp_size=1)
        with pytest.raises(ValueError, match="int8"):
            port_decode.make_tp_paged_tree_verify_fn(model, quantized=True)(
                q, cache, *_port_args(d))
        with pytest.raises(ValueError, match="int8"):
            port_decode.make_tp_paged_chunk_prefill_fn(
                model, quantized=True)(q, cache, *_port_args(c))
        with pytest.raises(ValueError, match="kv_quantized"):
            port_decode.make_tp_paged_decode_fn(model, quantized=True)(
                q, cache, *_port_args(decode))
    finally:
        ps.destroy_model_parallel()
        torch.distributed.destroy_process_group()
