"""Port parity for the weight-only int8 serving slice: ``apex_tpu_torch
.quant`` and the quantized serving steps against the JAX package on
``gpt_tiny``. The port runs on the CPU (the plain versions of its w8
kernels); the JAX side runs as its own tests run it (the Pallas w8
kernels in interpret mode), built once per module.

Tolerances: quantized trees bit for bit (int8 values and fp32 scales);
each w8 product per element to ``quant.kernels.w8_limit`` (two fp32 sum
orders over K, the bias rounding, one ulp of a bf16 output); prefill and
decode logits and cache rows fp32 1e-4, bf16 5e-2, as
``test_torch_gpt_serving.py``; greedy streams exactly; the accuracy
envelope of ``tests/L0/run_serving/test_quant.py`` (max |logit error|
against the fp32 full forward in (1e-4, 0.05))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu import quant as jax_quant
from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu_torch import amp as port_amp
from apex_tpu_torch import quant as port_quant
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.quant import kernels as port_qk

S_MAX = 64
W8_MAX_ABS = 0.05      # tests/L0/run_serving/test_quant.py
W8_MIN_ABS = 1e-4      # below it the int8 path did not run


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_tree(jax_tree):
    return port_gpt.params_from_jax(_np_tree(jax_tree), "cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _bits(x):
    """A leaf's raw bits and dtype name, from either framework."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        return x.numpy(), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16), "bfloat16"
    return a, a.dtype.name


def _assert_trees_bit_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path in w:
        (gb, gd), (wb, wd) = _bits(g[path]), _bits(w[path])
        assert gd == wd, path
        np.testing.assert_array_equal(gb, wb, err_msg=str(path))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return jax_gpt.init_gpt(jax.random.PRNGKey(0), jax_gpt.gpt_tiny())


@pytest.fixture(scope="module")
def trees(jax_params):
    """{"f32"|"bf16": (JAX quantized tree, port float tree)}; bf16 is the
    O2 cast, then quantized."""
    out = {}
    for dt in ("f32", "bf16"):
        jp = jax_params
        if dt == "bf16":
            jp = jax_amp.initialize("O2", verbosity=0).cast_model(jp)
        out[dt] = (jax_quant.quantize_params(jp), _port_tree(jp))
    return out


# -- quantize / dequantize --------------------------------------------------

def _quant_input(axis, dt):
    """(3, 8, 6) values with one all-zero channel and one channel of
    exact half-step ties (amax 127: scale 1, so w / scale = k + 0.5)."""
    rng = np.random.RandomState(5)
    w = rng.randn(3, 8, 6).astype(np.float32)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                    np.float32)
    if axis == -2:           # channels are columns, K runs along axis -2
        w[0, :, 1] = 0.0
        w[1, :, 2] = ties
    else:                    # channels are rows, K runs along axis -1
        w[0, 1, :] = 0.0
        w[1, 2, :] = ties[:6]
        w[1, 2, 0] = 127.0
    if dt == "bf16":
        return jnp.asarray(w, jnp.bfloat16)
    return jnp.asarray(w)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_quantize_tensor_bit_equal_to_jax(axis, dt):
    w = _quant_input(axis, dt)
    wq, ws = jax_quant.quantize_tensor(w, axis)
    pw = _port_tree({"w": np.asarray(w)})["w"]
    q, scale = port_quant.quantize_tensor(pw, axis)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))
    zero = (0, slice(None), 1) if axis == -2 else (0, 1)
    assert not q[zero].any() and float(scale[0, 1]) == 0.0
    tie = (1, slice(None), 2) if axis == -2 else (1, 2)
    assert q[tie][:4].tolist() == [127, 0, 2, 2]      # half to even
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = port_quant.dequantize_tensor(q, scale, axis, dtype)
        want = jax_quant.dequantize_tensor(wq, ws, axis, jdt)
        np.testing.assert_array_equal(_bits(got)[0], _bits(want)[0])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_params_bit_equal_to_jax(trees, dt):
    jq, pp = trees[dt]
    got = port_quant.quantize_params(pp)
    _assert_trees_bit_equal(got, jq)
    # the JAX tree carried across as it is gives the same bits too
    _assert_trees_bit_equal(_port_tree(jq), jq)
    assert got["layers"]["qkv"]["kernel"].dtype == torch.int8
    assert got["layers"]["qkv"]["scale"].dtype == torch.float32


def test_is_quantized_tree_matches_jax(jax_params, trees):
    jq, pp = trees["f32"]
    pairs = [(jq, port_quant.quantize_params(pp)), (jax_params, pp),
             (jq["layers"], pp["layers"]), ({}, {}),
             ({"embedding": {"word": {}}}, {"embedding": {"word": {}}})]
    want = [jax_quant.is_quantized_tree(j) for j, _ in pairs]
    assert [port_quant.is_quantized_tree(p) for _, p in pairs] == want
    assert want == [True, False, False, False, False]


# -- the w8 products --------------------------------------------------------

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _w8_case(lead, k, n, nk, xdt, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(*((n, k) if nk else (k, n))).astype(np.float32)
    wq, ws = jax_quant.quantize_tensor(jnp.asarray(w), -1 if nk else -2)
    x = jnp.asarray(rng.randn(*lead, k).astype(np.float32), _JDT[xdt])
    b = None
    if with_bias:
        b = jnp.asarray(rng.randn(n).astype(np.float32), _JDT[xdt])
    port = _port_tree({"x": np.asarray(x), "wq": np.asarray(wq),
                       "ws": np.asarray(ws),
                       "b": np.asarray(b) if with_bias else np.zeros(0)})
    return (x, wq, ws, b), (port["x"], port["wq"], port["ws"],
                            port["b"] if with_bias else None)


def _held(got, want, lim):
    err = np.abs(_f32(got) - _f32(want))
    share = float((err / lim.numpy()).max())
    print(f"max |err| {err.max():.3g}, worst share of w8_limit "
          f"{share:.4f}")
    assert share <= 1.0
    return share


@pytest.mark.parametrize("xdt,odt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("lead,k,n", [((2, 3), 64, 192), ((5,), 72, 200)],
                         ids=["lead_2x3", "k72_n200"])
@pytest.mark.parametrize("with_bias", [True, False],
                         ids=["bias", "nobias"])
def test_w8_matmul_matches_jax(xdt, odt, lead, k, n, with_bias):
    (x, wq, ws, b), (px, pwq, pws, pb) = _w8_case(lead, k, n, False, xdt,
                                                  with_bias)
    want = jax_quant.w8_matmul(x, wq, ws, b, out_dtype=_JDT[odt])
    got = port_quant.w8_matmul(px, pwq, pws, pb, out_dtype=_TDT[odt])
    assert got.dtype == _TDT[odt] and tuple(got.shape) == lead + (n,)
    _held(got, want, port_quant.w8_limit(px, pwq, pws, pb, _TDT[odt]))
    default = port_quant.w8_matmul(px, pwq, pws, pb)
    assert default.dtype == px.dtype


@pytest.mark.parametrize("xdt,odt", [("f32", "f32"), ("bf16", "f32"),
                                     ("bf16", "bf16")])
@pytest.mark.parametrize("lead,k,n", [((2, 3), 64, 512), ((1,), 72, 200)],
                         ids=["lead_2x3", "k72_n200"])
def test_w8_matmul_nk_matches_jax(xdt, odt, lead, k, n):
    (x, wq, ws, _), (px, pwq, pws, _) = _w8_case(lead, k, n, True, xdt,
                                                 False)
    want = jax_quant.w8_matmul_nk(x, wq, ws, out_dtype=_JDT[odt])
    got = port_quant.w8_matmul_nk(px, pwq, pws, out_dtype=_TDT[odt])
    assert got.dtype == _TDT[odt] and tuple(got.shape) == lead + (n,)
    _held(got, want, port_quant.w8_limit(px, pwq, pws, None, _TDT[odt],
                                         nk=True))
    assert port_quant.w8_matmul_nk(px, pwq, pws).dtype == torch.float32


def _tensor_core_order(x2, wq, scale, bias, out_dtype, nk=False):
    """The card's tensor-core orders on the CPU: each bf16 x times int8 q
    product exact in fp32, the products summed in fp32 one k16 step at a
    time, then one multiply by the channel's scale, the bias added in
    fp32, one cast. A step of the KN kernel (bf16 x at M > 8) is 16
    neighbouring k; one of the NK kernel (the logits head, bf16 x at M <=
    8) takes, in each 64-wide chunk c of k, k = 64 c + 16 t + 4 j + e for
    its four lanes t and bytes e of step j (each lane reads 16 contiguous
    bytes a row, word j a step)."""
    xf, q = x2.float(), (wq.t() if nk else wq).float()   # q: (K, N)
    k_all = q.shape[0]
    if nk:
        steps = [[c + 16 * t + 4 * j + e for t in range(4) for e in range(4)
                  if c + 16 * t + 4 * j + e < k_all]
                 for c in range(0, k_all, 64) for j in range(4)]
    else:
        steps = [list(range(k0, min(k0 + 16, k_all)))
                 for k0 in range(0, k_all, 16)]
    acc = torch.zeros((x2.shape[0], q.shape[1]), dtype=torch.float32)
    for ks in steps:
        if ks:
            acc = acc + torch.matmul(xf[:, ks], q[ks])
    y = acc * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


_TC_CASES = [(k, b, o, False) for k in (1024, 4096) for b in (True, False)
             for o in ("f32", "bf16")]
_TC_CASES += [(1024, False, o, True) for o in ("f32", "bf16")]


@pytest.mark.parametrize(
    "k,with_bias,odt,nk", _TC_CASES,
    ids=[("nk-" if nk else "") + f"{k}-{'bias' if b else 'nobias'}-{o}"
         for k, b, o, nk in _TC_CASES])
def test_w8_tensor_core_order_within_limit(k, with_bias, odt, nk):
    """``w8_limit``'s argument for the tensor-core orders (s_n times the
    fp32 sum of exact products) holds where there is no card: each order
    sits within the unchanged limit of the plain version and of the JAX
    package's w8 kernel, at GPT-2 medium's contractions (the NK case:
    the logits head at a decode step's M 8)."""
    lead = (8,) if nk else (4,)
    (x, wq, ws, b), (px, pwq, pws, pb) = _w8_case(lead, k, 96, nk, "bf16",
                                                  with_bias, seed=k + nk)
    got = _tensor_core_order(px, pwq, pws, pb, _TDT[odt], nk)
    if nk:
        lim = port_quant.w8_limit(px, pwq, pws, None, _TDT[odt], nk=True)
        plain = port_qk.w8_matmul_nk_plain(px, pwq, pws, _TDT[odt])
        ref = jax_quant.w8_matmul_nk(x, wq, ws, out_dtype=_JDT[odt])
    else:
        lim = port_quant.w8_limit(px, pwq, pws, pb, _TDT[odt])
        plain = port_qk.w8_matmul_plain(px, pwq, pws, pb, _TDT[odt])
        ref = jax_quant.w8_matmul(x, wq, ws, b, out_dtype=_JDT[odt])
    _held(got, plain, lim)
    _held(got, ref, lim)
    # the order differs from the plain version's in fp32
    if odt == "f32":
        assert not torch.equal(got, plain)


def test_w8_limit_catches_a_lost_scale():
    """The error model is tight enough that one channel served without
    its scale (or with the products' sign flipped) falls far outside."""
    _, (px, pwq, pws, pb) = _w8_case((8,), 64, 96, False, "f32", True)
    want = port_quant.w8_matmul(px, pwq, pws, pb)
    lim = port_quant.w8_limit(px, pwq, pws, pb)
    bad = pws.clone()
    bad[3] = 1.0
    err = (port_quant.w8_matmul(px, pwq, bad, pb) - want).abs()
    assert bool((err[:, 3] > 100 * lim[:, 3]).all())


@pytest.mark.parametrize("bad", ["wq_dtype", "scale_dtype", "scale_shape",
                                 "contraction"])
@pytest.mark.parametrize("nk", [False, True], ids=["kn", "nk"])
def test_w8_operand_errors_match_jax(bad, nk):
    (x, wq, ws, _), (px, pwq, pws, _) = _w8_case((2,), 16, 24, nk, "f32",
                                                 False)
    if bad == "wq_dtype":
        wq, pwq = wq.astype(jnp.float32), pwq.float()
    elif bad == "scale_dtype":
        ws, pws = ws.astype(jnp.bfloat16), pws.to(torch.bfloat16)
    elif bad == "scale_shape":
        ws, pws = ws[:-1], pws[:-1]
    else:
        x, px = x[:, :-1], px[:, :-1]
    jfn = jax_quant.w8_matmul_nk if nk else jax_quant.w8_matmul
    pfn = port_quant.w8_matmul_nk if nk else port_quant.w8_matmul
    with pytest.raises(ValueError) as want:
        jfn(x, wq, ws)
    with pytest.raises(ValueError) as got:
        pfn(px, pwq, pws)
    assert str(got.value) == str(want.value)


# -- the quantized serving path ---------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    cfg = jax_gpt.gpt_tiny()
    return {dt: (jax_serving.make_prefill_fn(cfg, cdt, quantized=True),
                 jax_serving.make_decode_fn(cfg, cdt, quantized=True))
            for dt, cdt in (("f32", None), ("bf16", jnp.bfloat16))}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_w8_prefill_and_decode_match_jax(trees, jax_steps, dt):
    cfg = jax_gpt.gpt_tiny()
    jq, pp = trees[dt]
    pq = port_quant.quantize_params(pp)
    cdt = None if dt == "f32" else torch.bfloat16
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    tol = 1e-4 if dt == "f32" else 5e-2
    rng = np.random.RandomState(3)
    bucket, slot, n_real = 16, 1, 11
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n_real] = rng.randint(0, cfg.vocab_size, size=n_real)
    ids[0, n_real:] = 499  # pad ids must not matter
    mask = (np.arange(bucket) < n_real).astype(np.int32)

    jprefill, jdecode = jax_steps[dt]
    jcache = jax_serving.init_cache(cfg, 2, S_MAX, jdt)
    jcache, jl = jprefill(jq, jcache, jnp.asarray(ids), jnp.asarray(mask),
                          jnp.int32(slot))
    pcfg = port_gpt.gpt_tiny()
    pcache = port_serving.init_cache(pcfg, 2, S_MAX, tdt, "cpu")
    pdecode = port_serving.make_decode_fn(pcfg, cdt, quantized=True)
    with torch.inference_mode():
        pcache, pl = port_serving.make_prefill_fn(pcfg, cdt, quantized=True)(
            pq, pcache, torch.from_numpy(ids).long(),
            torch.from_numpy(mask), slot)
        assert pl.dtype == torch.float32 and pl.shape == (1, 512)
        np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol, atol=tol)
        for a, b in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
            assert a.dtype == tdt
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)
        active = np.asarray([False, True])
        tok = int(np.argmax(np.asarray(jl)[0]))
        for _ in range(6):
            tokens = np.asarray([0, tok], np.int32)
            jcache, jl = jdecode(jq, jcache, jnp.asarray(tokens),
                                 jnp.asarray(active))
            pcache, pl = pdecode(pq, pcache, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(active))
            np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol,
                                       atol=tol)
            assert pcache.lengths.tolist() == \
                np.asarray(jcache.lengths).tolist()
            tok = int(np.argmax(np.asarray(jl)[1]))
        np.testing.assert_allclose(_f32(pcache.k), _f32(jcache.k),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_f32(pcache.v), _f32(jcache.v),
                                   rtol=tol, atol=tol)


def _full_logits(params, cfg, seq):
    hidden = port_gpt.apply_gpt_unsharded(params, cfg, seq)
    table = params["embedding"]["word"]["embedding"]
    return torch.matmul(hidden, table.to(hidden.dtype).t()).float()


def test_w8_teacher_forced_within_envelope(trees):
    """The JAX accuracy gate on the port: teacher-forced w8 logits
    against the fp32 full forward of the unquantized tree."""
    cfg = port_gpt.gpt_tiny()
    _, pp = trees["f32"]
    pq = port_quant.quantize_params(pp)
    prompt, total = 8, 16
    seq = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(1, total))).long()
    with torch.inference_mode():
        want = _full_logits(pp, cfg, seq)[0, prompt - 1:]
        cache = port_serving.init_cache(cfg, 2, 32, torch.float32, "cpu")
        cache, logits = port_serving.make_prefill_fn(cfg, quantized=True)(
            pq, cache, seq[:, :prompt], torch.ones(prompt, dtype=torch.int32),
            0)
        rows = [logits[0]]
        decode = port_serving.make_decode_fn(cfg, quantized=True)
        for t in range(prompt, total):
            tokens = torch.stack([seq[0, t], torch.tensor(0)])
            cache, logits = decode(pq, cache, tokens,
                                   torch.tensor([True, False]))
            rows.append(logits[0])
    err = float((torch.stack(rows) - want).abs().max())
    assert W8_MIN_ABS < err < W8_MAX_ABS, err


def _dequantized(qtree):
    """The float tree a quantized tree stands for (fp32 kernels)."""
    out = {k: v for k, v in qtree.items()}
    word = qtree["embedding"]["word"]
    out["embedding"] = dict(qtree["embedding"], word={
        "embedding": port_quant.dequantize_tensor(word["embedding"],
                                                  word["scale"], -1)})
    out["layers"] = {}
    for name, p in qtree["layers"].items():
        if "scale" in p:
            p = {"kernel": port_quant.dequantize_tensor(p["kernel"],
                                                        p["scale"], -2),
                 "bias": p["bias"]}
        out["layers"][name] = p
    return out


_EOS = 7


def _requests(vocab):
    rng = np.random.RandomState(0)
    lens, mnt = (5, 17, 9, 30, 3, 12), (8, 5, 10, 6, 9, 7)
    return [(tuple(int(t) for t in rng.randint(2, vocab, size=n)), m)
            for n, m in zip(lens, mnt)]


def test_w8_greedy_streams_identical_to_jax(trees):
    cfg = jax_gpt.gpt_tiny()
    jq, pp = trees["f32"]
    reqs = _requests(cfg.vocab_size)
    jeng = jax_serving.DecodeEngine(jq, cfg, num_slots=2, max_len=S_MAX,
                                    cache_dtype=jnp.float32)
    jsched = jax_serving.ContinuousBatchingScheduler(jeng, eos_id=_EOS)
    for p, m in reqs:
        jsched.submit(jax_serving.Request(prompt=p, max_new_tokens=m))
    want = jsched.run()

    pcfg = port_gpt.gpt_tiny()
    pq = port_quant.quantize_params(pp)
    with torch.inference_mode():
        # guard: every greedy choice wins by a clear top-2 margin, so a
        # near-tie cannot flip under fp32 reordering
        deq = _dequantized(pq)
        for (p, _), toks in zip(reqs, want):
            seq = torch.tensor([list(p) + toks[:-1]])
            top2 = _full_logits(deq, pcfg, seq)[0, len(p) - 1:].topk(2).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
        peng = port_serving.DecodeEngine(pq, pcfg, num_slots=2,
                                         max_len=S_MAX,
                                         cache_dtype=torch.float32,
                                         device="cpu")
        psched = port_serving.ContinuousBatchingScheduler(peng, eos_id=_EOS)
        for p, m in reqs:
            psched.submit(port_serving.Request(prompt=p, max_new_tokens=m))
        got = psched.run()
    assert got == want
    for i in range(len(reqs)):
        a, b = psched.outcomes[i], jsched.outcomes[i]
        assert (a.tokens, a.reason, a.ttft_ticks, a.total_ticks) == \
            (b.tokens, b.reason, b.ttft_ticks, b.total_ticks)


def test_both_engines_reject_an_int8_dense_cache(trees):
    cfg = jax_gpt.gpt_tiny()
    jq, pp = trees["f32"]
    with pytest.raises(ValueError) as want:
        jax_serving.DecodeEngine(jq, cfg, num_slots=2, max_len=S_MAX,
                                 cache_dtype=jnp.int8)
    with pytest.raises(ValueError) as got:
        port_serving.DecodeEngine(port_quant.quantize_params(pp),
                                  port_gpt.gpt_tiny(), num_slots=2,
                                  max_len=S_MAX, cache_dtype=torch.int8,
                                  device="cpu")
    assert str(got.value) == str(want.value)
    assert "PagedDecodeEngine" in str(got.value)


def test_o2_cast_after_quantize_raises_in_both(trees):
    """O2 after quantizing casts the fp32 scales to bf16: both engines
    refuse them at the first w8 product."""
    cfg = jax_gpt.gpt_tiny()
    jq, pp = trees["f32"]
    jbad = jax_amp.initialize("O2", verbosity=0).cast_model(jq)
    pbad = port_amp.initialize("O2", verbosity=0).cast_model(
        port_quant.quantize_params(pp))
    assert pbad["layers"]["qkv"]["kernel"].dtype == torch.int8
    assert pbad["layers"]["qkv"]["scale"].dtype == torch.bfloat16
    jeng = jax_serving.DecodeEngine(jbad, cfg, num_slots=2, max_len=S_MAX)
    peng = port_serving.DecodeEngine(pbad, port_gpt.gpt_tiny(), num_slots=2,
                                     max_len=S_MAX, device="cpu")
    with pytest.raises(ValueError) as want:
        jeng.prefill(0, [5, 6, 7])
    with torch.inference_mode(), pytest.raises(ValueError) as got:
        peng.prefill(0, [5, 6, 7])
    assert str(got.value) == str(want.value)
    assert "scale must be fp32, got bfloat16" in str(got.value)
