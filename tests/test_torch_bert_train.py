"""Port parity: the BERT O2 training step of ``apex_tpu_torch`` against
the JAX package's ``bench.py::_bert_step`` on ``bert_tiny``, on the CPU
(the port runs its kernels' plain versions; the JAX package its Pallas
kernels in interpret mode, or its unfused attention at this length).

Both start from the same weights (``init_bert`` in JAX, carried across
by ``params_from_jax``) and the same ids. Three configurations: the
default (flash attention, the tree-path FusedAdam); the unfused
attention (``fused_attention=False``: the fused softmax kernels) with
the flat FusedAdam (``use_flat_kernel=True``: the ``flat_adam`` kernel);
and flash attention with the flat FusedLAMB (``FusedLAMB(lr=1e-3,
weight_decay=0.01, use_flat_kernel=True)``, the JAX package's BERT-Large
LAMB setting, swapped into ``_bert_step`` on the JAX side). Flat m and v
are compared leaf by leaf through the JAX layout.

Tolerances. O0 (fp32 compute): loss within 1e-6 relative, every
gradient, m and v within 1e-5 in relative norm (sums in other orders),
and master per element to Adam's own error model (``_adam_limit``):
the update u = m^ / (sqrt(v^) + eps) is computed in float64 from each
side's new m and v, and master may differ by the previous step's master
difference (carried through the weight decay) plus lr |u_jax - u_port|
plus fp32 roundings, with a floor of 1e-6. Near a gradient within a
few eps of zero u is steep (du/dg = eps / (|g| + eps)^2 on the first
step), so a gradient that differs by its sum order moves master by a
visible share of lr: on ``bert_tiny`` a first-step gradient of 9.3e-9
in JAX and 8.7e-9 here gives u 0.479 against 0.466, master 1.34e-6
apart, which a fixed 1e-6 cannot hold. O2 (bf16 compute): the two frameworks round
activations to bf16 at different places (XLA keeps fused intermediates
in fp32; at this length JAX attends through its unfused path while the
port runs the kernels' numerics), so the loss is held within 2e-4
relative (4.4e-5 measured), each gradient and m within 0.05 in relative
norm and v within 0.1 (1.3 %, 1.3 % and 2.5 % measured). An Adam step
moves a leaf by at most about lr (|m^|/sqrt(v^) is 1 on the first
step), and a gradient near zero may change sign between the two, so
master is held within 2 lr per step. found_inf, the scaler state and
the step count are equal.

With a bf16 first moment, O0 holds m within M_BF16_STRICT in relative
norm: fp32 moments within r = 1e-5 of each other, each rounded once to
bf16, land one ulp (<= 2^-7 |m|) apart where a rounding boundary lies
between them, which happens with a chance of about |a - b| / ulp; that
adds about sqrt(2^-7 r) to the relative norm (Cauchy-Schwarz over
sum |m| |a - b|). That estimate needs many elements: a LAMB bias of 128
elements with one such flip reads 5.3e-4, so the flat-LAMB cases hold a
bf16 m per element instead: the fp32 moments' difference, at most 1e-5
of the leaf's norm, plus one bf16 ulp (2^-7 |m|). Bit-equal m is held
where the inputs are equal: ``test_torch_fused_adam.py`` steps both
optimizers on the same gradients and compares m bit for bit.

LAMB's master is held per element, in O0 and O2, to its own error model
(``_lamb_limit``): each side's step p - lr ratio u is recomputed in
float64 from its own previous master, m and v (u = m^ / (sqrt(v^) + eps)
+ wd p, the ratio ||p|| / ||u|| over the leaf), and the two may differ by
the difference of those float64 results plus each side's fp32 roundings:
the ratio's sums of squares ((1024 + k) u for the flat path's two levels
over a leaf of k sub-tiles, plus 3 u), 16 u of u (2^-8 more with a bf16
m), 2 u of the product and an ulp of p. A gradient near zero that
changes sign moves an element by up to 2 lr ratio, and the model carries
it exactly, so no fixed limit is needed."""

import dataclasses
import functools
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu import optimizers as jax_optimizers
from apex_tpu.models import bert as jax_bert
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.examples.bert.train import make_bert_train_step
from apex_tpu_torch.multi_tensor_apply.flatten import (
    make_spec, unflatten_tensors,
)
from apex_tpu_torch.utils.math import cdiv
from apex_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
LR = 1e-4
M_BF16_STRICT = 1e-5 + (2 ** -7 * 1e-5) ** 0.5   # ~2.9e-4; docstring


def _bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module("bench")


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _by_path(tree, path=()):
    """{path: leaf}, dict keys sorted (JAX flattens dicts that way)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, path + (i,)))
        return out
    return {path: tree}


def _pairs(jax_tree, port_tree):
    a, b = _by_path(_port(jax_tree)), _by_path(port_tree)
    assert a.keys() == b.keys()
    return [(a[k], b[k]) for k in a]


def _relnorm(want, got):
    want, got = want.double(), got.double()
    n = float(want.norm())
    return float((got - want).norm()) / (n if n > 0 else 1.0)


WD, _U = 0.01, 2.0 ** -24   # the steps' FusedAdam weight decay; fp32 ulp


def _moment(x, like):
    """{path: leaf} of an Adam moment (torch): a tree, or a flat buffer
    laid out over the leaves of ``like`` ({path: master leaf}, paths in
    JAX's order)."""
    if isinstance(x, torch.Tensor):
        spec = make_spec(list(like.values()))
        return dict(zip(like, unflatten_tensors(x, spec, cast_back=False)))
    return _by_path(x)


def _print_worst(t, lims, jout, pout, jgrads, pgrads):
    """Print the master element that uses most of its ``_adam_limit``
    (``pytest -s`` shows it), with both sides' gradient and update u
    there."""
    err = {k: (g - w).abs().double() for k, (w, g) in zip(
        _by_path(pout[0]), _pairs(jout[0], pout[0]))}
    use = {k: float((e / lims[k]).max()) for k, e in err.items()}
    k = max(use, key=use.get)
    i = int((err[k] / lims[k]).reshape(-1).argmax())
    c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
    like = _by_path(pout[0])
    at = []
    for grads, st in ((_port(jgrads), (_port(jout[1].m), _port(jout[1].v))),
                      (pgrads, (pout[1].m, pout[1].v))):
        m, v = (float(_moment(x, like)[k].reshape(-1)[i]) for x in st)
        at.append((float(_by_path(grads)[k].reshape(-1)[i]),
                   (m / c1) / ((v / c2) ** 0.5 + 1e-8)))
    print(f"step {t}: master {k}[{i}] uses {use[k]:.3f} of its limit: "
          f"|dp| {float(err[k].reshape(-1)[i]):.4g}; g jax {at[0][0]:.4g}, "
          f"port {at[1][0]:.4g}; u jax {at[0][1]:.4g}, port {at[1][1]:.4g}")


def _adam_limit(t, jprev, pprev, jstate, pstate):
    """{path: per-element limit on |master_port - master_jax|} after
    Adam step ``t`` (O0; the module docstring): the previous master
    difference through the weight decay, plus lr |u_jax - u_port| with u
    from each side's new m and v in float64, plus the fp32 roundings of
    u (16 ulps; a bf16 m stored rounded adds 2^-8 of |u|) and of p -
    lr u (an ulp a side), at least 1e-6."""
    prev_j, prev_p = _by_path(_port(jprev)), _by_path(pprev)
    c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
    bf16m = tree_leaves(pstate.m)[0].dtype == torch.bfloat16
    us = []
    for m, v in ((_port(jstate.m), _port(jstate.v)), (pstate.m, pstate.v)):
        m, v = _moment(m, prev_p), _moment(v, prev_p)
        us.append({k: (m[k].double() / c1) / (
            torch.sqrt(v[k].double() / c2) + 1e-8) for k in prev_p})
    out = {}
    for k, pp in prev_p.items():
        pp, pj = pp.double(), prev_j[k].double()
        uj, up = us[0][k], us[1][k]
        r_u = (16 * _U + (2 ** -8 if bf16m else 0.0)) * (uj.abs() + up.abs())
        r_p = 2 * _U * (pj.abs() + pp.abs() + 2 * LR)
        out[k] = torch.clamp((pp - pj).abs() * (1 + LR * WD) + LR * (
            (uj - up).abs() + r_u) + r_p, min=1e-6)
    return out


LAMB_LR, LAMB_EPS = 1e-3, 1e-6   # the flat FusedLAMB configuration's


def _lamb_limit(t, jprev, pprev, jstate, pstate):
    """{path: per-element limit on |master_port - master_jax|} after
    LAMB step ``t`` (the module docstring)."""
    prev_j, prev_p = _by_path(_port(jprev)), _by_path(pprev)
    c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
    bf = 2 ** -8 if tree_leaves(pstate.m)[0].dtype == torch.bfloat16 \
        else 0.0
    sides = []
    for prev, (m, v) in ((prev_j, (_port(jstate.m), _port(jstate.v))),
                         (prev_p, (pstate.m, pstate.v))):
        m, v = _moment(m, prev_p), _moment(v, prev_p)
        new = {}
        for k, p in prev.items():
            p = p.double()
            u = (m[k].double() / c1) / (torch.sqrt(v[k].double() / c2)
                                        + LAMB_EPS) + WD * p
            wn, un = float(p.norm()), float(u.norm())
            r = wn / un if wn > 0 and un > 0 else 1.0
            new[k] = (p - LAMB_LR * r * u, LAMB_LR * r * u.abs())
        sides.append(new)
    out = {}
    for k, p in prev_p.items():
        (pj, sj), (pp, sp) = sides[0][k], sides[1][k]
        n_sub = cdiv(max(p.numel(), 1), 1024) + 32   # + the buffer's tail
        rel = (1024 + n_sub + 3 + 16 + 2) * _U + bf
        out[k] = (pp - pj).abs() + (sj + sp) * rel + 2 * _U * (
            pj.abs() + pp.abs())
    return out


def test_init_bert_tree_matches_jax():
    cfg = jax_bert.bert_tiny()
    want = _by_path(jax_bert.init_bert(jax.random.PRNGKey(0), cfg))
    got = port_bert.init_bert(port_bert.bert_tiny(),
                              torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(got["encoder"], list)
    got = _by_path(got)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(w.dtype), path
    got = {"embeddings": {"word": {"embedding": got[
        ("embeddings", "word", "embedding")]}}}
    # truncated normal, stddev 0.02, within 2 stddev
    word = got["embeddings"]["word"]["embedding"]
    assert float(word.abs().max()) <= 0.04
    assert abs(float(word.std()) - 0.0176) < 2e-3   # 0.02 * 0.88 (cut at 2)


@pytest.mark.parametrize("name", ["lecun_normal", "trunc_normal"])
def test_init_draws_match_jax_distribution(name):
    """The two initialisers draw from JAX's distributions (threefry bits
    cannot be reproduced, so the moments and the range are compared):
    256 x 512 draws, stddev within 2 % (sampling error ~0.3 %), mean
    within 5 sampling stddevs of 0, and the same support."""
    from apex_tpu.models import layers as jax_layers
    from apex_tpu_torch.models import layers as port_layers

    shape, fan_in = (256, 512), 256
    if name == "lecun_normal":
        want = jax_layers.lecun_normal(jax.random.PRNGKey(0), shape, fan_in)
        got = port_layers.lecun_normal(torch.Generator().manual_seed(0),
                                       shape, fan_in, device="cpu")
    else:
        want = jax_layers.trunc_normal(jax.random.PRNGKey(0), shape)
        got = port_layers.trunc_normal(torch.Generator().manual_seed(0),
                                       shape, device="cpu")
        assert float(got.abs().max()) <= 0.04   # cut at 2 stddev
    want = np.asarray(want, np.float64)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    sd = float(got.double().std())
    assert abs(sd / want.std() - 1.0) < 0.02
    assert abs(float(got.double().mean())) < 5 * sd / np.sqrt(got.numel())


def test_params_from_jax_round_trip_bitwise():
    """A bert_tiny tree (O2: bf16 leaves, fp32 norms) crosses into the
    port and back bit for bit, the encoder list included."""
    tree = jax_amp.initialize("O2", verbosity=0).cast_model(
        jax_bert.init_bert(jax.random.PRNGKey(3), jax_bert.bert_tiny()))
    port = _port(tree)
    assert isinstance(port["encoder"], list) and len(port["encoder"]) == 2
    assert port["encoder"][0]["attention"]["qkv"]["kernel"].dtype == \
        torch.bfloat16
    assert port["encoder"][1]["mlp"]["layernorm"]["weight"].dtype == \
        torch.float32

    def back(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    want, got = _by_path(tree), _by_path(port)
    assert want.keys() == got.keys()
    for path, w in want.items():
        w = np.asarray(w)
        b = back(got[path])
        assert b.dtype == w.dtype
        np.testing.assert_array_equal(b.view(np.uint8), w.view(np.uint8))
    # the GPT module still re-exports it
    assert port_gpt.params_from_jax is params_from_jax


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_apply_bert_and_mlm_loss_match_jax(level):
    cfg = jax_bert.bert_tiny()
    h = jax_amp.initialize(level, verbosity=0)
    params = h.cast_model(jax_bert.init_bert(jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S - 5:] = 0
    want = jax_bert.apply_bert(params, cfg, jnp.asarray(ids),
                               jnp.asarray(mask))
    want_loss = jax_bert.mlm_loss(want["mlm_logits"], jnp.asarray(ids),
                                  jnp.asarray(mask))
    tids = torch.from_numpy(ids.astype(np.int64))
    tmask = torch.from_numpy(mask)
    got = port_bert.apply_bert(_port(params), port_bert.bert_tiny(), tids,
                               tmask)
    got_loss = port_bert.mlm_loss(got["mlm_logits"], tids, tmask)
    assert got["mlm_logits"].dtype == torch.float32
    tol = 1e-5 if level == "O0" else 5e-2   # O2: bf16 activations
    for key in ("hidden", "mlm_logits", "pooled"):
        g = got[key].float().numpy()
        w = np.asarray(want[key]).astype(np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=1e-6 if level == "O0" else 2e-4)


def test_unported_options_raise():
    cfg = port_bert.bert_tiny()
    params = port_bert.init_bert(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    c = port_bert.BertConfig(**{**cfg.__dict__, "remat": True})
    with pytest.raises(NotImplementedError, match="remat"):
        port_bert.apply_bert(params, c, ids)
    with pytest.raises(NotImplementedError, match="dropout_rng"):
        port_bert.apply_bert(params, cfg, ids, dropout_rng=object())


def _steps(level, mode, monkeypatch, config="flash_tree"):
    """Two steps of the JAX ``_bert_step`` and the port's, from the same
    state; yields per step (jax outputs, port outputs, jax grads tuple,
    port grads tuple, jax state before, port state before).
    ``config``: ``flash_tree``; ``softmax_flat``, unfused attention
    (``fused_attention=False``) and the flat FusedAdam; or
    ``flash_lamb_flat``, the flat FusedLAMB; set on the JAX side through
    its own switches."""
    m_jax, m_port, emit = {
        "fp32": (jnp.float32, torch.float32, False),
        "bf16m_castout": (jnp.bfloat16, torch.bfloat16, True)}[mode]
    orig = jax_amp.initialize
    monkeypatch.setattr(jax_amp, "initialize",
                        lambda opt_level, **kw: orig(level, **kw))
    cfg = jax_bert.bert_tiny()
    pcfg = port_bert.bert_tiny()
    if config == "softmax_flat":
        cfg = dataclasses.replace(cfg, fused_attention=False)
        pcfg = dataclasses.replace(pcfg, fused_attention=False)
        monkeypatch.setattr(jax_optimizers, "FusedAdam", functools.partial(
            jax_optimizers.FusedAdam, use_flat_kernel=True))
    elif config == "flash_lamb_flat":
        def lamb(lr, **kw):   # _bert_step's weight decay, m_dtype, emit
            return jax_optimizers.FusedLAMB(lr=LAMB_LR, use_flat_kernel=True,
                                            **kw)

        monkeypatch.setattr(jax_optimizers, "FusedAdam", lamb)
    jstep, jmake, (jids, jmask) = _bench()._bert_step(
        B, S, cfg, m_dtype=m_jax, emit_compute=emit)
    h = jax_amp.initialize("O2", loss_scale="dynamic", verbosity=0)
    monkeypatch.undo()

    def loss_fn(p):
        out = jax_bert.apply_bert(p, cfg, jids, jmask)
        return jax_bert.mlm_loss(out["mlm_logits"], jids, jmask)

    jgrad = jax.jit(h.value_and_grad(loss_fn))
    jstep = jax.jit(jstep)
    pstep, _, _ = make_bert_train_step(
        B, S, pcfg, m_dtype=m_port, emit_compute=emit, device="cpu",
        opt_level=level, use_flat_kernel=config != "flash_tree",
        optimizer="lamb" if config == "flash_lamb_flat" else "adam")
    ids = torch.from_numpy(np.asarray(jids).astype(np.int64))
    mask = torch.from_numpy(np.array(jmask))
    jstate = list(jmake())
    master = _port(jstate[0])
    pstate = [master, pstep.opt.init(master), pstep.amp.init_state("cpu")]
    if emit:
        pstate.append(pstep.amp.cast_model(master))
    out = []
    for _ in range(2):
        jc = jstate[3] if emit else None
        jg = jgrad(h.cast_model(jstate[0], precast=jc), jstate[2])
        pg = pstep.grads(pstate[0], pstate[2], ids, mask,
                         pstate[3] if emit else None)
        jout = jstep(*jstate, jids, jmask)
        pout = pstep(*pstate, ids, mask)
        out.append((jout, pout, jg, pg, jstate, pstate))
        jstate, pstate = list(jout[:-1]), list(pout[:-1])
    return out, pstep


# (level, state mode, configuration)
_STEP_CASES = [("O2", "fp32", "flash_tree"),
               ("O2", "bf16m_castout", "flash_tree"),
               ("O0", "fp32", "flash_tree"),
               ("O0", "bf16m_castout", "flash_tree"),
               ("O0", "fp32", "softmax_flat"),
               ("O2", "bf16m_castout", "softmax_flat"),
               ("O0", "fp32", "flash_lamb_flat"),
               ("O0", "bf16m_castout", "flash_lamb_flat"),
               ("O2", "fp32", "flash_lamb_flat"),
               ("O2", "bf16m_castout", "flash_lamb_flat")]


@pytest.mark.parametrize("level,mode,config", _STEP_CASES, ids=[
    f"{l}-{m}" + ("" if c == "flash_tree" else f"-{c}")
    for l, m, c in _STEP_CASES])
def test_bert_step_matches_jax(level, mode, config, monkeypatch):
    strict = level == "O0"
    lamb = config == "flash_lamb_flat"
    results, pstep = _steps(level, mode, monkeypatch, config)
    for i, (jout, pout, jg, pg, jprev, pprev) in enumerate(results):
        (jl, jgrads, jfound, jsc), (_, pl, pgrads, pfound, psc) = jg, pg
        assert bool(jfound) is False and bool(pfound) is False
        np.testing.assert_allclose(float(pl), float(jl),
                                   rtol=1e-6 if strict else 2e-4)
        np.testing.assert_allclose(float(pout[-1]), float(jout[-1]),
                                   rtol=1e-6 if strict else 2e-4)
        for w, g in _pairs(jgrads, pgrads):
            assert g.dtype == w.dtype
            assert _relnorm(w, g) <= (1e-5 if strict else 0.05)
        # the pooler is off the loss: zero gradients on both sides
        assert all(bool((g == 0).all()) for g in tree_leaves(
            pgrads["pooler"]))
        for key in ("loss_scale", "unskipped", "overflows"):
            assert float(getattr(pout[2], key)) == float(
                getattr(jout[2], key))
        assert int(pout[1].step) == int(jout[1].step) == i + 1
        like = _by_path(pprev[0])
        for key in ("m", "v"):
            want = _moment(_port(getattr(jout[1], key)), like)
            got = _moment(getattr(pout[1], key), like)
            assert want.keys() == got.keys()
            for k, g in got.items():
                w = want[k]
                if key == "m":
                    assert g.dtype == w.dtype == pstep.opt.m_dtype
                    if lamb and strict and g.dtype == torch.bfloat16:
                        # per element: the fp32 moments' difference (at
                        # most 1e-5 of the leaf's norm) plus one bf16 ulp
                        wf = w.float()
                        lim = 2 ** -7 * wf.abs() + 1.01e-5 * wf.norm()
                        assert bool(((g.float() - wf).abs() <= lim).all())
                        continue
                    lim = M_BF16_STRICT if strict and g.dtype == \
                        torch.bfloat16 else 1e-5 if strict else 0.05
                else:
                    lim = 1e-5 if strict else 0.1
                assert _relnorm(w, g) <= lim, (key, k)
        if lamb:
            lims = _lamb_limit(i + 1, jprev[0], pprev[0], jout[1], pout[1])
            use = max(float(((g - w).abs().double() / lims[k]).max())
                      for k, (w, g) in zip(_by_path(pout[0]),
                                           _pairs(jout[0], pout[0])))
            print(f"step {i + 1}: master uses {use:.6f} of the LAMB model")
        elif strict:
            lims = _adam_limit(i + 1, jprev[0], pprev[0], jout[1], pout[1])
            _print_worst(i + 1, lims, jout, pout, jgrads, pgrads)
        for path, (w, g) in zip(_by_path(pout[0]), _pairs(jout[0],
                                                          pout[0])):
            lim = lims[path] if strict or lamb else 2 * LR * (i + 1) + 1e-7
            assert bool(((g - w).abs() <= lim).all()), path
        if mode == "bf16m_castout":
            cast = pstep.amp.cast_model(pout[0])
            for c, want in zip(tree_leaves(pout[3]), tree_leaves(cast)):
                assert c.dtype == want.dtype and torch.equal(c, want)
