"""Port parity: amp O1 (``amp/lists.py``, ``amp/autocast.py``, the rest
of ``amp/frontend.py`` and the op-policy call sites) against the JAX
package, on the CPU.

The cases mirror ``tests/L0/run_amp/test_opt_levels.py`` (the O1 policy
at :56 and :159, and the two O1 traces' contracts, counted here with a
``TorchDispatchMode`` over the port's aten products: under
``autocast()`` every product of ``bert_tiny``'s unfused forward runs in
bf16 and GPT's tied logits product does; without it none does) and
``tests/L0/run_amp/test_scaler.py`` (:89 and :115, the N-loss state
dicts).

Tolerances. The policy, the lattice and the state dicts are exact. The
gradients through the casts are exact on operands that bf16 holds
exactly (small integers times 2^-3: every product and sum is exact in
both frameworks). The O1 BERT step (``bert_tiny``, unfused attention,
the JAX step run eagerly under ``h.autocast()``) rounds its bf16
products at places of each framework's choosing, as O2 does (and XLA
fuses the jitted JAX step's elementwise ops), and is held
to the O2 step's limits of ``tests/test_torch_bert_train.py``: loss
2e-4 relative, each gradient and m within 0.05 in relative norm and v
within 0.1 (2.0 % at most measured over the three), and master within 2
lr of an Adam step. The O1 GPT loss (``gpt_tiny``: only
the logits product is bf16 there, as in JAX) within 1e-6 relative (8e-8
measured), and away from the fp32 loss by more than that (1e-5 measured)."""

import ast
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu import amp as jax_amp
from apex_tpu.amp import lists as jax_lists
from apex_tpu.models import bert as jax_bert
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch import amp as port_amp
from apex_tpu_torch.amp import lists as port_lists
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models import layers as port_layers
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, LR = 2, 16, 1e-4
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "convolution")


class ProductDtypes(TorchDispatchMode):
    """Records ``(op, operand dtypes, operand shapes)`` of every aten
    product dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            self.seen.append((name, tuple(t.dtype for t in ts),
                              tuple(tuple(t.shape) for t in ts)))
        return func(*args, **(kwargs or {}))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _by_path(tree, path=()):
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


def _relnorm(want, got):
    want, got = want.double(), got.double()
    n = float(want.norm())
    return float((got - want).norm()) / (n if n > 0 else 1.0)


# -- the tables and the context ----------------------------------------------

def test_lists_are_the_references():
    for name in ("FP16_FUNCS", "FP32_FUNCS", "CASTS", "UNWIRED"):
        assert getattr(port_lists, name) == getattr(jax_lists, name), name
    names = (jax_lists.FP16_FUNCS | jax_lists.FP32_FUNCS | jax_lists.CASTS
             | {"gelu", "tanh"})
    assert {n: port_lists.policy_for(n) for n in names} == \
        {n: jax_lists.policy_for(n) for n in names}


def _cast_args_sites():
    """The op names of every ``cast_args("...")`` call in the port."""
    out = set()
    for dirpath, _, files in os.walk(os.path.join(REPO, "apex_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            out |= {n.args[0].value for n in ast.walk(tree)
                    if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "cast_args"
                    and n.args and isinstance(n.args[0], ast.Constant)}
    return out


def test_unwired_is_the_ops_without_a_call_site():
    """Every listed op is wired (a ``cast_args`` call site in the port)
    or in ``UNWIRED``, never both: the JAX package's four sites."""
    listed = port_lists.FP16_FUNCS | port_lists.FP32_FUNCS | \
        port_lists.CASTS
    wired = _cast_args_sites()
    assert wired == {"dense", "conv2d", "matmul", "einsum"}
    assert wired == listed - port_lists.UNWIRED


def test_o1_autocast_policy():
    """``run_amp/test_opt_levels.py::test_o1_autocast_policy``."""
    h = port_amp.initialize("O1", verbosity=0)
    x = torch.ones((2, 2))
    with h.autocast():
        (mm_x,) = port_amp.cast_args("matmul", x)
        assert mm_x.dtype == torch.bfloat16
        (sm_x,) = port_amp.cast_args("softmax", x.to(torch.bfloat16))
        assert sm_x.dtype == torch.float32
        a, b = port_amp.cast_args("add", x, x.to(torch.bfloat16))
        assert a.dtype == b.dtype == torch.float32
        ids = torch.zeros(2, dtype=torch.long)
        (same,) = port_amp.cast_args("matmul", ids)
        assert same is ids
    (y,) = port_amp.cast_args("matmul", x)
    assert y is x


def test_o1_einsum_policy():
    """``run_amp/test_opt_levels.py::test_o1_einsum_policy``."""
    h = port_amp.initialize("O1", verbosity=0)
    x = torch.ones((2, 4))
    with h.autocast():
        a, b = port_amp.cast_args("einsum", x, x)
        assert a.dtype == b.dtype == torch.bfloat16
    a, b = port_amp.cast_args("einsum", x, x)
    assert a.dtype == torch.float32


_DT = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
       torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.mark.parametrize("a", list(_DT), ids=str)
@pytest.mark.parametrize("b", list(_DT), ids=str)
def test_widest_is_jax_lattice(a, b):
    """``promote`` ops cast to JAX's promotion of the dtypes (f16 + bf16
    is f32), a 0-d tensor counting as much as any other."""
    from apex_tpu.amp.autocast import _widest as jax_widest

    from apex_tpu_torch.amp.autocast import _widest

    want = jnp.dtype(jax_widest([_DT[a], _DT[b]]))
    got = _widest([a, b])
    assert jnp.dtype(_DT[got]) == want
    with port_amp.autocast(torch.bfloat16):
        x, s = port_amp.cast_args("mul", torch.ones(3, dtype=a),
                                  torch.tensor(2.0, dtype=b))
    assert x.dtype == s.dtype == got


def test_context_nests_and_is_per_thread():
    assert not port_amp.is_autocast_enabled()
    with port_amp.autocast(torch.float16):
        assert port_amp.autocast_dtype() == torch.float16
        with port_amp.autocast(enabled=False):
            assert port_amp.autocast_dtype() is None
            (x,) = port_amp.cast_args("dense", torch.ones(2))
            assert x.dtype == torch.float32
        with port_amp.autocast():
            assert port_amp.autocast_dtype() == torch.bfloat16
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            port_amp.autocast_dtype()))
        t.start()
        t.join()
        assert seen == [None]
        assert port_amp.is_autocast_enabled()
    assert port_amp.autocast_dtype() is None


def test_amp_handle_autocast_per_opt_level():
    """``Amp.autocast``: bf16 under O1 (``cast_model_type`` when set), a
    disabled context at the other levels and with ``enabled=False``."""
    for level, want in (("O0", None), ("O1", torch.bfloat16), ("O2", None),
                        ("O3", None)):
        with port_amp.initialize(level, verbosity=0).autocast():
            assert port_amp.autocast_dtype() == want, level
    with port_amp.initialize("O1", cast_model_type=torch.float16,
                             verbosity=0).autocast():
        assert port_amp.autocast_dtype() == torch.float16
    with port_amp.initialize("O1", enabled=False, verbosity=0).autocast():
        assert port_amp.autocast_dtype() is None


def test_master_params_per_opt_level():
    params = {"dense": {"kernel": torch.ones((2, 2), dtype=torch.bfloat16)},
              "step": torch.zeros((), dtype=torch.int32)}
    m = port_amp.initialize("O2", verbosity=0).master_params(params)
    assert m["dense"]["kernel"].dtype == torch.float32
    assert m["step"].dtype == torch.int32
    assert port_amp.initialize("O1", verbosity=0).master_params(
        params) is params


# -- the N-loss state dicts (run_amp/test_scaler.py:89, :115) ----------------

def test_amp_multi_loss_state_dict_roundtrip():
    h = port_amp.initialize("O2", loss_scale="dynamic", num_losses=3,
                            verbosity=0)
    jh = jax_amp.initialize("O2", loss_scale="dynamic", num_losses=3,
                            verbosity=0)
    states = h.init_state("cpu")
    assert isinstance(states, tuple) and len(states) == 3
    states = (states[0], h.update_scale(states[1], torch.tensor(True)),
              states[2])
    jst = jh.init_state()
    jst = (jst[0], jh.update_scale(jst[1], jnp.asarray(True)), jst[2])
    d = h.state_dict(states)
    assert d == jh.state_dict(jst)
    assert set(d) == {"loss_scaler0", "loss_scaler1", "loss_scaler2"}
    back = h.load_state_dict(d, "cpu")
    assert float(back[1].loss_scale) == 2.0 ** 15
    assert float(back[0].loss_scale) == 2.0 ** 16

    h1 = port_amp.initialize("O2", loss_scale="dynamic", verbosity=0)
    s = h1.init_state("cpu")
    assert not isinstance(s, tuple)
    assert set(h1.state_dict(s)) == {"loss_scaler0"}
    assert not isinstance(h1.load_state_dict(h1.state_dict(s), "cpu"),
                          tuple)


def test_amp_load_state_dict_count_mismatch_warns_and_loads_overlap():
    h3 = port_amp.initialize("O2", loss_scale="dynamic", num_losses=3,
                             verbosity=0)
    states = h3.init_state("cpu")
    states = (h3.update_scale(states[0], torch.tensor(True)),) + states[1:]
    d3 = h3.state_dict(states)
    with pytest.warns(UserWarning, match="loss_scaler"):
        back = h3.load_state_dict({"loss_scaler0": d3["loss_scaler0"]},
                                  "cpu")
    assert isinstance(back, tuple) and len(back) == 3
    assert float(back[0].loss_scale) == 2.0 ** 15
    assert float(back[1].loss_scale) == 2.0 ** 16
    h1 = port_amp.initialize("O2", loss_scale="dynamic", verbosity=0)
    with pytest.warns(UserWarning, match="loss_scaler"):
        one = h1.load_state_dict(d3, "cpu")
    assert not isinstance(one, tuple)
    assert float(one.loss_scale) == 2.0 ** 15


# -- the call sites ----------------------------------------------------------

def _bert_unfused(jax_side=False):
    mod = jax_bert if jax_side else port_bert
    return dataclasses.replace(mod.bert_tiny(), fused_attention=False)


def test_o1_bert_unfused_products_are_bf16():
    """``test_o1_bert_unfused_attention_traces_bf16``'s contract: every
    product of the forward runs in bf16 under ``autocast()`` (the two
    attention products of each layer among them), none without."""
    cfg = _bert_unfused()
    params = port_bert.init_bert(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    ids = torch.zeros((2, 16), dtype=torch.long)
    h = port_amp.initialize("O1", verbosity=0)
    with h.autocast(), ProductDtypes() as hot:
        port_bert.apply_bert(params, cfg, ids)["mlm_logits"]
    with ProductDtypes() as cold:
        port_bert.apply_bert(params, cfg, ids)["mlm_logits"]
    assert hot.seen and all(set(d) == {torch.bfloat16}
                            for _, d, _ in hot.seen)
    assert sum(op == "bmm" for op, _, _ in hot.seen) == 2 * cfg.num_layers
    assert len(cold.seen) == len(hot.seen)
    assert all(set(d) == {torch.float32} for _, d, _ in cold.seen)


def test_o1_gpt_logits_product_is_bf16():
    """``test_o1_gpt_logits_matmul_traces_bf16``'s contract: the tied
    logits product (its right operand the (h, vocab) table) runs in bf16
    under ``autocast()`` and in fp32 without; the layers' own products
    do not take the policy, as in JAX."""
    cfg = port_gpt.gpt_tiny()
    params = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    ids = torch.zeros((2, 16), dtype=torch.long)

    def logits(seen, dtype):
        return [d for _, d, s in seen
                if s[1][-2:] == (cfg.hidden_size, cfg.vocab_size)
                and set(d) == {dtype}]

    with port_amp.initialize("O1", verbosity=0).autocast(), \
            ProductDtypes() as hot:
        port_gpt.gpt_loss_unsharded(params, cfg, ids, ids)
    with ProductDtypes() as cold:
        port_gpt.gpt_loss_unsharded(params, cfg, ids, ids)
    assert logits(hot.seen, torch.bfloat16)
    assert not logits(cold.seen, torch.bfloat16)
    assert logits(cold.seen, torch.float32)
    layer_products = [d for _, d, s in hot.seen
                      if s[1][-2:] != (cfg.hidden_size, cfg.vocab_size)]
    assert layer_products and all(set(d) == {torch.float32}
                                  for d in layer_products)


def test_dense_and_conv_under_autocast_match_jax_exactly():
    """The cast sites of ``models/layers.py``: bf16 outputs under
    ``autocast`` (the bias cast to the product's dtype), fp32 gradients
    to the fp32 leaves equal to ``jax.grad``'s under autocast, and the
    identity outside. Operands are halves in [-1, 1] and the loss weighs
    the outputs by integers in [-1, 1], so every bf16 product and sum,
    forward and backward, is exact on both sides."""
    from apex_tpu.models import layers as jax_layers

    rng = np.random.RandomState(0)

    def q(*shape, scale=0.5):
        return (rng.randint(-2, 3, size=shape) * scale).astype(np.float32)

    dp = {"kernel": q(8, 4), "bias": q(4)}
    cp = {"kernel": q(3, 3, 2, 4)}
    x, xc = q(2, 3, 8), q(1, 5, 5, 2)
    wd, wc = q(2, 3, 4, scale=1.0) / 2, q(1, 5, 5, 4, scale=1.0) / 2

    def jloss(p, x, xc):
        yd = jax_layers.dense(p["d"], x).astype(jnp.float32)
        yc = jax_layers.conv(p["c"], xc).astype(jnp.float32)
        return jnp.sum(yd * wd) + jnp.sum(yc * wc)

    jp = {"d": dp, "c": cp}
    with jax_amp.autocast(jnp.bfloat16):
        assert jax_layers.dense(dp, jnp.asarray(x)).dtype == jnp.bfloat16
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(xc))
    pp = _port(jp)
    for t in tree_leaves(pp):
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    txc = torch.from_numpy(xc).requires_grad_(True)
    with port_amp.autocast():
        yd = port_layers.dense(pp["d"], tx)
        yc = port_layers.conv(pp["c"], txc)
        assert yd.dtype == yc.dtype == torch.bfloat16
        loss = (yd.float() * torch.from_numpy(wd)).sum() + \
            (yc.float() * torch.from_numpy(wc)).sum()
    got = torch.autograd.grad(loss, tree_leaves(pp) + [tx, txc])
    want = tree_leaves(_port(jg[0])) + [torch.from_numpy(np.array(g))
                                        for g in jg[1:]]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 == w.dtype
        assert torch.equal(g, w)
    assert port_layers.dense(pp["d"], tx).dtype == torch.float32


def test_remat_recompute_reenters_the_forward_context():
    """``BertConfig(remat=True)`` under ``autocast``: the backward may
    run on another thread (the CUDA autograd engine's), whose context is
    empty; the recompute re-enters the forward's, so the gradients are
    the unrematerialised ones bit for bit."""
    cfg = _bert_unfused()
    params = port_bert.init_bert(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        from apex_tpu_torch.utils.tree import tree_map
        p = tree_map(lambda _: next(it), params)
        with port_amp.autocast():
            loss = port_bert.mlm_loss(
                port_bert.apply_bert(p, c, ids)["mlm_logits"], ids,
                torch.ones_like(ids))
        out = []
        t = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, leaves, allow_unused=True)))
        t.start()
        t.join()
        grads[remat] = out[0]
    for a, b in zip(grads[False], grads[True]):
        assert (a is None and b is None) or torch.equal(a, b)


# -- the O1 step and loss against the JAX package -----------------------------

def test_o1_bert_step_matches_jax():
    """One O1 step of ``bert_tiny`` (unfused attention, FusedAdam(lr=
    1e-4, weight_decay=0.01)) through ``make_bert_train_step(opt_level=
    "O1")``, whose forward runs inside ``h.autocast()``, against the JAX
    step traced under its ``h.autocast()`` (the context is read at trace
    time; jitted, 4 s here against 22 s op by op), at the module's
    tolerances."""
    from apex_tpu_torch.examples.bert.train import make_bert_train_step

    jcfg = _bert_unfused(jax_side=True)
    params = jax_bert.init_bert(jax.random.PRNGKey(0), jcfg)
    step, _, (ids, mask) = make_bert_train_step(
        B, S, _bert_unfused(), device="cpu", opt_level="O1")
    assert step.amp.properties.patch_torch_functions
    jids, jmask = jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy())
    jh = jax_amp.initialize("O1", loss_scale="dynamic", verbosity=0)
    jopt = JaxAdam(lr=LR, weight_decay=0.01)

    def jloss(p):
        out = jax_bert.apply_bert(p, jcfg, jids, jmask)
        return jax_bert.mlm_loss(out["mlm_logits"], jids, jmask)

    with jh.autocast():   # read while jit traces the step
        jl, jg, jf, jsc = jax.jit(jh.value_and_grad(jloss))(
            params, jh.init_state())
    jm, jo = jax.jit(lambda g, p, s, f: jopt.step(g, p, s, found_inf=f))(
        jg, params, jopt.init(params), jf)

    master = _port(params)
    state = (master, step.opt.init(master), step.amp.init_state("cpu"))
    _, _, pg, pf, _ = step.grads(master, state[2], ids, mask)
    pm, po, psc, pl = step(*state, ids, mask)
    assert not bool(pf) and not bool(jf)
    assert (float(psc.loss_scale), int(psc.unskipped)) == \
        (float(jsc.loss_scale), int(jsc.unskipped)) == (2.0 ** 16, 1)
    assert abs(float(pl) - float(jl)) <= 2e-4 * abs(float(jl))
    for (k, w), g in zip(_by_path(_port(jg)).items(),
                         _by_path(pg).values()):
        assert g.dtype == torch.float32
        assert _relnorm(w, g) <= 0.05, k
    for name, lim in (("m", 0.05), ("v", 0.1)):
        for w, g in zip(_by_path(_port(getattr(jo, name))).values(),
                        _by_path(getattr(po, name)).values()):
            assert _relnorm(w, g) <= lim, name
    for w, g in zip(_by_path(_port(jm)).values(), _by_path(pm).values()):
        assert float((g.double() - w.double()).abs().max()) <= 2 * LR


def test_o1_gpt_loss_matches_jax():
    cfg = jax_gpt.gpt_tiny()
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), cfg)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                           size=(2, 16)).astype(np.int32)
    with jax_amp.initialize("O1", verbosity=0).autocast():
        want = float(jax_gpt.gpt_loss_unsharded(
            params, cfg, jnp.asarray(ids), jnp.asarray(ids)))
    tids = torch.from_numpy(ids.astype(np.int64))
    pcfg, pp = port_gpt.gpt_tiny(), _port(params)
    with port_amp.initialize("O1", verbosity=0).autocast():
        got = float(port_gpt.gpt_loss_unsharded(pp, pcfg, tids, tids))
    fp32 = float(port_gpt.gpt_loss_unsharded(pp, pcfg, tids, tids))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert abs(got - fp32) > 1e-6 * abs(want)
