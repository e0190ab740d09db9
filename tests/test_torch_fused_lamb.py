"""Port parity: ``apex_tpu_torch.optimizers.FusedLAMB`` (tree path and
flat path) against the JAX package's, on the CPU (the JAX flat path runs
its Pallas kernels in interpret mode, the port its plain versions), over
the parametrisation of the JAX package's own LAMB test
(``tests/L0/run_optimizers/test_fused_optimizers.py``): weight decay
0.01; ``adam_w_mode=False``; no weight decay with NVLAMB; and
``max_grad_norm=0.05``, where the clip engages. Inputs come from a numpy
seed.

The gradients are small integers times 2^-10, so their squares and every
partial sum of them are exact in fp32: the global norm, and so the clip,
is the same number in any sum order. Tolerances then:

- m and v on the tree path bit for bit (the same fp32 operations in the
  same order, eager on both sides); on the flat path within 8 ulps (XLA
  contracts multiply-adds of the interpreted kernel into FMAs), a bf16 m
  within one bf16 ulp;
- params to LAMB's error model: the trust ratio ``||p|| / ||u||`` comes
  from sums of squares taken in other orders, so p may differ by ``lr
  ratio |u|`` times the ratio's relative limit (each side's norm^2 within
  (n + 1) u of exact for n squares in two levels of the flat path's
  sums or one of the tree path's, n counted as 1,025 k for a tensor of k
  sub-tiles; two sqrt and a division; 32 u more for u's and the
  product's roundings), plus an ulp of p a side. u and the ratio are
  computed in float64 from the JAX side's new m and v.

A second step with ``found_inf`` True must leave params, m, v, the step
count and the emitted compute tree exactly as they were."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu_torch.multi_tensor_apply.flatten import (
    make_spec, unflatten_tensors,
)
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.utils.math import cdiv
from apex_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map

_U = 2.0 ** -24
LR = 1e-2
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(seed, grads=False):
    """A nested tree whose dict keys are not in sorted order, with sizes
    that are not multiples of 128 and a 0-d leaf; gradients are small
    integers times 2^-10 (exact squares and sums, and exact in bf16)."""
    rng = np.random.RandomState(seed)

    def draw(*shape):
        if grads:
            return (rng.randint(-8, 9, size=shape) * 2.0 ** -10).astype(
                np.float32)
        return np.asarray(rng.randn(*shape), np.float32)

    return {"zeta": {"kernel": draw(9, 40), "bias": draw(40)},
            "alpha": [draw(3, 130), draw(), {"w": draw(1100)}],
            "mid": draw(7, 3, 5)}


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_leaves(tree):
    return [_to_torch(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return tree_flatten(tree)[0]     # JAX's order


_KW = [dict(weight_decay=0.01),
       dict(weight_decay=0.01, adam_w_mode=False),
       dict(weight_decay=0.0, use_nvlamb=True),
       dict(weight_decay=0.01, max_grad_norm=0.05),
       dict(weight_decay=0.01, bias_correction=False),
       dict(weight_decay=0.01, grad_averaging=False)]
_KW_IDS = ["wd", "l2", "nvlamb_no_wd", "clip", "no_bias_correction",
           "no_grad_averaging"]


def _p_limit(jprev, jm, jv, jnew, kw):
    """LAMB's error model for step 1 (module docstring), per leaf."""
    wd = kw.get("weight_decay", 0.01)
    aw = kw.get("adam_w_mode", True)
    c1, c2 = (1.0 - 0.9, 1.0 - 0.999) if kw.get("bias_correction", True) \
        else (1.0, 1.0)
    out = []
    for p, m, v, pn in zip(jprev, jm, jv, jnew):
        p, m, v = p.double(), m.double(), v.double()
        u = (m / c1) / (torch.sqrt(v / c2) + 1e-6) + (wd * p if aw else 0.0)
        wn, un = float(p.norm()), float(u.norm())
        ratio = wn / un if wn > 0 and un > 0 else 1.0
        if wd == 0.0 and not kw.get("use_nvlamb", False):
            ratio = 1.0
        k = cdiv(max(p.numel(), 1), 1024)
        rel = 2 * (1025 * k + 1) * _U + 4 * _U + 32 * _U
        ulp = 2 * _U * pn.double().abs()
        out.append(LR * ratio * u.abs() * rel + ulp + 1e-12)
    return out


def _compute_kw(emit, compute):
    return dict(compute_params=compute) if emit else {}


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
@pytest.mark.parametrize("m_dtype,emit", [("f32", False), ("bf16", True)])
@pytest.mark.parametrize("kw", _KW, ids=_KW_IDS)
def test_fused_lamb_matches_jax(flat, m_dtype, emit, kw):
    """One step with found_inf False, then one with found_inf True."""
    opt_kw = dict(lr=LR, use_flat_kernel=flat, emit_compute_params=emit,
                  **kw)
    jopt = JaxLAMB(m_dtype=_JDT[m_dtype], **opt_kw)
    popt = FusedLAMB(m_dtype=_TDT[m_dtype], **opt_kw)
    tree = _tree(1)
    jp = jax.tree.map(jnp.asarray, tree)
    pp = _torch_tree(tree)
    js, ps = jopt.init(jp), popt.init(pp)

    def compute(t, to):   # bf16 but for one kept-fp32 leaf
        c = tree_map(to, t)
        c["mid"] = t["mid"]
        return c

    jc = compute(jp, lambda a: a.astype(jnp.bfloat16))
    pc = compute(pp, lambda a: a.to(torch.bfloat16))
    g = _tree(2, grads=True)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
    pg = tree_map(lambda a: _to_torch(np.asarray(jnp.asarray(
        a, jnp.bfloat16))), g)
    jout = jopt.step(jg, jp, js, found_inf=jnp.asarray(False),
                     **_compute_kw(emit, jc))
    pout = popt.step(pg, pp, ps, found_inf=torch.tensor(False),
                     **_compute_kw(emit, pc))
    (jp1, js1), (pp1, ps1) = jout[:2], pout[:2]
    assert int(ps1.step) == int(js1.step) == 1
    assert list(pp1) == list(pp)           # dict order kept
    # m and v
    if flat:
        assert ps1.m.dtype == _TDT[m_dtype] and ps1.m.shape == js1.m.shape
        pairs = [(ps1.m, _to_torch(np.asarray(js1.m))),
                 (ps1.v, _to_torch(np.asarray(js1.v)))]
        for got, want in pairs:
            lim = 8 * _U * want.float().abs() + (
                2 ** -7 * want.float().abs() if m_dtype == "bf16" else 0.0)
            assert bool(((got.float() - want.float()).abs() <= lim).all())
        jm, jv = _flat_leaves(js1.m, pp), _flat_leaves(js1.v, pp)
    else:
        jm, jv = _jax_leaves(js1.m), _jax_leaves(js1.v)
        for want, got in zip(jm, _port_leaves(ps1.m)):
            assert got.dtype == _TDT[m_dtype] and torch.equal(got, want)
        for want, got in zip(jv, _port_leaves(ps1.v)):
            assert torch.equal(got, want)
    # params
    jnew = _jax_leaves(jp1)
    lims = _p_limit(_port_leaves(pp), jm, jv, jnew, kw)
    for want, got, lim in zip(jnew, _port_leaves(pp1), lims):
        assert got.dtype == want.dtype
        assert bool(((got.double() - want.double()).abs() <= lim).all())
    assert not all(torch.equal(a, b) for a, b in zip(
        _port_leaves(pp1), _port_leaves(pp)))
    if emit:
        pc1 = pout[2]
        for c, p1, tmpl, w in zip(_port_leaves(pc1), _port_leaves(pp1),
                                  _port_leaves(pc), _jax_leaves(jout[2])):
            assert c.dtype == tmpl.dtype and torch.equal(c, p1.to(c.dtype))
            torch.testing.assert_close(c.float(), w.float(), rtol=2 ** -7,
                                       atol=1e-9)
    # a skipped step changes nothing, the step count included
    g_bad = tree_map(lambda t: torch.full_like(t, float("inf")), pg)
    skip = popt.step(g_bad, pp1, ps1, found_inf=torch.tensor(True),
                     **_compute_kw(emit, pout[2] if emit else None))
    pp2, ps2 = skip[:2]
    assert int(ps2.step) == 1
    for a, b in zip(tree_leaves(pp2), tree_leaves(pp1)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ps2.m) + tree_leaves(ps2.v),
                    tree_leaves(ps1.m) + tree_leaves(ps1.v)):
        assert torch.equal(a, b)
    if emit:
        for a, b in zip(tree_leaves(skip[2]), tree_leaves(pout[2])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _flat_leaves(buf, like):
    """A JAX flat buffer's leaves, fp32, laid out over ``like``'s."""
    leaves, _ = tree_flatten(like)
    return unflatten_tensors(_to_torch(np.asarray(buf)).float(),
                             make_spec(leaves), cast_back=False)


@pytest.mark.parametrize("kw", _KW, ids=_KW_IDS)
def test_flat_path_matches_tree_path(kw):
    """Three steps of the port's flat path against its tree path, as the
    JAX package holds its own (rtol 1e-5, atol 1e-6: the ratio's sums in
    other orders, and beta3 = 1 - beta1 rounded from float64 on the flat
    path, in fp32 on the tree path, as in JAX)."""
    params = _torch_tree(_tree(3))
    states = {}
    for flat in (False, True):
        opt = FusedLAMB(lr=LR, use_flat_kernel=flat, **kw)
        p, s = params, opt.init(params)
        for step in range(3):
            g = _torch_tree(_tree(10 + step, grads=True))
            p, s = opt.step(g, p, s)
        states[flat] = p
    for a, b in zip(_port_leaves(states[True]), _port_leaves(states[False])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_unported_options_raise():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(amsgrad=True)
    with pytest.raises(ValueError, match="m_dtype"):
        FusedLAMB(m_dtype=torch.float16, use_flat_kernel=True)
