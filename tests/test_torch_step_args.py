"""Port parity: the optimizers' step arguments (``lr=``,
``weight_decay=``, ``grad_scale=``, and LAMB's ``grad_norm=``) against
the JAX package's, on the CPU, as ``tests/L0/run_optimizers/
test_fused_optimizers.py`` steps them (``test_jit_step``'s ``lr=``).

Each of the five optimizers steps three times with ``lr`` and
``weight_decay`` overriding its constructor's (a Python number, then a
0-d tensor) and ``grad_scale=2**-16`` on gradients 2^16 times too large.
Gradients are small integers times 2^-10 before that scale, so every
sum of their squares is exact in fp32 (LAMB's global norm, NovoGrad's
per-tensor norms) and the scale is a power of two; the tree paths (run
eagerly on both sides) then agree with the JAX package's bit for bit in
their state (m, v, the momentum, the sums), a bf16 m included, and the
params within 1e-6 relative + 1e-9 (the bias-correction powers of two
pow implementations, and LAMB's parameter norms summed in other orders).
The flat paths (the kernels' plain versions) are held bit for bit to the
same optimizer built with the overriding values and fed the gradients
already scaled: the arguments reach the kernels' hyperparameters and
nothing else changes. With ``grad_norm=`` the flat LAMB runs no grad-norm
pre-pass and gives the bits of the run that computed that norm."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import optimizers as jax_optimizers
from apex_tpu_torch import optimizers as port_optimizers
from apex_tpu_torch.multi_tensor_apply import kernels as pkern
from apex_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

GS = 2.0 ** -16
CASES = {  # name -> constructor arguments (beside lr, weight_decay)
    "FusedAdam": {},
    "FusedLAMB": {"max_grad_norm": 0.05},
    "FusedSGD": {"momentum": 0.9},
    "FusedAdagrad": {},
    "FusedNovoGrad": {},
}
STATE = {"FusedAdam": ("m", "v"), "FusedLAMB": ("m", "v"),
         "FusedSGD": ("momentum_buf",), "FusedAdagrad": ("sum",),
         "FusedNovoGrad": ("m", "v")}
STEP_ARGS = [dict(lr=0.02, weight_decay=0.03),
             dict(lr=torch.tensor(0.01), weight_decay=torch.tensor(0.05)),
             dict(lr=0.015, weight_decay=0.0)]


def _tree(seed, grads=False):
    rng = np.random.RandomState(seed)

    def draw(*shape):
        if grads:
            return (rng.randint(-8, 9, size=shape) * 2.0 ** -10
                    / GS).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)

    return {"w": draw(9, 14), "b": draw(14), "layers": [draw(3, 5),
                                                         draw(131)]}


def _to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _jax_args(kw):
    return {k: (jnp.asarray(float(v), jnp.float32)
                if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()}


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _make(mod, name, m_dtype=None, **kw):
    args = dict(CASES[name], lr=0.1, weight_decay=0.2, **kw)
    if m_dtype is not None:
        args["m_dtype"] = m_dtype
    return getattr(mod, name)(**args)


@pytest.mark.parametrize("name,m_dtype", [
    (n, "f32") for n in sorted(CASES)] + [
    (n, "bf16") for n in ("FusedAdam", "FusedLAMB", "FusedNovoGrad")])
def test_tree_step_arguments_match_jax(name, m_dtype):
    """The bf16 first moment where the optimizer keeps one (Adagrad has
    none; SGD's bf16 buffer is ``test_torch_sgd_family.py``'s)."""
    md = {"f32": None, "bf16": (jnp.bfloat16, torch.bfloat16)}[m_dtype]
    jopt = _make(jax_optimizers, name, None if md is None else md[0])
    popt = _make(port_optimizers, name, None if md is None else md[1])
    jp = jax.tree.map(jnp.asarray, _tree(0))
    pp = tree_map(_to_torch, _tree(0))
    js, ps = jopt.init(jp), popt.init(pp)
    for step, kw in enumerate(STEP_ARGS):
        g = _tree(10 + step, grads=True)
        jp, js = jopt.step(jax.tree.map(jnp.asarray, g), jp, js,
                           grad_scale=GS, **_jax_args(kw))
        pp, ps = popt.step(tree_map(_to_torch, g), pp, ps, grad_scale=GS,
                           **kw)
        for field in STATE[name]:
            for w, t in zip(_sorted_leaves(getattr(js, field)),
                            _sorted_leaves(getattr(ps, field))):
                assert torch.equal(t, _to_torch(w)), (step, field)
        for w, t in zip(_sorted_leaves(jp), _sorted_leaves(pp)):
            torch.testing.assert_close(t, _to_torch(w), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_step_arguments_reach_the_kernel(name):
    """``step(lr=a, weight_decay=b, grad_scale=s)`` on the flat path
    equals the optimizer built with ``lr=a, weight_decay=b`` stepping on
    ``g * s``, bit for bit; and differs from the constructor's values."""
    over = _make(port_optimizers, name, use_flat_kernel=True)
    built = getattr(port_optimizers, name)(
        **dict(CASES[name], lr=0.02, weight_decay=0.03,
               use_flat_kernel=True))
    p0 = tree_map(_to_torch, _tree(1))
    g = tree_map(_to_torch, _tree(11, grads=True))
    pa, sa = over.step(g, p0, over.init(p0), lr=0.02, weight_decay=0.03,
                       grad_scale=GS)
    pb, sb = built.step(tree_map(lambda t: t * GS, g), p0, built.init(p0))
    pc, _ = over.step(g, p0, over.init(p0), grad_scale=GS)
    for a, b in zip(tree_leaves((pa, sa)), tree_leaves((pb, sb))):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, c) for a, c in zip(tree_leaves(pa),
                                                     tree_leaves(pc)))


def test_flat_lamb_grad_norm_skips_the_pre_pass(monkeypatch):
    """``flat_lamb(grad_norm=...)`` (and ``FusedLAMB.step(grad_norm=)``)
    runs no ``flat_l2norm_partials``, and with the norm the pre-pass
    would give it returns that run's bits."""
    opt = port_optimizers.FusedLAMB(lr=1e-3, max_grad_norm=0.05,
                                    use_flat_kernel=True)
    p0 = tree_map(_to_torch, _tree(2))
    g = tree_map(_to_torch, _tree(12, grads=True))
    want_p, want_s = opt.step(g, p0, opt.init(p0), grad_scale=GS)
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(g)])
    norm = torch.sqrt((flat * flat).sum() * GS * GS)

    def fail(*a, **k):
        raise AssertionError("grad-norm pre-pass ran")

    monkeypatch.setattr(pkern, "flat_l2norm_partials", fail)
    got_p, got_s = opt.step(g, p0, opt.init(p0), grad_scale=GS,
                            grad_norm=norm)
    for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p,
                                                              want_s))):
        assert torch.equal(a, b)
    bigger, _ = opt.step(g, p0, opt.init(p0), grad_scale=GS,
                         grad_norm=norm * 4)
    assert not torch.equal(bigger["w"], want_p["w"])
