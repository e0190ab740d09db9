"""Port parity: ``flat_sgd``, ``flat_adagrad`` and ``flat_novograd``
(rows 17, 19 and 20 of the kernel table) and the optimizers that run
them, ``FusedSGD``, ``FusedAdagrad`` and ``FusedNovoGrad`` (tree path
and flat path), against the JAX package's, on the CPU: the JAX side runs
its Pallas kernels in interpret mode, the port its plain versions. The
cases are those ``tests/L0/run_optimizers/test_fused_optimizers.py``
parametrizes, plus dampening, a first run, bf16 state with the cast-out,
``found_inf``, and the first-run seeding after a skipped step. Inputs
come from a numpy seed.

Tolerances. The port's plain versions repeat the JAX kernels' fp32
operations in their order, but XLA may contract a multiply and an add of
the interpreted kernel into one FMA, so each output is held to 8 ulps of
the magnitudes of its terms (as the LAMB tests hold theirs), a bf16
state to one bf16 ulp more, and p to 8 ulps of |p| plus lr times 16 ulps
of its update's terms (the update passes through a division and a square
root). NovoGrad's per-tensor ||g||^2 is a sum of squares in another order on
each side: in the kernel tests it is held to ``sum_sq_limit``, and its
effect is carried through the denominator into m and p; in the
optimizer tests the gradients are small integers times 2^-10, so every
sum of their squares is exact in fp32 and the two sides agree as
elementwise code does. The optimizers' tree paths run eagerly on both
sides (one rounding an operation), the flat paths through the kernels
above; both are held to the same models over three steps."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import kernels as jkern
from apex_tpu.optimizers import FusedAdagrad as JaxAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JaxNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu_torch.multi_tensor_apply import flatten as pflat
from apex_tpu_torch.multi_tensor_apply import kernels as pkern
from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad, FusedSGD
from apex_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map

U = 2.0 ** -24
BF16_ULP = 2.0 ** -8      # relative, one rounding to bf16
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _j(t):
    """A port tensor as a JAX array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.uint16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _within(name, got, want, lim):
    err = (got.double() - want.double()).abs()
    bad = err > lim
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {err.numel()} past the limit, worst "
        f"{float((err / lim.clamp_min(1e-300)).max()):.3g} of it")


def _tree(seed, grads=False):
    """A nested tree whose dict keys are not in sorted order, with sizes
    that are not multiples of 128 and a 0-d leaf; gradients are small
    integers times 2^-10 (exact squares and sums in fp32)."""
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


def _flat(seed, scale=1.0, dt="f32"):
    """A flat buffer over ``_tree``'s layout and its spec."""
    leaves = tree_flatten(_torch_tree(_tree(seed)))[0]
    buf, spec = pflat.flatten_tensors([t * scale for t in leaves])
    return buf.to(_TDT[dt]), spec


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

_SGD_CASES = {
    "mom_wd": dict(momentum=0.9, weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, nesterov=True),
    "wd_after": dict(momentum=0.9, weight_decay=1e-4,
                     wd_after_momentum=True),
    "plain": dict(),
    "damp": dict(momentum=0.9, dampening=0.1, weight_decay=1e-4),
    "first": dict(momentum=0.9, weight_decay=1e-4, first_run=True),
}


@pytest.mark.parametrize("buf_dt,emit", [("f32", False), ("bf16", True)])
@pytest.mark.parametrize("case", sorted(_SGD_CASES))
def test_flat_sgd_plain_matches_jax(case, buf_dt, emit):
    g, spec = _flat(1, 1e-2)
    p, _ = _flat(2)
    buf, _ = _flat(3, 1e-2, buf_dt)
    kw = dict(lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
              nesterov=False, wd_after_momentum=False, first_run=False,
              grad_scale=0.5)
    kw.update(_SGD_CASES[case])
    want = jkern.flat_sgd(_j(g), _j(p), _j(buf), emit_compute_dtype=(
        jnp.bfloat16 if emit else None), **kw)
    want = [_to_torch(w) for w in want]
    p0, b0 = p.clone(), buf.clone()
    got = pkern.flat_sgd(g, p, buf, emit_compute_dtype=(
        torch.bfloat16 if emit else None), **kw)
    assert got[0] is p and got[1] is buf          # in place
    assert len(got) == len(want) == (3 if emit else 2)
    mom, damp, wd = kw["momentum"], kw["dampening"], kw["weight_decay"]
    a = g.abs() * 0.5 + wd * p0.abs()               # |g'|
    b = mom * b0.float().abs() + a                  # |buf'|
    d = a + mom * b + wd * p0.abs()                 # |d|
    b_lim = 8 * U * b + (BF16_ULP * want[1].float().abs()
                         if buf_dt == "bf16" else 0.0)
    _within("buf", got[1].float(), want[1].float(), b_lim)
    _within("p", got[0], want[0], 8 * U * p0.abs() + 0.1 * 16 * U * d)
    if not mom:
        assert torch.equal(got[1], b0)
    if emit:
        assert torch.equal(got[2], got[0].to(torch.bfloat16))


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("w_mode", [False, True])
def test_flat_adagrad_plain_matches_jax(w_mode, emit):
    g, _ = _flat(4, 1e-2)
    p, _ = _flat(5)
    s = _flat(6, 1e-2)[0].abs()
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=1e-2, adagrad_w_mode=w_mode,
              grad_scale=0.5)
    want = [_to_torch(w) for w in jkern.flat_adagrad(
        _j(g), _j(p), _j(s), emit_compute_dtype=(
            jnp.bfloat16 if emit else None), **kw)]
    p0, s0 = p.clone(), s.clone()
    got = pkern.flat_adagrad(g, p, s, emit_compute_dtype=(
        torch.bfloat16 if emit else None), **kw)
    assert got[0] is p and got[1] is s
    a = g.abs() * 0.5 + 1e-2 * p0.abs()
    _within("sum", got[1], want[1], 8 * U * (s0 + a * a))
    u = a / (torch.sqrt(want[1]) + 1e-10) + 1e-2 * p0.abs()
    _within("p", got[0], want[0], 8 * U * p0.abs() + 1e-2 * 16 * U * u)
    if emit:
        assert torch.equal(got[2], got[0].to(torch.bfloat16))


_NOVO_CASES = {
    "wd": dict(weight_decay=0.01),
    "reg_inside": dict(weight_decay=0.01, reg_inside_moment=True),
    "no_averaging": dict(weight_decay=0.0, grad_averaging=False),
    "init_zero": dict(weight_decay=0.01, init_zero=True),
    "no_bias_correction": dict(weight_decay=0.01, bias_correction=False),
}


@pytest.mark.parametrize("m_dt,emit", [("f32", False), ("bf16", True)])
@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("case", sorted(_NOVO_CASES))
def test_flat_novograd_plain_matches_jax(case, step, m_dt, emit):
    g, spec = _flat(7, 1e-2)
    p, _ = _flat(8)
    m, _ = _flat(9, 1e-2, m_dt)
    v = torch.from_numpy(np.abs(np.random.RandomState(10).randn(
        spec.num_tensors)).astype(np.float32) * 1e-2)
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8, step=step,
              grad_scale=0.5)
    kw.update(_NOVO_CASES[case])
    want = [_to_torch(w) for w in jkern.flat_novograd(
        _j(g), _j(p), _j(m), _j(v), _j(ids), num_tensors=spec.num_tensors,
        emit_compute_dtype=(jnp.bfloat16 if emit else None), **kw)]
    p0, m0 = p.clone(), m.float()
    got = pkern.flat_novograd(g, p, m, v, ids, counts, emit_compute_dtype=(
        torch.bfloat16 if emit else None), **kw)
    assert got[0] is p and got[1] is m
    assert len(got) == len(want) == (4 if emit else 3)
    # v: ||g||^2 a tensor in another sum order (and its EMA)
    gsq = pkern.segment_sums(pkern.flat_l2norm_partials(g * 0.5), counts)
    n = counts.double() * pkern.SUB
    rel = 2.0 * (n + 1) * U
    _within("v", got[2], want[2], rel * gsq + 4 * U * want[2])
    # through the denominator (half v's relative error, plus roundings)
    e = (rel / 2 + 8 * U).float()[ids.long()].repeat_interleave(
        pkern.SUB).view(p.shape)
    _, denom = pkern.novograd_moments(
        pkern.flat_l2norm_partials(g), v, counts, ids, beta2=0.98, eps=1e-8,
        step=step, bias_correction=kw.get("bias_correction", True),
        init_zero=kw.get("init_zero", False), grad_scale=0.5)
    gn = ((g.abs() * 0.5).view(-1, pkern.SUB) / denom[:, None]).view(
        p.shape)
    wd = kw["weight_decay"]
    beta3 = 0.05 if kw.get("grad_averaging", True) else 1.0
    t_m = 0.95 * m0.abs() + beta3 * (gn + wd * p0.abs())
    m_lim = beta3 * gn * e + 8 * U * t_m + (
        BF16_ULP * want[1].float().abs() if m_dt == "bf16" else 0.0)
    _within("m", got[1].float(), want[1].float(), m_lim)
    c1 = 1.0 - 0.95 ** step if kw.get("bias_correction", True) else 1.0
    _within("p", got[0], want[0], 8 * U * p0.abs() + 1e-2 * (
        m_lim / c1 + 16 * U * (t_m / c1 + wd * p0.abs())))
    if emit:
        assert torch.equal(got[3], got[0].to(torch.bfloat16))


@pytest.mark.parametrize("fn", ["sgd", "adagrad", "novograd"])
def test_found_inf_leaves_params_and_state(fn):
    """A skipped step keeps p and the state (v too) and casts out the old
    p; the same call with found_inf False equals the call without it."""
    g, spec = _flat(11, 1e-2)
    g[3, 7] = float("inf")
    p, _ = _flat(12)
    s = _flat(13, 1e-2)[0].abs()
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    v = torch.ones(spec.num_tensors)
    calls = {
        "sgd": lambda gg, pp, ss, **k: pkern.flat_sgd(
            gg, pp, ss, lr=0.1, momentum=0.9, dampening=0.0,
            weight_decay=1e-4, nesterov=False, wd_after_momentum=False,
            first_run=torch.tensor(False), **k),
        "adagrad": lambda gg, pp, ss, **k: pkern.flat_adagrad(
            gg, pp, ss, lr=1e-2, eps=1e-10, weight_decay=1e-2, **k),
        "novograd": lambda gg, pp, ss, **k: pkern.flat_novograd(
            gg, pp, ss, v, ids, counts, lr=1e-2, beta1=0.95, beta2=0.98,
            eps=1e-8, step=3, weight_decay=1e-2, **k),
    }
    pc, sc = p.clone(), s.clone()
    out = calls[fn](g, pc, sc, emit_compute_dtype=torch.bfloat16,
                    found_inf=torch.tensor(True))
    assert torch.equal(pc, p) and torch.equal(sc, s)
    assert torch.equal(out[-1], p.to(torch.bfloat16))
    if fn == "novograd":
        assert torch.equal(out[2], v)
    g[3, 7] = 0.0
    a = calls[fn](g, p.clone(), s.clone(), found_inf=torch.tensor(False))
    b = calls[fn](g, p.clone(), s.clone())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], p)


def test_hparams_vectors_are_the_jax_kernels():
    sgd = pkern.sgd_hparams(lr=0.1, momentum=0.9, dampening=0.1,
                            weight_decay=1e-4, nesterov=False,
                            wd_after_momentum=True,
                            first_run=torch.tensor(True), grad_scale=0.5,
                            device="cpu")
    np.testing.assert_array_equal(sgd.numpy(), np.array(
        [0.1, 0.9, 0.1, 1e-4, 0.0, 1.0, 1.0, 0.5, 1.0], np.float32))
    ada = pkern.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=0.0,
                                adagrad_w_mode=True, grad_scale=1.0,
                                device="cpu")
    np.testing.assert_array_equal(ada.numpy(), np.array(
        [1e-2, 1e-10, 0.0, 1.0, 1.0], np.float32))
    nov = pkern.novograd_hparams(lr=1e-3, beta1=0.95, step=torch.tensor(
        4, dtype=torch.int32), weight_decay=0.01, grad_averaging=True,
        bias_correction=True, reg_inside_moment=True, grad_scale=0.5,
        device="cpu")
    b1 = np.float32(0.95)
    want = np.array([1e-3, b1, np.float32(1.0 - 0.95), 0.01,
                     1 - b1 ** np.float32(4), 1.0, 0.5], np.float32)
    np.testing.assert_allclose(nov.numpy(), want, rtol=2 * U)
    off = pkern.novograd_hparams(lr=1e-3, beta1=0.95, step=4,
                                 weight_decay=0.0, grad_averaging=False,
                                 bias_correction=False,
                                 reg_inside_moment=False, grad_scale=1.0,
                                 device="cpu")
    assert off[2] == 1.0 and off[4] == 1.0 and off[5] == 0.0


# ---------------------------------------------------------------------------
# the optimizers, tree and flat paths, against the JAX optimizers
# ---------------------------------------------------------------------------

_OPTS = {
    "sgd": (FusedSGD, JaxSGD, dict(lr=1e-2, momentum=0.9,
                                   weight_decay=1e-4)),
    "sgd_nesterov": (FusedSGD, JaxSGD, dict(lr=1e-2, momentum=0.9,
                                            nesterov=True)),
    "sgd_wd_after": (FusedSGD, JaxSGD, dict(lr=1e-2, momentum=0.9,
                                            weight_decay=1e-4,
                                            wd_after_momentum=True)),
    "sgd_plain": (FusedSGD, JaxSGD, dict(lr=1e-2)),
    "adagrad": (FusedAdagrad, JaxAdagrad, dict(lr=1e-2, weight_decay=0.01)),
    "adagrad_w": (FusedAdagrad, JaxAdagrad, dict(lr=1e-2, weight_decay=0.01,
                                                 adagrad_w_mode=True)),
    "novograd": (FusedNovoGrad, JaxNovoGrad, dict(lr=1e-2,
                                                  weight_decay=0.01)),
    "novograd_reg": (FusedNovoGrad, JaxNovoGrad, dict(
        lr=1e-2, weight_decay=0.01, reg_inside_moment=True)),
    "novograd_no_avg": (FusedNovoGrad, JaxNovoGrad, dict(
        lr=1e-2, weight_decay=0.0, grad_averaging=False)),
    "novograd_init_zero": (FusedNovoGrad, JaxNovoGrad, dict(
        lr=1e-2, weight_decay=0.01, init_zero=True)),
}


# Norm-wise limits of the optimizer tests (per state buffer or leaf, and
# per leaf on each step's params update, where the params' own rounding,
# 2 u of their norm, is allowed beside it): the per-element models are the
# kernel tests' above; here the wiring is under test (state fields, flat
# layouts, hyperparameters, step counts), and a wrong hyperparameter moves
# a buffer by a percent or more. fp32 state: 16 ulps of the norm (an FMA
# that XLA contracts rounds once where the port rounds twice); bf16
# state: an element whose two fp32 values straddle a bf16 rounding
# boundary lands one bf16 ulp (2^-8) away, rarely.
_OPT_LIMITS = {"f32": 16 * U, "bf16": 1e-3}


def _relnorm(a, b):
    a, b = a.double(), b.double()
    n = float(b.norm())
    return float((a - b).norm()) / (n if n > 0 else 1.0)


def _jleaves(tree):
    return [_to_torch(np.asarray(x)) for x in jax.tree_util.tree_leaves(
        tree)]


def _state_pairs(ps, js, flat):
    """(port, JAX) pairs of every state buffer but the step count."""
    out = []
    for name in ps._fields[1:]:
        p, j = getattr(ps, name), getattr(js, name)
        if flat:
            out.append((name, p, _to_torch(np.asarray(j))))
        else:
            out += [(name, a, b) for a, b in zip(tree_flatten(p)[0],
                                                 _jleaves(j))]
    return out


# Adagrad has no m_dtype (its sum stays fp32): its cast-out runs with fp32
_OPT_CASES = [(n, "f32" if n.startswith("adagrad") and e else m, e)
              for n in sorted(_OPTS) for m, e in (("f32", False),
                                                  ("bf16", True))]


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
@pytest.mark.parametrize("name,m_dtype,emit", _OPT_CASES)
def test_optimizer_matches_jax(name, m_dtype, emit, flat):
    """Three steps on the same gradients, then a skipped one: every state
    buffer, and each step's params update, against JAX's to
    ``_OPT_LIMITS``; step counts equal; the skip a no-op."""
    cls, jcls, kw = _OPTS[name]
    kw = dict(kw, use_flat_kernel=flat, emit_compute_params=emit)
    if cls is FusedAdagrad:
        popt, jopt = cls(**kw), jcls(**kw)
    else:
        popt = cls(m_dtype=_TDT[m_dtype], **kw)
        jopt = jcls(m_dtype=_JDT[m_dtype], **kw)
    tree = _tree(1)
    jp, pp = jax.tree.map(jnp.asarray, tree), _torch_tree(tree)
    js, ps = jopt.init(jp), popt.init(pp)
    assert type(ps).__name__ == type(js).__name__
    assert ps._fields == js._fields
    worst = {"state": 0.0, "update": 0.0}
    lim = _OPT_LIMITS[m_dtype]
    for step in range(3):
        g = _tree(10 + step, grads=True)
        jout = jopt.step(jax.tree.map(jnp.asarray, g), jp, js)
        pout = popt.step(_torch_tree(g), pp, ps)
        (jp2, js2), (pp2, ps2) = jout[:2], pout[:2]
        assert int(ps2.step) == int(js2.step) == step + 1
        assert list(pp2) == list(pp)              # dict order kept
        for field, a, b in _state_pairs(ps2, js2, flat):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            worst["state"] = max(worst["state"], _relnorm(a, b))
        for a, b, p0 in zip(tree_flatten(pp2)[0], _jleaves(jp2),
                            tree_flatten(pp)[0]):
            # the update against JAX's, beside the params' own rounding
            # (an ulp of p on each side)
            a, b, p0 = a.double(), b.double(), p0.double()
            allowed = lim * float((b - p0).norm()) + 2 * U * float(b.norm())
            worst["update"] = max(worst["update"], float(
                (a - b).norm()) / max(allowed, 1e-300))
        if emit:
            for c, p1 in zip(tree_leaves(pout[2]), tree_leaves(pp2)):
                assert c.dtype == torch.bfloat16 and torch.equal(
                    c, p1.to(torch.bfloat16))
        jp, js, pp, ps = jp2, js2, pp2, ps2
    assert worst["state"] <= lim and worst["update"] <= 1.0, worst
    # a skipped step changes nothing
    bad = tree_map(lambda t: torch.full_like(t, float("inf")),
                   _torch_tree(_tree(20, grads=True)))
    snap = [t.clone() for t in tree_leaves(pp) + tree_leaves(ps)]
    skip = popt.step(bad, pp, ps, found_inf=torch.tensor(True))
    assert int(skip[1].step) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(skip[0]) + tree_leaves(skip[1]), snap))


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
@pytest.mark.parametrize("cls", ["sgd", "novograd"])
def test_first_run_seeds_after_a_skipped_step(cls, flat):
    """A skipped first step leaves the step count at 0, so the next step
    is still the first: SGD seeds its buffer with the gradient (with
    dampening 0.1, a second step would take 0.9 of it), NovoGrad seeds v
    with ||g||^2, both as JAX does."""
    if cls == "sgd":
        kw = dict(lr=1e-2, momentum=0.9, dampening=0.1)
        popt, jopt = (FusedSGD(use_flat_kernel=flat, **kw),
                      JaxSGD(use_flat_kernel=flat, **kw))
    else:
        kw = dict(lr=1e-2, weight_decay=0.01)
        popt, jopt = (FusedNovoGrad(use_flat_kernel=flat, **kw),
                      JaxNovoGrad(use_flat_kernel=flat, **kw))
    tree = _tree(3)
    pp, jp = _torch_tree(tree), jax.tree.map(jnp.asarray, tree)
    ps, js = popt.init(pp), jopt.init(jp)
    g = _tree(4, grads=True)
    pp, ps = popt.step(_torch_tree(g), pp, ps, found_inf=torch.tensor(True))
    jp, js = jopt.step(jax.tree.map(jnp.asarray, g), jp, js,
                       found_inf=jnp.asarray(True))
    assert int(ps.step) == int(js.step) == 0
    pp, ps = popt.step(_torch_tree(g), pp, ps)
    jp, js = jopt.step(jax.tree.map(jnp.asarray, g), jp, js)
    for field, a, b in _state_pairs(ps, js, flat):
        _within(field, a, b, 8 * U * b.abs())
    if cls == "sgd":   # the buffer is g itself
        got = pflat.unflatten_tensors(
            ps.momentum_buf, pflat.make_spec(tree_flatten(pp)[0])) \
            if flat else tree_flatten(ps.momentum_buf)[0]
        for a, b in zip(got, tree_flatten(_torch_tree(g))[0]):
            assert torch.equal(a, b)


def test_constructors_raise_as_the_reference():
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(lr=0.1, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(lr=0.1, momentum=0.9, dampening=0.1, nesterov=True)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(amsgrad=True)
    with pytest.raises(ValueError, match="norm_type"):
        FusedNovoGrad(norm_type=1)
    with pytest.raises(ValueError, match="m_dtype"):
        FusedSGD(lr=0.1, m_dtype=torch.float16)
