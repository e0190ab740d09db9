"""Port parity: ``apex_tpu_torch.multi_tensor_apply`` (the flat layout
and ``flat_adam``) and ``FusedAdam(use_flat_kernel=True)`` against the
JAX package's, on the CPU (the JAX side runs its Pallas kernel in
interpret mode; the port its plain version). Inputs come from a numpy
seed.

Tolerances. The layout (``FlatSpec`` fields, ``tile_tensor_ids``, the
packed buffers) is equal bit for bit. ``flat_adam``: XLA may contract a
multiply and an add of the interpreted kernel into one FMA (the JAX
package's own bf16-moment test is red for that reason: one element of
32768 lands one ulp off), so m and v are held to 8 fp32 ulps of their
terms and p to 1e-6 relative + 1e-9, as the tree-path test holds it; a
bf16 m to one bf16 ulp. The reduced-precision contract of
``tests/L0/run_multi_tensor/test_multi_tensor.py::
test_flat_adam_kernel_bf16_moment_and_castout`` is held within the port,
bit for bit: a bf16 m is the round-to-nearest of the fp32 path's m, v is
the fp32 path's, and the cast-out is the cast of the step's own p."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import flatten as jflat
from apex_tpu.multi_tensor_apply import kernels as jkern
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch.multi_tensor_apply import flatten as pflat
from apex_tpu_torch.multi_tensor_apply import kernels as pkern
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map

_U = 2.0 ** -24


def _to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(seed):
    """A nested tree whose dict keys are not in sorted order, with
    sizes that are not multiples of 128 and a 0-d leaf."""
    rng = np.random.RandomState(seed)
    return {"zeta": {"kernel": rng.randn(9, 40).astype(np.float32),
                     "bias": rng.randn(40).astype(np.float32)},
            "alpha": [rng.randn(3, 130).astype(np.float32),
                      np.float32(rng.randn()),
                      {"w": rng.randn(1100).astype(np.float32)}],
            "mid": rng.randn(7, 3, 5).astype(np.float32)}


def _torch_tree(tree):
    """The tree in torch, dicts in their insertion order (``jax.tree.map``
    would sort them)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_tree_flatten_follows_jax_order():
    tree = _tree(0)
    jleaves = jax.tree_util.tree_leaves(tree)
    leaves, treedef = tree_flatten(_torch_tree(tree))
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the insertion order, which the port's tree_leaves follows, differs
    assert [tuple(t.shape) for t in tree_leaves(_torch_tree(tree))] != \
        [tuple(t.shape) for t in leaves]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flat_layout_matches_jax_bitwise(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tree = _tree(1)
    jbuf, jspec, _ = jflat.flatten_pytree(
        jax.tree.map(jnp.asarray, tree), dtype=jdt)
    pbuf, pspec, ptreedef = pflat.flatten_pytree(_torch_tree(tree),
                                                 dtype=tdt)
    assert pspec.shapes == jspec.shapes
    assert pspec.row_offsets == jspec.row_offsets
    assert pspec.row_counts == jspec.row_counts
    assert pspec.total_rows == jspec.total_rows
    assert pspec.total_rows % pflat.ALIGN_ROWS == 0
    assert [str(d).split(".")[-1] for d in pspec.dtypes] == \
        [str(d) for d in jspec.dtypes]
    for rows in (8, 16):
        assert np.array_equal(pspec.tile_tensor_ids(rows).numpy(),
                              jspec.tile_tensor_ids(rows))
    assert pbuf.dtype == tdt and tuple(pbuf.shape) == jbuf.shape
    assert np.array_equal(pbuf.view(torch.int16 if dtype == "bf16"
                                    else torch.int32).numpy(),
                          np.asarray(jbuf).view(np.int16 if dtype == "bf16"
                                                else np.int32))
    # unflatten gives back the tree, its dict order and dtypes included
    back = pflat.unflatten_pytree(pbuf, pspec, ptreedef)
    orig = _torch_tree(tree)
    assert list(back) == list(orig)
    for a, b in zip(tree_leaves(back), tree_leaves(orig)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b.to(tdt).to(b.dtype))
    # fp32 leaves of an fp32 buffer are views of it, not copies
    if dtype == "f32":
        base = pbuf.data_ptr()
        end = base + pbuf.numel() * 4
        assert all(base <= t.data_ptr() < end for t in tree_leaves(back))


def test_flatten_refuses_tensors_off_the_layout():
    spec = pflat.make_spec([torch.zeros(3, 4), torch.zeros(5)])
    with pytest.raises(ValueError, match="do not fit"):
        pflat.flatten_tensors([torch.zeros(5), torch.zeros(3, 4)], spec)


def _flat_inputs(seed, n=5000, m_val=None):
    rng = np.random.RandomState(seed)
    g, p = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    m = rng.randn(n).astype(np.float32) * 0.1 if m_val is None else \
        np.full(n, m_val, np.float32)
    v = np.abs(rng.randn(n)).astype(np.float32) * 0.01
    spec = pflat.make_spec([torch.zeros(n)])
    bufs = [pflat.flatten_tensors([torch.from_numpy(a)], spec)[0]
            for a in (g, p, m, v)]
    return bufs


@pytest.mark.parametrize("m_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("grad_scale", [1.0, 0.125])
def test_flat_adam_plain_matches_jax(m_dtype, adam_w_mode, grad_scale):
    g, p, m, v = _flat_inputs(2)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[m_dtype]
    m = m.to(tdt)
    emit = m_dtype == "bf16"
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, step=3,
              weight_decay=0.01, adam_w_mode=adam_w_mode,
              grad_scale=grad_scale)
    got = pkern.flat_adam(g, p, m, v, emit_compute_dtype=(
        torch.bfloat16 if emit else None), **kw)
    want = jkern.flat_adam(*(jnp.asarray(t.float().numpy()) for t in
                             (g, p)), jnp.asarray(m.float().numpy(), jdt),
                           jnp.asarray(v.numpy()), emit_compute_dtype=(
                               jnp.bfloat16 if emit else None), **kw)
    assert len(got) == len(want) == (4 if emit else 3)
    want = [_to_torch(w) for w in want]
    gs = g * grad_scale
    m_terms = 0.9 * m.float().abs() + 0.1 * (gs.abs() + 0.01 * p.abs())
    v_terms = 0.999 * v + 0.001 * (gs.abs() + 0.01 * p.abs()) ** 2
    assert got[1].dtype == tdt and got[2].dtype == torch.float32
    m_lim = 8 * _U * m_terms + (2 ** -7 * want[1].float().abs()
                                if emit else 0.0)
    assert bool(((got[1].float() - want[1].float()).abs() <= m_lim).all())
    assert bool(((got[2] - want[2]).abs() <= 8 * _U * v_terms).all())
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-9)
    if emit:
        assert got[3].dtype == torch.bfloat16
        assert torch.equal(got[3], got[0].to(torch.bfloat16))


def test_flat_adam_bf16_moment_and_castout_contract():
    """The reduced-precision contract, within the port, bit for bit: m
    starts bf16-exact (0.25), so the bf16 path's m is the round-to-
    nearest of the fp32 path's, its v is the fp32 path's, and the
    cast-out is the cast of its own p."""
    g, p, m, v = _flat_inputs(3, m_val=0.25)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, step=3,
              weight_decay=0.01, adam_w_mode=True)
    p_ref, m_ref, v_ref = pkern.flat_adam(g, p, m, v, **kw)
    p_bf, m_bf, v_bf, pc = pkern.flat_adam(
        g, p, m.to(torch.bfloat16), v, emit_compute_dtype=torch.bfloat16,
        **kw)
    assert m_bf.dtype == torch.bfloat16 and v_bf.dtype == torch.float32
    assert torch.equal(m_bf, m_ref.to(torch.bfloat16))
    assert torch.equal(v_bf, v_ref) and torch.equal(p_bf, p_ref)
    assert pc.dtype == torch.bfloat16 and torch.equal(
        pc, p_bf.to(torch.bfloat16))


def test_flat_adam_found_inf_writes_the_old_values():
    g, p, m, v = _flat_inputs(4)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
              weight_decay=0.01)
    mb = m.to(torch.bfloat16)
    p2, m2, v2, pc = pkern.flat_adam(
        g, p, mb, v, emit_compute_dtype=torch.bfloat16,
        found_inf=torch.tensor(True), **kw)
    assert torch.equal(p2, p) and torch.equal(m2, mb) and torch.equal(v2, v)
    assert torch.equal(pc, p.to(torch.bfloat16))
    p3, _, _ = pkern.flat_adam(g, p, m, v, found_inf=torch.tensor(False),
                               **kw)
    assert torch.equal(p3, pkern.flat_adam(g, p, m, v, **kw)[0])
    assert not torch.equal(p3, p)


def test_hparams_vector_is_the_jax_kernels():
    """Order and values of the (9,) vector, c1 and c2 from the step."""
    hp = pkern.adam_hparams(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                            step=torch.tensor(4, dtype=torch.int32),
                            weight_decay=0.01, adam_w_mode=False,
                            bias_correction=True, grad_scale=0.5,
                            device="cpu")
    b1, b2 = np.float32(0.9), np.float32(0.999)
    want = np.array([1e-3, b1, b2, 1e-8, 0.01, 1 - b1 ** np.float32(4),
                     1 - b2 ** np.float32(4), 0.0, 0.5], np.float32)
    assert hp.dtype == torch.float32 and hp.shape == (9,)
    np.testing.assert_allclose(hp.numpy(), want, rtol=2 * _U)
    off = pkern.adam_hparams(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                             step=4, weight_decay=0.0, adam_w_mode=True,
                             bias_correction=False, grad_scale=1.0,
                             device="cpu")
    assert off[5] == off[6] == 1.0 and off[7] == 1.0


def _compute_kw(emit, compute):
    return dict(compute_params=compute) if emit else {}


@pytest.mark.parametrize("m_dtype,emit", [("f32", False), ("bf16", True)])
def test_flat_fused_adam_matches_jax_and_tree_path(m_dtype, emit):
    """Two steps, found_inf False then True: the flat port against the
    JAX flat optimizer (state buffer for buffer) and against the port's
    own tree path; the skipped step changes nothing, the step count
    included."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[m_dtype]
    kw = dict(lr=1e-2, weight_decay=0.01, emit_compute_params=emit)
    jopt = JaxAdam(m_dtype=jdt, use_flat_kernel=True, **kw)
    popt = FusedAdam(m_dtype=tdt, use_flat_kernel=True, **kw)
    topt = FusedAdam(m_dtype=tdt, **kw)
    tree = _tree(5)
    jp = jax.tree.map(jnp.asarray, tree)
    pp, tp = _torch_tree(tree), _torch_tree(tree)
    js, ps, ts = jopt.init(jp), popt.init(pp), topt.init(tp)
    assert ps.m.dtype == tdt and tuple(ps.m.shape) == js.m.shape
    # compute trees: bf16 but for one kept-fp32 leaf
    def compute(t, to):
        c = tree_map(to, t)
        c["mid"] = t["mid"]
        return c

    jc = compute(jp, lambda a: a.astype(jnp.bfloat16))
    pc = compute(pp, lambda a: a.to(torch.bfloat16))
    tc = compute(tp, lambda a: a.to(torch.bfloat16))
    for step, found in enumerate((False, True)):
        g = _tree(10 + step)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
        pg = tree_map(lambda a: _to_torch(np.asarray(
            jnp.asarray(a, jnp.bfloat16))), g)
        jf, pf = jnp.asarray(found), torch.tensor(found)
        jout = jopt.step(jg, jp, js, found_inf=jf, **_compute_kw(emit, jc))
        pout = popt.step(pg, pp, ps, found_inf=pf, **_compute_kw(emit, pc))
        tout = topt.step(pg, tp, ts, found_inf=pf, **_compute_kw(emit, tc))
        (jp2, js2), (pp2, ps2), (tp2, ts2) = (o[:2] for o in (jout, pout,
                                                              tout))
        assert int(ps2.step) == int(js2.step) == int(ts2.step) == 1
        assert list(pp2) == list(pp)          # dict order kept
        # state buffers against JAX's, element for element
        for w, t in ((js2.m, ps2.m), (js2.v, ps2.v)):
            t, w = t.float(), _to_torch(w).float()
            tol = 2 ** -7 * w.abs() if m_dtype == "bf16" else 0.0
            assert bool(((t - w).abs() <= 8 * _U * w.abs() + tol
                         + 1e-12).all())
        # params against JAX's and against the tree path's
        jleaves = jax.tree_util.tree_leaves(jp2)
        pleaves, _ = tree_flatten(pp2)
        tleaves, _ = tree_flatten(tp2)
        for w, a, b in zip(jleaves, pleaves, tleaves):
            torch.testing.assert_close(a, _to_torch(w), rtol=1e-6,
                                       atol=1e-9)
            assert torch.equal(a, b)
        if found:
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(pp2), tree_leaves(pp)))
            assert torch.equal(ps2.m, ps.m) and torch.equal(ps2.v, ps.v)
        if emit:
            pc2, tc2 = pout[2], tout[2]
            for a, b, t in zip(tree_leaves(pc2), tree_leaves(tc2),
                               tree_leaves(pc)):
                assert a.dtype == b.dtype == t.dtype and torch.equal(a, b)
            jc, pc, tc = jout[2], pc2, tc2
        jp, js, pp, ps, tp, ts = jp2, js2, pp2, ps2, tp2, ts2


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_fused_adam_without_bias_correction_matches_jax(flat):
    """``FusedAdam(bias_correction=False)`` (c1 = c2 = 1) on both paths
    against the JAX optimizer over two steps: m and v to 8 ulps of their
    terms on the flat path, bit for bit on the tree path (both sides run
    eagerly); params 1e-6 relative plus 32 ulps of the updates; and the
    restored argument moves the result."""
    kw = dict(lr=1e-2, bias_correction=False, weight_decay=0.01,
              use_flat_kernel=flat)
    jopt, popt = JaxAdam(**kw), FusedAdam(**kw)
    tree = _tree(6)
    jp, pp = jax.tree.map(jnp.asarray, tree), _torch_tree(tree)
    js, ps = jopt.init(jp), popt.init(pp)
    gs = []
    for step in range(2):
        g = _tree(20 + step)
        gs.append(pflat.flatten_tensors(tree_flatten(_torch_tree(g))[0])[0])
        jp, js = jopt.step(jax.tree.map(jnp.asarray, g), jp, js)
        pp, ps = popt.step(_torch_tree(g), pp, ps)
    # the terms of m and v after two steps from zero (AdamW: g unchanged)
    terms = {"m": 0.1 * (gs[0].abs() + gs[1].abs()),
             "v": 0.001 * (gs[0] ** 2 + gs[1] ** 2)}
    for key, w, t in (("m", js.m, ps.m), ("v", js.v, ps.v)):
        if flat:   # XLA may contract the interpreted kernel's FMAs
            w = _to_torch(w)
            assert bool(((t - w).abs() <= 8 * _U * terms[key]).all()), key
        else:      # both eager: bit for bit
            for a, b in zip(jax.tree_util.tree_leaves(w), tree_flatten(t)[0]):
                assert torch.equal(b, _to_torch(np.asarray(a))), key
    # params: 1e-6 of |p|, and 32 u of the two updates lr |u|, where |u|
    # = |m| / sqrt(v) is at most sqrt(sum a_i^2 / b_i) over the terms of
    # m and v (Cauchy-Schwarz): 3.17 after step 1, 4.26 after step 2
    for w, t in zip(jax.tree_util.tree_leaves(jp), tree_flatten(pp)[0]):
        torch.testing.assert_close(t, _to_torch(w), rtol=1e-6,
                                   atol=32 * _U * 1e-2 * (3.17 + 4.26))
    on = FusedAdam(lr=1e-2, weight_decay=0.01, use_flat_kernel=flat)
    p_on, _ = on.step(_torch_tree(_tree(20)), _torch_tree(tree),
                      on.init(_torch_tree(tree)))
    off = FusedAdam(**kw)
    p_off, _ = off.step(_torch_tree(_tree(20)), _torch_tree(tree),
                        off.init(_torch_tree(tree)))
    assert not torch.equal(tree_flatten(p_on)[0][0], tree_flatten(p_off)[0][0])


def test_lamb_hparams_without_bias_correction_or_averaging():
    hp = pkern.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6, step=4,
                            weight_decay=0.01, adam_w_mode=True,
                            gs_over_clip=torch.tensor(1.0), device="cpu",
                            bias_correction=False, grad_averaging=False)
    assert hp[4] == hp[5] == 1.0 and hp[7] == 1.0


# ---------------------------------------------------------------------------
# The list ops, flat_scale, flat_axpby, flat_l2norm_partials and flat_lamb
# against the JAX package. Elementwise outputs and flags are held exactly
# (each is one rounding of the same fp32 operations), the partials and
# LAMB's params to the module's error models (``sum_sq_limit``,
# ``lamb_p_limit``: sums of squares in other orders).
# ---------------------------------------------------------------------------

from apex_tpu.multi_tensor_apply import (  # noqa: E402
    multi_tensor_apply as jmta,
)
from apex_tpu_torch.multi_tensor_apply import (  # noqa: E402
    multi_tensor_apply as pmta,
)
from apex_tpu_torch.optimizers._common import flat_layout  # noqa: E402

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _list(seed, dtypes):
    rng = np.random.RandomState(seed)
    shapes = [(9, 40), (40,), (), (3, 130)]
    return [np.asarray(rng.randn(*s) * 3, np.float32) for s in shapes[
        :len(dtypes)]]


def _pair(arrays, dtypes):
    """The same arrays as JAX and as torch tensors, each in its dtype."""
    j = [jnp.asarray(a, _JDT[d]) for a, d in zip(arrays, dtypes)]
    return j, [_to_torch(np.asarray(x)) for x in j]


def _equal(got, want):
    want = _to_torch(np.asarray(want))
    assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got, want) or bool(
        (torch.isnan(got) == torch.isnan(want)).all()
        and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


@pytest.mark.parametrize("op", ["scale", "axpby", "l2norm", "l2norm_per",
                                "applier_scale", "applier_axpby"])
@pytest.mark.parametrize("inject", [None, "inf"])
def test_list_ops_match_jax(op, inject):
    dtypes = ["f32", "bf16", "f32", "bf16"]
    xs = _list(20, dtypes)
    ys = _list(21, dtypes)
    if inject:
        xs[1] = xs[1].copy()
        xs[1][3] = np.inf
    jx, px = _pair(xs, dtypes)
    jy, py = _pair(ys, dtypes)
    outs = ["bf16", "f32", "f32", "bf16"]
    if op in ("scale", "applier_scale"):
        if op == "scale":
            jo, jf = jmta.multi_tensor_scale(jx, 0.25)
            po, pf = pmta.multi_tensor_scale(px, 0.25)
        else:
            jdst = [jnp.zeros(x.shape, _JDT[d]) for x, d in zip(jx, outs)]
            pdst = [torch.zeros(tuple(x.shape), dtype=_TDT[d])
                    for x, d in zip(px, outs)]
            jo, jf = jmta.multi_tensor_applier("scale", None, [jx, jdst], 0.25)
            po, pf = pmta.multi_tensor_applier("scale", None, [px, pdst],
                                               0.25)
    elif op in ("axpby", "applier_axpby"):
        if op == "axpby":
            jo, jf = jmta.multi_tensor_axpby(2.0, jx, -0.5, jy)
            po, pf = pmta.multi_tensor_axpby(2.0, px, -0.5, py)
        else:
            jdst = [jnp.zeros(x.shape, _JDT[d]) for x, d in zip(jx, outs)]
            pdst = [torch.zeros(tuple(x.shape), dtype=_TDT[d])
                    for x, d in zip(px, outs)]
            jo, jf = jmta.multi_tensor_applier("axpby", None,
                                               [jx, jy, jdst], 2.0, -0.5)
            po, pf = pmta.multi_tensor_applier("axpby", None,
                                               [px, py, pdst], 2.0, -0.5)
    else:
        per = op == "l2norm_per"
        jres = jmta.multi_tensor_l2norm(jy, per_tensor=per)
        pres = pmta.multi_tensor_l2norm(py, per_tensor=per)
        jres, pres = (jres, pres) if per else ((jres,), (pres,))
        n = sum(int(np.prod(np.shape(y))) for y in ys)
        for w, g in zip(jres, pres):
            w = _to_torch(np.asarray(w))
            assert g.dtype == torch.float32 and g.shape == w.shape
            # sqrt of a sum of squares: half the relative sum-order bound
            assert bool(((g - w).abs() <= pkern.sum_sq_limit(w, n) / 2
                         + 2 * _U * w).all())
        return
    assert bool(pf) == bool(jf) == bool(inject)
    assert len(po) == len(jo)
    for g, w in zip(po, jo):
        _equal(g, w)


_SCALE_CASES = [("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"),
                ("bf16", "bf16")]


def _flat(seed, rows=40, scale=3.0, inject=None):
    rng = np.random.RandomState(seed)
    a = (rng.randn(rows, 128) * scale).astype(np.float32)
    if inject == "inf":
        a[7, 5] = -np.inf
    elif inject == "nan":
        a[rows - 1, 127] = np.nan
    elif inject == "big":   # finite fp32, inf once scaled by 4
        a[3, 3] = 3e38
    return a


@pytest.mark.parametrize("xdt,odt", _SCALE_CASES)
@pytest.mark.parametrize("inject", [None, "inf", "nan", "big"])
def test_flat_scale_plain_matches_jax(xdt, odt, inject):
    x = _flat(30, inject=inject)
    jx, px = _pair([x], [xdt])
    want, wf = jkern.flat_scale(jx[0], 4.0, out_dtype=_JDT[odt])
    got, gf = pkern.flat_scale(px[0], 4.0, out_dtype=_TDT[odt])
    _equal(got, want)
    # the flag judges the incoming values: 3e38 * 4 is inf, yet finite in
    assert gf.dtype == torch.bool and gf.shape == ()
    assert bool(gf) == bool(wf) == (inject in ("inf", "nan"))
    assert pkern.flat_scale(px[0], 4.0)[0].dtype == _TDT[xdt]


@pytest.mark.parametrize("xdt,ydt,odt", [("f32", "f32", "f32"),
                                         ("bf16", "f32", "bf16"),
                                         ("f32", "bf16", "f32"),
                                         ("bf16", "bf16", "f32")])
@pytest.mark.parametrize("inject", [None, "inf", "nan", "big"])
def test_flat_axpby_plain_matches_jax(xdt, ydt, odt, inject):
    x, y = _flat(31, inject=inject), _flat(32)
    (jx, jy), (px, py) = _pair([x, y], [xdt, ydt])
    want, wf = jkern.flat_axpby(4.0, jx, -0.5, jy, out_dtype=_JDT[odt])
    got, gf = pkern.flat_axpby(4.0, px, -0.5, py, out_dtype=_TDT[odt])
    _equal(got, want)
    # the flag judges the result: 4 * 3e38 overflows
    assert bool(gf) == bool(wf) == (inject is not None)
    assert pkern.flat_axpby(1.0, px, 1.0, py)[0].dtype == _TDT[xdt]


def test_flat_scale_and_axpby_refuse_other_dtypes():
    x = torch.zeros(8, 128, dtype=torch.float16)
    with pytest.raises(RuntimeError, match="fp32 or bf16"):
        pkern.flat_scale(x, 2.0)
    with pytest.raises(RuntimeError, match="fp32 or bf16"):
        pkern.flat_axpby(1.0, torch.zeros(8, 128), 1.0, x)
    with pytest.raises(RuntimeError, match="fp32 or bf16"):
        pkern.flat_scale(torch.zeros(8, 128), 2.0, out_dtype=torch.float64)


@pytest.mark.parametrize("rows", [256, 300, 8])
def test_flat_l2norm_partials_plain_matches_jax(rows):
    x = _flat(33, rows=rows)
    want = _to_torch(np.asarray(jkern.flat_l2norm_partials(jnp.asarray(x))))
    got = pkern.flat_l2norm_partials(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numel() % 32 == 0 and bool((got[rows // 8 + (rows % 8 > 0):]
                                           == 0).all())
    lim = pkern.sum_sq_limit(want, pkern.SUB)
    err = (got - want).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    n = float(pkern.flat_l2norm(torch.from_numpy(x)))
    w = float(jkern.flat_l2norm(jnp.asarray(x)))
    assert abs(n - w) <= (x.size + 2) * _U * w


def _lamb_inputs(seed, m_dtype):
    tree = _tree(seed)
    leaves, _ = tree_flatten(_torch_tree(tree))
    p, spec = pflat.flatten_tensors(leaves)
    rng = np.random.RandomState(seed + 1)

    def like(scale, fn=lambda a: a):
        a = np.zeros(p.shape, np.float32)
        for off, cnt, shape in zip(spec.row_offsets, spec.row_counts,
                                   spec.shapes):
            n = int(np.prod(shape))
            a.reshape(-1)[off * 128: off * 128 + n] = fn(
                rng.randn(n) * scale)
        return torch.from_numpy(a)

    g = like(0.3)
    m = like(0.1).to(_TDT[m_dtype])
    v = like(0.01, np.abs)
    return g, p, m, v, spec


_LAMB_CASES = [  # (m dtype, kwargs)
    ("f32", dict(weight_decay=0.01)),
    ("f32", dict(weight_decay=0.01, adam_w_mode=False)),
    ("f32", dict(weight_decay=0.0, use_nvlamb=True)),
    ("f32", dict(weight_decay=0.0)),
    ("f32", dict(weight_decay=0.01, max_grad_norm=0.05)),   # clip engages
    ("f32", dict(weight_decay=0.01, max_grad_norm=0.0)),    # no clip
    ("bf16", dict(weight_decay=0.01)),
    ("f32", dict(weight_decay=0.01, bias_correction=False)),
    ("f32", dict(weight_decay=0.01, grad_averaging=False)),
]


@pytest.mark.parametrize("m_dtype,kw", _LAMB_CASES, ids=[
    f"{m}-" + "-".join(f"{k}={v}" for k, v in kw.items())
    for m, kw in _LAMB_CASES])
def test_flat_lamb_plain_matches_jax(m_dtype, kw):
    g, p, m, v, spec = _lamb_inputs(6, m_dtype)
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    emit = m_dtype == "bf16"
    common = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6, step=3, **kw)
    got = pkern.flat_lamb(g, p, m, v, ids, counts, emit_compute_dtype=(
        torch.bfloat16 if emit else None), **common)
    want = jkern.flat_lamb(
        *(jnp.asarray(t.numpy()) for t in (g, p)),
        jnp.asarray(m.float().numpy(), _JDT[m_dtype]), jnp.asarray(v.numpy()),
        jnp.asarray(ids.numpy()), num_tensors=spec.num_tensors,
        emit_compute_dtype=(jnp.bfloat16 if emit else None), **common)
    assert len(got) == len(want) == (4 if emit else 3)
    want = [_to_torch(np.asarray(w)) for w in want]
    # m and v: the same fp32 operations, but XLA contracts multiply-adds
    # of the interpreted kernel into FMAs (in the first case 440 of 32768
    # v elements land one ulp off), so they are held to 8 ulps of their
    # terms as flat_adam's are above, a bf16 m to one bf16 ulp; where the
    # clip engages, its global norm is a sum of squares in another order
    hp, e_clip = _lamb_hp(g, spec, common)
    b1, b2, _, wd, _, _, aw, beta3, gsc = hp.unbind()
    gs_abs = g.abs() * gsc
    t_gl = gs_abs + ((1.0 - aw) * wd).abs() * p.abs()
    m_lim = 8 * _U * (b1 * m.float().abs() + beta3 * t_gl) \
        + beta3 * gs_abs * e_clip + (2 ** -7 * want[1].float().abs()
                                     if emit else 0.0)
    v_lim = 8 * _U * (b2 * v + (1.0 - b2) * t_gl ** 2) \
        + 2 * (1.0 - b2) * t_gl * gs_abs * e_clip
    assert got[1].dtype == _TDT[m_dtype]
    assert bool(((got[1].float() - want[1].float()).abs() <= m_lim).all())
    assert bool(((got[2] - want[2]).abs() <= v_lim).all())
    # p: the ratio's sums of squares in other orders (lamb_p_limit)
    _, _, u, pp, up = pkern.flat_lamb_stage1_plain(g, p, m, v, hp)
    lim = pkern.lamb_p_limit(want[0], u, pp, up, ids, counts, 1e-2)
    err = (got[0] - want[0]).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    assert not torch.equal(got[0], p)
    if emit:
        assert torch.equal(got[3], got[0].to(torch.bfloat16))


def _lamb_hp(g, spec, common):
    """The stage-1 vector flat_lamb builds for ``common``, and the
    relative limit on its clip between two sum orders of the global norm
    (0 where the clip does not engage: it is 1 exactly)."""
    parts = pkern.flat_l2norm_partials(g)
    norm = float(torch.sqrt(parts.sum()))
    mx = float(common.get("max_grad_norm", 1.0))
    e_clip = (g.numel() + 4) * _U if 0 < mx < norm else 0.0
    return pkern.lamb_hparams(
        beta1=0.9, beta2=0.999, eps=1e-6, step=3,
        weight_decay=common["weight_decay"],
        adam_w_mode=common.get("adam_w_mode", True),
        gs_over_clip=pkern.lamb_inv_clip(parts, mx), device="cpu",
        bias_correction=common.get("bias_correction", True),
        grad_averaging=common.get("grad_averaging", True)), e_clip


def test_lamb_hparams_vector_is_the_jax_kernels():
    """Order and values of the (9,) vector, beta3 as the JAX flat path
    rounds it (from float64), c1 and c2 from the step."""
    hp = pkern.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6,
                            step=torch.tensor(4, dtype=torch.int32),
                            weight_decay=0.01, adam_w_mode=False,
                            gs_over_clip=torch.tensor(0.25), device="cpu")
    b1, b2 = np.float32(0.9), np.float32(0.999)
    want = np.array([b1, b2, 1e-6, 0.01, 1 - b1 ** np.float32(4),
                     1 - b2 ** np.float32(4), 0.0, np.float32(1.0 - 0.9),
                     0.25], np.float32)
    assert hp.dtype == torch.float32 and hp.shape == (9,)
    np.testing.assert_allclose(hp.numpy(), want, rtol=2 * _U)
    assert hp[7] == np.float32(1.0 - 0.9) and hp[7] != 1 - b1
    aw = pkern.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6, step=1,
                            weight_decay=0.0, adam_w_mode=True,
                            gs_over_clip=torch.tensor(1.0), device="cpu")
    assert aw[6] == 1.0 and aw[3] == 0.0 and aw[4] == np.float32(1.0) - b1


@pytest.mark.parametrize("m_dtype", ["f32", "bf16"])
def test_flat_lamb_found_inf_keeps_the_old_values(m_dtype):
    g, p, m, v, spec = _lamb_inputs(7, m_dtype)
    g[0, 0] = float("inf")
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6, step=2,
              weight_decay=0.01)
    p2, m2, v2, pc = pkern.flat_lamb(g, p, m, v, ids, counts,
                                     emit_compute_dtype=torch.bfloat16,
                                     found_inf=torch.tensor(True), **kw)
    assert torch.equal(p2, p) and torch.equal(m2, m) and torch.equal(v2, v)
    assert torch.equal(pc, p.to(torch.bfloat16))
    g[0, 0] = 0.0
    p3 = pkern.flat_lamb(g, p, m, v, ids, counts,
                         found_inf=torch.tensor(False), **kw)[0]
    assert torch.equal(p3, pkern.flat_lamb(g, p, m, v, ids, counts,
                                           **kw)[0])
    assert not torch.equal(p3, p)


def test_stage1_plain_skip_and_segment_sums():
    """A skipped stage 1 gives u = 0 and zero partials (so stage 2 gives
    the old p); ``tile_counts`` are the run lengths of ``tile_ids`` and
    the per-tensor sums follow those spans."""
    g, p, m, v, spec = _lamb_inputs(8, "f32")
    hp, _ = _lamb_hp(g, spec, dict(weight_decay=0.01))
    m2, v2, u, pp, up = pkern.flat_lamb_stage1_plain(
        g, p, m, v, hp, torch.tensor(True))
    assert torch.equal(m2, m) and torch.equal(v2, v)
    assert not bool(u.any()) and not bool(pp.any()) and not bool(up.any())
    ids = spec.tile_tensor_ids(8)
    lengths = spec.tile_counts(8)
    assert lengths.tolist() == np.bincount(ids.numpy()).tolist()
    parts = pkern.flat_l2norm_partials(p)
    sums = pkern.segment_sums(parts[:ids.numel()], lengths)
    for t, leaf in enumerate(tree_flatten(_torch_tree(_tree(8)))[0]):
        w = float((leaf.double() ** 2).sum())
        assert abs(float(sums[t]) - w) <= 2 * (leaf.numel() + 1024) * _U * w


def test_flat_layout_caches_tile_ids_on_the_params_device():
    params = _torch_tree(_tree(9))
    cache = {}
    leaves, treedef, spec, ids, counts = flat_layout(cache, params)
    assert ids.dtype == torch.int32 and ids.device == leaves[0].device
    assert counts.dtype == torch.int64 and counts.device == ids.device
    assert torch.equal(ids, spec.tile_tensor_ids(8))
    assert torch.equal(counts, torch.bincount(ids.long()))
    again = flat_layout(cache, params)
    assert again[2] is spec and again[3] is ids and again[4] is counts \
        and len(cache) == 1
