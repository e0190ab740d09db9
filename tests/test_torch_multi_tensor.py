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
