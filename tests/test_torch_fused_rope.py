"""Port parity: ``apex_tpu_torch.transformer.functional.fused_rope``
against ``apex_tpu.transformer.functional.fused_rope`` on the CPU, on
the same seeded numpy inputs.

Every public function, in the sbhd, bshd and bhsd layouts, with
``d_rot = d`` and ``d_rot < d`` (the trailing channels pass through
untouched), ``positions`` as a (b,) decode offset and as (b, s)
per-element positions (positions past the table clamp to its last row,
as JAX's gather does), the cached form, in fp32 and bf16: the forward,
and the backward (``dt``, ``dcos``, ``dsin``, and the angle table's
gradient through cos and sin) against ``jax.vjp``.

Error model (the module's docstring). The angles agree bit for bit;
torch's cos and sin may land one fp32 ulp from XLA's. An fp32 output is
held to ``8 u (|t| |cos| + |rotate_half(t)| |sin|)``, u = 2^-24 (the two
products, their sum, and an ulp of each table value, on both sides); a
bf16 output adds one bf16 ulp of the output, ``2^-7 |out|``. ``dt`` is
the same form on the cotangent. ``dcos`` and ``dsin`` sum ``n``
products over the broadcast axes in other orders: ``2 n u sum |g t|``.
The angle table's gradient ``-sin dcos + cos dsin`` carries those
limits through the tables plus ``8 u`` of each term."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.transformer.functional import fused_rope as jrope
from apex_tpu_torch.transformer.functional import fused_rope as rope

U = 2.0 ** -24
S, B, H, D = 12, 2, 3, 16
S_TABLE = 24           # the decode table is longer than the query run


def _np(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        x = x.astype(np.float32)
    return x.astype(np.float64)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _inputs(shape, dtype, seed):
    """(numpy fp32 values representable in ``dtype``, jax array, torch
    tensor)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        return x, jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    return x, jnp.asarray(x), _t(x)


def _rot(x):
    h = x.shape[-1] // 2
    return np.concatenate([-x[..., h:], x[..., :h]], axis=-1)


def _fwd_limit(t, cos, sin, want, dtype):
    """Per element, for the leading d_rot channels (float64 inputs)."""
    d_rot = cos.shape[-1]
    r = t[..., :d_rot]
    lim = 8 * U * (np.abs(r) * np.abs(cos) + np.abs(_rot(r)) * np.abs(sin))
    if dtype == "bf16":
        lim = lim + 2.0 ** -7 * np.abs(want[..., :d_rot])
    return lim


def _check_fwd(got, want, t, cos, sin, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    d_rot = cos.shape[-1]
    np.testing.assert_array_equal(got[..., d_rot:], want[..., d_rot:])
    err = np.abs(got[..., :d_rot] - want[..., :d_rot])
    lim = _fwd_limit(t, cos, sin, want, dtype)
    assert (err <= lim + 1e-30).all(), float((err / (lim + 1e-30)).max())


def _reduce_limit(g, t, shape):
    """2 n u sum |g t| over the axes ``shape`` broadcasts."""
    axes = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    n = int(np.prod([g.shape[i] for i in axes])) if axes else 1
    return 2 * n * U * np.sum(np.abs(g * t), axis=axes, keepdims=True)


def _check_table_grads(dcos, dsin, want_dcos, want_dsin, g, t, cos, sin):
    d_rot = cos.shape[-1]
    g, t = g[..., :d_rot], t[..., :d_rot]
    for got, want, lim in (
            (dcos, want_dcos, _reduce_limit(g, t, cos.shape)),
            (dsin, want_dsin, _reduce_limit(g, _rot(t), sin.shape))):
        got, want = _np(got), _np(want)
        assert got.shape == want.shape
        assert (np.abs(got - want) <= lim + 1e-30).all()


# table shapes of each layout for t's shape; the tables broadcast over the
# other axes
LAYOUTS = {"sbhd": ((S, B, H, D), (S, 1, 1)),
           "bshd": ((B, S, H, D), (1, S, 1)),
           "bhsd": ((B, H, S, D), (1, 1, S)),
           "positions": ((B, H, S, D), (B, 1, S))}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d_rot", [D, D // 2], ids=["full", "partial"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rope_core_forward_and_vjp_match_jax(layout, d_rot, dtype):
    """``_rope_core`` (the custom vjp) at each layout's table shape: the
    forward, dt, dcos and dsin against jax.vjp."""
    t_shape, tab = LAYOUTS[layout]
    t, jt, pt = _inputs(t_shape, dtype, 1)
    g, jg, pg = _inputs(t_shape, dtype, 2)
    ang = np.random.RandomState(3).uniform(0, 20, tab + (d_rot,)).astype(
        np.float32)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want, vjp = jax.vjp(jrope._rope_core, jt, jnp.asarray(cos),
                        jnp.asarray(sin))
    wdt, wdc, wds = vjp(jg)
    pc, ps = _t(cos).requires_grad_(True), _t(sin).requires_grad_(True)
    ptg = pt.clone().requires_grad_(True)
    got = rope._rope_core(ptg, pc, ps)
    assert got.dtype == pt.dtype
    dt, dc, ds = torch.autograd.grad(got, (ptg, pc, ps), pg)
    t64, g64, c64, s64 = _np(t), _np(g), _np(cos), _np(sin)
    _check_fwd(got.detach().float(), want, t64, c64, s64, dtype)
    _check_fwd(dt.float(), wdt, g64, c64, s64, dtype)
    _check_table_grads(dc, ds, wdc, wds, g64, t64, c64, s64)


CASES = {  # name -> (public function, t shape, table rows, positions kind)
    "sbhd": ("fused_apply_rotary_pos_emb", (S, B, H, D), S, None),
    "bshd": ("fused_apply_rotary_pos_emb_bshd", (B, S, H, D), S, None),
    "bhsd": ("fused_apply_rotary_pos_emb_bhsd", (B, H, S, D), S, None),
    "bhsd_offset": ("fused_apply_rotary_pos_emb_bhsd", (B, H, S, D),
                    S_TABLE, "offset"),
    "bhsd_per_element": ("fused_apply_rotary_pos_emb_bhsd", (B, H, S, D),
                         S_TABLE, "per_element"),
    "bhsd_past_the_table": ("fused_apply_rotary_pos_emb_bhsd",
                            (B, H, S, D), S_TABLE, "past"),
}


def _positions(kind):
    if kind == "offset":        # decode: slot i's run starts at pos[i]
        return np.array([0, 7], np.int32)
    if kind == "past":          # 20 + 11 > 23: the tail clamps
        return np.array([3, 20], np.int32)
    return np.random.RandomState(4).randint(0, S_TABLE, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d_rot", [D, D // 2], ids=["full", "partial"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_public_functions_match_jax(case, d_rot, dtype):
    """Each layout's public function from the angle table: the forward,
    dt and the table's gradient (through cos and sin) against
    jax.vjp."""
    name, t_shape, rows, kind = CASES[case]
    t, jt, pt = _inputs(t_shape, dtype, 5)
    g, jg, pg = _inputs(t_shape, dtype, 6)
    freqs = np.asarray(jrope.rope_frequencies(d_rot, rows))
    kw, pkw = {}, {}
    if kind is not None:
        pos = _positions(kind)
        kw["positions"] = jnp.asarray(pos)
        pkw["positions"] = torch.from_numpy(pos)
    want, vjp = jax.vjp(lambda a, f: getattr(jrope, name)(a, f, **kw), jt,
                        jnp.asarray(freqs))
    wdt, wdf = vjp(jg)
    ptg, pf = pt.clone().requires_grad_(True), _t(freqs).requires_grad_(True)
    got = getattr(rope, name)(ptg, pf, **pkw)
    dt, dfreq = torch.autograd.grad(got, (ptg, pf), pg)
    # the tables each element saw, laid out like t (float64)
    f2 = _np(freqs).reshape(rows, d_rot)
    if kind is None:
        ang = {"sbhd": f2[:, None, None], "bshd": f2[None, :, None],
               "bhsd": f2[None, None]}[case]
    else:
        idx = pkw["positions"].numpy()
        idx = idx if idx.ndim == 2 else idx[:, None] + np.arange(S)[None]
        ang = f2[np.clip(idx, 0, rows - 1)][:, None]
    c64, s64 = np.cos(ang), np.sin(ang)
    t64, g64 = _np(t), _np(g)
    _check_fwd(got.detach().float(), want, t64, c64, s64, dtype)
    _check_fwd(dt.float(), wdt, g64, c64, s64, dtype)
    # the table gradient -sin dcos + cos dsin: the sums' order bound
    # over at most b h s terms, plus 16 u of each term (the products and
    # an ulp of each table value on both sides)
    r, gr = t64[..., :d_rot], g64[..., :d_rot]
    terms = np.abs(gr) * (np.abs(r) + np.abs(_rot(r)))
    lim = (2 * B * H * S + 16) * U * _sum_to_table(terms, case, kind, rows,
                                                  d_rot)
    err = np.abs(_np(dfreq.reshape(rows, d_rot)) - _np(wdf).reshape(
        rows, d_rot))
    assert (err <= lim + 1e-30).all(), float((err / (lim + 1e-30)).max())


def _sum_to_table(x, case, kind, rows, d_rot):
    """Sum per-element terms (t's layout) onto the (rows, d_rot) table
    the way the gradient reaches it."""
    if kind is None:
        axis = {"sbhd": (1, 2), "bshd": (0, 2), "bhsd": (0, 1)}[case]
        return x.sum(axis=axis)
    pos = _positions(kind)
    idx = pos if pos.ndim == 2 else pos[:, None] + np.arange(S)[None]
    out = np.zeros((rows, d_rot))
    np.add.at(out, np.clip(idx, 0, rows - 1), x.sum(axis=1))
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d_rot", [D, D // 2], ids=["full", "partial"])
def test_cached_form_matches_jax(d_rot, dtype):
    """``fused_apply_rotary_pos_emb_cached`` on ``rope_cos_sin``'s
    tables: the forward, dt, dcos and dsin against jax.vjp."""
    t, jt, pt = _inputs((S, B, H, D), dtype, 7)
    g, jg, pg = _inputs((S, B, H, D), dtype, 8)
    jc, js = jrope.rope_cos_sin(d_rot, S)
    cos, sin = np.asarray(jc), np.asarray(js)
    want, vjp = jax.vjp(jrope.fused_apply_rotary_pos_emb_cached, jt, jc, js)
    wdt, wdc, wds = vjp(jg)
    ptg = pt.clone().requires_grad_(True)
    pc, ps = _t(cos).requires_grad_(True), _t(sin).requires_grad_(True)
    got = rope.fused_apply_rotary_pos_emb_cached(ptg, pc, ps)
    dt, dc, ds = torch.autograd.grad(got, (ptg, pc, ps), pg)
    t64, g64, c64, s64 = _np(t), _np(g), _np(cos), _np(sin)
    _check_fwd(got.detach().float(), want, t64, c64, s64, dtype)
    _check_fwd(dt.float(), wdt, g64, c64, s64, dtype)
    _check_table_grads(dc, ds, wdc, wds, g64, t64, c64, s64)


def test_rope_core_skips_table_grads_autograd_does_not_ask_for():
    """A table built from positions needs no gradient: the backward
    returns dt only (the true cotangents when asked, as above)."""
    t = torch.randn(S, B, H, D, requires_grad=True)
    cos, sin = rope.rope_cos_sin(D, S, device="cpu")
    out = rope._rope_core(t, cos, sin)
    (dt,) = torch.autograd.grad(out, (t,), torch.ones_like(out))
    assert dt.shape == t.shape and cos.grad is None


@pytest.mark.parametrize("dim,seq", [(8, 24), (32, 1024), (64, 1024)])
def test_tables_match_jax(dim, seq):
    """``rope_frequencies``: the angles bit for bit (the same fp32
    operations in JAX's order); ``rope_cos_sin``: within one fp32 ulp of
    XLA's cos and sin."""
    want = np.asarray(jrope.rope_frequencies(dim, seq))
    got = rope.rope_frequencies(dim, seq, device="cpu")
    assert tuple(got.shape) == want.shape == (seq, 1, 1, dim)
    np.testing.assert_array_equal(got.numpy(), want)
    for base in (10000.0, 500.0):
        np.testing.assert_array_equal(
            rope.rope_frequencies(dim, seq, base, device="cpu").numpy(),
            np.asarray(jrope.rope_frequencies(dim, seq, base)))
    jc, js = jrope.rope_cos_sin(dim, seq)
    pc, ps = rope.rope_cos_sin(dim, seq, device="cpu")
    for g, w in ((pc, jc), (ps, js)):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        ulp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
        assert (np.abs(g.numpy().astype(np.float64) - w) <= ulp).all()
    bc, bs = rope.rope_cos_sin(dim, seq, dtype=torch.bfloat16, device="cpu")
    assert bc.dtype == bs.dtype == torch.bfloat16
    assert torch.equal(bc, pc.to(torch.bfloat16))
