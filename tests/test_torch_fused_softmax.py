"""Port parity: ``apex_tpu_torch.transformer.functional.fused_softmax``
against the JAX package's, on the CPU (the JAX side runs its Pallas
kernels in interpret mode, as its own tests do; the port its plain
versions). Inputs come from a numpy seed.

Tolerance, per element, from the module's error models: the forward's
y within ``fused_softmax.fwd_limits(y_jax)`` (the two row sums in other
orders, (2 (sk - 1) + 12) ulps of y, plus one ulp of a bf16 y); the
input gradient within ``fused_softmax.bwd_limits`` given the gradient's
own sum-order bound and the forward's limit as the difference of the y
the two backwards start from. Where both sides take
``forward_torch_softmax`` (plain softmax in both frameworks) the same
limits hold."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import fused_softmax as jfs
from apex_tpu_torch.transformer.enums import AttnMaskType

pfs = importlib.import_module(
    "apex_tpu_torch.transformer.functional.fused_softmax")

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a, dt):
    """The same values in JAX and torch (bf16 rounded once, alike)."""
    j = jnp.asarray(a, _JDT[dt])
    t = torch.from_numpy(np.asarray(a, np.float32)).to(_TDT[dt])
    return j, t


def _np(a):
    return np.array(a, np.float32)


def _assert_within(name, got, want, lim):
    err = (got.float() - torch.from_numpy(_np(want))).abs()
    bad = err > lim
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {err.numel()} elements past the "
        f"limit; worst {float((err / lim.clamp_min(1e-30)).max()):.3g} of "
        f"it, max error {float(err.max()):.3g}")


def _check_fwd_bwd(jfn, pfn, x_np, dy_np, dt, scale):
    """Forward and input gradient of ``jfn`` (jax.vjp) and ``pfn``
    (autograd) on the same inputs, held to the error models."""
    jx, tx = _pair(x_np, dt)
    jdy, tdy = _pair(dy_np, dt)
    jy, vjp = jax.vjp(jfn, jx)
    jdx, = vjp(jdy)
    tx.requires_grad_(True)
    ty = pfn(tx)
    ty.backward(tdy)
    assert ty.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    y0 = torch.from_numpy(_np(jy)).to(ty.dtype)
    y_lim = pfs.fwd_limits(y0)
    _assert_within("y", ty.detach(), jy, y_lim)
    dx0 = torch.from_numpy(_np(jdx)).to(ty.dtype)
    lim = pfs.bwd_limits(ty.detach(), tdy, scale, dx0, y_err=y_lim)
    _assert_within("dx", tx.grad, jdx, lim)
    return ty.detach()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape,mask_q", [
    ((2, 3, 17, 40), True),    # (b, 1, sq, sk) mask, sq not a multiple of 8
    ((2, 2, 16, 24), False),   # BERT's (b, 1, 1, sk) mask
    ((1, 2, 5, 130), False),
])
def test_scaled_masked_softmax_matches_jax(dt, shape, mask_q):
    b, np_, sq, sk = shape
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3
    dy = rng.randn(*shape).astype(np.float32)
    mshape = (b, 1, sq, sk) if mask_q else (b, 1, 1, sk)
    mask = (rng.rand(*mshape) < 0.3).astype(np.int32)
    mask[0, ..., 0, :] = 1        # a fully masked row (every row if mask_q is off)
    scale = 0.7
    y = _check_fwd_bwd(
        lambda x: jfs.scaled_masked_softmax(x, jnp.asarray(mask), scale),
        lambda x: pfs.scaled_masked_softmax(x, torch.from_numpy(mask), scale),
        x, dy, dt, scale)
    # a fully masked row is uniform, 1 / sk (the constant is -10000, not
    # -inf), as the JAX kernel gives
    want = torch.full((sk,), 1.0 / sk).to(y.dtype)
    assert torch.equal(y[0, 0, 0], want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 24, 24), (3, 12, 20), (2, 2, 17, 17)])
def test_scaled_upper_triang_softmax_matches_jax(dt, shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32) * 2
    dy = rng.randn(*shape).astype(np.float32)
    y = _check_fwd_bwd(
        lambda x: jfs.scaled_upper_triang_masked_softmax(x, 1.3),
        lambda x: pfs.scaled_upper_triang_masked_softmax(x, 1.3),
        x, dy, dt, 1.3)
    sq, sk = shape[-2:]
    above = pfs._causal(sq, sk, "cpu")
    # exp(-10000 - max) underflows to exactly 0 above the diagonal
    assert bool((y.float()[..., above] == 0).all())


def _card_forward(x, mask, scale):
    """The card's padding-mask forward on the CPU, in fp32: z and the
    row max as the plain version, exp(z - max), the row sum in the
    register path's order (each thread of a row's group sums its vectors
    j and their elements in turn, then the group's sums meet by the
    shuffle butterfly), one correctly rounded reciprocal of the sum and
    a multiply a score."""
    z = torch.where(mask != 0, pfs._MASK_VALUE, x.float() * scale)
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    sk = z.shape[-1]
    vec = 16 // x.element_size()
    nvec = sk // vec
    chunks, lg = 4, 0       # csrc/fused_softmax.cu fwd_plan
    while chunks > 1 and chunks >= 2 * nvec:
        chunks //= 2
    while (chunks << lg) < nvec and lg < 5:
        lg += 1
    while (chunks << lg) < nvec:
        chunks *= 2
    tpr = 1 << lg
    part = torch.zeros(z.shape[:-1] + (tpr,), dtype=torch.float32)
    for lane in range(tpr):
        for j in range(chunks):
            for v in range(vec):
                c = (j * tpr + lane) * vec + v
                if c < sk:
                    part[..., lane] = part[..., lane] + e[..., c]
    o = tpr // 2
    while o:
        part = part + part[..., [i ^ o for i in range(tpr)]]
        o //= 2
    r = 1.0 / part[..., :1]
    return (e * r).to(x.dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sk", [128, 1000])
def test_reciprocal_form_within_fwd_limits(dt, sk):
    """``fwd_limits``' argument for the card's division (a reciprocal of
    the row sum and a multiply) holds where there is no card: that form,
    summed in the kernel's order, sits within the unchanged limit of the
    plain version and of the JAX package's kernel, a fully masked row
    uniform at 1/sk."""
    rng = np.random.RandomState(sk)
    x = rng.randn(2, 3, 5, sk).astype(np.float32) * 3
    mask = (rng.rand(2, 1, 1, sk) < 0.3).astype(np.int32)
    mask[0] = 1
    jx, tx = _pair(x, dt)
    tm = torch.from_numpy(mask)
    got = _card_forward(tx, tm, 0.7)
    plain = pfs.masked_softmax_fwd_plain(tx, tm, 0.7)
    jy = jfs.scaled_masked_softmax(jx, jnp.asarray(mask), 0.7)
    _assert_within("y vs plain", got, _np(plain.float()),
                   pfs.fwd_limits(plain))
    _assert_within("y vs JAX", got, jy,
                   pfs.fwd_limits(torch.from_numpy(_np(jy)).to(got.dtype)))
    want = torch.full((sk,), 1.0 / sk).to(got.dtype)
    assert bool((got[0] == want).all())
    if dt == "f32":   # the form differs from the plain version's
        assert not torch.equal(got, plain)


def test_mask_dtypes_agree():
    """int32, bool and int64 masks give the same probabilities."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 2, 8, 16).astype(np.float32))
    m = torch.from_numpy(rng.rand(2, 1, 1, 16) < 0.4)
    ys = [pfs.scaled_masked_softmax(x, mm, 0.5)
          for mm in (m, m.to(torch.int32), m.to(torch.int64))]
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])


_BRANCHES = [
    # (name, ctor kwargs, x dtype, sq, with mask, expected port branch)
    ("padding", dict(input_in_bf16=True, scale=0.5), "bf16", 12, True,
     "masked"),
    ("no_mask", dict(input_in_bf16=True, scale=0.5), "bf16", 12, False,
     "masked"),
    ("causal", dict(input_in_bf16=True, attn_mask_type="causal", scale=0.5),
     "bf16", 12, False, "causal"),
    ("fp32_input", dict(scale=0.5), "f32", 12, True, "torch"),
    ("fusion_off", dict(input_in_bf16=True,
                        scaled_masked_softmax_fusion=False, scale=0.5),
     "bf16", 12, True, "torch"),
    ("fusion_off_causal", dict(input_in_bf16=True, attn_mask_type="causal",
                               scaled_masked_softmax_fusion=False),
     "bf16", 12, False, "torch"),
    ("one_query", dict(input_in_bf16=True, scale=0.5), "bf16", 1, True,
     "torch"),
    ("mask_func", dict(scaled_masked_softmax_fusion=False,
                       mask_func="add"), "f32", 12, True, "torch"),
]


@pytest.mark.parametrize("name,kw,dt,sq,masked,branch", _BRANCHES,
                         ids=[b[0] for b in _BRANCHES])
def test_dispatcher_branches_match_jax(monkeypatch, name, kw, dt, sq, masked,
                                       branch):
    taken = []
    for fn, tag in (("scaled_masked_softmax", "masked"),
                    ("scaled_upper_triang_masked_softmax", "causal")):
        orig = getattr(pfs, fn)
        monkeypatch.setattr(pfs, fn, lambda *a, _o=orig, _t=tag, **k: (
            taken.append(_t), _o(*a, **k))[1])
    orig_torch = pfs.FusedScaleMaskSoftmax.forward_torch_softmax
    monkeypatch.setattr(pfs.FusedScaleMaskSoftmax, "forward_torch_softmax",
                        lambda self, *a: (taken.append("torch"),
                                          orig_torch(self, *a))[1])
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("attn_mask_type") == "causal":
        jkw["attn_mask_type"] = JaxMaskType.causal
        pkw["attn_mask_type"] = AttnMaskType.causal
    if kw.get("mask_func") == "add":   # an additive mask, both frameworks
        jkw["mask_func"] = lambda z, m: z - 1e4 * m
        pkw["mask_func"] = lambda z, m: z - 1e4 * m
    shape = (2, 3, sq, 20)
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32) * 2
    dy = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(2, 1, sq, 20) < 0.3).astype(np.int32) if masked \
        else None
    jsm = jfs.FusedScaleMaskSoftmax(**jkw)
    psm = pfs.FusedScaleMaskSoftmax(**pkw)
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    assert psm.is_kernel_available(pm, *shape) == jsm.is_kernel_available(
        jm, *shape) == (branch != "torch")
    scale = kw.get("scale") or 1.0
    _check_fwd_bwd(lambda x: jsm(x, jm), lambda x: psm(x, pm), x, dy, dt,
                   scale)
    assert taken == [branch]


def test_dispatcher_rejects_bad_flags():
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        pfs.FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        pfs.FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the wrappers never run: the kernels need the card."""
    x = torch.zeros((1, 1, 2, 8))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        pfs.masked_softmax_fwd_kernel(x, torch.zeros((1, 1, 1, 8),
                                                     dtype=torch.int32), 1.0)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        pfs.causal_softmax_fwd_kernel(x[0], 1.0)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        pfs.softmax_bwd_kernel(x, x, 1.0)
