"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports only torch and numpy, so it runs on a machine without
JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test here skips. Tolerances: LayerNorm fp32
1e-5, bf16 one bf16 ulp (2^-7 relative: both round one fp32 value);
attention o per element as ``flash_attention.o_limit`` states it (fp32
1e-5 (|o0| + 1); bf16 one ulp of o0 plus 2^-5 sqrt(sum p^2 v^2), the
scale of the error that rounding p and the prescaled q put into o);
base-2 lse absolute, fp32 1e-4, bf16 1e-2; the bf16 forward, dq and
dk/dv (tensor-core kernels) over ragged s (one row either side of the
64-row tile), d = 32, 48, 100 and 128, dropout 0.1 and 0.5 and the model
paths' strided views, by both load variants (16-byte copies and element
loads give the same bits), must repeat bit for bit, and the dropout keep
masks read off o and dv must equal the plain version's. Each C entry
launches 65535 tiles of its own height on the grid's y axis and refuses
one row more. The backward kernels and the softmax cross entropy are
held per element to the error models of ``fused_layer_norm.bwd_limits``,
``flash_attention.bwd_limits`` and ``xentropy.limits`` (the sum-order
bound of each fp32 reduction plus one ulp per rounding to bf16), the
limits ``chip_smoke.py`` uses; the cross-entropy backward also on rows
that do not start 16-byte aligned, a row shorter than one vector, labels
on a row's first and last column, every row ignored, x views off and on
dx's 16-byte phase, and two launches at GPT-medium's shape bit for bit.
The fused softmax forward and backward
are held per element to ``fused_softmax.fwd_limits`` and
``fused_softmax.bwd_limits`` (the row sums in other orders, one ulp of a bf16
or fp16 output; the forward also with uint8 and int32 masks read as vectors or
through strides, a query count off a block's rows, a causal batch count past
the grid's y limit, a fully masked batch uniform at 1/sk and a CUDA-graph
replay the same bits), and ``flat_adam`` to its plain version bit for bit (the
same fp32 operations in the same order, no FMA). So are
``flat_scale`` and ``flat_axpby`` (the outputs and the finite flags,
with an injected inf or NaN) and LAMB's stage 1 (m, v and u); the sums
of squares (the L2 partials, stage 1's partials, and ``flat_lamb``'s
params through the trust ratio) are held to
``multi_tensor_apply.kernels.sum_sq_limit`` and ``lamb_p_limit``, and
must repeat bit for bit. ``flat_sgd``, ``flat_adagrad`` and
``flat_novograd`` update params and state in place and are held to their
plain versions bit for bit, on clones of the same inputs, and to a
second launch; the whole ``flat_novograd`` (partials, per-tensor v,
elementwise pass) on the card against the CPU's, v to the sum-of-squares
model and m and p to its effect through the denominator. The int8
weight-only matmuls (``w8_matmul`` with and without bias,
``w8_matmul_nk``) are held per element to ``quant.kernels.w8_limit``
(two fp32 sum orders over K, the bias rounding, one ulp of a bf16
output) and must repeat bit for bit: the bf16 tensor-core kernel at
prefill M (ragged shapes and an unaligned x view too), the one-launch
decode gemv across CUDA-graph replays, the logits head's tensor-core
kernel at M <= 8 (N off its tile, K off its loads, an unaligned x, the
same bits under graph replay), and the regime each dtype and M takes,
read off the profiler's kernel names. The LayerNorm forward also
runs at ragged h, at teams of one to 32 warps, at 8 and at 32 columns a
thread, and on rows that do not start 16-byte aligned. The threefry bits
and dropout (``utils.prng``) are held to their plain int64 versions bit
for bit (one key and eight, aligned and unaligned views, a repeat, a
CUDA-graph replay), jax 0.9.0's known answers as constants, and the
samplers on the card to the CPU: uniforms, Bernoulli draws and
``randint`` bit for bit, ``normal`` and ``gumbel`` to
``prng.normal_limit`` and ``prng.gumbel_limit``. The paged attention
(one kernel: decode at one query a slot, speculative verify at k1) is
held per element to ``paged_attention.paged_limit`` (per query row;
linear and tree masks, fp32, bf16 and int8 pools, odd pages, hd 6, 48
and 256), a repeat and two page placements bit for bit, column j of a
linear verify to the decode kernel at pos + j bit for bit (also across
the boundaries of its parts of ``PART_ROWS`` rows, and a tree's chain
columns), slots of 1, ``PART_ROWS``, ``PART_ROWS`` + 1 and S_max rows
under two placements bit for bit, a split launch's CUDA-graph replays
bit for bit with the arrival counters left zero, and k1 past
``MAX_K1`` refused by the C entry without a launch counted or a counter
moved; the wrapper at k1 = 80
launches once a slice of ``verify_slices`` and gives the bits of
one-query launches (linear and tree), as it does for an fp32 prompt
chunk (one slot, k1 = 256 at pos 0, 256 and 512, over a gather row
apart from the parked stored row). The prompt-chunk kernel (bf16, tensor
cores) is held per element to ``paged_attention.chunk_limit`` at pages
of 16, 24 and 64, hd 64 and 48, sc 64 and 256, pos 0, mid-page and 768
(a split walk), repeats and two page placements bit for bit, and
refuses without a launch counted. A ``PagedDecodeEngine`` at
``spec_k`` 64 and 80 serves with the CPU's streams. A data-parallel
BERT step on an NCCL world of one equals the plain step bit for
bit. A ``PagedDecodeEngine`` with a ``FaultInjector`` quarantines a NaN
decode row on the card without touching the co-tenant's stream and
leaves the pool whole. A ``DisaggregatedRouter`` pair and a 2x2
``PoolRouter`` of paged engines on one card commit the colocated
scheduler's streams, a corrupt handoff quarantined and retried. Row 21
is also held at int8 tensor-parallel serving's tp 2 shapes (M 8, K 512
and 2048 into N 1024), and the flash forward, dq and dk/dv at
``EncdecMultiheadAttn``'s sequence-first views (s_q 256 != s_k 512)."""

import functools
import importlib

import numpy as np
import pytest
import torch

from apex_tpu_torch.models.gpt import _split_qkv
from apex_tpu_torch.normalization.fused_layer_norm import (
    LN_BWD, LN_FWD, layer_norm_bwd_kernel, layer_norm_bwd_plain,
    layer_norm_fwd_kernel, layer_norm_fwd_plain,
)
from apex_tpu_torch.transformer.functional.flash_attention import (
    FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD, attention_bwd_kernel,
    attention_bwd_plain, attention_fwd_kernel, attention_fwd_plain, o_limit,
)

ln_mod = importlib.import_module(
    "apex_tpu_torch.normalization.fused_layer_norm")
fa_mod = importlib.import_module(
    "apex_tpu_torch.transformer.functional.flash_attention")
xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
fsm = importlib.import_module(
    "apex_tpu_torch.transformer.functional.fused_softmax")
mta = importlib.import_module("apex_tpu_torch.multi_tensor_apply.kernels")

_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
_LSE_TOL = {"f32": 1e-4, "bf16": 1e-2}  # base 2, absolute


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _t(a, dt, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, _DT[dt])


_LN_CASES = [
    # (rows, h, x dtype, w/b dtype, mode, affine)
    (7, 64, "f32", "f32", "ln", True),
    (333, 1000, "f32", "f32", "ln", True),
    (1024, 1024, "bf16", "bf16", "ln", True),
    (8, 1024, "bf16", "bf16", "ln", True),
    (8192, 1024, "bf16", "f32", "ln", True),    # BERT O2
    (8192, 1024, "f32", "f32", "ln", True),     # BERT O1's residual LNs
    (64, 1000, "bf16", "f32", "rms", True),
    (64, 1024, "f32", "bf16", "ln", True),
    (7, 1000, "bf16", "bf16", "ln", False),
    (7, 1024, "f32", "f32", "rms", False),
    # ragged h (element loads), and the team sizes past one warp
    (16, 100, "bf16", "bf16", "ln", True),
    (5, 100, "f32", "bf16", "rms", True),
    (33, 4096, "bf16", "f32", "ln", True),
    (9, 8192, "f32", "f32", "ln", True),
    (3, 20000, "bf16", "bf16", "ln", True),
    (1024, 4096, "bf16", "f32", "ln", True),    # 32 columns a thread
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,xdt,wdt,mode,affine", _LN_CASES)
def test_layer_norm_kernel_matches_plain(cuda_device, rows, h, xdt, wdt,
                                         mode, affine):
    rng = np.random.RandomState(0)
    x = _t(rng.randn(rows, h) * 2.0 + 0.5, xdt, cuda_device)
    w = _t(1.0 + 0.5 * rng.randn(h), wdt, cuda_device) if affine else None
    b = _t(0.3 * rng.randn(h), wdt, cuda_device) \
        if affine and mode == "ln" else None
    before = LN_FWD.launches
    y, mean, rstd = layer_norm_fwd_kernel(x, w, b, mode, 1e-5)
    torch.cuda.synchronize()
    assert LN_FWD.launches == before + 1
    y0, mean0, rstd0 = layer_norm_fwd_plain(x, w, b, mode, 1e-5)
    assert y.dtype == x.dtype and rstd.dtype == torch.float32
    tol = 1e-5 if xdt == "f32" else 2 ** -7
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=1e-5)
    torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-6)
    if mode == "ln":
        torch.testing.assert_close(mean, mean0, rtol=1e-5, atol=1e-6)
    else:
        assert mean is None


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt,h", [("bf16", "bf16", 1024),
                                       ("f32", "f32", 1024),
                                       ("bf16", "f32", 1000)])
def test_layer_norm_kernel_reads_unaligned_rows(cuda_device, xdt, wdt, h):
    """x and y whose rows do not start 16-byte aligned (a view one
    element into a buffer) take the element loads, with the same bits as
    an aligned copy of the same x."""
    rng = np.random.RandomState(4)
    rows = 40
    buf = _t(rng.randn(rows * h + 1) * 2.0 + 0.5, xdt, cuda_device)
    x = buf[1:].view(rows, h)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w = _t(1.0 + 0.5 * rng.randn(h), wdt, cuda_device)
    b = _t(0.3 * rng.randn(h), wdt, cuda_device)
    y, mean, rstd = layer_norm_fwd_kernel(x, w, b, "ln", 1e-5)
    y1, mean1, rstd1 = layer_norm_fwd_kernel(x.clone(), w, b, "ln", 1e-5)
    torch.cuda.synchronize()
    y0, mean0, rstd0 = layer_norm_fwd_plain(x, w, b, "ln", 1e-5)
    tol = 1e-5 if xdt == "f32" else 2 ** -7
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=1e-5)
    torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-6)
    assert torch.equal(y, y1) and torch.equal(mean, mean1) \
        and torch.equal(rstd, rstd1)


def _assert_o_close(o, o0, q, k, v, mask, causal, scale):
    err = (o.float() - o0.float()).abs()
    lim = o_limit(q, k, v, mask, o0, causal=causal, scale=scale)
    bad = err > lim
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {err.numel()} elements past o_limit; worst "
        f"{float((err / lim.clamp_min(1e-30)).max()):.3g} of it, max "
        f"error {float(err.max()):.3g}")


_FA_CASES = [
    # (b, h, s, d, causal, masked, dtype); bf16 runs on the tensor cores:
    # s past a 64-row tile (40, 130, 200, 300), the element-load variant
    # (d = 100), d = 32 / 48 / 128 (d zero-padded to 32, 64, 128)
    (2, 2, 40, 16, False, True, "f32"),
    (2, 2, 130, 64, True, True, "f32"),
    (1, 4, 256, 128, True, False, "f32"),
    (1, 16, 1024, 64, True, True, "bf16"),
    (2, 16, 300, 64, False, True, "bf16"),
    (2, 2, 40, 100, True, False, "bf16"),
    (2, 2, 40, 64, False, True, "bf16"),
    (2, 3, 130, 64, True, True, "bf16"),
    (1, 4, 300, 128, True, True, "bf16"),
    (2, 2, 130, 100, False, True, "bf16"),
    (2, 2, 40, 32, True, True, "bf16"),
    (1, 2, 200, 48, True, True, "bf16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("b,h,s,d,causal,masked,dt", _FA_CASES)
def test_flash_kernel_matches_plain(cuda_device, b, h, s, d, causal,
                                    masked, dt, rate):
    rng = np.random.RandomState(0)
    q, k, v = (_t(rng.randn(b, h, s, d), dt, cuda_device)
               for _ in range(3))
    m = None
    if masked:
        mask = np.ones((b, s), np.int32)
        mask[0, 0] = 0           # under causal, row 0 of batch 0 sees nothing
        mask[:, s - 9:] = 0      # a padded tail
        m = torch.from_numpy(mask).to(cuda_device)
    kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
    before = FLASH_FWD.launches
    o, lse = attention_fwd_kernel(q, k, v, m, (123, 456), **kw)
    o2, lse2 = attention_fwd_kernel(q, k, v, m, (123, 456), **kw)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o0, lse0 = attention_fwd_plain(q, k, v, m, (123, 456), **kw)
    assert o.dtype == q.dtype and o.shape == (b, h, s, d)
    _assert_o_close(o, o0, q, k, v, m, causal, d ** -0.5)
    torch.testing.assert_close(lse, lse0, rtol=0.0, atol=_LSE_TOL[dt])
    if masked and causal:
        assert bool((o[0, :, 0] == 0).all())
        assert bool(torch.isinf(lse[:h, 0]).all())


@pytest.mark.cuda
def test_flash_kernel_reads_strided_qkv(cuda_device):
    """q, k, v as views into one fused (b, s, 3*h) projection, the GPT
    prefill's layout (``_split_qkv``), with a padded-tail key mask: the
    kernel matches the plain version on the same views and gives the
    same result as on contiguous copies."""
    rng = np.random.RandomState(1)
    q, k, v = _split_qkv(_t(rng.randn(1, 200, 3 * 8 * 64), "bf16",
                            cuda_device), 64)
    mask = torch.ones((1, 200), dtype=torch.int32, device=cuda_device)
    mask[:, 180:] = 0
    kw = dict(causal=True, scale=0.125, rate=0.0)
    o, lse = attention_fwd_kernel(q, k, v, mask, (0, 0), **kw)
    o1, _ = attention_fwd_kernel(q.contiguous(), k.contiguous(),
                                 v.contiguous(), mask, (0, 0), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o1)
    o0, lse0 = attention_fwd_plain(q, k, v, mask, (0, 0), **kw)
    _assert_o_close(o, o0, q, k, v, mask, True, 0.125)
    torch.testing.assert_close(lse, lse0, rtol=0.0, atol=_LSE_TOL["bf16"])


def _qkv_views(layout, b, h, s, d, dt, dev, rng):
    """q, k, v as the model paths hand them over: GPT's ``_split_qkv``
    views of a (b, s, 3 h d) head-major projection, BERT's views of a
    (b, s, 3, h, d) projection, or those views shifted by one element
    (rows no longer 16-byte aligned: the element-load variant)."""
    if layout == "gpt":
        return _split_qkv(_t(rng.randn(b, s, 3 * h * d), dt, dev), d)
    flat = _t(rng.randn(b * s * 3 * h * d + 1), dt, dev)
    off = 1 if layout == "bert_shifted" else 0
    qkv = flat[off:off + b * s * 3 * h * d].view(b, s, 3, h, d)
    return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("layout,s,causal", [
    ("gpt", 130, True), ("gpt", 300, True), ("bert", 130, False),
    ("bert", 128, False), ("bert_shifted", 130, False)])
def test_flash_kernel_views_take_both_load_variants(cuda_device, layout, s,
                                                    causal, rate):
    """The model paths' strided views reach the cp.async variant, views
    one element off their alignment the element-load variant, and both
    give the bits of the same kernel on contiguous copies (forward, dq
    and dk/dv), within the error models of the plain version."""
    b, h, d = 2, 4, 64
    rng = np.random.RandomState(3)
    q, k, v = _qkv_views(layout, b, h, s, d, "bf16", cuda_device, rng)
    # the C entry's rule: copies where every row of q, k and v starts on
    # a 16-byte boundary (d = 64 fills whole copies)
    rows16 = all(t.data_ptr() % 16 == 0
                 and all(st % 8 == 0 for st in t.stride()[:3])
                 for t in (q, k, v))
    assert rows16 is (layout != "bert_shifted")
    mask = torch.ones((b, s), dtype=torch.int32, device=cuda_device)
    mask[0, 0] = 0
    mask[:, s - 11:] = 0
    do = _t(rng.randn(b, h, s, d), "bf16", cuda_device)
    seed = (0x1234ABCD, 0x9876FEDC)
    kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
    o, lse = attention_fwd_kernel(q, k, v, mask, seed, **kw)
    cont = [t.contiguous() for t in (q, k, v)]
    o1, lse1 = attention_fwd_kernel(*cont, mask, seed, **kw)
    delta = (do.float() * o.float()).sum(-1).reshape(-1, s)
    dkv = fa_mod.attention_dkv_kernel(q, k, v, mask, do, lse, delta, seed,
                                      **kw)
    dkv1 = fa_mod.attention_dkv_kernel(*cont, mask, do, lse, delta, seed,
                                       **kw)
    dq = fa_mod.attention_dq_kernel(q, k, v, mask, do, lse, delta, seed, **kw)
    dq1 = fa_mod.attention_dq_kernel(*cont, mask, do, lse, delta, seed, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    assert torch.equal(dkv[0], dkv1[0]) and torch.equal(dkv[1], dkv1[1])
    assert torch.equal(dq, dq1)
    o0, lse0 = attention_fwd_plain(q, k, v, mask, seed, **kw)
    _assert_o_close(o, o0, q, k, v, mask, causal, d ** -0.5)
    torch.testing.assert_close(lse, lse0, rtol=0.0, atol=_LSE_TOL["bf16"])
    want = attention_bwd_plain(q, k, v, mask, o, lse, do, seed, **kw)
    lims = fa_mod.bwd_limits(q, k, v, mask, o, lse, do, *want, **kw)
    for name, g, w0, lim in zip(("dq", "dk", "dv"), (dq, *dkv), want, lims):
        _assert_within(name, g, w0, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("d,sq,sk", [(64, 300, 64), (128, 130, 128)])
def test_flash_kernel_keep_masks_equal_plain(cuda_device, d, sq, sk, rate):
    """The dropout keep mask read straight off the kernels. Forward: q =
    0 makes every score 0 and every p 1 before normalisation, and v the
    identity (s_k = d), so o[q, j] = p_drop[q, j] / s_k, 0 exactly where
    (q, j) is dropped. dk/dv: lse = log2 s_k makes p = 1 / s_k, and do
    the identity (s_q = d), so dv[k, j] = p_drop[j, k]. Both must equal
    the plain version's mask at every (head, q, k), bit for bit."""
    b, h = 2, 3
    dev = cuda_device
    seed = (0x1234ABCD, 0x9876FEDC)
    kw = dict(causal=False, scale=d ** -0.5, rate=rate)
    eye = torch.eye(d, dtype=torch.bfloat16, device=dev)
    zero = torch.zeros((b, h, sq, d), dtype=torch.bfloat16, device=dev)
    v = eye[:sk].expand(b, h, sk, d)
    o, _ = attention_fwd_kernel(zero, zero[:, :, :sk], v, None, seed, **kw)
    keep = fa_mod._keep_mask(b, h, sq, sk, seed, rate, dev)
    assert torch.equal(o != 0, keep)
    q = torch.zeros((b, h, d, d), dtype=torch.bfloat16, device=dev)
    k = _t(np.random.RandomState(5).randn(b, h, sk, d), "bf16", dev)
    do = eye.expand(b, h, d, d)
    lse = torch.full((b * h, d), float(np.log2(sk)), device=dev)
    delta = torch.zeros((b * h, d), device=dev)
    _, dv = fa_mod.attention_dkv_kernel(q, k, k, None, do, lse, delta, seed,
                                        **kw)
    torch.cuda.synchronize()
    keep = fa_mod._keep_mask(b, h, d, sk, seed, rate, dev)
    assert torch.equal(dv != 0, keep.transpose(-1, -2))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dt,rows", [
    ("fwd", "bf16", 64), ("fwd", "f32", 32), ("dq", "bf16", 64),
    ("dkv", "bf16", 64), ("dkv", "f32", 32)])
def test_flash_grid_limit_follows_the_tile_height(cuda_device, kernel, dt,
                                                  rows):
    """Each kernel puts one block per tile of its sequence (q rows for
    the forward and dq, keys for dk/dv) on the grid's y axis, at most
    65535. The C entry, which knows the tile height (64 rows on the
    tensor cores, 32 on the CUDA cores), launches 65535 tiles and refuses
    one row more with CUDA's invalid-configuration error, and the
    refused launch keeps the count."""
    dev, d = cuda_device, 8
    z = dict(dtype=_DT[dt], device=dev)
    kw = dict(causal=False, scale=d ** -0.5, rate=0.0)
    counter = {"fwd": FLASH_FWD, "dq": FLASH_BWD_DQ,
               "dkv": FLASH_BWD_DKV}[kernel]

    def launch(s):
        sq, sk = (s, 3) if kernel != "dkv" else (3, s)
        q = torch.zeros((1, 2, sq, d), **z)
        k = torch.zeros((1, 2, sk, d), **z)
        if kernel == "fwd":
            return attention_fwd_kernel(q, k, k, None, (0, 0), **kw)
        lse = torch.zeros((2, sq), device=dev)
        fn = (fa_mod.attention_dq_kernel if kernel == "dq"
              else fa_mod.attention_dkv_kernel)
        return fn(q, k, k, None, q, lse, lse, (0, 0), **kw)

    before = counter.launches
    launch(65535 * rows)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    with pytest.raises(RuntimeError, match="invalid configuration"):
        launch(65535 * rows + 1)
    assert counter.launches == before + 1


def _assert_within(name, got, want, lim):
    err = (got.float() - want.float()).abs()
    bad = err > lim
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {err.numel()} elements past the "
        f"limit; worst {float((err / lim.clamp_min(1e-30)).max()):.3g} of "
        f"it, max error {float(err.max()):.3g}")


_LN_BWD_CASES = [
    # (rows, h, x dtype, w/b dtype, mode, affine)
    (8192, 1024, "bf16", "f32", "ln", True),    # BERT O2
    (8192, 1024, "f32", "f32", "ln", True),     # BERT O1's residual LNs
    (1024, 1024, "bf16", "bf16", "ln", True),   # GPT O2
    (1024, 1024, "bf16", "bf16", "rms", True),
    (333, 1000, "f32", "f32", "ln", False),
    (2048, 4096, "bf16", "f32", "ln", True),    # JAX column-split regime
    (2048, 4096, "f32", "f32", "ln", True),
    (7, 64, "f32", "f32", "rms", False),
    (1024, 1000, "bf16", "bf16", "ln", True),   # ragged h, 16-byte chunks
    (333, 1001, "bf16", "f32", "ln", True),     # h off the chunk: elements
    (333, 1001, "f32", "bf16", "rms", True),
    (65, 8192, "bf16", "f32", "ln", True),      # the largest h
    (7, 2731, "f32", "f32", "ln", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,xdt,wdt,mode,affine", _LN_BWD_CASES)
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, rows, h, xdt, wdt,
                                             mode, affine):
    rng = np.random.RandomState(0)
    x = _t(rng.randn(rows, h) * 2.0 + 0.5, xdt, cuda_device)
    dy = _t(rng.randn(rows, h), xdt, cuda_device)
    w = _t(1.0 + 0.5 * rng.randn(h), wdt, cuda_device) if affine else None
    b = _t(0.3 * rng.randn(h), wdt, cuda_device) \
        if affine and mode == "ln" else None
    _, mean, rstd = layer_norm_fwd_plain(x, w, b, mode, 1e-5)
    before = LN_BWD.launches
    got = layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)
    again = layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)
    torch.cuda.synchronize()
    assert LN_BWD.launches == before + 2
    want = layer_norm_bwd_plain(dy, x, w, b, mean, rstd)
    lims = ln_mod.bwd_limits(dy, x, w, mean, rstd, *want)
    for name, g, g2, w0, lim in zip(("dx", "dgamma", "dbeta"), got, again,
                                    want, lims):
        assert (g is None) == (w0 is None)
        if g is None:
            continue
        assert g.dtype == w0.dtype and g.shape == w0.shape
        assert torch.equal(g, g2)   # no atomics: the same bits every run
        _assert_within(name, g, w0, lim)


def _flash_inputs(b, h, s, d, dt, dev, views, masked, seed=0):
    rng = np.random.RandomState(seed)
    if views:  # BERT's layout: (b, s, 3, h, d) projection, strided views
        qkv = _t(rng.randn(b, s, 3, h, d), dt, dev)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    else:
        q, k, v = (_t(rng.randn(b, h, s, d), dt, dev) for _ in range(3))
    m = None
    if masked:
        mask = np.ones((b, s), np.int32)
        mask[0, 0] = 0           # under causal, row 0 of batch 0 sees nothing
        mask[:, s - s // 8:] = 0  # a padded tail
        m = torch.from_numpy(mask).to(dev)
    do = _t(rng.randn(b, h, s, d), dt, dev)
    return q, k, v, m, do


_FA_BWD_CASES = [
    # (b, h, s, d, dtype, causal, masked, rate, views); bf16 dk/dv runs
    # on the tensor cores: s past a 64-key tile, d = 100 (element loads),
    # d = 32 / 48 / 128, dropout 0.1 and 0.5
    (64, 16, 128, 64, "bf16", False, True, 0.0, True),   # BERT-Large step
    (1, 16, 1024, 64, "bf16", True, False, 0.0, False),
    (2, 16, 300, 64, "bf16", True, True, 0.1, False),
    (1, 4, 256, 128, "f32", True, False, 0.0, False),
    (2, 2, 40, 100, "bf16", True, True, 0.0, False),
    (2, 2, 130, 16, "f32", False, True, 0.2, True),
    (2, 3, 40, 64, "bf16", False, True, 0.5, False),
    (2, 2, 130, 64, "bf16", True, True, 0.1, True),
    (1, 4, 300, 128, "bf16", True, True, 0.5, False),
    (2, 2, 130, 100, "bf16", False, True, 0.1, False),
    (2, 2, 200, 48, "bf16", True, True, 0.0, False),
    (1, 2, 40, 32, "bf16", True, False, 0.5, False),
    # the bf16 dq kernel's 64-row q tile: one row short, one row over,
    # and causal runs whose last q tile holds one row
    (2, 4, 63, 64, "bf16", False, True, 0.0, True),
    (2, 4, 65, 64, "bf16", False, True, 0.1, True),
    (2, 4, 129, 64, "bf16", True, True, 0.0, False),
    (1, 4, 129, 128, "bf16", True, False, 0.5, False),
    (2, 2, 65, 100, "bf16", True, True, 0.0, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d,dt,causal,masked,rate,views",
                         _FA_BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda_device, b, h, s, d, dt, causal,
                                       masked, rate, views):
    q, k, v, m, do = _flash_inputs(b, h, s, d, dt, cuda_device, views,
                                   masked)
    kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
    seed = (0x1234ABCD, 0x9876FEDC)
    o, lse = attention_fwd_kernel(q, k, v, m, seed, **kw)
    # the forward at this shape and layout, before its o and lse feed
    # both backward versions
    o0, lse0 = attention_fwd_plain(q, k, v, m, seed, **kw)
    _assert_o_close(o, o0, q, k, v, m, causal, d ** -0.5)
    torch.testing.assert_close(lse, lse0, rtol=0.0, atol=_LSE_TOL[dt])
    before = FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches
    got = attention_bwd_kernel(q, k, v, m, o, lse, do, seed, **kw)
    again = attention_bwd_kernel(q, k, v, m, o, lse, do, seed, **kw)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches) == (
        before[0] + 2, before[1] + 2)
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))
    want = attention_bwd_plain(q, k, v, m, o, lse, do, seed, **kw)
    lims = fa_mod.bwd_limits(q, k, v, m, o, lse, do, *want, **kw)
    for name, g, w0, lim in zip(("dq", "dk", "dv"), got, want, lims):
        assert g.dtype == q.dtype and g.shape == q.shape
        assert bool(torch.isfinite(g).all())
        _assert_within(name, g, w0, lim)
    if masked and causal:
        assert bool((got[0][0, :, 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_at_encdec_sequence_first_views(cuda_device, rate):
    """``EncdecMultiheadAttn``'s call (tgt 256 != src 512): q a
    sequence-first head view of a (256, b, 1024) projection, k and v
    views of a packed head-major (512, b, 2048) kv projection, a key mask
    over the source; the forward, dq and dk/dv against their plain
    versions per element (``o_limit``, ``bwd_limits``), repeats the same
    bits."""
    from apex_tpu_torch.contrib.multihead_attn.multihead_attn import (
        _split_heads,
    )

    dev = cuda_device
    rng = np.random.RandomState(3)
    b, nh, hd, tgt, src = 4, 16, 64, 256, 512
    q = _split_heads(_t(rng.randn(tgt, b, nh * hd), "bf16", dev), nh)
    kv = _t(rng.randn(src, b, 2 * nh * hd), "bf16", dev).reshape(
        src, b, nh, 2, hd)
    k, v = (kv[:, :, :, j].permute(1, 2, 0, 3) for j in range(2))
    do = _split_heads(_t(rng.randn(tgt, b, nh * hd), "bf16", dev), nh)
    mask = np.ones((b, src), np.int32)
    for i in range(b):
        mask[i, src - 37 * i:] = 0
    m = torch.from_numpy(mask).to(dev)
    kw = dict(causal=False, scale=hd ** -0.5, rate=rate)
    seed = (0x1234ABCD, 0x9876FEDC)
    o, lse = attention_fwd_kernel(q, k, v, m, seed, **kw)
    o2, lse2 = attention_fwd_kernel(q, k, v, m, seed, **kw)
    o0, lse0 = attention_fwd_plain(q, k, v, m, seed, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _assert_o_close(o, o0, q, k, v, m, False, hd ** -0.5)
    torch.testing.assert_close(lse, lse0, rtol=0.0, atol=_LSE_TOL["bf16"])
    got = attention_bwd_kernel(q, k, v, m, o, lse, do, seed, **kw)
    again = attention_bwd_kernel(q, k, v, m, o, lse, do, seed, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))
    want = attention_bwd_plain(q, k, v, m, o, lse, do, seed, **kw)
    lims = fa_mod.bwd_limits(q, k, v, m, o, lse, do, *want, **kw)
    for name, g, w0, lim, like in zip(("dq", "dk", "dv"), got, want, lims,
                                      (q, k, v)):
        assert g.shape == like.shape and bool(torch.isfinite(g).all())
        _assert_within(name, g, w0, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,dt,eps", [
    (8192, 30522, "f32", 0.0), (8192, 30522, "f32", 0.1),
    (100, 1000, "bf16", 0.1), (5, 77, "f32", 0.0),
    (8192, 50304, "bf16", 0.0),    # GPT-medium's step: 393 x 128 columns
    (64, 50257, "bf16", 0.1),      # GPT-2's vocabulary: rows at any even byte
    (3, 7, "bf16", 0.0)])          # a row shorter than one 16-byte vector
def test_xentropy_kernels_match_plain(cuda_device, n, v, dt, eps):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn((n, v), generator=g, device=cuda_device) * 3.0).to(
        _DT[dt])
    labels = torch.randint(0, v, (n,), generator=g, device=cuda_device)
    labels[torch.rand((n,), generator=g, device=cuda_device) < 0.15] = -1
    dloss = torch.rand((n,), generator=g, device=cuda_device) + 0.5
    before = xent.XENT_FWD.launches, xent.XENT_BWD.launches
    loss, lse = xent.xentropy_fwd_kernel(x, labels, eps)
    dx = xent.xentropy_bwd_kernel(x, labels, lse, dloss, eps)
    torch.cuda.synchronize()
    assert (xent.XENT_FWD.launches, xent.XENT_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    loss0, lse0 = xent.xentropy_fwd_plain(x, labels, eps)
    dx0 = xent.xentropy_bwd_plain(x, labels, lse0, dloss, eps)
    lim_loss, lim_lse, lim_dx = xent.limits(x, labels, eps, loss0, lse0,
                                            dloss, dx0)
    _assert_within("loss", loss, loss0, lim_loss)
    _assert_within("lse", lse, lse0, lim_lse)
    _assert_within("dx", dx, dx0, lim_dx)
    assert dx.dtype == x.dtype
    assert bool((loss[labels < 0] == 0).all())
    assert bool((dx[labels < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,dt,eps,labels,offset", [
    # labels on the first and the last column of their rows, and each
    # row's scalar head and tail (rows of 30522 fp32 start at 8-byte
    # steps, of 50257 bf16 at 2-byte steps)
    (64, 50257, "bf16", 0.1, "edges", 0),
    (9, 30522, "f32", 0.0, "edges", 0),
    (3, 7, "bf16", 0.1, "edges", 0),
    (16, 50304, "bf16", 0.0, "ignored", 0),   # every row ignored
    (9, 30522, "f32", 0.1, "ignored", 0),
    # x a view at an element offset: off dx's 16-byte phase (one element
    # a vector) or on it (8 bf16, 4 fp32: the vectors)
    (33, 1003, "bf16", 0.0, "edges", 1),
    (33, 1003, "f32", 0.1, "edges", 2),
    (33, 1003, "bf16", 0.0, "edges", 8),
    (33, 1003, "f32", 0.0, "edges", 4)])
def test_xentropy_bwd_rows_and_labels_match_plain(cuda_device, n, v, dt, eps,
                                                  labels, offset):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    buf = (torch.randn((n * v + offset,), generator=g, device=cuda_device)
           * 3.0).to(_DT[dt])
    x = buf[offset:].view(n, v)
    lab = torch.full((n,), -1, dtype=torch.int64, device=cuda_device)
    if labels == "edges":
        lab[0::2] = 0
        lab[1::2] = v - 1
    dloss = torch.rand((n,), generator=g, device=cuda_device) + 0.5
    loss, lse = xent.xentropy_fwd_kernel(x, lab, eps)
    dx = xent.xentropy_bwd_kernel(x, lab, lse, dloss, eps)
    torch.cuda.synchronize()
    loss0, lse0 = xent.xentropy_fwd_plain(x, lab, eps)
    dx0 = xent.xentropy_bwd_plain(x, lab, lse0, dloss, eps)
    lim_loss, lim_lse, lim_dx = xent.limits(x, lab, eps, loss0, lse0,
                                            dloss, dx0)
    _assert_within("loss", loss, loss0, lim_loss)
    _assert_within("lse", lse, lse0, lim_lse)
    _assert_within("dx", dx, dx0, lim_dx)
    assert dx.dtype == x.dtype and bool(torch.isfinite(dx).all())
    assert bool((dx[lab < 0] == 0).all())


@pytest.mark.cuda
def test_xentropy_bwd_repeats_bit_equal(cuda_device):
    """Two launches at GPT-medium's (8192, 50304) bf16 give the same
    bits: nothing is reduced across threads."""
    n, v = 8192, 50304
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn((n, v), generator=g, device=cuda_device) * 3.0).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device=cuda_device)
    dloss = torch.full((n,), 1.0 / n, device=cuda_device)
    _, lse = xent.xentropy_fwd_kernel(x, labels, 0.0)
    dx = xent.xentropy_bwd_kernel(x, labels, lse, dloss, 0.0)
    again = xent.xentropy_bwd_kernel(x, labels, lse, dloss, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(dx, again)


def _gpt_qkv(b, h, s, d, dev, seed=0):
    """q, k, v as the GPT training step hands them to flash: q and k out
    of RoPE (new tensors), v a ``_split_qkv`` view of the fused bf16
    projection; and a do laid out (b, s, h, d) as the heads' merge
    gives it."""
    from apex_tpu_torch.transformer.functional import (
        fused_apply_rotary_pos_emb_bhsd, rope_frequencies,
    )

    rng = np.random.RandomState(seed)
    q, k, v = _split_qkv(_t(rng.randn(b, s, 3 * h * d), "bf16", dev), d)
    freqs = rope_frequencies(d, s, device=dev)
    do = _t(rng.randn(b, s, h, d), "bf16", dev).transpose(1, 2)
    return (fused_apply_rotary_pos_emb_bhsd(q, freqs),
            fused_apply_rotary_pos_emb_bhsd(k, freqs), v, do)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_flash_gpt_training_shape_mixed_strides(cuda_device, masked):
    """The causal forward, dq and dk/dv at GPT-medium's training shape
    (b 8, h 16, s 1024, d 64) on RoPE'd q and k beside a view v (three
    tensors with different strides), with and without a key mask: per
    element to ``o_limit`` and ``bwd_limits``, a repeat the same bits."""
    b, h, s, d = 8, 16, 1024, 64
    q, k, v, do = _gpt_qkv(b, h, s, d, cuda_device)
    m = None
    if masked:
        m = torch.ones((b, s), dtype=torch.int32, device=cuda_device)
        m[:, s - s // 8:] = 0
    kw = dict(causal=True, scale=d ** -0.5, rate=0.0)
    o, lse = attention_fwd_kernel(q, k, v, m, (0, 0), **kw)
    o2, lse2 = attention_fwd_kernel(q, k, v, m, (0, 0), **kw)
    got = attention_bwd_kernel(q, k, v, m, o, lse, do, (0, 0), **kw)
    again = attention_bwd_kernel(q, k, v, m, o, lse, do, (0, 0), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))
    o0, lse0 = attention_fwd_plain(q, k, v, m, (0, 0), **kw)
    _assert_o_close(o, o0, q, k, v, m, True, d ** -0.5)
    fin = torch.isfinite(lse0)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], lse0[fin], rtol=0.0,
                               atol=_LSE_TOL["bf16"])
    want = attention_bwd_plain(q, k, v, m, o, lse, do, (0, 0), **kw)
    lims = fa_mod.bwd_limits(q, k, v, m, o, lse, do, *want, **kw)
    for name, g, w0, lim in zip(("dq", "dk", "dv"), got, want, lims):
        assert bool(torch.isfinite(g).all())
        _assert_within(name, g, w0, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,decode", [((8, 16, 1024, 64), False),
                                          ((8, 16, 1, 64), True)],
                         ids=["train", "decode"])
def test_rope_on_card_matches_cpu(cuda_device, shape, decode):
    """``fused_apply_rotary_pos_emb_bhsd`` and its dt on the card against
    the CPU on the same bf16 input: within ``fused_rope``'s error model
    (8 u of |t| |cos| + |rotate_half(t)| |sin|, plus one bf16 ulp of the
    output), per-slot positions at the decode tick."""
    from apex_tpu_torch.transformer.functional import fused_rope as rope

    rng = np.random.RandomState(1)
    b, h, s, d = shape
    t = _t(rng.randn(*shape), "bf16", cuda_device).requires_grad_(True)
    g = _t(rng.randn(*shape), "bf16", cuda_device)
    rows = 1024
    freqs = rope.rope_frequencies(d, rows if decode else s,
                                  device=cuda_device)
    pos = torch.tensor([0, 1, 63, 100, 511, 512, 900, 1023],
                       device=cuda_device) if decode else None
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        tt = t.detach().to(dev).requires_grad_(True)
        y = rope.fused_apply_rotary_pos_emb_bhsd(
            tt, freqs.to(dev), None if pos is None else pos.to(dev))
        (dt,) = torch.autograd.grad(y, (tt,), g.to(dev))
        outs.append((y.detach().cpu(), dt.cpu()))
    f2 = freqs.cpu().reshape(-1, d).double()
    idx = pos.cpu()[:, None] if decode else torch.arange(s)
    cos = torch.cos(f2)[idx].reshape(b if decode else 1, 1, s, d)
    sin = torch.sin(f2)[idx].reshape(cos.shape)
    for x, (got, want) in ((t, (outs[0][0], outs[1][0])),
                           (g, (outs[0][1], outs[1][1]))):
        x = x.detach().cpu().double()
        half = d // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        lim = 8 * 2.0 ** -24 * (x.abs() * cos.abs() + rot.abs() * sin.abs()) \
            + 2.0 ** -7 * want.double().abs()
        _assert_within("rope", got.double(), want.double(), lim)


_SOFTMAX_CASES = [
    # (b, np, sq, sk, dtype, mask: "key" (b, 1, 1, sk) padded tail, "query"
    # (b, 1, sq, sk) random, "full" a fully masked row)
    (64, 16, 128, 128, "bf16", "key"),       # the BERT-Large step
    (2, 3, 17, 40, "f32", "query"),
    (2, 2, 16, 24, "bf16", "full"),
    (1, 2, 5, 130, "bf16", "key"),           # sk % 8: the generic path
    (2, 4, 8, 1000, "f32", "query"),         # eight vectors a thread
    (2, 2, 16, 256, "f16", "key"),
    (1, 1, 3, 3000, "f32", "key"),           # past the register path
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,np_,sq,sk,dt,kind", _SOFTMAX_CASES)
def test_masked_softmax_kernels_match_plain(cuda_device, b, np_, sq, sk, dt,
                                            kind):
    rng = np.random.RandomState(0)
    x = _t(rng.randn(b, np_, sq, sk) * 3, dt, cuda_device)
    dy = _t(rng.randn(b, np_, sq, sk), dt, cuda_device)
    if kind == "query":
        mask = rng.rand(b, 1, sq, sk) < 0.3
    else:
        mask = np.zeros((b, 1, 1, sk), bool)
        mask[..., sk - sk // 8:] = True
        if kind == "full":
            mask[0] = True
    mask = torch.from_numpy(mask.astype(np.int32)).to(cuda_device)
    before = fsm.SOFTMAX_FWD.launches, fsm.SOFTMAX_BWD.launches
    y = fsm.masked_softmax_fwd_kernel(x, mask, 0.125)
    dx = fsm.softmax_bwd_kernel(y, dy, 0.125)
    torch.cuda.synchronize()
    assert (fsm.SOFTMAX_FWD.launches, fsm.SOFTMAX_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    y0 = fsm.masked_softmax_fwd_plain(x, mask, 0.125)
    dx0 = fsm.softmax_bwd_plain(y, dy, 0.125)
    assert y.dtype == dx.dtype == x.dtype
    _assert_within("y", y, y0, fsm.fwd_limits(y0))
    _assert_within("dx", dx, dx0, fsm.bwd_limits(y, dy, 0.125, dx0))
    if kind == "full":
        assert bool((y[0].float() == y0[0].float()).all())
        assert torch.equal(y[0, 0, 0], torch.full(
            (sk,), 1.0 / sk, device=cuda_device).to(y.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("batches,sq,sk,dt", [
    (16, 1024, 1024, "bf16"), (4, 24, 24, "f32"), (3, 12, 20, "bf16"),
    (2, 17, 17, "f32"),
    (65537, 2, 8, "bf16"),     # batches past the grid's y limit
    (2, 37, 2048, "bf16"),     # eight vectors a thread
    (3, 40, 3000, "f32")])     # the generic path
def test_causal_softmax_kernel_matches_plain(cuda_device, batches, sq, sk,
                                             dt):
    rng = np.random.RandomState(1)
    x = _t(rng.randn(batches, sq, sk) * 2, dt, cuda_device)
    dy = _t(rng.randn(batches, sq, sk), dt, cuda_device)
    before = fsm.SOFTMAX_CAUSAL_FWD.launches
    y = fsm.causal_softmax_fwd_kernel(x, 1.3)
    dx = fsm.softmax_bwd_kernel(y, dy, 1.3)
    torch.cuda.synchronize()
    assert fsm.SOFTMAX_CAUSAL_FWD.launches == before + 1
    y0 = fsm.causal_softmax_fwd_plain(x, 1.3)
    _assert_within("y", y, y0, fsm.fwd_limits(y0))
    _assert_within("dx", dx, fsm.softmax_bwd_plain(y, dy, 1.3),
                   fsm.bwd_limits(y, dy, 1.3, fsm.softmax_bwd_plain(
                       y, dy, 1.3)))
    assert bool((y.float()[:, fsm._causal(sq, sk, cuda_device)] == 0).all())


_MASK_LAYOUTS = [
    # (b, np, sq, sk, x dtype, mask dtype, layout): "key" (b, 1, 1, sk),
    # "query" (b, 1, sq, sk), "strided" a (b, 1, sq, 2 sk) mask read at
    # every second key, "offset" a key mask one element past an aligned
    # start (element reads); sq 37 leaves the last block's rows partly
    # empty, and batch 0 is masked everywhere
    (64, 16, 128, 128, "bf16", "u8", "key"),     # the BERT-Large step
    (64, 16, 128, 128, "bf16", "i32", "key"),
    (4, 8, 37, 128, "bf16", "u8", "query"),
    (4, 8, 37, 128, "bf16", "i32", "query"),
    (2, 4, 37, 96, "f32", "u8", "query"),
    (2, 4, 37, 96, "f32", "i32", "key"),
    (2, 4, 37, 128, "f16", "u8", "key"),
    (2, 4, 37, 128, "bf16", "i32", "strided"),
    (2, 4, 37, 128, "bf16", "u8", "offset"),
    (2, 3, 37, 130, "bf16", "u8", "query"),      # the generic path
    (1, 2, 5, 3000, "bf16", "u8", "key"),        # past the register path
    (1, 2, 5, 3000, "f32", "i32", "query"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,np_,sq,sk,dt,mdt,layout", _MASK_LAYOUTS)
def test_masked_softmax_mask_layouts(cuda_device, b, np_, sq, sk, dt, mdt,
                                     layout):
    """The forward reads uint8 and int32 masks in one vector load a 16
    bytes of x where their key stride is 1 and their rows are aligned,
    element by element otherwise; each within ``fwd_limits``, a fully
    masked batch uniform at 1/sk, a repeat and a CUDA-graph replay the
    same bits."""
    rng = np.random.RandomState(sk + sq)
    x = _t(rng.randn(b, np_, sq, sk) * 3, dt, cuda_device)
    qs = 1 if layout == "key" or layout == "offset" else sq
    ks = 2 * sk if layout == "strided" else sk
    m = rng.rand(b, 1, qs, ks + (1 if layout == "offset" else 0)) < 0.3
    m[0] = True
    mt = torch.from_numpy(m).to(cuda_device)
    mt = mt.to(torch.uint8 if mdt == "u8" else torch.int32)
    if layout == "strided":
        mt = mt[..., ::2]
    elif layout == "offset":
        mt = mt[..., 1:]
    assert mt.shape[-1] == sk
    before = fsm.SOFTMAX_FWD.launches
    y = fsm.masked_softmax_fwd_kernel(x, mt, 0.125)
    again = fsm.masked_softmax_fwd_kernel(x, mt, 0.125)
    torch.cuda.synchronize()
    assert fsm.SOFTMAX_FWD.launches == before + 2
    y0 = fsm.masked_softmax_fwd_plain(x, mt, 0.125)
    _assert_within("y", y, y0, fsm.fwd_limits(y0))
    assert torch.equal(y, again)
    assert torch.equal(y[0], torch.full(y[0].shape, 1.0 / sk,
                                        device=cuda_device).to(y.dtype))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fsm.masked_softmax_fwd_kernel(x, mt, 0.125)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fsm.masked_softmax_fwd_kernel(x, mt, 0.125)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, y)


@pytest.mark.cuda
@pytest.mark.parametrize("m_dt,emit", [("f32", False), ("bf16", True),
                                       ("bf16", False)])
@pytest.mark.parametrize("found", [None, False, True])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_flat_adam_kernel_matches_plain_bitwise(cuda_device, m_dt, emit,
                                                found, adam_w_mode):
    rng = np.random.RandomState(2)
    n = 256 * 128 * 3
    g, p = (_t(rng.randn(n // 128, 128), "f32", cuda_device)
            for _ in range(2))
    m = _t(rng.randn(n // 128, 128) * 0.1, m_dt, cuda_device)
    v = _t(np.abs(rng.randn(n // 128, 128)) * 0.01, "f32", cuda_device)
    hp = mta.adam_hparams(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                          step=torch.tensor(3, device=cuda_device),
                          weight_decay=0.01, adam_w_mode=adam_w_mode,
                          bias_correction=True, grad_scale=0.5,
                          device=cuda_device)
    fi = None if found is None else torch.tensor(found, device=cuda_device)
    emit_dt = torch.bfloat16 if emit else None
    before = mta.FLAT_ADAM.launches
    got = mta.flat_adam_kernel(g, p, m, v, hp, fi, emit_dt)
    torch.cuda.synchronize()
    assert mta.FLAT_ADAM.launches == before + 1
    want = mta.flat_adam_plain(g, p, m, v, hp, fi, emit_dt)
    assert len(got) == len(want) == (4 if emit else 3)
    for name, a, w in zip(("p", "m", "v", "compute"), got, want):
        assert a.dtype == w.dtype, name
        assert torch.equal(a, w), (name, float((a.float() - w.float()).abs()
                                               .max()))
    if emit:
        assert torch.equal(got[3], got[0].to(torch.bfloat16))
    if found:
        assert torch.equal(got[0], p) and torch.equal(got[1], m)


def _flat_buf(rng, rows, dt, dev, scale=3.0, inject=None):
    a = (rng.randn(rows, 128) * scale).astype(np.float32)
    if inject == "inf":
        a[rows // 2, 5] = -np.inf
    elif inject == "nan":
        a[rows - 1, 127] = np.nan
    return _t(a, dt, dev)


def _same(a, b):
    """Equal values and dtypes, a NaN where the other has one (a NaN's
    payload may differ between the two roundings to bf16)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0), b.masked_fill(nb, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,odt", [("f32", "f32"), ("f32", "bf16"),
                                     ("bf16", "f32"), ("bf16", "bf16")])
@pytest.mark.parametrize("inject", [None, "inf", "nan"])
def test_flat_scale_kernel_matches_plain(cuda_device, xdt, odt, inject):
    rng = np.random.RandomState(3)
    x = _flat_buf(rng, 300, xdt, cuda_device, inject=inject)
    s = torch.tensor(0.37, device=cuda_device)
    before = mta.FLAT_SCALE.launches
    out, found = mta.flat_scale_kernel(x, s, _DT[odt])
    torch.cuda.synchronize()
    assert mta.FLAT_SCALE.launches == before + 1
    out0, found0 = mta.flat_scale_plain(x, s, _DT[odt])
    assert _same(out, out0) and found.dtype == torch.bool
    assert bool(found) == bool(found0) == (inject is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,ydt,odt", [("f32", "f32", "f32"),
                                         ("bf16", "f32", "bf16"),
                                         ("f32", "bf16", "f32"),
                                         ("bf16", "bf16", "bf16")])
@pytest.mark.parametrize("inject", [None, "inf", "nan"])
def test_flat_axpby_kernel_matches_plain(cuda_device, xdt, ydt, odt, inject):
    rng = np.random.RandomState(4)
    x = _flat_buf(rng, 300, xdt, cuda_device)
    y = _flat_buf(rng, 300, ydt, cuda_device, inject=inject)
    ab = torch.tensor([1.7, -0.3], device=cuda_device)
    before = mta.FLAT_AXPBY.launches
    out, found = mta.flat_axpby_kernel(x, y, ab, _DT[odt])
    torch.cuda.synchronize()
    assert mta.FLAT_AXPBY.launches == before + 1
    out0, found0 = mta.flat_axpby_plain(x, y, ab, _DT[odt])
    assert _same(out, out0)
    assert bool(found) == bool(found0) == (inject is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [256, 300, 8, 4096])
def test_flat_l2norm_partials_kernel_matches_plain(cuda_device, rows):
    x = _flat_buf(np.random.RandomState(5), rows, "f32", cuda_device)
    before = mta.FLAT_L2NORM.launches
    got = mta.flat_l2norm_partials_kernel(x)
    again = mta.flat_l2norm_partials_kernel(x)
    torch.cuda.synchronize()
    assert mta.FLAT_L2NORM.launches == before + 2
    want = mta.flat_l2norm_partials_plain(x)
    assert got.shape == want.shape and torch.equal(got, again)
    _assert_within("partials", got, want, mta.sum_sq_limit(want, mta.SUB))


def _lamb_case(dev, m_dt, adam_w_mode, rows=1024):
    rng = np.random.RandomState(6)
    g = _flat_buf(rng, rows, "f32", dev, 1e-2)
    p = _flat_buf(rng, rows, "f32", dev, 1.0)
    m = _flat_buf(rng, rows, m_dt, dev, 1e-3)
    v = _t(np.abs(rng.randn(rows, 128)) * 1e-5, "f32", dev)
    hp = mta.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6,
                          step=torch.tensor(3, device=dev), weight_decay=0.01,
                          adam_w_mode=adam_w_mode,
                          gs_over_clip=torch.tensor(0.8, device=dev),
                          device=dev)
    return g, p, m, v, hp


@pytest.mark.cuda
@pytest.mark.parametrize("m_dt", ["f32", "bf16"])
@pytest.mark.parametrize("found", [None, False, True])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_flat_lamb_stage1_kernel_matches_plain(cuda_device, m_dt, found,
                                               adam_w_mode):
    g, p, m, v, hp = _lamb_case(cuda_device, m_dt, adam_w_mode)
    fi = None if found is None else torch.tensor(found, device=cuda_device)
    before = mta.FLAT_LAMB_STAGE1.launches
    got = mta.flat_lamb_stage1_kernel(g, p, m, v, hp, fi)
    again = mta.flat_lamb_stage1_kernel(g, p, m, v, hp, fi)
    torch.cuda.synchronize()
    assert mta.FLAT_LAMB_STAGE1.launches == before + 2
    want = mta.flat_lamb_stage1_plain(g, p, m, v, hp, fi)
    for name, a, w in zip(("m", "v", "u"), got[:3], want[:3]):
        assert a.dtype == w.dtype and torch.equal(a, w), (
            name, float((a.float() - w.float()).abs().max()))
    for name, a, a2, w in zip(("p_parts", "u_parts"), got[3:], again[3:],
                              want[3:]):
        assert torch.equal(a, a2)
        _assert_within(name, a, w, mta.sum_sq_limit(w, mta.SUB))
    if found:
        assert torch.equal(got[0], m) and torch.equal(got[1], v)
        assert not bool(got[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("m_dt", ["f32", "bf16"])
def test_flat_lamb_kernels_match_plain_and_repeat(cuda_device, m_dt):
    """flat_lamb on the card (both kernels, stage 2 in PyTorch) against
    the same call on the CPU (the plain versions), the gradients' norm
    under max_grad_norm (so the clip is 1 on both): m and v bit for bit,
    p within lamb_p_limit; a second call on the card gives the same
    bits (the segment sums use no atomics)."""
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors

    rng = np.random.RandomState(7)
    shapes = [(1024, 300), (300,), (1,), (77, 129), (4096,)]
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in shapes]
    p, spec = flatten_tensors(leaves)
    g, _ = flatten_tensors([torch.from_numpy(
        (rng.randn(*s) * 1e-4).astype(np.float32)) for s in shapes], spec)
    m = torch.zeros_like(p).to(_DT[m_dt])
    v = torch.zeros_like(p)
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=1,
              weight_decay=0.01)
    dev = [t.to(cuda_device) for t in (g, p, m, v, ids, counts)]
    before = (mta.FLAT_L2NORM.launches, mta.FLAT_LAMB_STAGE1.launches)
    got = mta.flat_lamb(*dev, **kw)
    again = mta.flat_lamb(*dev, **kw)
    torch.cuda.synchronize()
    assert (mta.FLAT_L2NORM.launches, mta.FLAT_LAMB_STAGE1.launches) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = mta.flat_lamb(g, p, m, v, ids, counts, **kw)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    hp = mta.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6, step=1,
                          weight_decay=0.01, adam_w_mode=True,
                          gs_over_clip=torch.tensor(1.0), device="cpu")
    _, _, u, pp, up = mta.flat_lamb_stage1_plain(g, p, m, v, hp)
    lim = mta.lamb_p_limit(want[0], u, pp, up, ids, counts, 1e-3)
    _assert_within("p", got[0].cpu(), want[0], lim)
    assert not torch.equal(want[0], p)


@pytest.mark.cuda
@pytest.mark.parametrize("m_dt", ["f32", "bf16"])
def test_flat_lamb_with_grad_norm_skips_the_pre_pass(cuda_device, m_dt):
    """flat_lamb with a caller's ``grad_norm=`` and ``grad_scale=2**-16``
    (the optimizers' step arguments): stage 1 alone on the card (no
    ``flat_l2norm_partials`` launch), m and v bit for bit against the
    same call on the CPU (the plain versions), p within lamb_p_limit;
    the clip engages (the norm is above ``max_grad_norm``)."""
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors

    rng = np.random.RandomState(17)
    shapes = [(1024, 300), (300,), (77, 129)]
    p, spec = flatten_tensors([torch.from_numpy(
        rng.randn(*s).astype(np.float32)) for s in shapes])
    g, _ = flatten_tensors([torch.from_numpy(
        (rng.randn(*s) * 2.0 ** 16).astype(np.float32)) for s in shapes],
        spec)
    m = (torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
         * 1e-3).to(_DT[m_dt])
    v = torch.from_numpy(np.abs(rng.randn(*p.shape)).astype(np.float32)
                         ) * 1e-6
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    norm = torch.tensor(3.25)
    kw = dict(lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=2,
              weight_decay=0.02, grad_scale=2.0 ** -16, grad_norm=norm,
              max_grad_norm=1.0)
    dev = [t.to(cuda_device) for t in (g, p, m, v, ids, counts)]
    before = (mta.FLAT_L2NORM.launches, mta.FLAT_LAMB_STAGE1.launches)
    got = mta.flat_lamb(*dev, **dict(kw, grad_norm=norm.to(cuda_device)))
    torch.cuda.synchronize()
    assert (mta.FLAT_L2NORM.launches, mta.FLAT_LAMB_STAGE1.launches) == (
        before[0], before[1] + 1)
    want = mta.flat_lamb(g, p, m, v, ids, counts, **kw)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    hp = mta.lamb_hparams(
        beta1=0.9, beta2=0.999, eps=1e-6, step=2, weight_decay=0.02,
        adam_w_mode=True, gs_over_clip=mta.lamb_inv_clip(
            None, 1.0, 2.0 ** -16, norm, "cpu"), device="cpu")
    assert float(hp[8]) == float(torch.tensor(2.0 ** -16) / norm)
    _, _, u, pp, up = mta.flat_lamb_stage1_plain(g, p, m, v, hp)
    lim = mta.lamb_p_limit(want[0], u, pp, up, ids, counts, 2e-3)
    _assert_within("p", got[0].cpu(), want[0], lim)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_flat_wrappers_take_the_step_arguments_bitwise(cuda_device, opt):
    """``flat_adam`` and ``flat_sgd`` as the optimizers' step arguments
    call them: ``lr`` and ``weight_decay`` as 0-d tensors on the card,
    ``grad_scale=2**-16``: the kernel against its plain version on the
    same hyperparameter vector, bit for bit."""
    rng = np.random.RandomState(19)
    rows = 256 * 3
    g = _flat_buf(rng, rows, "f32", cuda_device, 2.0 ** 16)
    p = _flat_buf(rng, rows, "f32", cuda_device, 1.0)
    lr = torch.tensor(2e-3, device=cuda_device)
    wd = torch.tensor(0.02, device=cuda_device)
    gs = 2.0 ** -16
    if opt == "adam":
        m = _flat_buf(rng, rows, "f32", cuda_device, 1e-2)
        v = _t(np.abs(rng.randn(rows, 128)) * 1e-4, "f32", cuda_device)
        kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, adam_w_mode=True,
                  bias_correction=True)
        before = mta.FLAT_ADAM.launches
        got = mta.flat_adam(g, p, m, v, lr=lr, step=torch.tensor(
            2, device=cuda_device), weight_decay=wd, grad_scale=gs, **kw)
        torch.cuda.synchronize()
        assert mta.FLAT_ADAM.launches == before + 1
        hp = mta.adam_hparams(lr=lr, step=2, weight_decay=wd, grad_scale=gs,
                              device=cuda_device, **kw)
        assert float(hp[8]) == gs and float(hp[0]) == float(lr)
        want = mta.flat_adam_plain(g, p, m, v, hp)
    else:
        buf = _flat_buf(rng, rows, "f32", cuda_device, 1e-2)
        kw = dict(momentum=0.9, dampening=0.0, nesterov=False,
                  wd_after_momentum=False)
        pk, bk = p.clone(), buf.clone()
        before = mta.FLAT_SGD.launches
        got = mta.flat_sgd(g, pk, bk, lr=lr, weight_decay=wd,
                           first_run=torch.tensor(False, device=cuda_device),
                           grad_scale=gs, **kw)
        torch.cuda.synchronize()
        assert mta.FLAT_SGD.launches == before + 1
        hp = mta.sgd_hparams(lr=lr, weight_decay=wd, first_run=False,
                             grad_scale=gs, device=cuda_device, **kw)
        want = mta.flat_sgd_plain(g, p.clone(), buf.clone(), hp)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert not torch.equal(got[0], p)


w8 = importlib.import_module("apex_tpu_torch.quant.kernels")

# GPT-2 medium's four linears (K, N): qkv, out, fc1, fc2
_W8_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
_W8_TAILS = [  # (M, K, N): vector and byte loads, gemv and tiled, K split
    (6, 72, 200), (3, 72, 201), (37, 72, 200), (37, 100, 201),
    (128, 1024, 1024), (9, 33, 7)]


def _w8_operands(dev, m, k, n, xdt, nk, bias, seed=0):
    from apex_tpu_torch.quant import quantize_tensor

    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(*((n, k) if nk else (k, n))).astype(
        np.float32)).to(dev)
    wq, scale = quantize_tensor(w, -1 if nk else -2)
    x = _t(rng.randn(m, k), xdt, dev)
    b = _t(rng.randn(n), xdt, dev) if bias else None
    return x, wq, scale, b


def _w8_check(fn_kernel, fn_plain, counter, args, lim):
    before = counter.launches
    got = fn_kernel(*args)
    again = fn_kernel(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want = fn_plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_within("y", got, want, lim)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", _W8_SHAPES)
@pytest.mark.parametrize("m", [8, 1024], ids=["decode", "prefill"])
def test_w8_matmul_kernels_match_plain(cuda_device, m, k, n, xdt, bias):
    """Rows 21 (no bias) and 22 (bias) at GPT-2 medium's decode and
    prefill shapes, out in x's dtype as the serving path calls them."""
    x, wq, scale, b = _w8_operands(cuda_device, m, k, n, xdt, False, bias)
    counter = w8.W8_MATMUL if bias else w8.W8_MATMUL_NOBIAS
    _w8_check(w8.w8_matmul_kernel, w8.w8_matmul_plain, counter,
              (x, wq, scale, b, x.dtype),
              w8.w8_limit(x, wq, scale, b, x.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(512, 1024), (2048, 1024)],
                         ids=["out", "fc2"])
def test_w8_nobias_at_the_tp2_row_parallel_shapes(cuda_device, k, n, xdt):
    """Row 21 where int8 tensor-parallel serving launches it at tp 2: the
    Row-parallel out (K 512) and fc2 (K 2048) into N 1024 at a decode
    tick's M 8 (fp32 x on that path; bf16 x too)."""
    x, wq, scale, _ = _w8_operands(cuda_device, 8, k, n, xdt, False, False)
    _w8_check(w8.w8_matmul_kernel, w8.w8_matmul_plain, w8.W8_MATMUL_NOBIAS,
              (x, wq, scale, None, x.dtype),
              w8.w8_limit(x, wq, scale, None, x.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 1024, 3])
def test_w8_matmul_nk_kernel_matches_plain(cuda_device, m, xdt):
    """Row 23, the tied logits head over the (50304, 1024) word table."""
    x, wq, scale, _ = _w8_operands(cuda_device, m, 1024, 50304, xdt, True,
                                   False)
    _w8_check(w8.w8_matmul_nk_kernel, w8.w8_matmul_nk_plain,
              w8.W8_MATMUL_NK, (x, wq, scale, torch.float32),
              w8.w8_limit(x, wq, scale, None, torch.float32, nk=True))


@pytest.mark.cuda
@pytest.mark.parametrize("odt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", _W8_TAILS)
def test_w8_kernels_take_any_shape(cuda_device, m, k, n, odt):
    for nk, bias in ((False, True), (False, False), (True, False)):
        x, wq, scale, b = _w8_operands(cuda_device, m, k, n, "bf16", nk,
                                       bias, seed=m + k + n)
        if nk:
            _w8_check(w8.w8_matmul_nk_kernel, w8.w8_matmul_nk_plain,
                      w8.W8_MATMUL_NK, (x, wq, scale, _DT[odt]),
                      w8.w8_limit(x, wq, scale, None, _DT[odt], nk=True))
        else:
            _w8_check(w8.w8_matmul_kernel, w8.w8_matmul_plain,
                      w8.W8_MATMUL if bias else w8.W8_MATMUL_NOBIAS,
                      (x, wq, scale, b, _DT[odt]),
                      w8.w8_limit(x, wq, scale, b, _DT[odt]))


def _w8_kernel_names(fn):
    """The device kernels one call of ``fn`` launches, by the profiler.
    A first call outside the profiler builds and loads what the call
    needs: on the H100 a kernel library loaded while the profiler ran
    left the process's later profiler sessions without device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "w8_" in e.name]


@pytest.mark.cuda
@pytest.mark.parametrize("odt", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("k,n", _W8_SHAPES)
@pytest.mark.parametrize("m", [128, 1024])
def test_w8_mma_kernel_matches_plain(cuda_device, m, k, n, bias, odt):
    """Rows 21/22 with a bf16 x at prefill M: the tensor-core kernel
    (s_n times the fp32 sum of exact bf16 x int8 products), bf16 and fp32
    out, held to the unchanged ``w8_limit``; a repeat gives the same
    bits, whether or not K is split."""
    x, wq, scale, b = _w8_operands(cuda_device, m, k, n, "bf16", False, bias)
    _w8_check(w8.w8_matmul_kernel, w8.w8_matmul_plain,
              w8.W8_MATMUL if bias else w8.W8_MATMUL_NOBIAS,
              (x, wq, scale, b, _DT[odt]),
              w8.w8_limit(x, wq, scale, b, _DT[odt]))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset", [
    (9, 1024, 1024, 0), (37, 1024, 3072, 0), (100, 4096, 1024, 0),
    (127, 1024, 4096, 0), (37, 100, 201, 0), (128, 72, 200, 0),
    (128, 1024, 3072, 1), (37, 1024, 1024, 1), (300, 100, 201, 1)])
def test_w8_mma_takes_any_shape(cuda_device, m, k, n, offset):
    """M between 9 and 127, K or N ragged (element loads and zero fill)
    and an x view whose base is 2 bytes past a 16-byte boundary: within
    ``w8_limit``, and an aligned copy of x gives the same bits."""
    x, wq, scale, b = _w8_operands(cuda_device, m, k, n, "bf16", False, True,
                                   seed=m + k + n)
    if offset:
        buf = torch.empty(m * k + offset, dtype=x.dtype, device=x.device)
        xv = buf[offset:].view(m, k)
        xv.copy_(x)
        assert xv.data_ptr() % 16 == 2 and xv.is_contiguous()
    else:
        xv = x
    args = (xv, wq, scale, b, torch.bfloat16)
    _w8_check(w8.w8_matmul_kernel, w8.w8_matmul_plain, w8.W8_MATMUL, args,
              w8.w8_limit(x, wq, scale, b, torch.bfloat16))
    assert torch.equal(w8.w8_matmul_kernel(*args),
                       w8.w8_matmul_kernel(x, wq, scale, b, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,m,kind", [
    ("bf16", 1024, "w8_mma"), ("bf16", 128, "w8_mma"),
    ("f32", 1024, "w8_tiled"), ("bf16", 8, "w8_gemv_kn"),
    ("f32", 8, "w8_gemv_kn"), ("bf16", 1, "w8_gemv_kn")])
def test_w8_kernel_by_dtype_and_m(cuda_device, xdt, m, kind):
    """The regime follows M and x's dtype alone: a bf16 x at M > 8 runs
    the tensor-core kernel, an fp32 x the CUDA-core tile (and its K-part
    sum where K is split), and M <= 8 one gemv launch, K parts folded in.
    """
    x, wq, scale, b = _w8_operands(cuda_device, m, 1024, 1024, xdt, False,
                                   True)
    names = _w8_kernel_names(
        lambda: w8.w8_matmul_kernel(x, wq, scale, b, x.dtype))
    assert names and kind in names[0], names
    if kind == "w8_tiled":
        assert all("w8_tiled" in n or "w8_reduce" in n for n in names)
    else:
        assert len(names) == 1, names


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset", [
    (8, 1024, 50304, 1), (1, 1024, 50300, 0), (3, 1024, 1000, 1),
    (8, 1024, 4097, 0), (5, 72, 200, 0), (8, 200, 37, 1), (7, 3056, 300, 0),
    (2, 4000, 96, 0)])
@pytest.mark.parametrize("odt", ["f32", "bf16"])
def test_w8_mma_nk_takes_any_shape(cuda_device, m, k, n, offset, odt):
    """Row 23 with a bf16 x at M <= 8: N off the 16-channel tile, K off
    the 16-byte loads (byte loads), an x view 2 bytes past a 16-byte
    boundary (element staging), the largest K whose x is staged in
    shared memory and one past it (the CUDA-core gemv): within
    ``w8_limit``, an aligned copy of x the same bits, and two replays of
    a CUDA graph of the call the same bits as an eager call."""
    x, wq, scale, _ = _w8_operands(cuda_device, m, k, n, "bf16", True, False,
                                   seed=m + k + n)
    xv = x
    if offset:
        buf = torch.empty(m * k + offset, dtype=x.dtype, device=x.device)
        xv = buf[offset:].view(m, k)
        xv.copy_(x)
        assert xv.data_ptr() % 16 == 2 and xv.is_contiguous()
    args = (xv, wq, scale, _DT[odt])
    _w8_check(w8.w8_matmul_nk_kernel, w8.w8_matmul_nk_plain,
              w8.W8_MATMUL_NK, args,
              w8.w8_limit(x, wq, scale, None, _DT[odt], nk=True))
    want = w8.w8_matmul_nk_kernel(x, wq, scale, _DT[odt])
    assert torch.equal(w8.w8_matmul_nk_kernel(*args), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8.w8_matmul_nk_kernel(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = w8.w8_matmul_nk_kernel(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", _W8_SHAPES)
@pytest.mark.parametrize("m", [1, 8])
def test_w8_decode_one_launch_repeats_under_graph_replay(cuda_device, m, k,
                                                         n, xdt):
    """The decode gemv is one launch a linear; its arrival counters are
    zero at every launch, so two replays of a CUDA graph of the call
    give the same bits as an eager call, within ``w8_limit``."""
    x, wq, scale, b = _w8_operands(cuda_device, m, k, n, xdt, False, True)
    want = w8.w8_matmul_kernel(x, wq, scale, b, x.dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8.w8_matmul_kernel(x, wq, scale, b, x.dtype)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = w8.w8_matmul_kernel(x, wq, scale, b, x.dtype)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(got.clone())
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    _assert_within("y", want, w8.w8_matmul_plain(x, wq, scale, b, x.dtype),
                   w8.w8_limit(x, wq, scale, b, x.dtype))


@pytest.mark.cuda
def test_w8_refused_launch_keeps_the_count(cuda_device):
    x, wq, scale, b = _w8_operands(cuda_device, 8, 64, 32, "f32", False,
                                   True)
    counts = (w8.W8_MATMUL.launches, w8.W8_MATMUL_NK.launches)
    with pytest.raises(RuntimeError, match="fp32 or bf16"):
        w8.w8_matmul_kernel(x.half(), wq, scale, b, torch.float16)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        w8.w8_matmul_nk_kernel(x.cpu(), wq.t().contiguous().cpu(),
                               scale.cpu(), torch.float32)
    assert (w8.W8_MATMUL.launches, w8.W8_MATMUL_NK.launches) == counts
    w8.w8_matmul(x, wq, scale, b)
    torch.cuda.synchronize()
    assert w8.W8_MATMUL.launches == counts[0] + 1


# ---------------------------------------------------------------------------
# flat_sgd, flat_adagrad and flat_novograd (in place): each kernel against
# its plain version on clones of the same card inputs, bit for bit (the
# same fp32 operations in the same order, no FMA); found_inf leaves params
# and state as they were; two launches give the same bits.
# ---------------------------------------------------------------------------

def _in_place_check(kernel, plain, counter, args, n_state, found, emit):
    """``args`` = (grads, params, *states, *rest): the kernel on clones of
    params and states, twice (from the same inputs), against the plain
    version on another clone."""
    g, p, *rest = args
    states, extra = rest[:n_state], rest[n_state:]
    fi = None if found is None else torch.tensor(found, device=p.device)
    emit_dt = torch.bfloat16 if emit else None
    runs = []
    before = counter.launches
    for _ in range(2):
        pc, sc = p.clone(), [s.clone() for s in states]
        runs.append(kernel(g, pc, *sc, *extra, fi, emit_dt))
        assert runs[-1][0] is pc and all(
            a is b for a, b in zip(runs[-1][1:1 + n_state], sc))
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    pp, sp = p.clone(), [s.clone() for s in states]
    want = plain(g, pp, *sp, *extra, fi, emit_dt)
    got = runs[0]
    assert len(got) == len(want) == 1 + n_state + (1 if emit else 0)
    for i, (a, b, w) in enumerate(zip(got, runs[1], want)):
        assert a.dtype == w.dtype and torch.equal(a, w), (
            i, float((a.float() - w.float()).abs().max()))
        assert torch.equal(a, b)
    if emit:
        assert torch.equal(got[-1], got[0].to(torch.bfloat16))
    if found:
        assert torch.equal(got[0], p)
        assert all(torch.equal(a, s) for a, s in zip(got[1:], states))
    return got


_SGD_CASES = {  # the JAX package's FusedSGD cases and the first run
    "first": dict(momentum=0.9, weight_decay=1e-4, first_run=True),
    "damp": dict(momentum=0.9, dampening=0.1, weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, nesterov=True),
    "wd_after": dict(momentum=0.9, weight_decay=1e-4,
                     wd_after_momentum=True),
    "no_momentum": dict(weight_decay=1e-4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("buf_dt,emit", [("f32", False), ("bf16", True)])
@pytest.mark.parametrize("found", [None, False, True])
@pytest.mark.parametrize("case", sorted(_SGD_CASES))
def test_flat_sgd_kernel_matches_plain_bitwise(cuda_device, case, found,
                                               buf_dt, emit):
    rng = np.random.RandomState(8)
    rows = 256 * 3
    g = _flat_buf(rng, rows, "f32", cuda_device, 1e-2)
    p = _flat_buf(rng, rows, "f32", cuda_device, 1.0)
    buf = _flat_buf(rng, rows, buf_dt, cuda_device, 1e-2)
    kw = dict(momentum=0.0, dampening=0.0, weight_decay=0.0, nesterov=False,
              wd_after_momentum=False, first_run=False)
    kw.update(_SGD_CASES[case])
    hp = mta.sgd_hparams(lr=0.1, grad_scale=0.5, device=cuda_device, **kw)
    got = _in_place_check(mta.flat_sgd_kernel, mta.flat_sgd_plain,
                          mta.FLAT_SGD, (g, p, buf, hp), 1, found, emit)
    if case == "no_momentum":
        assert torch.equal(got[1], buf)


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("found", [None, False, True])
@pytest.mark.parametrize("w_mode", [False, True])
def test_flat_adagrad_kernel_matches_plain_bitwise(cuda_device, w_mode,
                                                   found, emit):
    rng = np.random.RandomState(9)
    rows = 256 * 3
    g = _flat_buf(rng, rows, "f32", cuda_device, 1e-2)
    p = _flat_buf(rng, rows, "f32", cuda_device, 1.0)
    s = _t(np.abs(rng.randn(rows, 128)) * 1e-4, "f32", cuda_device)
    hp = mta.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=1e-2,
                             adagrad_w_mode=w_mode, grad_scale=0.5,
                             device=cuda_device)
    _in_place_check(mta.flat_adagrad_kernel, mta.flat_adagrad_plain,
                    mta.FLAT_ADAGRAD, (g, p, s, hp), 1, found, emit)


@pytest.mark.cuda
@pytest.mark.parametrize("m_dt,emit", [("f32", False), ("bf16", True)])
@pytest.mark.parametrize("found", [None, False, True])
@pytest.mark.parametrize("reg", [False, True])
def test_flat_novograd_kernel_matches_plain_bitwise(cuda_device, reg, found,
                                                    m_dt, emit):
    rng = np.random.RandomState(10)
    rows = 256 * 3
    g = _flat_buf(rng, rows, "f32", cuda_device, 1e-2)
    p = _flat_buf(rng, rows, "f32", cuda_device, 1.0)
    m = _flat_buf(rng, rows, m_dt, cuda_device, 1e-2)
    denom = _t(np.abs(rng.randn(rows // 8)) + 0.1, "f32", cuda_device)
    hp = mta.novograd_hparams(lr=1e-2, beta1=0.95, step=2, weight_decay=1e-2,
                              grad_averaging=True, bias_correction=True,
                              reg_inside_moment=reg, grad_scale=0.5,
                              device=cuda_device)
    _in_place_check(mta.flat_novograd_kernel, mta.flat_novograd_plain,
                    mta.FLAT_NOVOGRAD, (g, p, m, denom, hp), 1, found, emit)


@pytest.mark.cuda
@pytest.mark.parametrize("m_dt", ["f32", "bf16"])
@pytest.mark.parametrize("step", [1, 2])
def test_flat_novograd_on_card_matches_cpu(cuda_device, m_dt, step):
    """The whole flat_novograd on the card (the partials and NovoGrad
    kernels, v in PyTorch) against the same call on the CPU (the plain
    versions): v to the sum-of-squares model (step 1 seeds it with
    ||g||^2, step 2 takes the EMA), p and m then held to the model's
    effect through the denominator; two card calls give the same bits."""
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors

    rng = np.random.RandomState(11)
    shapes = [(1024, 300), (300,), (1,), (77, 129), (4096,)]
    p, spec = flatten_tensors([torch.from_numpy(
        rng.randn(*s).astype(np.float32)) for s in shapes])
    g, _ = flatten_tensors([torch.from_numpy(
        (rng.randn(*s) * 1e-2).astype(np.float32)) for s in shapes], spec)
    m = flatten_tensors([torch.from_numpy(
        (rng.randn(*s) * 1e-2).astype(np.float32)) for s in shapes],
        spec)[0].to(_DT[m_dt])
    v = torch.from_numpy(np.abs(rng.randn(len(shapes))).astype(np.float32))
    ids, counts = spec.tile_tensor_ids(8), spec.tile_counts(8)
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8, step=step,
              weight_decay=1e-2)
    runs = []
    before = (mta.FLAT_L2NORM.launches, mta.FLAT_NOVOGRAD.launches)
    for _ in range(2):
        dev = [t.to(cuda_device) for t in (g, p, m, v, ids, counts)]
        runs.append(mta.flat_novograd(*dev, **kw))
    torch.cuda.synchronize()
    assert (mta.FLAT_L2NORM.launches, mta.FLAT_NOVOGRAD.launches) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    pc, mc = p.clone(), m.clone()
    want = mta.flat_novograd(g, pc, mc, v, ids, counts, **kw)
    gsq = mta.segment_sums(mta.flat_l2norm_partials_plain(g), counts)
    n = counts.double() * mta.SUB
    rel = (2.0 * (n + 1) * mta.U).float()   # sum_sq_limit's, relative
    v_lim = rel * gsq * (1.0 if step == 1 else 0.02) + 2 * mta.U * want[2]
    _assert_within("v", runs[0][2].cpu(), want[2], v_lim)
    # the denominator's relative difference: half v's, plus the roundings
    # of v / c2, the sqrt and + eps on each side
    e = (rel / 2 + 8 * mta.U)[ids.long()].repeat_interleave(mta.SUB).view(
        p.shape)
    gn = (g.view(-1, mta.SUB) / mta.novograd_moments(
        mta.flat_l2norm_partials_plain(g), v, counts, ids, beta2=0.98,
        eps=1e-8, step=step, bias_correction=True, init_zero=False)[1][
            :, None]).view(p.shape).abs()
    m_lim = 0.05 * gn * e + 4 * mta.U * want[1].float().abs() + (
        2 ** -8 * want[1].float().abs() if m_dt == "bf16" else 0.0)
    _assert_within("m", runs[0][1].float().cpu(), want[1].float(), m_lim)
    c1 = 1.0 - 0.95 ** step
    _assert_within("p", runs[0][0].cpu(), want[0],
                   1e-2 * m_lim / c1 + 2 * mta.U * want[0].abs())


@pytest.mark.cuda
def test_sgd_family_refused_launch_keeps_the_count(cuda_device):
    p = torch.zeros((256, 128), device=cuda_device)
    hp = mta.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=0.0,
                             adagrad_w_mode=False, grad_scale=1.0,
                             device=cuda_device)
    n = mta.FLAT_ADAGRAD.launches
    with pytest.raises(RuntimeError, match="sum of .'torch.float32'."):
        mta.flat_adagrad_kernel(p, p, p.to(torch.bfloat16), hp)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        mta.flat_adagrad_kernel(p.cpu(), p.cpu(), p.cpu(), hp.cpu())
    assert mta.FLAT_ADAGRAD.launches == n


# ---------------------------------------------------------------------------
# threefry (utils.prng): the bits kernel and the fused dropout against
# their plain int64 versions, bit for bit, and the table of known answers
# (jax 0.9.0, partitionable threefry) as constants: this machine may have
# no JAX.
# ---------------------------------------------------------------------------

prng = importlib.import_module("apex_tpu_torch.utils.prng")

_KNOWN_BITS = [0xF29A4FA7, 0xFA843692, 0x55110E28, 0x77FAA835]


@pytest.mark.cuda
def test_threefry_known_answers_on_card(cuda_device):
    k = prng.PRNGKey(0)
    assert prng.split(k, 2).tolist() == [[0x6B200159, 0x99BA4EFE],
                                         [0x375F238F, 0xCDDB151D]]
    assert prng.bits(k, (4,), device=cuda_device).cpu().tolist() == \
        _KNOWN_BITS


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (1, 3), (1, 1001), (8, 50304),
                                    (3, 7), (1, 64 * 128 * 1024)])
def test_threefry_bits_kernel_matches_plain(cuda_device, rows, n):
    keys = prng.split(prng.PRNGKey(rows + n), rows)
    before = prng.THREEFRY_BITS.launches
    got = prng.threefry_bits_kernel(keys, n, cuda_device)
    again = prng.threefry_bits_kernel(keys, n, cuda_device)
    want = prng.threefry_bits_plain(keys, n, cuda_device)
    torch.cuda.synchronize()
    assert prng.THREEFRY_BITS.launches == before + 2
    assert got.shape == (rows, n) and got.dtype == torch.int32
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("n,offset", [(64 * 128 * 1024, 0), (1001, 0),
                                      (4099, 1), (17, 3)])
def test_threefry_dropout_kernel_matches_plain(cuda_device, dt, rate, n,
                                               offset):
    """Bit for bit, on aligned buffers (16-byte vectors) and on views
    that start off a 16-byte boundary (element loads), twice, and under
    a CUDA-graph replay."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    base = torch.randn(n + offset, generator=g, device=cuda_device).to(
        _DT[dt])
    x = base[offset:]
    kw = (prng.host_bits(prng.PRNGKey(n), 2), rate)
    before = prng.THREEFRY_DROPOUT.launches
    got = prng.dropout_kernel(x, *kw)
    again = prng.dropout_kernel(x, *kw)
    want = prng.dropout_plain(x, *kw)
    torch.cuda.synchronize()
    assert prng.THREEFRY_DROPOUT.launches == before + 2
    assert torch.equal(got.view(-1).float(), want.view(-1).float())
    assert torch.equal(got, again)
    keep = (want != 0).float().mean().item()
    assert abs(keep - (1 - rate)) < 0.05 or n < 5000
    static = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static.copy_(prng.dropout_kernel(x, *kw))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, got)


@pytest.mark.cuda
def test_threefry_dropout_autograd_regenerates_the_mask(cuda_device):
    x = torch.randn(64, 1024, device=cuda_device, requires_grad=True)
    key = prng.PRNGKey(4)
    y = prng.dropout(key, x, 0.1)
    y.backward(torch.ones_like(y))
    want = prng.dropout_plain(torch.ones_like(x), prng._key_words(key), 0.1)
    assert torch.equal(x.grad, want)
    assert torch.equal((y != 0), (x.grad != 0) & (x != 0))


@pytest.mark.cuda
def test_threefry_samplers_on_card_match_the_cpu(cuda_device):
    """uniform, bernoulli, randint and normal's uniforms bit for bit
    across devices; gumbel within its limit (torch's log on the card
    rounds otherwise than on the CPU)."""
    k = prng.PRNGKey(1000)
    for fn in (lambda d: prng.uniform(k, (64, 1001), device=d),
               lambda d: prng.bernoulli(k, 0.9, (64, 1001), device=d),
               lambda d: prng.randint(k, (4096,), 0, 1000, device=d)):
        assert torch.equal(fn(cuda_device).cpu(), fn("cpu"))
    z_d, z_c = (prng.normal(k, (4096,), device=d).cpu()
                for d in (cuda_device, "cpu"))
    assert bool(((z_d - z_c).abs() <= prng.normal_limit(z_c)).all())
    keys = prng.split(k, 8)
    g_d = prng.gumbel_rows(keys, 50304, cuda_device).cpu()
    g_c = prng.gumbel_rows(keys, 50304, "cpu")
    assert bool(((g_d - g_c).abs() <= prng.gumbel_limit(g_c)).all())


@pytest.mark.cuda
def test_threefry_refused_launch_keeps_the_count(cuda_device):
    counts = (prng.THREEFRY_BITS.launches, prng.THREEFRY_DROPOUT.launches)
    with pytest.raises(RuntimeError, match="fp32/bf16"):
        prng.dropout_kernel(torch.ones(8, device=cuda_device,
                                       dtype=torch.float16), (1, 2), 0.1)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        prng.dropout_kernel(torch.ones(8), (1, 2), 0.1)
    with pytest.raises(RuntimeError, match="1 to 65535 keys"):
        prng.threefry_bits_kernel(torch.zeros((65536, 2), dtype=torch.int64),
                                  4, cuda_device)
    assert (prng.THREEFRY_BITS.launches,
            prng.THREEFRY_DROPOUT.launches) == counts


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

pa_mod = importlib.import_module(
    "apex_tpu_torch.transformer.functional.paged_attention")


def _paged_case(dev, b, nh, hd, page, max_pages, kv, qdt, seed=0):
    """q (b, nh, hd), pools of max_pages * b + 2 pages, each slot's
    table row a random run of distinct pages, ragged positions with 0, a
    page's last row and the next page's first among them; int8 pools
    with (num_pages, nh) scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    num_pages = b * max_pages + 2
    q = torch.randn((b, nh, hd), generator=g, device=dev).to(_DT[qdt])
    shape = (num_pages, nh, page, hd)
    if kv == "i8":
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, nh), generator=g, device=dev)
                  * 0.05 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g, device=dev).to(_DT[kv])
                for _ in range(2))
        ks = vs = None
    perm = 2 + torch.randperm(num_pages - 2, generator=g, device=dev)
    bt = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    s_len = page * max_pages
    fixed = [0, page - 1, page, s_len - 1]
    pos = torch.randint(0, s_len, (b,), generator=g, device=dev)
    pos[:min(b, 4)] = torch.tensor(fixed[:min(b, 4)], device=dev)
    return q, k, v, bt, pos.to(torch.int32), ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kv", [("f32", "f32"), ("bf16", "bf16"),
                                    ("f32", "bf16"), ("bf16", "i8"),
                                    ("f32", "i8")])
@pytest.mark.parametrize("page,hd", [(16, 64), (64, 64), (4, 8), (8, 48),
                                     (64, 128), (64, 256), (8, 6), (32, 6)])
def test_paged_attention_kernel_within_limit(cuda_device, qdt, kv, page,
                                             hd):
    args = _paged_case(cuda_device, 9, 4, hd, page, 5, kv, qdt)
    n0 = pa_mod.PAGED_DECODE.launches
    got = pa_mod.paged_decode_attention(*args)
    want = pa_mod.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert pa_mod.PAGED_DECODE.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    lim = pa_mod.paged_limit(*args[:5], want, *args[5:])
    err = (got.float() - want.float()).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    again = pa_mod.paged_decode_attention_kernel(*args)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8"])
def test_paged_attention_kernel_placement_invariant(cuda_device, kv):
    """The same logical rows scattered to two permutations of the
    physical pages: the same bits."""
    q, k, v, bt, pos, ks, vs = _paged_case(cuda_device, 32, 16, 64, 64, 8,
                                           kv, "bf16", seed=1)
    outs = []
    for seed in (2, 3):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        perm = torch.arange(k.shape[0], device=cuda_device)
        perm[2:] = 2 + torch.randperm(k.shape[0] - 2, generator=g,
                                      device=cuda_device)
        k2, v2 = torch.empty_like(k), torch.empty_like(v)
        k2[perm], v2[perm] = k, v
        s2 = [None if s is None else torch.empty_like(s) for s in (ks, vs)]
        for dst, src in zip(s2, (ks, vs)):
            if src is not None:
                dst[perm] = src
        outs.append(pa_mod.paged_decode_attention_kernel(
            q, k2, v2, perm[bt.long()].to(torch.int32), pos, *s2))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_without_counting(cuda_device):
    q, k, v, bt, pos, _, _ = _paged_case(cuda_device, 2, 2, 512, 4, 2,
                                         "f32", "f32")
    n0 = pa_mod.PAGED_DECODE.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_decode_attention_kernel(q, k, v, bt, pos)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        pa_mod.paged_decode_attention_kernel(q.cpu(), k, v, bt, pos)
    assert pa_mod.PAGED_DECODE.launches == n0


# ---------------------------------------------------------------------------
# multi-query (speculative verify) paged attention
# ---------------------------------------------------------------------------

def _anc(b, k1, tree, seed):
    """(b, k1, k1) visibility: the linear chain (None) or random valid
    draft trees packed by ``serving.draft.tree_arrays`` (forced chains
    and trees of random shape)."""
    if not tree:
        return None
    from apex_tpu_torch.serving.draft import tree_arrays

    rng = np.random.RandomState(seed)
    forced, trees = [], []
    for _ in range(b):
        f = rng.randint(1, k1 + 1)
        forced.append([1] * f)
        n = k1 - f
        trees.append(([2] * n, [int(rng.randint(-1, i)) for i in range(n)])
                     if n else None)
    return torch.from_numpy(tree_arrays(forced, trees, k1)[2])


def _verify_case(dev, b, nh, hd, page, max_pages, kv, qdt, k1, tree,
                 seed=0):
    """q (b, nh, k1, hd) over the pools of :func:`_paged_case`, positions
    with their k1-row window inside the table (0, a page's last row, the
    next's first and the table's end among them)."""
    _, k, v, bt, _, ks, vs = _paged_case(dev, b, nh, hd, page, max_pages,
                                         kv, qdt, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    q = torch.randn((b, nh, k1, hd), generator=g, device=dev).to(_DT[qdt])
    s_len = page * max_pages
    pos = torch.randint(0, s_len - k1 + 1, (b,), generator=g, device=dev)
    fixed = [0, page - 1, page, s_len - k1]
    pos[:min(b, 4)] = torch.tensor(fixed[:min(b, 4)], device=dev)
    anc = _anc(b, k1, tree, seed)
    return (q, k, v, bt, pos.to(torch.int32),
            None if anc is None else anc.to(dev), ks, vs)


_VERIFY_KV = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "i8")]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kv", _VERIFY_KV)
@pytest.mark.parametrize("page,hd", [(64, 64), (7, 48)])
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
@pytest.mark.parametrize("k1", [1, 2, 5, 9])
def test_paged_verify_kernel_within_limit(cuda_device, qdt, kv, page, hd,
                                          tree, k1):
    """The k1-query kernel against its plain version within
    ``paged_limit`` (per query row), and the same bits on a second
    launch."""
    args = _verify_case(cuda_device, 9, 4, hd, page, 5, kv, qdt, k1, tree)
    n0 = pa_mod.PAGED_VERIFY.launches
    got = pa_mod.paged_verify_attention(*args)
    want = pa_mod.paged_verify_attention_plain(*args)
    torch.cuda.synchronize()
    assert pa_mod.PAGED_VERIFY.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    q, k, v, bt, pos, anc, ks, vs = args
    lim = pa_mod.paged_limit(q, k, v, bt, pos, want, ks, vs, anc=anc)
    err = (got.float() - want.float()).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    assert torch.equal(pa_mod.paged_verify_attention_kernel(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8"])
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_paged_verify_kernel_placement_invariant(cuda_device, kv, tree):
    """The same logical rows under two permutations of the physical
    pages: the same bits, k1 = 5."""
    q, k, v, bt, pos, anc, ks, vs = _verify_case(
        cuda_device, 32, 16, 64, 64, 8, kv, "bf16", 5, tree, seed=1)
    outs = []
    for seed in (2, 3):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        perm = torch.arange(k.shape[0], device=cuda_device)
        perm[2:] = 2 + torch.randperm(k.shape[0] - 2, generator=g,
                                      device=cuda_device)
        k2, v2 = torch.empty_like(k), torch.empty_like(v)
        k2[perm], v2[perm] = k, v
        s2 = [None if s is None else torch.empty_like(s) for s in (ks, vs)]
        for dst, src in zip(s2, (ks, vs)):
            if src is not None:
                dst[perm] = src
        outs.append(pa_mod.paged_verify_attention_kernel(
            q, k2, v2, perm[bt.long()].to(torch.int32), pos, anc, *s2))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kv", _VERIFY_KV)
@pytest.mark.parametrize("page,hd", [(64, 64), (7, 48)])
def test_paged_verify_column_is_the_decode_kernel(cuda_device, qdt, kv,
                                                  page, hd):
    """Column j of a linear verify gives the bits of the decode kernel
    at pos + j on the same pools (one template, one per-query order)."""
    q, k, v, bt, pos, _, ks, vs = _verify_case(cuda_device, 9, 4, hd, page,
                                               5, kv, qdt, 9, False)
    ctx = pa_mod.paged_verify_attention_kernel(q, k, v, bt, pos, None, ks,
                                               vs)
    for j in range(q.shape[2]):
        dec = pa_mod.paged_decode_attention_kernel(
            q[:, :, j].contiguous(), k, v, bt, pos + j, ks, vs)
        assert torch.equal(ctx[:, :, j], dec), j


@pytest.mark.cuda
def test_paged_verify_kernel_k1_limit(cuda_device):
    """k1 = MAX_K1 launches; one more is refused by the C entry with a
    non-zero code the wrapper raises, and no launch is counted."""
    k1 = pa_mod.MAX_K1
    args = _verify_case(cuda_device, 2, 2, 64, 64, 4, "bf16", "bf16", k1,
                        True)
    got = pa_mod.paged_verify_attention(*args)
    want = pa_mod.paged_verify_attention_plain(*args)
    q, k, v, bt, pos, anc, ks, vs = args
    lim = pa_mod.paged_limit(q, k, v, bt, pos, want, ks, vs, anc=anc)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    big = _verify_case(cuda_device, 2, 2, 64, 64, 4, "bf16", "bf16",
                       k1 + 1, False)
    n0 = pa_mod.PAGED_VERIFY.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_verify_attention_kernel(*big)
    assert pa_mod.PAGED_VERIFY.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kv", [("bf16", "bf16"), ("f32", "f32")])
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_paged_verify_wrapper_slices_past_max_k1(cuda_device, qdt, kv,
                                                 tree):
    """``paged_verify_attention`` at k1 = 80 (hd 64): one launch a slice
    of ``verify_slices`` (two), within ``paged_limit`` of the plain
    version, and bit for bit the launches of one query each: the decode
    kernel at pos + j (linear) or the slice (j, 1) of the window
    (tree). At k1 = MAX_K1 it stays one launch."""
    k1 = 80
    args = _verify_case(cuda_device, 5, 4, 64, 64, 4, kv, qdt, k1, tree)
    q, k, v, bt, pos, anc, ks, vs = args
    n0 = pa_mod.PAGED_VERIFY.launches
    got = pa_mod.paged_verify_attention(*args)
    torch.cuda.synchronize()
    assert pa_mod.verify_slices(k1, 64) == [(0, 64), (64, 16)]
    assert pa_mod.PAGED_VERIFY.launches == n0 + 2
    want = pa_mod.paged_verify_attention_plain(*args)
    lim = pa_mod.paged_limit(q, k, v, bt, pos, want, ks, vs, anc=anc)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    for j in range(k1):
        if tree:
            one = pa_mod.paged_verify_attention_kernel(
                q, k, v, bt, pos, anc, ks, vs, q0=j, nq=1)[:, :, j]
        else:
            one = pa_mod.paged_decode_attention_kernel(
                q[:, :, j].contiguous(), k, v, bt, pos + j, ks, vs)
        assert torch.equal(got[:, :, j], one), j
    small = _verify_case(cuda_device, 5, 4, 64, 64, 4, kv, qdt,
                         pa_mod.MAX_K1, tree)
    n0 = pa_mod.PAGED_VERIFY.launches
    pa_mod.paged_verify_attention(*small)
    assert pa_mod.PAGED_VERIFY.launches == n0 + 1


@pytest.mark.cuda
def test_paged_verify_slice_is_the_c_entrys_limit(cuda_device):
    """At hd 256 over an fp32 pool, the widest row the C entry takes,
    shared memory holds 62 queries: ``verify_slices``'s slice launches
    within ``paged_limit``, one query more is refused by the C entry
    (its formula agrees with the C file's ``smem_bytes``)."""
    nq = pa_mod.verify_slices(100, 256)[0][1]
    assert nq == 62
    args = _verify_case(cuda_device, 2, 2, 256, 64, 4, "f32", "f32", 100,
                        False)
    out = pa_mod.paged_verify_attention_kernel(*args, q0=0, nq=nq)
    torch.cuda.synchronize()
    want = pa_mod.paged_verify_attention_plain(*args, q0=0, nq=nq)
    q, k, v, bt, pos, anc, ks, vs = args
    lim = pa_mod.paged_limit(q, k, v, bt, pos,
                             pa_mod.paged_verify_attention_plain(*args),
                             ks, vs, anc=anc)[:, :, :nq]
    assert bool(((out[:, :, :nq].float() - want.float()).abs()
                 <= lim).all())
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_verify_attention_kernel(*args, q0=0, nq=nq + 1)


# ---------------------------------------------------------------------------
# the split into parts of PART_ROWS logical positions
# ---------------------------------------------------------------------------

def _moved(k, v, ks, vs, bt, seed, dev):
    """The same pools, scales and tables with the physical pages past the
    reserved two permuted."""
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.arange(k.shape[0], device=dev)
    perm[2:] = 2 + torch.randperm(k.shape[0] - 2, generator=g, device=dev)
    out = []
    for t in (k, v, ks, vs):
        m = None if t is None else torch.empty_like(t)
        if t is not None:
            m[perm] = t
        out.append(m)
    return out[0], out[1], perm[bt.long()].to(torch.int32), out[2], out[3]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kv", _VERIFY_KV)
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_paged_verify_column_is_the_decode_kernel_across_parts(
        cuda_device, qdt, kv, tree):
    """k1 = 5 windows at pos PART_ROWS - 2 (straddling the first part
    boundary; query 2's reach ends on part 1's first row), 2 PART_ROWS -
    3 (query 3's on part 2's), PART_ROWS - 5 (inside part 0) and 3
    PART_ROWS - 1: column j of a linear verify, and the forced-chain
    columns of a tree, give the decode kernel's bits at pos + j; a tree
    column whose ancestors skip a window row gives the bits of its
    one-query slice launch; all within ``paged_limit``."""
    part = pa_mod.PART_ROWS
    q, k, v, bt, _, _, ks, vs = _verify_case(cuda_device, 4, 4, 64, 16,
                                             4 * part // 16, kv, qdt, 5,
                                             False, seed=7)
    pos = torch.tensor([part - 2, 2 * part - 3, part - 5, 3 * part - 1],
                       dtype=torch.int32, device=cuda_device)
    anc, chain = None, 5
    if tree:
        from apex_tpu_torch.serving.draft import tree_arrays

        # three forced rows, then two draft nodes on the walk root: the
        # last sees the window rows 0, 1, 2 and 4
        anc = torch.from_numpy(tree_arrays([[1] * 3] * 4,
                                           [([2, 2], [-1, -1])] * 4, 5)[2])
        anc, chain = anc.to(cuda_device), 3
    ctx = pa_mod.paged_verify_attention_kernel(q, k, v, bt, pos, anc, ks,
                                               vs)
    for j in range(5):
        if j < chain:
            one = pa_mod.paged_decode_attention_kernel(
                q[:, :, j].contiguous(), k, v, bt, pos + j, ks, vs)
        else:
            one = pa_mod.paged_verify_attention_kernel(
                q, k, v, bt, pos, anc, ks, vs, q0=j, nq=1)[:, :, j]
        assert torch.equal(ctx[:, :, j], one), j
    want = pa_mod.paged_verify_attention_plain(q, k, v, bt, pos, anc, ks,
                                               vs)
    lim = pa_mod.paged_limit(q, k, v, bt, pos, want, ks, vs, anc=anc)
    assert bool(((ctx.float() - want.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8"])
@pytest.mark.parametrize("k1", [1, 5])
def test_paged_attention_parts_placement_invariant(cuda_device, kv, k1):
    """Slots of 1 (k1 for a verify window), PART_ROWS, PART_ROWS + 1 and
    S_max rows (the table's three parts) in one launch: one part, one
    part exactly, a second part of one row, every part. Two permutations of
    the physical pages give the same bits, and the kernel stays within
    ``paged_limit``."""
    part = pa_mod.PART_ROWS
    page, mp = 16, 3 * pa_mod.PART_ROWS // 16
    q, k, v, bt, _, _, ks, vs = _verify_case(cuda_device, 4, 4, 64, page,
                                             mp, kv, "bf16", k1, False,
                                             seed=8)
    pos = torch.tensor([max(n - k1, 0) for n in (1, part, part + 1,
                                                 page * mp)],
                       dtype=torch.int32, device=cuda_device)
    if k1 == 1:
        q = q[:, :, 0].contiguous()

    def run(k, v, bt, ks, vs):
        if k1 == 1:
            return pa_mod.paged_decode_attention_kernel(q, k, v, bt, pos, ks,
                                                        vs)
        return pa_mod.paged_verify_attention_kernel(q, k, v, bt, pos, None,
                                                    ks, vs)

    outs = [run(*_moved(k, v, ks, vs, bt, seed, cuda_device))
            for seed in (2, 3)]
    assert torch.equal(outs[0], outs[1])
    base = run(k, v, bt, ks, vs)
    assert torch.equal(base, outs[0])
    if k1 == 1:
        want = pa_mod.paged_decode_attention_plain(q, k, v, bt, pos, ks, vs)
    else:
        want = pa_mod.paged_verify_attention_plain(q, k, v, bt, pos, None,
                                                   ks, vs)
    lim = pa_mod.paged_limit(q, k, v, bt, pos, want, ks, vs)
    assert bool(((base.float() - want.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 5])
def test_paged_attention_split_launch_replays_in_a_cuda_graph(cuda_device,
                                                              k1):
    """A launch whose slots span up to 8 parts (8 slots, 16 heads,
    S_max 1024), captured in a CUDA graph and replayed twice: each
    replay the eager launch's bits, and the arrival counters zero after
    both."""
    q, k, v, bt, pos, _, ks, vs = _verify_case(cuda_device, 8, 16, 64, 64,
                                               16, "bf16", "bf16", k1,
                                               False, seed=9)
    if k1 == 1:
        q = q[:, :, 0].contiguous()
        fn = functools.partial(pa_mod.paged_decode_attention_kernel, q, k,
                               v, bt, pos)
    else:
        fn = functools.partial(pa_mod.paged_verify_attention_kernel, q, k,
                               v, bt, pos)
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    counters = pa_mod._counters(8 * 16, q.device)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
def test_paged_attention_refused_launch_keeps_counts_and_counters(
        cuda_device):
    """A split launch the C entry refuses (k1 past ``MAX_K1``) leaves the
    launch count and the arrival counters as they were; the C file's
    part size is the wrapper's ``PART_ROWS``."""
    lib = pa_mod.LIB.load()
    assert lib.apx_paged_attention_part_rows() == pa_mod.PART_ROWS
    pa_mod.paged_verify_attention_kernel(*_verify_case(
        cuda_device, 2, 2, 64, 64, 4, "bf16", "bf16", 5, False))
    torch.cuda.synchronize()
    counters = pa_mod._counters(4, cuda_device)
    before = counters.clone()
    big = _verify_case(cuda_device, 2, 2, 64, 64, 4, "bf16", "bf16",
                       pa_mod.MAX_K1 + 1, False)
    n0 = pa_mod.PAGED_VERIFY.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_verify_attention_kernel(*big)
    torch.cuda.synchronize()
    assert pa_mod.PAGED_VERIFY.launches == n0
    assert torch.equal(counters, before)
    assert int(counters.abs().sum()) == 0


def _chunk_case(dev, sc, pos, page, hd, kv="bf16", nh=16, seed=0,
                extra_pages=0):
    """One slot's prompt chunk: q (1, nh, sc, hd), pools of 2 + 2 x the
    table's pages, a gather row of distinct random pages for the rows 0
    .. pos + sc - 1 (NULL_PAGE past them, ``extra_pages`` more entries),
    and ``pos``."""
    from apex_tpu_torch.serving.cache import NULL_PAGE

    g = torch.Generator(device=dev).manual_seed(seed)
    live = -(-(pos + sc) // page)
    max_pages = live + extra_pages
    num_pages = 2 + 2 * max_pages
    k, v = (torch.randn((num_pages, nh, page, hd), generator=g,
                        device=dev).to(_DT[kv]) for _ in range(2))
    q = torch.randn((1, nh, sc, hd), generator=g, device=dev).to(_DT[kv])
    row = torch.full((1, max_pages), NULL_PAGE, dtype=torch.int32,
                     device=dev)
    row[0, :live] = (2 + torch.randperm(num_pages - 2, generator=g,
                                        device=dev)[:live]).to(torch.int32)
    return q, k, v, row, torch.tensor([pos], dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 24, 64])
@pytest.mark.parametrize("hd", [64, 48])
@pytest.mark.parametrize("sc", [64, 256])
@pytest.mark.parametrize("where", ["0", "mid_page", "768"])
def test_paged_chunk_kernel_within_limit(cuda_device, page, hd, sc, where):
    """The chunk kernel (one launch) against its plain version within
    ``chunk_limit`` per element, at pos 0, mid-page (1.5 pages) and 768
    (a split walk: the table holds 1024 rows or more), and the same bits
    on a second launch."""
    pos = {"0": 0, "mid_page": page + page // 2, "768": 768}[where]
    args = _chunk_case(cuda_device, sc, pos, page, hd, nh=4, seed=pos + sc,
                       extra_pages=1024 // page)
    n0 = pa_mod.PAGED_CHUNK.launches
    v0 = pa_mod.PAGED_VERIFY.launches
    got = pa_mod.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert pa_mod.PAGED_CHUNK.launches == n0 + 1
    assert pa_mod.PAGED_VERIFY.launches == v0
    want = pa_mod.paged_chunk_attention_plain(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    lim = pa_mod.chunk_limit(*args, want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    assert torch.equal(pa_mod.paged_chunk_attention_kernel(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 768])
def test_paged_chunk_kernel_placement_invariant(cuda_device, pos):
    """The same logical rows under two permutations of the physical
    pages: the same bits (pos 768 walks in parts), and again on a repeat
    launch."""
    q, k, v, row, p = _chunk_case(cuda_device, 256, pos, 64, 64, seed=3,
                                  extra_pages=2)
    outs = []
    for seed in (2, 3):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        perm = torch.arange(k.shape[0], device=cuda_device)
        perm[2:] = 2 + torch.randperm(k.shape[0] - 2, generator=g,
                                      device=cuda_device)
        k2, v2 = torch.empty_like(k), torch.empty_like(v)
        k2[perm], v2[perm] = k, v
        row2 = perm[row.long()].to(torch.int32)
        outs.append(pa_mod.paged_chunk_attention_kernel(q, k2, v2, row2, p))
        outs.append(pa_mod.paged_chunk_attention_kernel(q, k2, v2, row2, p))
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_paged_chunk_kernel_reads_through_the_gather_row(cuda_device):
    """A parked row (every entry the scratch page) reads other rows than
    the gather row: another ctx."""
    from apex_tpu_torch.serving.cache import SCRATCH_PAGE

    q, k, v, row, p = _chunk_case(cuda_device, 256, 256, 64, 64, seed=4)
    got = pa_mod.paged_chunk_attention_kernel(q, k, v, row, p)
    parked = torch.full_like(row, SCRATCH_PAGE)
    assert not torch.equal(
        pa_mod.paged_chunk_attention_kernel(q, k, v, parked, p), got)


@pytest.mark.cuda
def test_paged_chunk_kernel_refuses_without_counting(cuda_device):
    """The C entry refuses splits past its most, an unaligned q and a
    table past the shared memory with a non-zero code the wrapper
    raises; the wrapper refuses CPU tensors and an fp32 pool; no launch
    is counted. Its split constants are the wrapper's."""
    lib = pa_mod.LIB.load()
    assert (lib.apx_paged_chunk_max_splits(),
            lib.apx_paged_chunk_min_tiles()) == (pa_mod._MAX_SPLITS,
                                                 pa_mod._MIN_TILES)
    q, k, v, row, p = _chunk_case(cuda_device, 64, 0, 16, 64, nh=2)
    n0 = pa_mod.PAGED_CHUNK.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_chunk_attention_kernel(q, k, v, row, p, splits=5)
    base = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    q_off = base[1:].view(q.shape)
    q_off.copy_(q)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_chunk_attention_kernel(q_off, k, v, row, p)
    wide = torch.full((1, 60000), 2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa_mod.paged_chunk_attention_kernel(q, k, v, wide, p)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        pa_mod.paged_chunk_attention_kernel(q.cpu(), k, v, row, p)
    with pytest.raises(ValueError, match="bf16 q and pools"):
        pa_mod.paged_chunk_attention_kernel(q.float(), k.float(), v.float(),
                                            row, p)
    assert pa_mod.PAGED_CHUNK.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("pos", [0, 256, 512])
def test_paged_verify_at_a_prompt_chunks_shape(cuda_device, kv, pos):
    """A chunked prefill's attention: one slot, 16 heads, hd 64, a chunk
    of 256 queries at ``pos``, pages of 64 in a table of 16, attending
    through the slot's gather row while its stored row is parked on
    scratch. bf16: ``paged_chunk_attention`` launches the chunk kernel
    once, within ``chunk_limit`` of the plain version (the reference
    promises no decode bits for a chunk query, and speculation does not
    reach this path). fp32: the verify wrapper launches once a slice of
    ``verify_slices(256, 64)``, within ``paged_limit`` of the plain
    version, every query the bits of its one-query launch (the decode
    kernel at pos + j), and ``paged_chunk_attention`` takes that route.
    The parked row reads other rows."""
    from apex_tpu_torch.serving.cache import NULL_PAGE, SCRATCH_PAGE

    dev, sc, nh, hd, page, max_pages = cuda_device, 256, 16, 64, 64, 16
    g = torch.Generator(device=dev).manual_seed(pos + 7)
    num_pages = 2 + 2 * max_pages
    k, v = (torch.randn((num_pages, nh, page, hd), generator=g,
                        device=dev).to(_DT[kv]) for _ in range(2))
    q = torch.randn((1, nh, sc, hd), generator=g, device=dev).to(_DT[kv])
    live = (pos + sc) // page
    row = torch.full((max_pages,), NULL_PAGE, dtype=torch.int32,
                     device=dev)
    row[:live] = (2 + torch.randperm(num_pages - 2, generator=g,
                                     device=dev)[:live]).to(torch.int32)
    gather = row[None].contiguous()
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    parked = torch.full_like(gather, SCRATCH_PAGE)
    want = pa_mod.paged_verify_attention_plain(q, k, v, gather, p, None)
    if kv == "bf16":
        n0 = pa_mod.PAGED_CHUNK.launches
        v0 = pa_mod.PAGED_VERIFY.launches
        got = pa_mod.paged_chunk_attention(q, k, v, gather, p)
        torch.cuda.synchronize()
        assert pa_mod.PAGED_CHUNK.launches - n0 == 1
        assert pa_mod.PAGED_VERIFY.launches == v0
        lim = pa_mod.chunk_limit(q, k, v, gather, p, want)
        err = (got.float() - want.float()).abs()
        assert bool((err <= lim).all()), float((err / lim).max())
        assert not torch.equal(
            pa_mod.paged_chunk_attention(q, k, v, parked, p), got)
        return
    n0 = pa_mod.PAGED_VERIFY.launches
    got = pa_mod.paged_verify_attention(q, k, v, gather, p, None)
    torch.cuda.synchronize()
    assert pa_mod.PAGED_VERIFY.launches - n0 \
        == len(pa_mod.verify_slices(sc, hd)) == 4
    lim = pa_mod.paged_limit(q, k, v, gather, p, want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    for j in range(sc):
        one = pa_mod.paged_decode_attention_kernel(
            q[:, :, j].contiguous(), k, v, gather, p + j)
        assert torch.equal(got[:, :, j], one), j
    c0 = pa_mod.PAGED_CHUNK.launches
    assert torch.equal(pa_mod.paged_chunk_attention(q, k, v, gather, p), got)
    assert pa_mod.PAGED_CHUNK.launches == c0
    assert not torch.equal(
        pa_mod.paged_verify_attention(q, k, v, parked, p, None), got)


def spec_engine_streams(dev, spec_k, tree):
    """Greedy streams of a fp32 ``gpt_tiny`` (positions to 256, seed 0)
    on a ``PagedDecodeEngine`` with ``spec_k``: linear n-gram drafts
    (a verify window of spec_k + 1 every verify tick), or tree drafts
    from the target as its own fp32 ``DraftModel`` (its chain plus an
    alternate root child: a window of spec_k + 1). Three prompts: a
    random run of 90-110 tokens and its first three again, so the n-gram
    drafter proposes the run's next tokens. Returns (streams, spec
    ticks, verify launches, layers)."""
    import dataclasses

    from apex_tpu_torch.models.gpt import gpt_tiny, init_gpt
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, DraftModel, PagedDecodeEngine, Request,
    )
    from apex_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(gpt_tiny(), max_position_embeddings=256)
    params = tree_map(lambda t: t.to(dev), init_gpt(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    eng = PagedDecodeEngine(params, cfg, num_slots=2, max_len=256,
                            num_pages=40, page_size=16, buckets=(128, 256),
                            cache_dtype=torch.float32, spec_k=spec_k,
                            tree_spec=tree, device=dev,
                            draft_model=DraftModel(
                                params, cfg, 2, 240, chunk=16,
                                cache_dtype=torch.float32, device=dev)
                            if tree else None)
    sched = ContinuousBatchingScheduler(eng, eos_id=-1)
    rng = np.random.RandomState(5)
    for n in (90, 110, 100):
        run = [int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
        sched.submit(Request(prompt=tuple(run + run[:3]), max_new_tokens=8))
    n0 = pa_mod.PAGED_VERIFY.launches
    with torch.inference_mode():
        streams = sched.run()
    return (streams, sched.stats.spec_ticks,
            pa_mod.PAGED_VERIFY.launches - n0, cfg.num_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [64, 80])
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_paged_engine_speculates_past_max_k1(cuda_device, spec_k, tree):
    """A ``PagedDecodeEngine`` at ``spec_k`` 64 and 80 serves to the end
    on the card, with the CPU's streams; its verify ticks past
    ``MAX_K1`` queries launch the kernel once a slice (more than one
    launch a layer a verify tick)."""
    got, ticks, launches, L = spec_engine_streams(cuda_device, spec_k, tree)
    want = spec_engine_streams(torch.device("cpu"), spec_k, tree)[0]
    assert got == want
    assert ticks > 0 and launches > L * ticks


@pytest.mark.cuda
def test_ddp_bert_step_world_one_nccl_is_the_plain_step(cuda_device):
    """``BertTrainStep`` with ``DistributedDataParallel`` on an NCCL world
    of one (``initialize_model_parallel()`` brings it up): two O2 steps of
    ``bert_tiny`` equal the plain step's master, m, v and loss bit for
    bit (the all-reduce over one rank and the division by 1 are
    exact)."""
    import torch.distributed as dist

    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.models.bert import bert_tiny
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.tree import tree_leaves

    assert not dist.is_initialized()
    ps.initialize_model_parallel()
    try:
        assert dist.get_backend() == "nccl"
        runs = []
        for ddp in (None, DistributedDataParallel()):
            step, make_state, (ids, mask) = make_bert_train_step(
                4, 32, bert_tiny(), device=cuda_device, ddp=ddp)
            state = make_state()
            losses = []
            for _ in range(2):
                *state, loss = step(*state, ids, mask)
                losses.append(loss)
            runs.append((state, losses))
        (plain, lp), (ddp_state, ld) = runs
        assert all(torch.equal(a, b) for a, b in zip(lp, ld))
        for a, b in zip(tree_leaves((plain[0], plain[1].m, plain[1].v)),
                        tree_leaves((ddp_state[0], ddp_state[1].m,
                                     ddp_state[1].v))):
            assert torch.equal(a, b)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_paged_engine_quarantines_a_nan_decode_row(cuda_device):
    """The fault tier on the card: a 2-layer ``gpt_tiny`` on a bf16
    ``PagedDecodeEngine`` with the ``decode_exec`` site pinned at its
    first draw. With no retry budget the victim ends typed
    (``retry_budget``, its prefill token committed, the corrupt one
    never), the co-tenant's stream equals the fault-free run's token for
    token, the paged kernel ran every decode tick, and the pool is whole:
    no slot holds a page, every referenced page is the prefix registry's
    alone."""
    import dataclasses

    from apex_tpu_torch.models.gpt import gpt_tiny, init_gpt
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, FaultInjector, PagedDecodeEngine,
        Request, RetryBudgetExhausted, Tracer,
    )
    from apex_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(gpt_tiny(), num_layers=2)
    params = tree_map(lambda t: t.to(cuda_device, torch.bfloat16), init_gpt(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    reqs = [Request(prompt=(7, 11, 13), max_new_tokens=6),
            Request(prompt=(23, 29), max_new_tokens=6, temperature=0.8,
                    seed=3)]

    def run(injector=None):
        eng = PagedDecodeEngine(params, cfg, num_slots=2, max_len=32,
                                num_pages=20, page_size=4, buckets=(16, 32),
                                injector=injector, tracer=Tracer(),
                                device=cuda_device)
        sched = ContinuousBatchingScheduler(eng, eos_id=-1, audit=True,
                                            max_retries=0)
        for r in reqs:
            sched.submit(r)
        n0 = pa_mod.PAGED_DECODE.launches
        with torch.inference_mode():
            streams = sched.run()
        return sched, streams, pa_mod.PAGED_DECODE.launches - n0

    _, golden, _ = run()
    sched, _, launches = run(FaultInjector(schedule={"decode_exec": (0,)}))
    eng = sched.engine
    assert eng.injector.counts["decode_exec"] == 1
    assert sched.stats.nan_events == 1 and sched.stats.retries == 1
    bad = [rid for rid, o in sched.outcomes.items() if not o.ok]
    assert len(bad) == 1
    victim = sched.outcomes[bad[0]]
    assert victim.reason == "retry_budget"
    assert isinstance(victim.error, RetryBudgetExhausted)
    assert list(victim.tokens) == golden[bad[0]][:1]
    ok = 1 - bad[0]
    assert list(sched.outcomes[ok].tokens) == golden[ok]
    assert launches == cfg.num_layers * sched.decode_steps > 0
    eng.check_invariants()
    snap = eng.pool.snapshot()
    assert all(not p for p in eng._slot_pages)
    assert all(n == 1 for n in snap["refcounts"].values())
    assert len(snap["refcounts"]) == snap["num_cached"]
    assert eng.pool.num_free + eng.pool.num_cached == eng.pool.num_usable


@pytest.mark.cuda
def test_routed_serving_on_the_card_equals_colocated(cuda_device):
    """The cross-replica tier on the card: a 2-layer ``gpt_tiny`` on bf16
    ``PagedDecodeEngine`` replicas sharing one card. A
    ``DisaggregatedRouter`` pair and a 2x2 ``PoolRouter`` serve every
    admission remotely and commit the colocated scheduler's greedy and
    sampled streams token for token (the pages copied verbatim, the same
    kernels on the same inputs); a ``page_recv`` corruption on the pair
    is quarantined at the checksum and retried to the same streams; the
    paged kernel ran every decode tick."""
    import dataclasses

    from apex_tpu_torch.models.gpt import gpt_tiny, init_gpt
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, DisaggregatedRouter, FaultInjector,
        PagedDecodeEngine, PoolRouter, Request, Tracer,
    )
    from apex_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(gpt_tiny(), num_layers=2)
    params = tree_map(lambda t: t.to(cuda_device, torch.bfloat16), init_gpt(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    reqs = [Request(prompt=(1, 2, 3, 4, 5), max_new_tokens=8),
            Request(prompt=(6, 7, 8), max_new_tokens=6, temperature=0.8,
                    seed=7),
            Request(prompt=(1, 2, 3, 4, 9, 10), max_new_tokens=5)]

    def engines(n, injector):
        trc = Tracer()
        return [PagedDecodeEngine(params, cfg, num_slots=2, max_len=32,
                                  num_pages=20, page_size=4,
                                  buckets=(16, 32), injector=injector,
                                  tracer=trc, device=cuda_device)
                for _ in range(n)]

    def run(sched):
        for r in reqs:
            sched.submit(r)
        n0 = pa_mod.PAGED_DECODE.launches
        with torch.inference_mode():
            streams = sched.run()
        assert pa_mod.PAGED_DECODE.launches - n0 \
            == cfg.num_layers * sched.decode_steps > 0
        return streams

    golden = run(ContinuousBatchingScheduler(engines(1, None)[0], eos_id=-1,
                                             audit=True))
    pair = DisaggregatedRouter(*engines(2, FaultInjector()), eos_id=-1,
                               audit=True)
    assert run(pair) == golden
    assert pair.stats.remote_prefills == len(reqs)
    assert pair.stats.transfer_pages_deduped == 1
    e = engines(4, FaultInjector())
    pool = PoolRouter(e[:2], e[2:], eos_id=-1, audit=True)
    assert run(pool) == golden
    assert pool.stats.reshards == pool.stats.remote_prefills == len(reqs)
    bad = DisaggregatedRouter(*engines(2, FaultInjector(
        schedule={"page_recv": (0,)})), eos_id=-1, audit=True)
    assert run(bad) == golden
    assert bad.stats.transfer_corrupt == 1 and bad.stats.transfer_retries == 1
    assert bad.stats.transfer_failures == 0
    assert all(o.ok for o in bad.outcomes.values())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_tensor_parallel_collectives_stage_only_on_gloo(cuda_device,
                                                        backend):
    """``tensor_parallel.mappings.collective`` on a world of one over
    CUDA tensors: every kind returns the member's own values on the card;
    on gloo each is staged through the host (the bytes both ways
    counted), on NCCL nothing is staged."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer.tensor_parallel import mappings

    assert not dist.is_initialized()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        x = torch.arange(12.0, device=cuda_device).reshape(3, 4).to(
            torch.bfloat16)
        mappings.staged_bytes = 0
        for kind in ("all_reduce", "all_gather", "reduce_scatter",
                     "broadcast"):
            got = mappings.collective(kind, x, group, [0], dim=1)
            assert got.device == x.device and torch.equal(got, x), kind
        want = 4 * 2 * x.numel() * x.element_size() \
            if backend == "gloo" else 0
        assert mappings.staged_bytes == want
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_pipe_and_context_collectives_on_a_world_of_one(cuda_device,
                                                       backend):
    """The pipeline's and context parallelism's two kinds on a world of
    one over CUDA tensors: a ring shift over a group of one is the
    identity and posts nothing (no bytes staged); the tiled all-to-all
    returns the member's own values on the card, staged through the host
    on gloo only."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer.tensor_parallel import mappings

    assert not dist.is_initialized()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        x = torch.arange(24.0, device=cuda_device).reshape(2, 3, 4)
        mappings.staged_bytes = 0
        got = mappings.collective("shift", x, group, [0], step=1)
        assert got.device == x.device and torch.equal(got, x)
        assert mappings.staged_bytes == 0
        got = mappings.collective("all_to_all", x, group, [0], dim=2,
                                  concat_dim=1)
        assert got.device == x.device and torch.equal(got, x)
        want = 2 * x.numel() * x.element_size() if backend == "gloo" else 0
        assert mappings.staged_bytes == want
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_context_parallel_at_cp1_on_the_card(cuda_device):
    """Ring and Ulysses attention on a context axis of one (an NCCL world
    of one), bf16 q, k, v on the card: Ulysses' all-to-alls are the
    identity around the flash kernel, so its output is the kernel's bit
    for bit (one flash launch); the ring's fp32 block (plain PyTorch, no
    kernel) is within a bf16 rounding of the float64 attention."""
    import importlib

    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.context_parallel import (
        ring_attention, ulysses_attention,
    )
    from apex_tpu_torch.transformer.functional import flash_attention

    fa = importlib.import_module(
        "apex_tpu_torch.transformer.functional.flash_attention")
    ps.initialize_model_parallel(device=cuda_device)
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        q, k, v = (torch.randn((2, 4, 256, 64), generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(3))
        want = flash_attention(q, k, v, causal=True)
        before = fa.FLASH_FWD.launches
        got = ulysses_attention(q, k, v, causal=True)
        assert fa.FLASH_FWD.launches == before + 1
        assert torch.equal(got, want)
        ring = ring_attention(q, k, v, causal=True)
        assert fa.FLASH_FWD.launches == before + 1
        s = torch.matmul(q.double(), k.double().transpose(-1, -2)) / 8.0
        s = s.masked_fill(torch.ones(256, 256, dtype=torch.bool,
                                     device=cuda_device).triu(1),
                          float("-inf"))
        ref = torch.matmul(torch.softmax(s, -1), v.double())
        err = float((ring.double() - ref).abs().max())
        assert ring.dtype == torch.bfloat16 and err <= 2.0 ** -8 * float(
            ref.abs().max())
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gpt_model_at_tp1_is_the_unsharded_model(cuda_device):
    """``GPTModel`` at tp 1 on an NCCL world of one (every region the
    identity), bf16 compute over fp32 params: the final hidden equals
    ``apply_gpt_unsharded``'s bit for bit (the same kernels and
    products), and the vocab-parallel loss meets the fused cross
    entropy's within 1e-5 relative (one reads the bf16 logits in fp32
    plain ops, the other in its kernel)."""
    import torch.distributed as dist

    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.transformer import parallel_state as ps

    P = ps.PartitionSpec
    cfg = gpt.gpt_tiny()
    params = gpt.init_gpt(cfg, torch.Generator(device=cuda_device)
                          .manual_seed(0), device=cuda_device)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(1))
    ps.initialize_model_parallel()
    try:
        assert dist.get_backend() == "nccl"
        model = gpt.GPTModel(cfg)
        specs = model.partition_specs()
        hidden = ps.shard_map(
            lambda p, i: model.apply(p, i, compute_dtype=torch.bfloat16),
            in_specs=(specs, P()), out_specs=P())(params, ids)
        loss = ps.shard_map(
            lambda p, i: model.loss(p, i, i, compute_dtype=torch.bfloat16),
            in_specs=(specs, P()), out_specs=P())(params, ids)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    want = gpt.apply_gpt_unsharded(params, cfg, ids,
                                   compute_dtype=torch.bfloat16)
    assert torch.equal(hidden, want)
    want_loss = gpt.gpt_loss_unsharded(params, cfg, ids, ids,
                                       compute_dtype=torch.bfloat16)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
