"""Port parity of ``transformer/context_parallel`` (ring and Ulysses
attention) against the JAX package on the CPU.

The reference's ``test_ring_attention.py`` and
``test_ulysses_attention.py`` cases at cp 2 and cp 4, each rank a gloo
process (``tests/_torch_ranks.py``) running the port's function inside
``parallel_state.shard_map`` on its sequence block: against the JAX
package's full ``flash_attention`` on the whole sequence (causal and
not, a padding mask; ring: fully masked rows give 0; the gradients of
``sum(out**2)``, ring with and without ``checkpoint_blocks``) at the
reference's tolerances (ring 2e-5 relative and 2e-6 absolute, its
gradients 3e-5 / 3e-6; Ulysses 2e-5 / 2e-5, its gradients 2e-4 / 2e-4),
and against the JAX ring and Ulysses functions on a cp-device mesh
(causal forward; the gradients at one degree each) to the same bounds.
A context axis of one rank gives flash; Ulysses with ``heads % cp``
raises the reference's message. q, k and v are the reference's
``normal`` draws, carried across as numpy. This module imports no JAX at
its top."""

import functools
import os

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.context_parallel import (
    ring_attention, ulysses_attention,
)

P = ps.PartitionSpec
B, H, S, D = 2, 8, 64, 16
SEQ = P(None, None, ps.CONTEXT_AXIS, None)
MASK = P(None, ps.CONTEXT_AXIS)
FNS = {"ring": ring_attention, "ulysses": ulysses_attention}
FWD_TOL = {"ring": (2e-5, 2e-6), "ulysses": (2e-5, 2e-5)}
GRAD_TOL = {"ring": (3e-5, 3e-6), "ulysses": (2e-4, 2e-4)}
# the (impl, cp) whose gradients are also held to the JAX function's
JAX_GRADS = {("ring", 4), ("ulysses", 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX side (memoized; imported lazily)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _qkv(seed):
    import jax
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.asarray(jax.random.normal(k, (B, H, S, D))) for k in ks)


@functools.lru_cache(maxsize=None)
def _masks():
    import jax
    import jax.numpy as jnp
    pad = np.ones((B, S), np.int32)
    pad[:, S // 3:] = 0
    rnd = np.asarray((jax.random.uniform(jax.random.PRNGKey(9), (B, S))
                      > 0.2).astype(jnp.int32))
    return {"pad": pad, "random": rnd, "zero": np.zeros((B, S), np.int32)}


def _jax_flash(q, k, v, mask=None, causal=False):
    from apex_tpu.transformer.functional import flash_attention
    return flash_attention(q, k, v, mask, causal=causal)


@functools.lru_cache(maxsize=None)
def _jax_full(seed, causal, mask):
    q, k, v = _qkv(seed)
    m = None if mask is None else _masks()[mask]
    return np.asarray(_jax_flash(q, k, v, m, causal))


def _sq_loss(fn):
    import jax.numpy as jnp

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)
    return loss


@functools.lru_cache(maxsize=None)
def _jax_full_grads(seed):
    import jax
    q, k, v = _qkv(seed)
    loss, grads = jax.value_and_grad(
        _sq_loss(lambda q, k, v: _jax_flash(q, k, v, causal=True)),
        argnums=(0, 1, 2))(q, k, v)
    return float(loss), tuple(np.asarray(g) for g in grads)


@functools.lru_cache(maxsize=None)
def _jax_cp(impl, cp, seed, grads):
    """The JAX function on a cp-device context mesh: the causal output,
    or (loss, gradients) of ``sum(out**2)``."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.transformer import context_parallel as jcp
    from apex_tpu.transformer import parallel_state as jps

    fn = {"ring": jcp.ring_attention, "ulysses": jcp.ulysses_attention}[impl]
    seq = JP(None, None, jps.CONTEXT_AXIS, None)
    mesh = jps.initialize_model_parallel(context_parallel_size_=cp,
                                         devices=jax.devices()[:cp])
    try:
        q, k, v = _qkv(seed)
        run = jax.jit(jps.shard_map(
            lambda q, k, v: fn(q, k, v, causal=True), mesh=mesh,
            in_specs=(seq,) * 3, out_specs=seq))
        if not grads:
            return np.asarray(run(q, k, v))
        loss, g = jax.jit(jax.value_and_grad(_sq_loss(run),
                                             argnums=(0, 1, 2)))(q, k, v)
        return float(loss), tuple(np.asarray(x) for x in g)
    finally:
        jps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _fwd(impl, qkv, mask=None, causal=False):
    fn = FNS[impl]
    if mask is None:
        return ps.shard_map(lambda q, k, v: fn(q, k, v, causal=causal),
                            in_specs=(SEQ,) * 3, out_specs=SEQ)(*qkv)
    return ps.shard_map(lambda q, k, v, m: fn(q, k, v, m, causal=causal),
                        in_specs=(SEQ,) * 3 + (MASK,),
                        out_specs=SEQ)(*qkv, mask)


def _grads(impl, qkv, **kw):
    """(the summed loss, the gathered gradients) of ``sum(out**2)``,
    each rank differentiating its own block's loss."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        collective,
    )

    def local(q, k, v):
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = FNS[impl](*xs, causal=True, **kw)
            loss = (out.float() ** 2).sum()
            g = torch.autograd.grad(loss, xs)
        mesh = ps.get_mesh()
        total = collective("all_reduce", loss.detach(),
                           mesh.groups[ps.CONTEXT_AXIS],
                           mesh.members(ps.CONTEXT_AXIS))
        return total, tuple(g)

    return ps.shard_map(local, in_specs=(SEQ,) * 3,
                        out_specs=(P(), (SEQ,) * 3))(*qkv)


def job(rank, world, tmp):
    d = torch.load(os.path.join(tmp, "inputs.pt"))
    qkv, masks = d["qkv"], d["masks"]
    out = {}
    ps.initialize_model_parallel(context_parallel_size_=world, device="cpu")
    for impl in FNS:
        for causal in (False, True):
            out[(impl, "causal", causal)] = _fwd(impl, qkv[0], causal=causal)
        mask = "pad" if impl == "ring" else "random"
        out[(impl, "mask")] = _fwd(impl, qkv[1], masks[mask])
    out[("ring", "zero")] = _fwd("ring", qkv[2], masks["zero"])
    for ckpt in (False, True):
        out[("ring", "grads", ckpt)] = _grads("ring", qkv[3],
                                              checkpoint_blocks=ckpt)
    out[("ulysses", "grads")] = _grads("ulysses", qkv[3])
    q = torch.ones((1, world + 1, 8 * world, 4))
    try:
        ps.shard_map(lambda q: ulysses_attention(q, q, q), in_specs=SEQ,
                     out_specs=SEQ)(q)
        out["heads_error"] = None
    except ValueError as e:
        out["heads_error"] = str(e)
    if world == 2:
        # a context axis of one rank: the two ranks data-parallel
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(device="cpu")
        out["cp1"] = ps.shard_map(lambda q, k, v: ring_attention(q, k, v),
                                  in_specs=(P(),) * 3,
                                  out_specs=P())(*qkv[4])
    return out


def _inputs_file(tmp):
    torch.save({"qkv": [tuple(torch.from_numpy(np.array(t))
                              for t in _qkv(s)) for s in range(5)],
                "masks": {k: torch.from_numpy(np.array(v))
                          for k, v in _masks().items()}},
               os.path.join(tmp, "inputs.pt"))


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp2")
    _inputs_file(tmp)
    return spawn(job, 2, tmp)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp4")
    _inputs_file(tmp)
    return spawn(job, 4, tmp)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _close(got, want, tol):
    rtol, atol = tol
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("impl", sorted(FNS))
@pytest.mark.parametrize("causal", [False, True])
def test_matches_flash_attention(impl, cp, causal, request):
    res = request.getfixturevalue(f"w{cp}")
    want = _jax_full(0, causal, None)
    for r in res:
        _close(r[(impl, "causal", causal)], want, FWD_TOL[impl])
    if causal:
        jax_cp = _jax_cp(impl, cp, 0, False)
        for r in res:
            _close(r[(impl, "causal", causal)], jax_cp, FWD_TOL[impl])


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("impl", sorted(FNS))
def test_padding_mask(impl, cp, request):
    res = request.getfixturevalue(f"w{cp}")
    want = _jax_full(1, False, "pad" if impl == "ring" else "random")
    for r in res:
        _close(r[(impl, "mask")], want, FWD_TOL[impl])


@pytest.mark.parametrize("cp", [2, 4])
def test_fully_masked_rows_return_zero(cp, request):
    for r in request.getfixturevalue(f"w{cp}"):
        got = r[("ring", "zero")]
        assert torch.isfinite(got).all() and not got.any()


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("case", ["ring-False", "ring-True", "ulysses"])
def test_gradients_match_full_attention(case, cp, request):
    impl, _, ckpt = case.partition("-")
    key = ("ring", "grads", ckpt == "True") if impl == "ring" \
        else ("ulysses", "grads")
    res = request.getfixturevalue(f"w{cp}")
    wants = [_jax_full_grads(3)]
    if (impl, cp) in JAX_GRADS:
        wants.append(_jax_cp(impl, cp, 3, True))
    for want_loss, want_grads in wants:
        for r in res:
            loss, grads = r[key]
            np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
            for g, w in zip(grads, want_grads):
                _close(g, w, GRAD_TOL[impl])


def test_cp1_degenerates_to_flash(w2):
    q, k, v = _qkv(4)
    want = np.asarray(_jax_flash(q, k, v))
    for r in w2:
        _close(r["cp1"], want, FWD_TOL["ring"])


@pytest.mark.parametrize("cp", [2, 4])
def test_heads_divisibility_error(cp, request):
    for r in request.getfixturevalue(f"w{cp}"):
        assert r["heads_error"] == (
            f"ulysses_attention needs heads % cp == 0, got {cp + 1} % {cp}")
