"""Port parity: ``apex_tpu_torch.parallel.LARC`` against the JAX
package's, on the CPU, and the step arguments it passes to the inner
optimizer.

The cases mirror ``tests/L0/run_parallel/test_data_parallel.py::
test_larc_clip_formula`` (:194): the clipped and unclipped factors
against their formulas, and a zero-gradient leaf left untouched with a
weight decay given. The rest run LARC over ``FusedSGD`` with momentum
and weight decay on a tree whose values are small integers times 2^-4
(params) and 2^-10 (gradients): every sum of squares is then exact in
fp32, the norms are correctly rounded square roots on both sides, and
the port repeats the JAX package's fp32 operations in its order, so
params and momentum agree with the JAX package's bit for bit after the
first step (clip on and off, a leaf of zeros among them); after it the
params' sums of squares are no longer exact and are taken in other
orders, and the next two steps are held within 1e-6 relative (a few
ulps of a norm carried through the factor). The flat inner
step (``use_flat_kernel=True``, the ``flat_sgd`` kernel's plain version
here) gives the tree path's bits. The formula cases are held to the
reference's rtol (1e-5, and 1e-4 unclipped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.parallel import LARC as JaxLARC
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import LARC
from apex_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)


def test_larc_clip_formula():
    p = {"w": torch.full((4,), 2.0)}
    g = {"w": torch.full((4,), 0.1)}
    larc = LARC(FusedSGD(lr=0.1, momentum=0.0), trust_coefficient=0.02,
                clip=True)
    new_p, _ = larc.step(g, p, larc.init(p))
    adaptive = 0.02 * 4.0 / (0.2 + 1e-8)       # 0.4
    want = 2.0 - 0.1 * 0.1 * min(adaptive / 0.1, 1.0)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)

    larc2 = LARC(FusedSGD(lr=0.1, momentum=0.0), trust_coefficient=0.02,
                 clip=False)
    new_p2, _ = larc2.step(g, p, larc2.init(p))
    np.testing.assert_allclose(new_p2["w"].numpy(),
                               2.0 - 0.1 * adaptive * 0.1, rtol=1e-4)

    larc3 = LARC(FusedSGD(lr=0.1, momentum=0.0, weight_decay=0.0),
                 trust_coefficient=0.02, clip=True)
    zg = {"w": torch.zeros(4)}
    new_p3, _ = larc3.step(zg, p, larc3.init(p), weight_decay=0.5)
    assert torch.equal(new_p3["w"], torch.full((4,), 2.0))


def _tree(seed, grads=False):
    rng = np.random.RandomState(seed)
    scale, hi = (2.0 ** -10, 8) if grads else (2.0 ** -4, 24)

    def draw(*shape):
        return (rng.randint(-hi, hi + 1, size=shape) * scale).astype(
            np.float32)

    return {"dense": {"kernel": draw(12, 7), "bias": draw(7)},
            "frozen": np.zeros((5,), np.float32) if grads else draw(5),
            "layers": [draw(3, 4), draw(130)]}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _pairs(jtree, ptree):
    """Leaves of the JAX tree and the port tree, dict keys sorted on
    both (the port keeps insertion order)."""
    def walk(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in walk(v)]
        return [t]
    return list(zip(walk(jtree), walk(ptree)))


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_larc_matches_jax_bitwise(clip):
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-2)
    jl = JaxLARC(JaxSGD(**kw), trust_coefficient=0.02, clip=clip)
    pl = LARC(FusedSGD(**kw), trust_coefficient=0.02, clip=clip)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    pp = _torch(_tree(0))
    js, ps = jl.init(jp), pl.init(pp)
    for step in range(3):
        g = _tree(10 + step, grads=True)
        extra = {"lr": 0.05} if step == 2 else {}
        jp, js = jl.step(jax.tree.map(jnp.asarray, g), jp, js, **extra)
        pp, ps = pl.step(_torch(g), pp, ps, **extra)
        for w, t in _pairs(jp, pp) + _pairs(js.momentum_buf,
                                            ps.momentum_buf):
            w = torch.from_numpy(np.array(w))
            if step == 0:
                assert torch.equal(t, w)
            else:
                torch.testing.assert_close(t, w, rtol=1e-6, atol=1e-7)
    # the zero-gradient leaf moved only by the momentum of no gradient
    assert torch.equal(pp["frozen"], _torch(_tree(0))["frozen"])


def test_larc_flat_inner_step_gives_the_tree_bits():
    """LARC over ``FusedSGD(use_flat_kernel=True)`` (the card's
    ``resnet_larc`` configuration) against the tree path; a
    ``found_inf`` step leaves params and buffer as they were."""
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    tree, flat = LARC(FusedSGD(**kw)), \
        LARC(FusedSGD(use_flat_kernel=True, **kw))
    pt = pf = _torch(_tree(1))
    st, sf = tree.init(pt), flat.init(pf)
    for step in range(3):
        g = _torch(_tree(20 + step, grads=True))
        pt, st = tree.step(g, pt, st)
        pf, sf = flat.step(g, pf, sf)
        for a, b in zip(tree_leaves(pt), tree_leaves(pf)):
            assert torch.equal(a, b)
    buf = sf.momentum_buf.clone()
    old = [t.clone() for t in tree_leaves(pf)]
    pf2, sf2 = flat.step(g, pf, sf, found_inf=torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pf2), old))
    assert torch.equal(sf2.momentum_buf, buf)
    assert int(sf2.step) == int(sf.step)
