"""Port parity for the serving slice: ``apex_tpu_torch`` GPT prefill,
decode and continuous batching (greedy, and sampled with top-k / top-p)
against the JAX package on
``gpt_tiny``, with the JAX parameters carried across by
``params_from_jax``. The port runs on the CPU (plain versions of its
kernels); the JAX side runs as its own serving tests run it.

Tolerances: logits fp32 1e-4, bf16 5e-2 (O2 params and a bf16 cache,
where the two frameworks round at different places); greedy and sampled
token streams and tick accounting exactly."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models import gpt as jax_gpt
from apex_tpu import serving as jax_serving
from apex_tpu.serving import sampling as jax_sampling
from apex_tpu.utils import seqlen as jax_seqlen
from apex_tpu_torch import amp as port_amp
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.serving import sampling as port_sampling
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils import seqlen as port_seqlen

S_MAX = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_params():
    return jax_gpt.init_gpt(jax.random.PRNGKey(0), jax_gpt.gpt_tiny())


def _rope_cfgs():
    """gpt_tiny with RoPE: (JAX config, port config)."""
    import dataclasses

    return (dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True),
            dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True))


@pytest.fixture(scope="module")
def rope_params():
    # key 3: every greedy choice of the stream test clears its near-tie
    # guard (keys 0-2 leave a top-2 margin under 1e-3 on this tiny
    # random model, where an fp32 reordering could flip a token)
    return jax_gpt.init_gpt(jax.random.PRNGKey(3), _rope_cfgs()[0])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(jax_tree):
    return port_gpt.params_from_jax(_np_tree(jax_tree), "cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_cast_model_leaf_dtypes_match_jax(jax_params, level):
    want = jax_amp.initialize(level, verbosity=0).cast_model(jax_params)
    got = port_amp.initialize(level, verbosity=0).cast_model(
        _port_params(jax_params))
    want_d = {p: np.dtype(x.dtype).name for p, x in _leaves(want)}
    got_d = {p: str(x.dtype).replace("torch.", "")
             for p, x in _leaves(got)}
    assert got_d == want_d
    if level == "O2":
        # the norm-path markers match none of the GPT tree's LN names
        assert got_d[("layers", "ln1", "weight")] == "bfloat16"


def test_params_from_jax_carries_bf16_bits(jax_params):
    cast = jax_amp.initialize("O2", verbosity=0).cast_model(jax_params)
    got = _port_params(cast)
    ref = port_amp.initialize("O2", verbosity=0).cast_model(
        _port_params(jax_params))
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        assert a.dtype == torch.bfloat16, path
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), path


def test_init_gpt_matches_jax_tree():
    cfg = port_gpt.gpt_tiny()
    got = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    want = jax_gpt.init_gpt(jax.random.PRNGKey(0), jax_gpt.gpt_tiny())
    shapes = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for p, x in _leaves(got)}
    assert shapes == {p: (tuple(x.shape), np.dtype(x.dtype).name)
                      for p, x in _leaves(want)}
    h = cfg.hidden_size
    std = got["layers"]["qkv"]["kernel"].std().item()
    assert abs(std - (1.0 / h) ** 0.5) < 0.1 * (1.0 / h) ** 0.5


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(jax_params, dt):
    _prefill_and_decode(jax_params, jax_gpt.gpt_tiny(), port_gpt.gpt_tiny(),
                        dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_prefill_and_decode_match_jax(rope_params, dt):
    """The RoPE model (no position table; q and k rotated in prefill,
    and at each slot's position in decode)."""
    assert "position" not in rope_params["embedding"]
    _prefill_and_decode(rope_params, *_rope_cfgs(), dt)


def _prefill_and_decode(jp, cfg, pcfg, dt):
    if dt == "bf16":
        jp = jax_amp.initialize("O2", verbosity=0).cast_model(jp)
    pp = _port_params(jp)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    tol = 1e-4 if dt == "f32" else 5e-2
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, size=11)
    bucket, slot = 16, 1
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :11] = prompt
    ids[0, 11:] = 499  # pad ids must not matter
    mask = (np.arange(bucket) < 11).astype(np.int32)

    jcache = jax_serving.init_cache(cfg, 2, S_MAX, jdt)
    jcache, jl = jax_serving.make_prefill_fn(cfg)(
        jp, jcache, jnp.asarray(ids), jnp.asarray(mask), jnp.int32(slot))
    pcache = port_serving.init_cache(pcfg, 2, S_MAX, tdt, "cpu")
    with torch.inference_mode():
        pcache, pl = port_serving.make_prefill_fn(pcfg)(
            pp, pcache, torch.from_numpy(ids).long(),
            torch.from_numpy(mask), slot)
        assert pl.dtype == torch.float32 and pl.shape == (1, 512)
        np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol, atol=tol)
        for a, b in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
            assert a.dtype == tdt
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)
        assert pcache.lengths.tolist() == np.asarray(jcache.lengths).tolist()

        jdecode = jax_serving.make_decode_fn(cfg)
        pdecode = port_serving.make_decode_fn(pcfg)
        active = np.asarray([False, True])
        tok = int(np.argmax(np.asarray(jl)[0]))
        for _ in range(6):
            tokens = np.asarray([0, tok], np.int32)
            jcache, jl = jdecode(jp, jcache, jnp.asarray(tokens),
                                 jnp.asarray(active))
            pcache, pl = pdecode(pp, pcache, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(active))
            np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol,
                                       atol=tol)
            assert pcache.lengths.tolist() == \
                np.asarray(jcache.lengths).tolist()
            tok = int(np.argmax(np.asarray(jl)[1]))
        np.testing.assert_allclose(_f32(pcache.k), _f32(jcache.k),
                                   rtol=tol, atol=tol)


def _full_logits(params, cfg, seq):
    hidden = port_gpt.apply_gpt_unsharded(params, cfg, seq)
    table = params["embedding"]["word"]["embedding"]
    return torch.matmul(hidden, table.t()).float()


def test_decode_matches_full_forward(jax_params):
    """Port-only headline contract: cached decode logits equal the
    port's full-sequence forward at the same positions."""
    _decode_vs_full(_port_params(jax_params), port_gpt.gpt_tiny())


def test_rope_decode_matches_full_forward(rope_params):
    """The same contract with RoPE: decode rotates q and k at each
    slot's own position, the full forward at rows 0..s-1."""
    _decode_vs_full(_port_params(rope_params), _rope_cfgs()[1])


def _decode_vs_full(pp, cfg):
    seq = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(1, 20))).long()
    prompt = 8
    with torch.inference_mode():
        want = _full_logits(pp, cfg, seq)[0, prompt - 1:]
        cache = port_serving.init_cache(cfg, 2, S_MAX, torch.float32, "cpu")
        cache, logits = port_serving.make_prefill_fn(cfg)(
            pp, cache, seq[:, :prompt], torch.ones(prompt, dtype=torch.int32),
            0)
        rows = [logits[0]]
        decode = port_serving.make_decode_fn(cfg)
        active = torch.tensor([True, False])
        for t in range(prompt, seq.shape[1]):
            tokens = torch.stack([seq[0, t], torch.tensor(0)])
            cache, logits = decode(pp, cache, tokens, active)
            rows.append(logits[0])
    np.testing.assert_allclose(torch.stack(rows).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


_EOS = 7  # emitted mid-stream by one request on these weights


def _requests(vocab):
    rng = np.random.RandomState(0)
    lens, mnt = (5, 17, 9, 30, 3, 12), (8, 5, 10, 6, 9, 7)
    return [(tuple(int(t) for t in rng.randint(2, vocab, size=n)), m)
            for n, m in zip(lens, mnt)]


def test_greedy_streams_identical_to_jax(jax_params):
    reasons = _greedy_streams(jax_params, jax_gpt.gpt_tiny(),
                              port_gpt.gpt_tiny())
    assert "eos" in reasons


def test_rope_greedy_streams_identical_to_jax(rope_params):
    """The RoPE model's greedy streams and tick accounting equal the JAX
    scheduler's."""
    _greedy_streams(rope_params, *_rope_cfgs())


def _greedy_streams(jax_params, cfg, pcfg):
    """Both schedulers on one request mix; the JAX side's reasons."""
    reqs = _requests(cfg.vocab_size)
    jeng = jax_serving.DecodeEngine(jax_params, cfg, num_slots=2,
                                    max_len=S_MAX, cache_dtype=jnp.float32)
    jsched = jax_serving.ContinuousBatchingScheduler(jeng, eos_id=_EOS)
    for p, m in reqs:
        jsched.submit(jax_serving.Request(prompt=p, max_new_tokens=m))
    want = jsched.run()
    reasons = [jsched.outcomes[i].reason for i in range(len(reqs))]
    assert "length" in reasons

    pp = _port_params(jax_params)
    with torch.inference_mode():
        # guard: every greedy choice wins by a clear top-2 margin, so a
        # near-tie cannot flip under fp32 reordering
        for (p, _), toks in zip(reqs, want):
            seq = torch.tensor([list(p) + toks[:-1]])
            top2 = _full_logits(pp, pcfg, seq)[0, len(p) - 1:].topk(2).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
        peng = port_serving.DecodeEngine(pp, pcfg, num_slots=2,
                                         max_len=S_MAX,
                                         cache_dtype=torch.float32,
                                         device="cpu")
        psched = port_serving.ContinuousBatchingScheduler(peng, eos_id=_EOS)
        for p, m in reqs:
            psched.submit(port_serving.Request(prompt=p, max_new_tokens=m))
        got = psched.run()
    assert got == want
    for i in range(len(reqs)):
        a, b = psched.outcomes[i], jsched.outcomes[i]
        assert (a.tokens, a.reason, a.ttft_ticks, a.total_ticks,
                a.prefill_ticks) == (b.tokens, b.reason, b.ttft_ticks,
                                     b.total_ticks, b.prefill_ticks)
    return reasons


@pytest.mark.parametrize("n_req", [1, 2])
def test_decode_steps_count_batched_decodes(jax_params, n_req):
    """Requests of 5 tokens on 2 slots: the prefill yields the first
    token, then 4 batched decode steps serve every occupied slot."""
    peng = port_serving.DecodeEngine(_port_params(jax_params),
                                     port_gpt.gpt_tiny(), num_slots=2,
                                     max_len=S_MAX, cache_dtype=torch.float32,
                                     device="cpu")
    psched = port_serving.ContinuousBatchingScheduler(peng, eos_id=-1)
    for i in range(n_req):
        psched.submit(port_serving.Request(prompt=(3 + i, 4, 5),
                                           max_new_tokens=5))
    with torch.inference_mode():
        streams = psched.run()
    assert [len(s) for s in streams] == [5] * n_req
    assert psched.decode_steps == 4


def test_cache_full_eviction_matches_jax(jax_params):
    """A request that outgrows its cache row ends ``cache_full`` with
    the same tokens on both sides (max_len 16, a 14-token prompt)."""
    cfg = jax_gpt.gpt_tiny()
    prompt = tuple(range(3, 17))
    jeng = jax_serving.DecodeEngine(jax_params, cfg, num_slots=1,
                                    max_len=16, cache_dtype=jnp.float32)
    jsched = jax_serving.ContinuousBatchingScheduler(jeng, eos_id=-1)
    jsched.submit(jax_serving.Request(prompt=prompt, max_new_tokens=10))
    jsched.run()
    peng = port_serving.DecodeEngine(_port_params(jax_params),
                                     port_gpt.gpt_tiny(), num_slots=1,
                                     max_len=16, cache_dtype=torch.float32,
                                     device="cpu")
    psched = port_serving.ContinuousBatchingScheduler(peng, eos_id=-1)
    psched.submit(port_serving.Request(prompt=prompt, max_new_tokens=10))
    with torch.inference_mode():
        psched.run()
    want, got = jsched.outcomes[0], psched.outcomes[0]
    assert want.reason == "cache_full"
    assert (got.tokens, got.reason) == (want.tokens, want.reason)


@pytest.mark.parametrize("prompt,buckets", [
    ((), None), (tuple(range(2, 2 + S_MAX + 1)), None),
    (tuple(range(2, 22)), (16,))], ids=["empty", "too_long", "no_bucket"])
def test_submit_validation_matches_jax(jax_params, prompt, buckets):
    cfg = jax_gpt.gpt_tiny()
    jeng = jax_serving.DecodeEngine(jax_params, cfg, num_slots=2,
                                    max_len=S_MAX, buckets=buckets)
    peng = port_serving.DecodeEngine(_port_params(jax_params),
                                     port_gpt.gpt_tiny(), num_slots=2,
                                     max_len=S_MAX, buckets=buckets,
                                     device="cpu")
    with pytest.raises(ValueError) as want:
        jax_serving.ContinuousBatchingScheduler(jeng, eos_id=1).submit(
            jax_serving.Request(prompt=prompt))
    with pytest.raises(ValueError) as got:
        port_serving.ContinuousBatchingScheduler(peng, eos_id=1).submit(
            port_serving.Request(prompt=prompt))
    assert str(got.value) == str(want.value)


def test_nonfinite_logits_raise_and_never_commit(jax_params):
    """NaN params make every prefill's logits non-finite: the admission
    gate quarantines each attempt (the reference's always-on gate, no
    token committed), and once the retry budget is spent the request
    ends typed — a ``retry_budget`` outcome whose
    ``RetryBudgetExhausted`` names the non-finite logits — with every
    slot free."""
    pp = _port_params(jax_params)
    pp["final_ln"]["weight"][3] = float("nan")
    eng = port_serving.DecodeEngine(pp, port_gpt.gpt_tiny(), num_slots=2,
                                    max_len=S_MAX, device="cpu")
    sched = port_serving.ContinuousBatchingScheduler(eng, eos_id=1,
                                                     max_retries=2)
    sched.submit(port_serving.Request(prompt=(5, 6, 7)))
    with torch.inference_mode():
        assert sched.run() == [[]]
    out = sched.outcomes[0]
    assert (out.reason, out.retries, out.ok) == ("retry_budget", 3, False)
    assert isinstance(out.error, port_serving.RetryBudgetExhausted)
    assert "non-finite prefill logits" in str(out.error)
    assert sched.stats.nan_events == 3 and sched.stats.retries == 3
    assert all(s is None for s in sched._slots)


def test_sampled_rows_not_ported(jax_params):
    """Sampled rows raised until the threefry streams were ported; a
    sampled request runs now, and a replay commits the same stream."""
    streams = []
    for _ in range(2):
        eng = port_serving.DecodeEngine(_port_params(jax_params),
                                        port_gpt.gpt_tiny(), num_slots=1,
                                        max_len=S_MAX, device="cpu")
        sched = port_serving.ContinuousBatchingScheduler(eng, eos_id=-1)
        sched.submit(port_serving.Request(prompt=(5, 6), temperature=0.8,
                                          max_new_tokens=6, seed=3))
        with torch.inference_mode():
            streams.append(sched.run())
    assert streams[0] == streams[1] and len(streams[0][0]) == 6


_TEMPS = (0.0, 0.7, 1.3, 0.0, 0.7, 1.3)


def _smallest_gap(pp, pcfg, reqs, streams, top_k, top_p):
    """Over every sampled token committed, the gap between the two best
    perturbed scores the port drew it from (teacher-forced logits, the
    token's key ``fold_in(PRNGKey(seed), n)``): how close a draw came to
    a flip."""
    gaps = []
    for i, ((p, _), toks) in enumerate(zip(reqs, streams)):
        if _TEMPS[i] <= 0:
            continue
        seq = torch.tensor([list(p) + toks[:-1]])
        rows = _full_logits(pp, pcfg, seq)[0, len(p) - 1:]
        keys = torch.stack([prng.fold_in(prng.PRNGKey(i), n)
                            for n in range(len(toks))])
        scaled = port_sampling._restrict(rows, top_k, top_p) / _TEMPS[i]
        score = scaled + prng.gumbel_rows(keys, rows.shape[-1], "cpu")
        top2 = score.topk(2).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
    return min(gaps)


def test_sample_token_grid_matches_jax():
    """The verify step's sampler over (B, k1, V) logits, one key a
    position and one temperature a slot: the JAX package's tokens."""
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 3, 97) * 2).astype(np.float32)
    keys = np.stack([np.stack([np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(b), j)) for j in range(3)]) for b in range(2)])
    temps = np.array([0.9, 0.0], np.float32)
    want = jax_sampling.sample_token_grid(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temps), 5, 0.9)
    got = port_sampling.sample_token_grid(
        torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(temps), 5, 0.9)
    assert got.dtype == torch.int32 and got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_p", [0.0, 0.9])
@pytest.mark.parametrize("top_k", [0, 5])
def test_sampled_streams_identical_to_jax(jax_params, top_k, top_p):
    """Greedy requests beside sampled ones at temperatures 0.7 and 1.3
    (seed = request index), on engines with ``top_k`` / ``top_p``: the
    port's committed streams equal the JAX scheduler's. A token may flip
    only where its two best perturbed scores lie within twice
    ``prng.gumbel_limit`` (the test prints the smallest gap met)."""
    cfg = jax_gpt.gpt_tiny()
    reqs = _requests(cfg.vocab_size)
    jeng = jax_serving.DecodeEngine(jax_params, cfg, num_slots=2,
                                    max_len=S_MAX, cache_dtype=jnp.float32,
                                    top_k=top_k, top_p=top_p)
    jsched = jax_serving.ContinuousBatchingScheduler(jeng, eos_id=_EOS)
    for i, (p, m) in enumerate(reqs):
        jsched.submit(jax_serving.Request(prompt=p, max_new_tokens=m,
                                          temperature=_TEMPS[i], seed=i))
    want = jsched.run()
    pcfg = port_gpt.gpt_tiny()
    pp = _port_params(jax_params)
    peng = port_serving.DecodeEngine(pp, pcfg, num_slots=2, max_len=S_MAX,
                                     cache_dtype=torch.float32, top_k=top_k,
                                     top_p=top_p, device="cpu")
    psched = port_serving.ContinuousBatchingScheduler(peng, eos_id=_EOS)
    for i, (p, m) in enumerate(reqs):
        psched.submit(port_serving.Request(prompt=p, max_new_tokens=m,
                                           temperature=_TEMPS[i], seed=i))
    with torch.inference_mode():
        got = psched.run()
        gap = _smallest_gap(pp, pcfg, reqs, got, top_k, top_p)
    print(f"top_k {top_k}, top_p {top_p}: smallest top-two gap of a "
          f"sampled token {gap:.3g}")
    assert got == want
    assert [psched.outcomes[i].reason for i in range(len(reqs))] == [
        jsched.outcomes[i].reason for i in range(len(reqs))]


def test_seqlen_helpers_match_jax():
    for n in (1, 100, 128, 129, 1000):
        assert port_seqlen.default_buckets(n) == \
            jax_seqlen.default_buckets(n)
    assert port_seqlen.bucket_for(130, (128, 256, 512)) == \
        jax_seqlen.bucket_for(130, (128, 256, 512))
    ids = np.arange(1, 12, dtype=np.int32)[None, :]
    want, wmask = jax_seqlen.pad_to_bucket(ids, 11, buckets=(16, 32))
    got, gmask = port_seqlen.pad_to_bucket(torch.from_numpy(ids), 11,
                                           buckets=(16, 32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert gmask.dtype == torch.int32


def test_pad_to_bucket_pads_every_leaf_like_jax():
    """A dict batch (ids and labels) pads leaf by leaf, called with the
    reference's keyword ``batch``."""
    rng = np.random.RandomState(2)
    batch = {"ids": rng.randint(0, 100, size=(2, 11)).astype(np.int32),
             "labels": rng.randint(0, 100, size=(2, 11, 3)).astype(
                 np.int32)}
    want, wmask = jax_seqlen.pad_to_bucket(batch=batch, length=11,
                                           buckets=(16,), pad_value=-1)
    got, gmask = port_seqlen.pad_to_bucket(
        batch={k: torch.from_numpy(v) for k, v in batch.items()},
        length=11, buckets=(16,), pad_value=-1)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


def test_pad_to_bucket_ragged_leaf_raises_like_jax():
    batch = {"ids": np.zeros((2, 11), np.int32),
             "mask": np.zeros((2, 9), np.int32)}
    with pytest.raises(ValueError) as want:
        jax_seqlen.pad_to_bucket(batch, 11, buckets=(16,))
    with pytest.raises(ValueError) as got:
        port_seqlen.pad_to_bucket({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, 11,
                                  buckets=(16,))
    assert str(got.value) == str(want.value)


def _generate(*flags):
    out = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.examples.gpt.generate",
         "--device", "cpu", "--num-requests", "3", "--num-slots", "2",
         "--max-new-tokens", "4", "--max-len", "64", "--eos-id=-1", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated 12 tokens across 3 requests" in out.stdout


def test_generate_cli_runs_on_cpu():
    _generate()


def test_generate_cli_runs_on_cpu_with_rope():
    """``--use-rope``, as the reference CLI takes it."""
    _generate("--use-rope")


def test_rope_tree_serves_past_the_position_table(rope_params):
    """A RoPE tree has no position leaf: ``quantize_params`` and the
    cache take it, and the cache may outrun ``max_position_embeddings``
    (the angle table covers the cache), as in the JAX package."""
    from apex_tpu_torch.quant import quantize_params

    _, pcfg = _rope_cfgs()
    q = quantize_params(_port_params(rope_params))
    assert "position" not in q["embedding"]
    n = 2 * pcfg.max_position_embeddings
    eng = port_serving.DecodeEngine(q, pcfg, num_slots=1, max_len=n,
                                    cache_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        logits = eng.prefill(0, list(range(2, 2 + n - 8)))
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="learned position table"):
        port_serving.init_cache(port_gpt.gpt_tiny(), 1, n, device="cpu")
