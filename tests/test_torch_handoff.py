"""Port parity of the page handoff between processes (``serving.
transfer``'s ``PageReshard`` over two meshes of disjoint ranks, and
``serving.router``'s ``PoolRouter`` with each replica's engine in its
own process, a ``RemoteReplica`` in its place on the other ranks)
against the JAX package on the CPU.

One spawn of two gloo ranks and one of four (``tests/_torch_ranks.py``):

- the channel, 1 -> 1 ranks (two ranks) and 2 -> 2 (four: tp 2 meshes
  over ranks 0, 1 and 2, 3, each source rank holding its head block of
  the pool): under ``{"reshard_send": (0,), "reshard_recv": (0,)}`` the
  destination ranks get the JAX ``PageReshard``'s tile bytes and sha256
  digest (the JAX meshes over host devices 0, 1 and 2, 3), every rank
  the JAX attempts and counters, and each destination rank keeps its
  head block of the tiles; fp32 and bf16 pools;
- the reference's pool cases (``tests/L0/run_serving/test_pool.py``:
  fault-free, a dropped reshard send, a corrupted reshard receive, the
  reshard budget exhausted and the pages re-shipped host-staged, the
  active decode replica down to its sibling, the chaos sweep's seed 0)
  at 1 x 1 over two ranks (prefill on rank 0, decode on rank 1, the
  two-mesh reshard; the JAX run's meshes as above) and at 2 x 2 over four
  (replica i on rank i, the default reshard, as the JAX run): the
  streams, outcomes, ``ServingStats``, injector counts, the tracer's
  event names and tick stream and the registry's Prometheus text equal
  the JAX run's, on every rank. The bytes each rank sent are counted by
  kind; the tiles and logits rows sent equal what the run shipped;
- the ``DisaggregatedRouter`` pair over the two ranks, fault-free and
  under a dropped and a corrupted host-staged send, equals the JAX
  pair's run on both ranks.

gpt_tiny with RoPE, fp32 weights from a seeded generator (carried to JAX
as the same arrays), replicas of 2 slots, max_len 32, pages of 4,
buckets (16, 32). This module imports no JAX at its top."""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.models import gpt as port_gpt

EOS = -1
MAX_LEN = 32
PAGE = 4
NUM_PAGES = 20
GEOMETRY = dict(num_slots=2, max_len=MAX_LEN, num_pages=NUM_PAGES,
                page_size=PAGE, buckets=(16, 32))
REQS = (dict(prompt=(1, 2, 3, 4, 5), max_new_tokens=8),
        dict(prompt=(6, 7, 8), max_new_tokens=6, temperature=0.8, seed=7),
        dict(prompt=(9, 10, 11, 12), max_new_tokens=4, temperature=1.1,
             seed=5))
RATES = {"reshard_send": 0.25, "reshard_recv": 0.2, "pool_route": 0.15,
         "replica_health": 0.1, "page_send": 0.1, "decode_exec": 0.05}
CASES = {
    "fault_free": {},
    "reshard_send": dict(schedule={"reshard_send": (0,)}),
    "reshard_recv": dict(schedule={"reshard_recv": (0,)}),
    "reshard_exhausted": dict(schedule={"reshard_send": (0, 1, 2)}),
    "decode_down": dict(schedule={"replica_health": (2, 6)}),
    "chaos_seed0": dict(rates=RATES, seed=0),
}
#: the DisaggregatedRouter pair over two ranks (the host-staged channel)
PAIR_CASES = {
    "pair_fault_free": {},
    "pair_page_faults": dict(schedule={"page_send": (0,),
                                       "page_recv": (1,)}),
}
CHANNEL_SCHEDULE = {"reshard_send": (0,), "reshard_recv": (0,)}
CHANNEL_PAGES = [3, 2, 9]
CHANNEL_TOKENS = list(range(12))
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The JAX engines' jitted steps depend only on their factory's arguments:
# built once for the module, each reference run compiles only what no
# earlier run did (the functions are the JAX package's own).
_JAX_FACTORIES = {
    "apex_tpu.serving.scheduler": (
        "make_paged_prefill_fn", "make_paged_decode_fn",
        "make_paged_verify_fn", "make_copy_page_fn",
        "make_extract_pages_fn", "make_insert_pages_fn"),
    "apex_tpu.serving.router": ("make_insert_pages_fn",),
    "apex_tpu.serving.transfer": ("make_extract_pages_fn",),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_fns_once():
    import importlib

    memo = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in _JAX_FACTORIES.items():
            m = importlib.import_module(mod)
            for name in names:
                f = getattr(m, name)
                mp.setattr(m, name, memo.setdefault(f, functools.cache(f)))
        yield


def _cfg(mod):
    return dataclasses.replace(mod.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)


@functools.lru_cache(maxsize=None)
def _params():
    return port_gpt.init_gpt(_cfg(port_gpt), torch.Generator().manual_seed(0),
                             device="cpu")


def _pool_tiles(dtype: str):
    """(k, v) of a whole page pool, seeded: numpy float32 arrays that
    both packages cast to ``dtype``."""
    cfg = _cfg(port_gpt)
    shape = (cfg.num_layers, NUM_PAGES, cfg.num_heads, PAGE, cfg.head_dim)
    rng = np.random.default_rng(5 + DTYPES.index(dtype))
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape, np.float32))


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _summary(pool):
    """What a pool run must equal on every rank and in the JAX run."""
    return dict(
        streams=pool.run(),
        outcomes={rid: (tuple(o.tokens), o.reason, o.retries,
                        type(o.error).__name__, o.ttft_ticks,
                        o.total_ticks, o.prefill_ticks)
                  for rid, o in sorted(pool.outcomes.items())},
        stats=pool.stats.as_dict(),
        counts=dict(pool.engine.injector.counts),
        names=[e.name for e in pool.tracer.events],
        ticks=pool.tracer.tick_stream(),
        metrics=pool.tracer.registry.to_prometheus(),
        health={n: (h.state, h.transitions)
                for n, h in sorted(pool.health.items())},
        active=pool.engine.active_name, clock=pool.clock)


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _meshes(world):
    """(source mesh, destination mesh): one rank each at two ranks, tp 2
    over ranks 0, 1 and 2, 3 at four."""
    from apex_tpu_torch.partition import make_mesh

    half = world // 2
    return (make_mesh(tp=half, devices=list(range(half)), device="cpu"),
            make_mesh(tp=half, devices=list(range(half, world)),
                      device="cpu"))


def _channel(rank, world):
    """The channel alone, under the pinned schedule, fp32 and bf16."""
    from apex_tpu_torch.serving import FaultInjector, PageReshard
    from apex_tpu_torch.serving.cache import init_paged_cache
    from apex_tpu_torch.serving.router import RemoteReplica
    from apex_tpu_torch.transformer import parallel_state as ps

    src_mesh, dst_mesh = _meshes(world)
    half = world // 2
    out = {}
    for name in DTYPES:
        dt = getattr(torch, name)
        cfg = _cfg(port_gpt)
        tier = PageReshard(FaultInjector(seed=3, schedule=CHANNEL_SCHEDULE),
                           max_retries=3, src_mesh=src_mesh,
                           dst_mesh=dst_mesh)
        if rank < half:
            # this rank's head block of the source pool
            cache = init_paged_cache(cfg, 2, MAX_LEN, NUM_PAGES, PAGE, dt,
                                     "cpu")
            nh = cfg.num_heads // half
            k, v = (torch.from_numpy(x)[:, :, rank * nh:(rank + 1) * nh]
                    .to(dt) for x in _pool_tiles(name))
            src = SimpleNamespace(cache=cache._replace(k=k, v=v),
                                  page_size=PAGE)
        else:
            src = RemoteReplica(0, cfg, **GEOMETRY)
        k, v, attempts = tier.ship(src, CHANNEL_TOKENS, CHANNEL_PAGES,
                                   replica="prefill")
        res = dict(attempts=attempts,
                   stats={f: getattr(tier.stats, f) for f in (
                       "reshards", "reshard_retries", "reshard_corrupt",
                       "reshard_failures")},
                   sent=dict(tier.wire.sent), tiles=None)
        if k is not None:
            kb, vb = tier.shard_fn(k, v)
            # tensors: the harness loads results with weights_only
            res["tiles"] = tuple(torch.from_numpy(np.array(t))
                                 for t in (k, v))
            res["block"] = tuple(torch.as_tensor(t).clone()
                                 for t in (kb, vb))
            res["index"] = dst_mesh.members("model").index(rank)
        out[name] = res
    ps.destroy_model_parallel()
    return out


def _pool_case(rank, world, name):
    """One reference case on the port's pool, this rank holding replica
    ``rank`` (1 x 1 at two ranks, 2 x 2 at four), or on the pair router
    (two ranks)."""
    from apex_tpu_torch import serving as S
    from apex_tpu_torch.serving.router import RemoteReplica

    kw = dict(CASES.get(name, PAIR_CASES.get(name)))
    inj = S.FaultInjector(seed=kw.pop("seed", 0), rates=kw.pop("rates", None),
                          schedule=kw.pop("schedule", None))
    trc = S.Tracer()
    cfg = _cfg(port_gpt)

    def replica(i):
        if i == rank:
            return S.PagedDecodeEngine(_params(), cfg, injector=inj,
                                       tracer=trc, device="cpu", **GEOMETRY)
        return RemoteReplica(i, cfg, injector=inj, tracer=trc, **GEOMETRY)

    reps = [replica(i) for i in range(world)]
    half = world // 2
    if name in PAIR_CASES:
        pool = S.DisaggregatedRouter(reps[0], reps[1], EOS, audit=True, **kw)
    else:
        if world == 2:
            src_mesh, dst_mesh = _meshes(world)
            kw["reshard"] = S.PageReshard(
                injector=inj, tracer=trc, stats=reps[1].stats,
                src_mesh=src_mesh, dst_mesh=dst_mesh)
        pool = S.PoolRouter(reps[:half], reps[half:], EOS, audit=True, **kw)
    for r in REQS:
        pool.submit(S.Request(**r))
    with torch.inference_mode():
        pool.run()
    out = _summary(pool)
    out["sent"] = dict(pool.engine.wire.sent)
    out["logits_row"] = cfg.vocab_size * 4
    return out


def job(rank, world, tmp):
    from apex_tpu_torch.transformer import parallel_state as ps

    out = {"channel": _channel(rank, world)}
    for name in list(CASES) + (list(PAIR_CASES) if world == 2 else []):
        out[name] = _pool_case(rank, world, name)
        ps.destroy_model_parallel()
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def ranks(request, tmp_path_factory):
    """Each rank's results: two ranks (1 -> 1, the 1 x 1 pool), then
    four (2 -> 2, the 2 x 2 pool)."""
    world = request.param
    return world, spawn(job, world,
                        tmp_path_factory.mktemp(f"handoff{world}"))


# ---------------------------------------------------------------------------
# the JAX side, in the test process
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp

    from apex_tpu import serving as jserving
    from apex_tpu.models import gpt as jgpt
    from apex_tpu.partition.mesh import make_mesh
    return jax, jnp, jserving, jgpt, make_mesh


@functools.lru_cache(maxsize=None)
def _jax_params():
    jax, jnp = _jax()[:2]
    from apex_tpu_torch.utils.tree import tree_map

    return jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                              _params()))


def _jax_meshes():
    jax, _, _, _, make_mesh = _jax()
    return (make_mesh(tp=2, devices=jax.devices()[:2]),
            make_mesh(tp=2, devices=jax.devices()[2:4]))


@functools.lru_cache(maxsize=None)
def _jax_channel(name):
    jax, jnp, S, jgpt, _ = _jax()
    from apex_tpu.serving.cache import init_paged_cache

    src_mesh, dst_mesh = _jax_meshes()
    tier = S.PageReshard(S.FaultInjector(seed=3, schedule=CHANNEL_SCHEDULE),
                         max_retries=3, src_mesh=src_mesh, dst_mesh=dst_mesh)
    dt = getattr(jnp, name)
    cache = init_paged_cache(_cfg(jgpt), 2, MAX_LEN, NUM_PAGES, PAGE, dt)
    k, v = (jnp.asarray(x).astype(dt) for x in _pool_tiles(name))
    src = SimpleNamespace(cache=cache._replace(k=k, v=v), page_size=PAGE)
    tk, tv, attempts = tier.ship(src, CHANNEL_TOKENS, CHANNEL_PAGES,
                                 replica="prefill")
    tk, tv = np.asarray(tk), np.asarray(tv)
    if tk.dtype != np.float32:
        tk, tv = tk.view(np.int16), tv.view(np.int16)
    key = S.prefix_page_keys(CHANNEL_TOKENS, PAGE)[-1]
    return dict(tiles=(tk, tv), digest=S.transfer_checksum(tk, tv, key),
                attempts=attempts,
                stats={f: getattr(tier.stats, f) for f in (
                    "reshards", "reshard_retries", "reshard_corrupt",
                    "reshard_failures")})


@functools.lru_cache(maxsize=None)
def _jax_pool(world, name):
    jax, jnp, S, jgpt, _ = _jax()
    kw = dict(CASES.get(name, PAIR_CASES.get(name)))
    inj = S.FaultInjector(seed=kw.pop("seed", 0), rates=kw.pop("rates", None),
                          schedule=kw.pop("schedule", None))
    trc = S.Tracer()
    reps = [S.PagedDecodeEngine(_jax_params(), _cfg(jgpt), injector=inj,
                                tracer=trc, **GEOMETRY)
            for _ in range(world)]
    if name in PAIR_CASES:
        pool = S.DisaggregatedRouter(reps[0], reps[1], EOS, audit=True, **kw)
    else:
        if world == 2:
            src_mesh, dst_mesh = _jax_meshes()
            kw["reshard"] = S.PageReshard(
                injector=inj, tracer=trc, stats=reps[1].stats,
                src_mesh=src_mesh, dst_mesh=dst_mesh)
        half = world // 2
        pool = S.PoolRouter(reps[:half], reps[half:], EOS, audit=True, **kw)
    for r in REQS:
        pool.submit(S.Request(**r))
    pool.run()
    return _summary(pool)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_channel_between_rank_sets_gives_the_jax_payload(ranks, dtype):
    """The destination ranks hold the JAX tiles bit for bit and their
    digest; every rank the JAX attempts (a dropped send, then a
    quarantined payload, then the delivery) and counters; each
    destination rank keeps its head block; only the first source rank
    sends, and it sends each destination rank the tiles twice (the
    corrupt payload and the good one)."""
    from apex_tpu_torch.serving import prefix_page_keys, transfer_checksum

    world, res = ranks
    want = _jax_channel(dtype)
    half = world // 2
    key = prefix_page_keys(CHANNEL_TOKENS, PAGE)[-1]
    nbytes = sum(t.nbytes for t in want["tiles"])
    for rank, r in enumerate(res):
        got = r["channel"][dtype]
        assert got["attempts"] == want["attempts"] == 3
        assert got["stats"] == want["stats"]
        if rank < half:
            assert got["tiles"] is None
            assert got["sent"].get("tiles", 0) == (
                2 * half * nbytes if rank == 0 else 0)
            continue
        k, v = (t.numpy() for t in got["tiles"])
        for a, b in zip((k, v), want["tiles"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert transfer_checksum(k, v, key) == want["digest"]
        nh = k.shape[2] // half
        i = got["index"]
        for blk, whole in zip(got["block"], (k, v)):
            assert _host(blk).tobytes() == np.ascontiguousarray(
                whole[:, :, i * nh:(i + 1) * nh]).tobytes()
        assert "tiles" not in got["sent"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_over_rank_sets_equals_the_jax_pool(ranks, case):
    """Streams, outcomes, stats, injector counts, event names, the tick
    stream, the metrics, the health ladders, the active replica and the
    clock: the JAX pool's, on every rank."""
    world, res = ranks
    want = _jax_pool(world, case)
    for rank, r in enumerate(res):
        got = r[case]
        for key in want:
            assert got[key] == want[key], \
                f"rank {rank}: {case}: {key} differs from JAX"


@pytest.mark.parametrize("ranks", [2], indirect=True, ids=["W2"])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_over_two_ranks_equals_the_jax_pair(ranks, case):
    """The DisaggregatedRouter with its prefill replica on rank 0 and its
    decode replica on rank 1 (the host-staged channel between them):
    the JAX pair's run, on both ranks."""
    world, res = ranks
    want = _jax_pool(world, case)
    for rank, r in enumerate(res):
        for key in want:
            assert r[case][key] == want[key], \
                f"rank {rank}: {case}: {key} differs from JAX"
    assert want["stats"]["transfers"] == len(REQS)


def test_pool_sends_the_shipped_bytes(ranks):
    """Fault-free: each prefill replica's rank sent the tile bytes its
    handoffs delivered (the registry's ``serving_reshard_src_bytes_
    total``) plus one fp32 logits row a remote prefill; the active
    decode replica's rank sent every rank the verdicts and the control
    reads, and no tile."""
    world, res = ranks
    half = world // 2
    got = [r["fault_free"] for r in res]
    stats = got[0]["stats"]
    tiles = sum(g["sent"].get("tiles", 0) for g in got[:half])
    rows = sum(g["sent"].get("logits", 0) for g in got[:half])
    assert stats["remote_prefills"] == len(REQS)
    assert rows == len(REQS) * got[0]["logits_row"]
    shipped = sum(float(line.split()[-1])
                  for line in got[0]["metrics"].splitlines()
                  if line.startswith("serving_reshard_src_bytes_total"))
    assert tiles == shipped > 0
    assert all("tiles" not in g["sent"] for g in got[half:])
    assert got[half]["sent"]["verdict"] > 0
    assert got[half]["sent"]["control"] > 0
