"""Host-side page allocator: free list, refcounts, prefix cache
(counterpart of ``apex_tpu/serving/paging.py``, the same host code).

The device half of paging (``serving.cache.PagedKVCache``) is dumb
storage — a fixed pool of ``(heads, page_size, head_dim)`` pages per
layer plus per-slot block tables. Everything that decides WHICH page a
logical position lives in happens here, on the host, in plain Python:

- **free list + refcounts** — ``alloc()`` hands out exclusively-owned
  pages (refcount 1); ``retain``/``release`` move shared pages between
  owners; a page returns to the free list when its last reference
  drops. Page ids below ``RESERVED_PAGES`` (the null and scratch pages)
  are never allocated.
- **prefix cache** — completed prompt pages register under a CHAINED
  content hash (``prefix_page_keys``): page ``i``'s key commits to
  every token of pages ``0..i``, so a registry hit at key ``i`` means
  the whole prefix matches, not just one page. ``match_prefix`` walks
  the longest registered chain and retains each hit for the caller —
  two requests sharing a system prompt then hold the SAME physical
  pages (stored once, refcounted). The registry holds its own +1 ref
  per page so cached prefixes survive the submitting request.
- **copy-on-write** — appending a row into a page some other owner
  (another slot or the registry) can still read MUST NOT mutate it.
  ``needs_copy`` is exactly ``refcount > 1``; the engine copies the
  page device-side, releases the shared original, and repoints its
  block table. The cached/shared copy is never perturbed — the
  acceptance contract ``tests/L0/run_serving/test_paging.py`` pins.
- **eviction** — when the free list runs dry, ``alloc()`` drops
  least-recently-used prefix-cache entries (releasing the registry's
  refs) until a page frees or the registry is empty; only then does it
  return ``None`` and the engine preempts.
- **host spill tier** — a :class:`PrefixRegistry` (byte-budgeted,
  LRU, shared across engines AND replicas) catches cold prefixes on
  their way out: when the eviction sweep drops an entry whose page is
  held ONLY by the registry (refcount 1 — never a page a slot still
  attends), the pool's ``spill_hook`` copies the page's rows to host
  memory as a :class:`SpillRecord` under the SAME chained content key.
  A later admission that misses HBM but hits the host tier PROMOTES
  the record back: checksum + versioned-header verification first
  (:func:`spill_checksum`, :func:`encode_spill_header` — the transfer
  tier's checksum-bound wire discipline), then a device scatter into
  freshly allocated pages. int8 pools spill their per-page-per-head
  scales with the payload. The engine's side of the tier (its spill
  hook and promotion) is ``scheduler.PagedDecodeEngine``'s, the page
  extract/insert steps ``serving.transfer``'s.

- **audit** — ``check_invariants()`` cross-checks refcounts against
  the free list, the prefix registry, and (given the engine's per-slot
  page lists) the slots' references; the chaos tier runs it after
  every scheduler tick. The ``pool_alloc`` fault site
  (``serving.faults``) hooks ``alloc()`` to simulate transient
  exhaustion deterministically.

Determinism: nothing here touches device state or RNG — identical
request streams replay identical page decisions, and the decode math
is placement-invariant anyway (see ``_paged_decode_attention``).
"""

import hashlib
import struct
from collections import Counter, OrderedDict, deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from apex_tpu_torch.serving.cache import RESERVED_PAGES
from apex_tpu_torch.serving.faults import FaultInjector
from apex_tpu_torch.serving.health import PoolInvariantError, QuotaExhausted

#: Version tag baked into every hashed page record. The chained key is
#: a CROSS-REPLICA content address (prefix cache, transfer dedup, and
#: transfer integrity all compare raw digests), so the byte layout
#: under the hash is a wire format: bump this when it changes and the
#: old generation's keys simply never match — no silent aliasing.
PAGE_KEY_VERSION = 1


def _encode_page(page: Sequence[int]) -> bytes:
    """Canonical byte record for one page of token ids: a
    ``struct.pack``'d little-endian layout — ``<II`` header (version,
    token count) followed by one ``<i`` int32 per token. Replaces the
    original ``repr(page).encode()``, whose text form depended on the
    Python int formatting of the host that hashed it — too fragile to
    serve as a content address two replicas must agree on. int32 is
    deliberate: token ids are vocabulary indices, and ``struct.pack``
    raises on anything outside int32 range rather than truncating."""
    return struct.pack(f"<II{len(page)}i", PAGE_KEY_VERSION,
                       len(page), *page)


def prefix_page_keys(tokens: Sequence[int],
                     page_size: int) -> List[bytes]:
    """One chained content key per page of ``tokens`` (the last page
    may be partial — its key commits to the partial contents, so only
    an EXACT partial match shares it). Key ``i`` is
    ``sha256(key[i-1] + encode(page_i))`` over the canonical
    :func:`_encode_page` layout, so it commits to every token of pages
    ``0..i`` and the same prompt hashes identically on every replica
    (the encoding-stability test pins exact digests)."""
    if page_size < 1:
        raise ValueError(f"page_size must be positive, got {page_size}")
    keys: List[bytes] = []
    h = b""
    for start in range(0, len(tokens), page_size):
        page = tuple(int(t) for t in tokens[start:start + page_size])
        h = hashlib.sha256(h + _encode_page(page)).digest()
        keys.append(h)
    return keys


# ---------------------------------------------------------------------------
# host spill tier: wire format + registry
# ---------------------------------------------------------------------------

#: Cache-dtype tags in the spill payload header. Append-only — like
#: :data:`PAGE_KEY_VERSION` this is a wire format two tiers (and, via
#: the shared registry, two replicas) must agree on.
SPILL_DTYPE_TAGS = {"bfloat16": 1, "float32": 2, "float16": 3, "int8": 4}

#: ``struct`` layout of the fixed spill-header prefix: version, layers,
#: heads, page_size, head_dim, dtype tag — all little-endian uint32,
#: followed by the 32-byte chained page key the payload belongs to.
_SPILL_HEADER_FMT = "<IIIIII"
SPILL_HEADER_BYTES = struct.calcsize(_SPILL_HEADER_FMT) + 32


def encode_spill_header(key: bytes, num_layers: int, num_heads: int,
                        page_size: int, head_dim: int,
                        dtype_tag: int) -> bytes:
    """Canonical versioned header bound into every spilled payload —
    the same ``struct.pack`` wire-format discipline as
    :func:`_encode_page`. It embeds the CHAINED page key, so a host-
    tier record can only ever verify against the prompt chain that
    produced it (the transfer tier's "payload can never install under
    the wrong prompt" guarantee, extended to the spill tier), plus the
    pool geometry and cache dtype so a record can never scatter into a
    differently-shaped pool. The pinned-hex regression test freezes
    this layout; changes bump :data:`PAGE_KEY_VERSION`."""
    if len(key) != 32:
        raise ValueError(
            f"spill headers embed a 32-byte sha256 chain key, got "
            f"{len(key)} bytes")
    return struct.pack(_SPILL_HEADER_FMT, PAGE_KEY_VERSION, num_layers,
                       num_heads, page_size, head_dim, dtype_tag) + key


def decode_spill_header(header: bytes) -> Dict:
    """Parse :func:`encode_spill_header` output; raises ``ValueError``
    on a malformed length (content checks are the promoter's job)."""
    if len(header) != SPILL_HEADER_BYTES:
        raise ValueError(
            f"spill header must be {SPILL_HEADER_BYTES} bytes, got "
            f"{len(header)}")
    version, layers, heads, page_size, head_dim, tag = struct.unpack(
        _SPILL_HEADER_FMT, header[:-32])
    return {"version": version, "num_layers": layers,
            "num_heads": heads, "page_size": page_size,
            "head_dim": head_dim, "dtype_tag": tag, "key": header[-32:]}


def spill_checksum(header: bytes, k, v, k_scale=None,
                   v_scale=None) -> bytes:
    """sha256 over the header (which embeds the chain key — identity)
    plus the staged tile bytes (integrity), the exact shape of
    ``transfer.transfer_checksum`` with the scale planes of an int8
    page folded in. Recomputed before every promotion; a mismatch
    quarantines the record (dropped, never installed)."""
    h = hashlib.sha256()
    h.update(header)
    h.update(np.ascontiguousarray(k).tobytes())
    h.update(np.ascontiguousarray(v).tobytes())
    if k_scale is not None:
        h.update(np.ascontiguousarray(k_scale).tobytes())
        h.update(np.ascontiguousarray(v_scale).tobytes())
    return h.digest()


class SpillRecord(NamedTuple):
    """One spilled page in host memory: the versioned header, the
    page's K/V tiles as host arrays ``(layers, 1, heads, page_size,
    head_dim)``, the int8 pool's per-page-per-head scale planes
    ``(layers, 1, heads)`` (``None`` for float pools — they must
    travel together or the page dequantizes wrong), and the
    :func:`spill_checksum` digest computed at spill time."""

    header: bytes
    k: np.ndarray
    v: np.ndarray
    k_scale: Optional[np.ndarray]
    v_scale: Optional[np.ndarray]
    digest: bytes

    @property
    def nbytes(self) -> int:
        n = len(self.header) + self.k.nbytes + self.v.nbytes
        if self.k_scale is not None:
            n += self.k_scale.nbytes + self.v_scale.nbytes
        return n


class PrefixRegistry:
    """The host-memory spill tier: a byte-budgeted LRU map from
    chained prefix page keys to :class:`SpillRecord` payloads. ONE
    instance is shared by every engine (and both replicas of a
    :class:`~apex_tpu.serving.router.DisaggregatedRouter`) — the keys
    are a global content address, so any replica's prefill seeds
    everyone's cache and a promotion never cares which pool spilled
    the bytes.

    Capacity is measured in BYTES, not pages, deliberately: an int8
    pool's records are roughly half a bf16 pool's, so KV quantization
    doubles the effective capacity of this tier exactly as it does
    HBM's. Eviction is LRU by insertion/refresh order; ``get`` hits
    refresh recency and feed the hit-rate gauge. Deterministic host
    state: no RNG, no clocks — identical request streams replay
    identical spill/promote decisions (and APX401-style discipline
    applies: never read from traced code)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be positive, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[bytes, SpillRecord]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    @property
    def num_pages(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    @property
    def hit_rate(self) -> float:
        probes = self.hits + self.misses
        return self.hits / probes if probes else 0.0

    def put(self, key: bytes, record: SpillRecord) -> bool:
        """Admit one spilled page; False when deduped (already held —
        only LRU-refreshed) or rejected (a single record over the whole
        byte budget). Admission may LRU-evict colder records to fit."""
        if record.header[-32:] != key:
            raise ValueError(
                "spill record header embeds a different chain key than "
                "it is being registered under")
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        if record.nbytes > self.capacity_bytes:
            self.rejected += 1
            return False
        self._entries[key] = record
        self._bytes += record.nbytes
        while self._bytes > self.capacity_bytes:
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            self.evictions += 1
        return True

    def get(self, key: bytes) -> Optional[SpillRecord]:
        """Look one key up, refreshing recency on a hit. Promotion-path
        verification (checksum, header) is the caller's job — the
        registry only answers "do I hold these bytes"."""
        rec = self._entries.get(key)
        if rec is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return rec

    def drop(self, key: bytes) -> bool:
        """Evict one record (failed verification, explicit
        invalidation); False when absent."""
        rec = self._entries.pop(key, None)
        if rec is None:
            return False
        self._bytes -= rec.nbytes
        return True

    def stats(self) -> Dict:
        """``host_*``-prefixed gauge sources, merged into
        :meth:`PagePool.stats` per-tier breakdowns."""
        return {"host_pages": self.num_pages,
                "host_bytes": self._bytes,
                "host_capacity_bytes": self.capacity_bytes,
                "host_hits": self.hits,
                "host_misses": self.misses,
                "host_hit_rate": self.hit_rate,
                "host_evictions": self.evictions}

    def check_invariants(self) -> bool:
        """Audit the tier's books: byte accounting exact, budget
        respected, every record keyed consistently with its embedded
        header key, every digest recomputing. Raises
        :class:`~apex_tpu.serving.health.PoolInvariantError`; folded
        into ``PagePool.check_invariants`` (the per-tick chaos audit)
        when the pool carries a host tier."""
        total = sum(r.nbytes for r in self._entries.values())
        if total != self._bytes:
            raise PoolInvariantError(
                f"host tier byte accounting drifted: tracked "
                f"{self._bytes}, actual {total}")
        if self._bytes > self.capacity_bytes:
            raise PoolInvariantError(
                f"host tier over budget: {self._bytes} > "
                f"{self.capacity_bytes}")
        for key, rec in self._entries.items():
            if rec.header[-32:] != key:
                raise PoolInvariantError(
                    f"host tier record {key.hex()[:12]} embeds a "
                    "different chain key in its header")
            if spill_checksum(rec.header, rec.k, rec.v, rec.k_scale,
                              rec.v_scale) != rec.digest:
                raise PoolInvariantError(
                    f"host tier record {key.hex()[:12]} fails its "
                    "spill checksum")
        return True


class QuotaLedger:
    """Per-tenant page-reservation accounting for the tenancy
    front-end (``serving.tenancy``). Reservations are CONSERVATIVE:
    a request charges its worst-case page need (prompt +
    ``max_new_tokens`` + speculative headroom) when it is first
    admitted and credits it back exactly once, when it finishes —
    preemption, requeue and retry in between never touch the books,
    which is what makes the ledger trivially leak-free (every charge
    has exactly one credit, at the single exit point every request
    passes through).

    ``quotas`` maps tenant name -> page cap (``None`` = unlimited).
    The ledger attaches to a :class:`PagePool` (``pool.ledger``) so
    the chaos tier's per-tick ``check_invariants`` audit covers the
    tenancy books alongside the refcounts. Host state (APX401).
    """

    def __init__(self, quotas: Dict[str, Optional[int]]):
        for tenant in sorted(quotas):
            q = quotas[tenant]
            if q is not None and q < 1:
                raise ValueError(
                    f"tenant {tenant!r} quota must be >= 1 pages or "
                    f"None, got {q}")
        self.quotas: Dict[str, Optional[int]] = dict(quotas)
        self._charged: Dict[str, int] = {t: 0 for t in quotas}

    def quota(self, tenant: str) -> Optional[int]:
        return self.quotas.get(tenant)

    def charged(self, tenant: str) -> int:
        return self._charged.get(tenant, 0)

    def can_charge(self, tenant: str, pages: int) -> bool:
        q = self.quotas.get(tenant)
        if q is None:
            return True
        return self._charged.get(tenant, 0) + pages <= q

    def charge(self, tenant: str, pages: int) -> None:
        if not self.can_charge(tenant, pages):
            q = self.quotas.get(tenant)
            raise QuotaExhausted(
                f"tenant {tenant!r}: charging {pages} pages would "
                f"exceed the {q}-page quota "
                f"({self._charged.get(tenant, 0)} already reserved)",
                tenant=tenant, need=pages, quota=q or 0,
                charged=self._charged.get(tenant, 0))
        self._charged[tenant] = self._charged.get(tenant, 0) + pages

    def credit(self, tenant: str, pages: int) -> None:
        held = self._charged.get(tenant, 0)
        if pages > held:
            raise PoolInvariantError(
                f"tenant {tenant!r}: crediting {pages} pages but only "
                f"{held} are reserved — double credit")
        self._charged[tenant] = held - pages

    def check(self) -> bool:
        """Audit the books: reservations non-negative and within each
        tenant's quota. Raises :class:`PoolInvariantError` on the first
        inconsistency (the per-tick chaos audit calls this through
        ``PagePool.check_invariants``)."""
        for tenant in sorted(self._charged):
            held = self._charged[tenant]
            if held < 0:
                raise PoolInvariantError(
                    f"tenant {tenant!r}: negative page reservation "
                    f"{held}")
            q = self.quotas.get(tenant)
            if q is not None and held > q:
                raise PoolInvariantError(
                    f"tenant {tenant!r}: {held} pages reserved over "
                    f"the {q}-page quota")
        return True

    def snapshot(self) -> Dict[str, Dict[str, Optional[int]]]:
        return {t: {"quota": self.quotas.get(t),
                    "charged": self._charged.get(t, 0)}
                for t in sorted(self._charged)}


class PagePool:
    """Free list + per-page refcounts + LRU prefix registry (see
    module doc). ``free_order`` overrides the initial free-list order —
    the placement bit-identity tests admit the same requests through
    permuted orders and require identical logits. ``host_tier`` hangs
    a shared :class:`PrefixRegistry` under the pool; the owning engine
    installs ``spill_hook`` so the eviction sweep can copy out
    sole-registry-owned pages before releasing them."""

    def __init__(self, num_pages: int, page_size: int,
                 free_order: Optional[Sequence[int]] = None,
                 injector: Optional[FaultInjector] = None,
                 host_tier: Optional[PrefixRegistry] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if num_pages <= RESERVED_PAGES:
            raise ValueError(
                f"num_pages {num_pages} must exceed the "
                f"{RESERVED_PAGES} reserved pages")
        self.num_pages = num_pages
        self.page_size = page_size
        usable = range(RESERVED_PAGES, num_pages)
        if free_order is None:
            free_order = list(usable)
        if sorted(free_order) != list(usable):
            raise ValueError(
                f"free_order must be a permutation of {usable}")
        self._free = deque(free_order)
        # fault hook: the ``pool_alloc`` site makes alloc() report a
        # transient exhaustion (no LRU sweep, nothing evicted)
        self.injector = injector or FaultInjector()
        self._ref: Dict[int, int] = {}  # page -> refcount; absent = free
        # chained prefix key -> page holding that page's rows; each
        # entry owns one reference on its page; insertion order = LRU
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        # the host spill tier (shared across pools) and the engine's
        # spill callback ``(key, page) -> None`` — consulted by the
        # eviction sweep ONLY for pages the registry solely owns
        self.host_tier = host_tier
        self.spill_hook: Optional[Callable[[bytes, int], None]] = None
        # the tenancy front-end attaches its QuotaLedger here so the
        # per-tick invariant audit covers the reservation books too
        self.ledger: Optional[QuotaLedger] = None

    # -- refcounting ------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        return len(self._prefix)

    @property
    def num_usable(self) -> int:
        """Pages the allocator may ever hand out (total minus the
        reserved null/scratch pages)."""
        return self.num_pages - RESERVED_PAGES

    @property
    def occupancy(self) -> float:
        """Fraction of usable pages currently referenced (slots or the
        prefix registry) — the ``serving_page_pool_occupancy`` gauge
        the tracer samples every tick."""
        return (self.num_usable - self.num_free) / self.num_usable

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def needs_copy(self, page: int) -> bool:
        """True when appending a row into ``page`` would be observable
        by another owner (slot or prefix registry) — the COW trigger."""
        return self.refcount(page) > 1

    def alloc(self) -> Optional[int]:
        """An exclusively-owned page (refcount 1), evicting LRU prefix
        entries as needed; None when genuinely out of pages (or when
        the ``pool_alloc`` fault site fires — a transient refusal that
        leaves the registry untouched)."""
        if self.injector.fire("pool_alloc"):
            return None
        while not self._free and self._prefix:
            key, page = self._prefix.popitem(last=False)
            # spill on the way out — but NEVER a page a slot still
            # attends (refcount > 1): only the registry's sole
            # reference guarantees the rows are the pristine
            # registered prefix (COW protects shared pages from
            # mutation, and an attended page keeps serving from HBM)
            if self.spill_hook is not None \
                    and self._ref.get(page, 0) == 1:
                self.spill_hook(key, page)
            self.release(page)
        if not self._free:
            return None
        page = self._free.popleft()
        self._ref[page] = 1
        return page

    def retain(self, page: int) -> None:
        if page not in self._ref:
            raise ValueError(f"retain of free/reserved page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> None:
        ref = self._ref.get(page, 0)
        if ref <= 0:
            raise ValueError(f"release of free/reserved page {page}")
        if ref == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = ref - 1

    # -- prefix cache -----------------------------------------------------

    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """Pages of the longest registered chain prefix of ``keys``,
        each RETAINED for the caller (the admitting slot takes one
        reference per shared page; release on free/preempt)."""
        pages: List[int] = []
        for key in keys:
            page = self._prefix.get(key)
            if page is None:
                break
            self._prefix.move_to_end(key)  # LRU refresh
            self.retain(page)
            pages.append(page)
        return pages

    def register_prefix(self, keys: Sequence[bytes],
                        pages: Sequence[int]) -> None:
        """Publish a prompt's page chain for future sharing. New
        entries take the registry's own reference; keys already
        registered are only LRU-refreshed (their pages stay shared)."""
        if len(keys) != len(pages):
            raise ValueError(
                f"{len(keys)} keys vs {len(pages)} pages")
        for key, page in zip(keys, pages):
            if key in self._prefix:
                self._prefix.move_to_end(key)
                continue
            self.retain(page)
            self._prefix[key] = page

    def evict_prefix(self, key: bytes) -> bool:
        """Drop one registry entry (tests / explicit invalidation)."""
        page = self._prefix.pop(key, None)
        if page is None:
            return False
        self.release(page)
        return True

    # -- runtime audit ----------------------------------------------------

    def check_invariants(self, slot_pages: Optional[
            Sequence[Sequence[int]]] = None) -> bool:
        """Audit the allocator's books; raises
        :class:`~apex_tpu.serving.health.PoolInvariantError` on the
        first inconsistency, returns True when they balance. Checks:

        - the free list is duplicate-free, within the usable id range,
          and disjoint from the refcounted set;
        - free + refcounted partition the usable pages exactly (a page
          in neither is leaked, reserved ids appear in neither);
        - every refcount is positive and covers the registry's own
          reference on each cached page;
        - with ``slot_pages`` (the engine's per-slot page lists): every
          page's refcount equals its slot references plus its registry
          entries — the exact accounting a copy-on-write livelock
          violates.

        ``PagedDecodeEngine.check_invariants`` runs it with the engine's
        page lists; tests run that after every scheduler tick."""
        free = list(self._free)
        usable = set(range(RESERVED_PAGES, self.num_pages))
        if len(set(free)) != len(free):
            raise PoolInvariantError(
                f"free list holds duplicates: {sorted(free)}")
        if not set(free) <= usable:
            raise PoolInvariantError(
                f"free list holds reserved/out-of-range ids: "
                f"{sorted(set(free) - usable)}")
        held = set(self._ref)
        if held & set(free):
            raise PoolInvariantError(
                f"pages both free and refcounted: "
                f"{sorted(held & set(free))}")
        if not held <= usable:
            raise PoolInvariantError(
                f"refcounted reserved/out-of-range ids: "
                f"{sorted(held - usable)}")
        leaked = usable - held - set(free)
        if leaked:
            raise PoolInvariantError(
                f"pages neither free nor referenced (leaked): "
                f"{sorted(leaked)}")
        bad = {p: r for p, r in self._ref.items() if r <= 0}
        if bad:
            raise PoolInvariantError(f"non-positive refcounts: {bad}")
        registry = Counter(self._prefix.values())
        for page, n in registry.items():
            if self._ref.get(page, 0) < n:
                raise PoolInvariantError(
                    f"page {page}: {n} registry entries but refcount "
                    f"{self._ref.get(page, 0)}")
        if self.host_tier is not None:
            self.host_tier.check_invariants()
        if self.ledger is not None:
            self.ledger.check()
        if slot_pages is not None:
            expected = Counter(registry)
            for slot, pages in enumerate(slot_pages):
                stray = [p for p in pages if p not in usable]
                if stray:
                    raise PoolInvariantError(
                        f"slot {slot} maps reserved/out-of-range pages "
                        f"{stray}")
                expected.update(pages)
            if dict(expected) != self._ref:
                diff = {p: (expected.get(p, 0), self._ref.get(p, 0))
                        for p in sorted(set(expected) | set(self._ref))
                        if expected.get(p, 0) != self._ref.get(p, 0)}
                raise PoolInvariantError(
                    "refcounts out of balance (page: expected slot+"
                    f"registry refs vs actual): {diff}")
        return True

    def stats(self) -> Dict:
        """Per-tier breakdown for gauges and bench ``extra`` blocks:
        the HBM side (usable/free/cached/used pages, occupancy) plus,
        when a host tier is attached, its ``host_*``-prefixed stats
        (:meth:`PrefixRegistry.stats`)."""
        s = {"hbm_pages": self.num_usable,
             "hbm_free": self.num_free,
             "hbm_cached": self.num_cached,
             "hbm_used": self.num_usable - self.num_free,
             "occupancy": self.occupancy}
        if self.host_tier is not None:
            s.update(self.host_tier.stats())
        return s

    def snapshot(self) -> Dict:
        """Plain-dict view of the allocator state for diagnostics
        (:class:`~apex_tpu.serving.health.LivelockError` payloads)."""
        snap = {"num_free": self.num_free,
                "num_cached": self.num_cached,
                "occupancy": self.occupancy,
                "refcounts": dict(self._ref)}
        if self.host_tier is not None:
            snap["host_tier"] = self.host_tier.stats()
        if self.ledger is not None:
            snap["quota_ledger"] = self.ledger.snapshot()
        return snap
