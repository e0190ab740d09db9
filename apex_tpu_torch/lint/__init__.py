"""apxlint for the PyTorch/CUDA port — a static contract checker over
``apex_tpu_torch`` (counterpart of ``apex_tpu/lint``).

The port's load-bearing invariants (int8 dequant products on fp32
operands, one collective sequence on every rank, O1 op lists that match
their ``cast_args`` sites, no host state frozen into a CUDA graph or
read twice by an activation recompute, a serving tick that replays bit
for bit) are held at run time only by tests that happen to take the
right branch. This package checks them at review time, reading source
with ``ast``: it imports neither ``torch`` nor ``jax`` and executes
nothing it reads.

Run it as ``python -m apex_tpu_torch.lint apex_tpu_torch tests
--determinism``. Each check has an error code (catalogue below) and can
be suppressed on one line with ``# apxlint: disable=CODE`` (on the
flagged line or on a standalone comment line directly above it), or for
a whole file with ``# apxlint: disable-file=CODE``. Files whose first
lines contain ``# apxlint: fixture`` are test fixtures: directory walks
skip them, explicit paths lint them.

The catalogue keeps every code of the JAX package's checker, so a
suppression comment that names one stays valid. The tiers bound to
Pallas calls and jaxprs (APX101-105, APX5xx-6xx, APX7xx, APX9xx) are
not ported yet: :data:`PENDING` names the ROADMAP queue item of each,
and asking the engine for one raises ``NotImplementedError``.
"""

from dataclasses import dataclass

_LATER = "not yet ported ({}): "

#: code -> queue item of ROADMAP.md that ports it, for the codes whose
#: tier has no port yet.
PENDING = {
    **{c: "A8.2" for c in ("APX101", "APX102", "APX103", "APX105")},
    **{c: "A8.3" for c in ("APX501", "APX502", "APX503", "APX511",
                           "APX512", "APX601", "APX602", "APX603",
                           "APX604")},
    **{c: "A8.4" for c in ("APX701", "APX702", "APX703", "APX704")},
    **{c: "A8.5" for c in ("APX901", "APX902", "APX903", "APX904")},
}

#: code -> one-line contract description. The docstring of each checker
#: module carries the full rationale.
CODES = {
    "APX100": "lint internal: a linted file does not parse (its "
              "contracts are unverifiable)",
    "APX101": "hand kernel updates an input in place without declaring "
              "the alias",
    "APX102": "hand kernel's shared-memory residency exceeds its "
              "per-kernel budget",
    "APX103": "attention/softmax/norm statistics (m, l, lse, mean, "
              "rstd) stored or allocated below fp32",
    "APX105": "hand kernel family registered in neither budget tier",
    "APX106": "quantization contract: a *scale* tensor stored or "
              "allocated below fp32 (.to(torch.bfloat16), .half(), "
              "torch.empty(..., dtype=torch.bfloat16)), a product in a "
              "w8/dequant function (torch.matmul, @, mm, bmm, einsum, "
              "F.linear) on an operand not provably fp32, or "
              ".to(torch.int8) with no torch.round in scope",
    "APX201": "collective sequence diverges across the branches of a "
              "rank-dependent conditional (collective(kind, ...), shift, "
              "all_to_all, the region mappings, dist.*), or a "
              "point-to-point send/recv on one side has no matching "
              "recv/send on the same group on another (multi-rank "
              "deadlock)",
    "APX202": "axis name passed to shift / all_to_all / _axis / "
              "axis_group / mesh.groups[...] / mesh.members(...) does "
              "not resolve to a parallel_state mesh axis",
    "APX301": "op appears in more than one AMP policy list "
              "(FP16_FUNCS / FP32_FUNCS / CASTS)",
    "APX302": "op intercepted by cast_args() appears in no AMP policy "
              "list",
    "APX303": "op listed in an AMP policy list is neither intercepted "
              "by cast_args() nor declared in UNWIRED",
    "APX304": "op declared UNWIRED is actually intercepted by "
              "cast_args() (stale exemption)",
    "APX401": "host-state read (time.*, np.random.*, random.*, or the "
              "registered serving fault/stats/observe state) in code "
              "captured by a CUDA graph, compiled by torch.compile / "
              "torch.jit, or recomputed by activation checkpointing",
    "APX402": "global-statement write in code captured by a CUDA graph, "
              "compiled by torch.compile / torch.jit, or recomputed by "
              "activation checkpointing",
    "APX501": "traced program accumulates on a sub-fp32 operand",
    "APX502": "amp train step writes optimizer state not dominated by "
              "the loss-scale division and the overflow check",
    "APX503": "traced op materializes an intermediate more than 8x "
              "larger than its operands",
    "APX511": "per-rank simulation of a sharded body yields divergent "
              "collective schedules",
    "APX512": "declared in-place pair does not survive into the traced "
              "program",
    "APX601": "entry's static memory traffic exceeds its budget ceiling",
    "APX602": "entry's static memory traffic drifted outside the "
              "tolerance band without a budget update",
    "APX603": "entry's static collective volume differs from its "
              "budget record",
    "APX604": "entry's peak-live-bytes estimate exceeds its budget cap",
    "APX701": "partition-rule table defect (unmatched or doubly "
              "matched leaf, bad spec, dead rule)",
    "APX702": "cross-tree sharding drift between params, optimizer "
              "state and KV cache",
    "APX703": "rule-derived shard_map specs disagree with the "
              "partition table",
    "APX704": "rule-generated sharded body fails per-rank schedule "
              "agreement or its volume record",
    "APX801": "nondeterministic ordering on the serving tick path: "
              "set iteration flowing into scheduling/requeue/commit "
              "order, a set rendered into error text, unseeded random "
              "(stdlib, np.random, or a torch.rand*/randint/randn/"
              "multinomial/bernoulli/random_/normal_/uniform_ draw with "
              "no generator=), hash()/id() ordering keys, or a "
              "wall-clock read outside the Tracer wall-stamp allowlist",
    "APX802": "fault-site contract incomplete or stale: a "
              "faults.SITES entry missing its consultation site (a "
              ".draw/.fire/.calls literal, a *_site attribute, or a "
              "literal passed to a helper that consults its "
              "parameter), typed degrade error, chaos-test reference "
              "in a test of the package, or CI sweep env read by such "
              "a test — or a stale name in SITE_CONTRACTS or the "
              "ci.yml chaos matrix",
    "APX803": "error-taxonomy closure: a tick-path raise that is not "
              "a ServingError taxonomy class (or allowlisted "
              "constructor-time guard), or a taxonomy class no test of "
              "the package references",
    "APX804": "observe-name drift: a tracer span/instant name "
              "missing from PHASES/LIFECYCLE, a dynamic name at an "
              "emit site, or a metric read-back no creation site "
              "matches",
    "APX805": "RNG key indiscipline on the tick path: a raw PRNGKey "
              "consumed (not only folded), a prng/jax.random split "
              "tree, or a key consumed by more than one call instead "
              "of fold_in(PRNGKey(seed), counter) chains",
    "APX901": "collective schedule is not scale-invariant across a "
              "swept mesh grid",
    "APX902": "collective volume off the declared scaling law",
    "APX903": "per-device memory grows with the mesh",
    "APX904": "rule table unsafe under the mesh sweep",
}
for _code, _item in PENDING.items():
    CODES[_code] = _LATER.format(_item) + CODES[_code]
del _code, _item


@dataclass(frozen=True)
class Finding:
    """One lint violation, addressable by (path, line) for suppression."""
    code: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


__all__ = ["CODES", "Finding", "PENDING"]
