"""apxlint determinism tier (APX8xx) for the port — static
nondeterminism detection and fault-contract coverage for
``apex_tpu_torch/serving``.

The serving contract is that committed streams are bit-identical to
golden through every scheduling, speculation, handoff, failover, and
fault path — enforced dynamically by chaos tests that can miss a
nondeterminism source until a seed happens to hit it. This tier checks
the contract's statically checkable preconditions: an AST pass over
every file in a ``serving`` directory, scoped to functions reachable
from the tick/admission roots (:mod:`.reach`). Five codes:

- **APX801** (:mod:`.ordering`) — nondeterministic ordering on the
  tick path: set iteration flowing into scheduling/requeue/commit
  order, sets rendered into error text, unseeded stdlib or torch RNG,
  ``hash()``/``id()`` ordering keys, wall-clock reads outside the
  Tracer's allowlisted wall-stamp sites.
- **APX802** (:mod:`.contracts`) — every ``faults.SITES`` entry
  carries its full contract (consultation site, typed degrade error,
  chaos-test reference in a test of the package, CI sweep env) via the
  ``SITE_CONTRACTS`` table, with stale names flagged in both
  directions.
- **APX803** (:mod:`.taxonomy`) — tick-path raises are ServingError
  taxonomy classes (or allowlisted constructor guards), and every
  taxonomy class is referenced by at least one test of the package.
- **APX804** (:mod:`.coherence`) — tracer span/instant names resolve
  against ``observe.PHASES``/``LIFECYCLE``, metric read-backs resolve
  against creation sites, no drifting dynamic names.
- **APX805** (:mod:`.rng`) — sampling keys derive via
  ``fold_in(PRNGKey(seed), counter)`` chains: no raw ``PRNGKey``
  consumption, no split trees, no key reuse on the tick path.

Run with ``python -m apex_tpu_torch.lint --determinism`` (or any
``--codes 'APX8*'`` selection, which enables the tier implicitly).
Pure AST: no torch or jax import, no execution of the linted code.
"""

import ast
from typing import Dict, List

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.determinism import (contracts, coherence, ordering,
                                             rng, taxonomy)
from apex_tpu_torch.lint.determinism.reach import serving_trees


def check_files(trees: Dict[str, ast.Module]) -> List[Finding]:
    """All APX8xx findings over the serving-scope subset of ``trees``."""
    strees = serving_trees(trees)
    if not strees:
        return []
    findings: List[Finding] = []
    findings.extend(ordering.check_files(strees))
    findings.extend(contracts.check_files(strees))
    findings.extend(taxonomy.check_files(strees))
    findings.extend(coherence.check_files(strees))
    findings.extend(rng.check_files(strees))
    return findings


__all__ = ["check_files", "serving_trees"]
