"""Repo-layout discovery shared by the cross-artifact determinism
checks (APX802 fault contracts, APX803 taxonomy test coverage).

Those checks compare the serving scope against artifacts OUTSIDE the
linted file set — the chaos tests under ``tests/`` and the CI chaos
matrix in ``.github/workflows/ci.yml``. The repo root is derived from
the serving directory itself (``<root>/apex_tpu_torch/serving`` → two
levels up), which makes the same code work on the real repo, on
fixture mini-repos and on seeded-bug scratch copies under a tmpdir.

The port's checks count only the tests of the package that holds the
serving scope (:func:`package_tests`): a test of the JAX package that
names a fault site or error class vouches for the JAX package, not for
the port, which shares the repo, its ``tests/`` and its ``ci.yml``.
"""

import os
import re
from typing import Dict, Optional

def repo_root(serving_path: str) -> str:
    """``<root>/apex_tpu_torch/serving`` (or any ``<root>/<pkg>/serving``)
    → ``<root>``. A bare ``serving/`` dir resolves to its parent."""
    parent = os.path.dirname(serving_path)
    return os.path.dirname(parent) if parent else os.curdir


def test_texts(root: str) -> Optional[Dict[str, str]]:
    """path -> source text for every ``.py`` under ``<root>/tests``;
    None when the tree has no tests directory at all (the caller
    decides whether that is itself a finding). Read anew on every call:
    a walk of the repo's tests takes milliseconds, and a cache would
    hide an edit to them from a later lint in the same process."""
    tests = os.path.join(root, "tests")
    if not os.path.isdir(tests):
        return None
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(tests):
        dirnames.sort()
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path, encoding="utf-8") as fh:
                    out[path] = fh.read()
            except OSError:
                continue
    return out


def package_tests(serving_path: str) -> Optional[Dict[str, str]]:
    """The :func:`test_texts` of the repo around ``<root>/<pkg>/serving``
    that import ``<pkg>`` (``import <pkg>...`` or ``from <pkg>... import``
    on a line of its own); None when the tree has no tests directory."""
    texts = test_texts(repo_root(serving_path))
    if texts is None:
        return None
    pkg = os.path.basename(os.path.dirname(os.path.abspath(serving_path)))
    imports = re.compile(rf"^\s*(?:from|import)\s+{re.escape(pkg)}\b", re.M)
    return {p: t for p, t in texts.items() if imports.search(t)}


def ci_text(root: str) -> Optional[str]:
    """The CI workflow text, or None when the tree has none."""
    path = os.path.join(root, ".github", "workflows", "ci.yml")
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None
