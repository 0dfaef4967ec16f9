"""Findings baseline: content-addressed fingerprints + the CI ratchet.

The port of ``gome_tpu/analysis/baseline.py``: the same fingerprint (so a
finding both packages report has one fingerprint) and the same file
format; the port's tree has its own committed baseline.

Turning new rule families on over a living tree needs a migration story:
the tree may carry findings that are understood and deliberately deferred
(or permanently justified at a coarser granularity than a line
suppression). The baseline file records their FINGERPRINTS; the CLI then
fails only on findings *not* in the baseline — new debt is blocked, old
debt can only shrink (``--update-baseline`` refuses to grow silently: it
rewrites the file to exactly the current findings, and the diff is
reviewed like any other code change).

Fingerprints are content-addressed so routine refactors do not churn the
baseline:

  * the file PATH is not hashed — moving a module keeps its findings
    baselined;
  * the LINE NUMBER is not hashed — inserting code above a finding keeps
    it baselined;
  * what IS hashed: the rule id, the finding message (which carries the
    function qualname / jaxpr context — logical anchors that survive
    moves), the stripped TEXT of the flagged source line, and an
    occurrence index that disambiguates identical (rule, message, text)
    triples in their sorted order.

Changing the flagged line's code — the thing a reviewer must re-judge —
changes the fingerprint, which is exactly the invalidation we want. The
SARIF output carries the same fingerprint as ``partialFingerprints``
(``gomelint/v1``) so code-review annotation dedup agrees with CI.
"""

from __future__ import annotations

import hashlib
import json
import os

from .core import TOOL_VERSION, Finding

FINGERPRINT_KEY = "gomelint/v1"

#: Default baseline location, relative to the repo root (the CLI resolves
#: it from its own location so CI and local runs agree).
DEFAULT_BASELINE = os.path.join("gome_tpu_torch", "analysis",
                                "baseline.json")


def _source_line(finding: Finding, cache: dict) -> str:
    """The stripped text of the flagged physical line; '' when the path
    is not a readable file (jaxpr pseudo-paths, <memory> fixtures)."""
    path = finding.path
    if path not in cache:
        try:
            with open(path, encoding="utf-8") as fh:
                cache[path] = fh.read().splitlines()
        except OSError:
            cache[path] = None
    lines = cache[path]
    if not lines or not 1 <= finding.line <= len(lines):
        return ""
    return lines[finding.line - 1].strip()


def fingerprint_findings(
    findings: list[Finding], root: str = "",
) -> list[tuple[Finding, str]]:
    """[(finding, fingerprint)] in the findings' given order. `root`
    resolves relative finding paths when reading source lines."""
    cache: dict = {}
    keyed: list[tuple[tuple, Finding]] = []
    for f in findings:
        probe = f if os.path.isabs(f.path) or not root else dataclass_with(
            f, path=os.path.join(root, f.path)
        )
        text = _source_line(probe, cache)
        keyed.append(((f.rule, f.message, text), f))
    counts: dict[tuple, int] = {}
    by_id: dict[int, str] = {}
    # occurrence index assigned in (line, col) order and scoped PER FILE:
    # within one file duplicates stay stably numbered as lines drift (and
    # reordering identical-text duplicates only swaps interchangeable
    # indices — the fingerprint multiset is invariant), while editing,
    # moving, or renaming one module can never renumber ANOTHER module's
    # duplicates. The path is still not hashed, so a moved file keeps its
    # own fingerprints; identical keys in different files intentionally
    # share a fingerprint — either instance matches the baseline entry.
    for key, f in sorted(keyed, key=lambda kf: (kf[1].path, kf[1].line,
                                                kf[1].col, kf[1].rule)):
        scope = (f.path, key)
        n = counts.get(scope, 0)
        counts[scope] = n + 1
        blob = "|".join((key[0], key[1], key[2], str(n)))
        by_id[id(f)] = hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]
    return [(f, by_id[id(f)]) for f in findings]


def dataclass_with(f: Finding, **kw) -> Finding:
    import dataclasses

    return dataclasses.replace(f, **kw)


def load_baseline(path: str) -> dict:
    """{} when missing — an absent baseline means 'everything is new'."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except OSError:
        return {}
    return doc.get("fingerprints", {})


def save_baseline(path: str, fingerprinted: list[tuple[Finding, str]]) -> None:
    """Rewrite the baseline to exactly the given findings. The per-entry
    metadata (rule/path/line/message) is for the human reading the diff;
    matching uses only the fingerprint key."""
    fps: dict[str, dict] = {}
    for f, fp in sorted(fingerprinted,
                        key=lambda ff: (ff[0].path, ff[0].line, ff[0].rule)):
        fps[fp] = dict(rule=f.rule, path=f.path, line=f.line,
                       message=f.message)
    doc = dict(
        version=1,
        tool=f"gomelint {TOOL_VERSION}",
        note="CI fails only on findings NOT in this file (ratchet). "
             "Regenerate with python -m gome_tpu_torch.analysis "
             "gome_tpu_torch --update-baseline; "
             "review the diff — shrinking is progress, growing is debt.",
        fingerprints=fps,
    )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=False)
        fh.write("\n")


def partition(
    fingerprinted: list[tuple[Finding, str]], baseline: dict,
) -> tuple[list[tuple[Finding, str]], list[tuple[Finding, str]]]:
    """(new, baselined) split against a loaded baseline."""
    new: list[tuple[Finding, str]] = []
    known: list[tuple[Finding, str]] = []
    for f, fp in fingerprinted:
        (known if fp in baseline else new).append((f, fp))
    return new, known
