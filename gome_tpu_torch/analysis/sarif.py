"""SARIF 2.1.0 output: findings as code-review annotations.

The port of ``gome_tpu/analysis/sarif.py`` (the same document and
validator; baselined results cite the port's baseline).

SARIF (Static Analysis Results Interchange Format, OASIS 2.1.0) is what
code hosts ingest to render linter findings as inline review comments.
``gomelint --format sarif`` / ``--sarif FILE`` emit one run with:

  * ``tool.driver.rules`` — the full rule catalogue (id + description),
    so viewers can show the rule help without a second lookup;
  * one ``result`` per finding with a ``physicalLocation`` (relative URI,
    1-based line/column per the spec) and ``partialFingerprints`` carrying
    the SAME content-addressed fingerprint the baseline uses
    (``gomelint/v1``) — host-side dedup and the CI ratchet agree on
    finding identity;
  * baselined findings are still emitted but marked with an ``external``
    suppression (reviewers see them greyed out, not hidden) and
    ``baselineState: "unchanged"``; new findings are ``level: error`` so
    the annotation severity mirrors the exit code.

:func:`validate_sarif` structurally validates a document against the
2.1.0 schema's required properties/enums (the subset gomelint emits —
the test suite runs every emitted document through it; no network schema
fetch in CI).
"""

from __future__ import annotations

from .baseline import FINGERPRINT_KEY
from .core import TOOL_VERSION, Finding, rule_catalogue

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def to_sarif(
    fingerprinted: list[tuple[Finding, str]],
    baselined: set[str] | None = None,
    root: str = "",
) -> dict:
    """Build one SARIF 2.1.0 document. `baselined` is the set of
    fingerprints present in the committed baseline; `root` is stripped
    from finding paths to keep artifact URIs repo-relative."""
    baselined = baselined or set()
    rules = [
        dict(
            id=rule,
            shortDescription=dict(text=desc),
            defaultConfiguration=dict(level="warning"),
        )
        for rule, desc in rule_catalogue().items()
    ]
    rule_index = {r["id"]: i for i, r in enumerate(rules)}
    results = []
    for f, fp in fingerprinted:
        uri = f.path
        if root and uri.startswith(root):
            uri = uri[len(root):].lstrip("/\\")
        uri = uri.replace("\\", "/")
        known = fp in baselined
        result = dict(
            ruleId=f.rule,
            ruleIndex=rule_index.get(f.rule, -1),
            level="warning" if known else "error",
            message=dict(text=f.message),
            locations=[dict(
                physicalLocation=dict(
                    artifactLocation=dict(uri=uri),
                    region=dict(
                        startLine=max(f.line, 1),
                        startColumn=f.col + 1,
                    ),
                ),
            )],
            partialFingerprints={FINGERPRINT_KEY: fp},
            baselineState="unchanged" if known else "new",
        )
        if known:
            result["suppressions"] = [dict(
                kind="external",
                justification="baselined in gome_tpu_torch/analysis/"
                              "baseline.json (ratchet: only new findings "
                              "fail CI)",
            )]
        results.append(result)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [dict(
            tool=dict(driver=dict(
                name="gomelint",
                version=TOOL_VERSION,
                informationUri="https://github.com/lxalano/gome",
                rules=rules,
            )),
            results=results,
        )],
    }


_LEVELS = {"none", "note", "warning", "error"}
_BASELINE_STATES = {"new", "unchanged", "updated", "absent"}
_SUPPRESSION_KINDS = {"inSource", "external"}


def validate_sarif(doc) -> list[str]:
    """Structural validation against SARIF 2.1.0's required properties
    and enums (the emitted subset). Returns a list of violations — empty
    means valid. Paths in messages use JSON-pointer-ish notation."""
    errs: list[str] = []

    def need(cond, where, what):
        if not cond:
            errs.append(f"{where}: {what}")

    need(isinstance(doc, dict), "$", "document must be an object")
    if not isinstance(doc, dict):
        return errs
    need(doc.get("version") == SARIF_VERSION, "$.version",
         f"must be the string {SARIF_VERSION!r}")
    runs = doc.get("runs")
    need(isinstance(runs, list) and runs, "$.runs",
         "must be a non-empty array")
    for i, run in enumerate(runs or []):
        w = f"$.runs[{i}]"
        need(isinstance(run, dict), w, "must be an object")
        if not isinstance(run, dict):
            continue
        driver = (run.get("tool") or {}).get("driver")
        need(isinstance(driver, dict), f"{w}.tool.driver",
             "required object")
        if isinstance(driver, dict):
            need(isinstance(driver.get("name"), str) and driver["name"],
                 f"{w}.tool.driver.name", "required non-empty string")
            seen_ids: set[str] = set()
            for j, rule in enumerate(driver.get("rules", [])):
                rw = f"{w}.tool.driver.rules[{j}]"
                need(isinstance(rule.get("id"), str) and rule["id"],
                     f"{rw}.id", "required non-empty string")
                need(rule.get("id") not in seen_ids, f"{rw}.id",
                     "rule ids must be unique within a driver")
                seen_ids.add(rule.get("id"))
        for j, res in enumerate(run.get("results", [])):
            rw = f"{w}.results[{j}]"
            msg = res.get("message")
            need(isinstance(msg, dict) and isinstance(msg.get("text"), str),
                 f"{rw}.message.text", "required string")
            if "ruleId" in res:
                need(isinstance(res["ruleId"], str), f"{rw}.ruleId",
                     "must be a string")
            if "level" in res:
                need(res["level"] in _LEVELS, f"{rw}.level",
                     f"must be one of {sorted(_LEVELS)}")
            if "baselineState" in res:
                need(res["baselineState"] in _BASELINE_STATES,
                     f"{rw}.baselineState",
                     f"must be one of {sorted(_BASELINE_STATES)}")
            if "partialFingerprints" in res:
                pf = res["partialFingerprints"]
                need(
                    isinstance(pf, dict) and all(
                        isinstance(k, str) and isinstance(v, str)
                        for k, v in pf.items()
                    ),
                    f"{rw}.partialFingerprints",
                    "must map strings to strings",
                )
            for k, loc in enumerate(res.get("locations", [])):
                lw = f"{rw}.locations[{k}].physicalLocation"
                phys = loc.get("physicalLocation")
                if phys is None:
                    continue
                art = phys.get("artifactLocation")
                if art is not None:
                    need(isinstance(art.get("uri"), str), f"{lw}"
                         ".artifactLocation.uri", "must be a string")
                region = phys.get("region")
                if region is not None:
                    for prop in ("startLine", "startColumn", "endLine",
                                 "endColumn"):
                        if prop in region:
                            need(
                                isinstance(region[prop], int)
                                and region[prop] >= 1,
                                f"{lw}.region.{prop}",
                                "must be an integer >= 1",
                            )
            for k, sup in enumerate(res.get("suppressions", [])):
                need(sup.get("kind") in _SUPPRESSION_KINDS,
                     f"{rw}.suppressions[{k}].kind",
                     f"must be one of {sorted(_SUPPRESSION_KINDS)}")
    return errs
