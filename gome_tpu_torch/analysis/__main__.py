"""gomelint over the port — run the AST analyzers over the tree.

    python -m gome_tpu_torch.analysis gome_tpu_torch                 # all
    python -m gome_tpu_torch.analysis gome_tpu_torch --select GL5    # one family
    python -m gome_tpu_torch.analysis gome_tpu_torch --format sarif  # annotations
    python -m gome_tpu_torch.analysis gome_tpu_torch --update-baseline
    python -m gome_tpu_torch.analysis --list-rules

The port of ``scripts/gomelint.py``'s AST flags (the reference's jaxpr
audits have no counterpart here; see ``analysis/__init__.py``). Exit
status: 0 when every finding is clean or baselined, 1 when any NEW
(non-baselined) finding survives suppressions, 2 on usage errors. The
baseline (``gome_tpu_torch/analysis/baseline.json``, override with
--baseline, disable with --no-baseline) is the ratchet: existing debt is
recorded by content-addressed fingerprint, new debt fails. ``--report
FILE`` writes findings JSON and ``--sarif FILE`` writes SARIF 2.1.0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .baseline import (
    DEFAULT_BASELINE,
    fingerprint_findings,
    load_baseline,
    partition,
    save_baseline,
)
from .core import (
    TOOL_VERSION,
    _ensure_checkers_loaded,
    rule_catalogue,
    run_paths,
)

#: The checkout's root (the package's parent): relative paths in the
#: baseline and in SARIF URIs are relative to it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="gomelint", description=__doc__)
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument("--select", default="",
                    help="comma-separated rule ids/prefixes (GL4,GL501,...)")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"))
    ap.add_argument("--report", default="",
                    help="write findings as JSON to this path")
    ap.add_argument("--sarif", default="",
                    help="write findings as SARIF 2.1.0 to this path")
    ap.add_argument("--baseline", default=os.path.join(ROOT, DEFAULT_BASELINE),
                    help="baseline file for the ratchet (default: "
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: every finding fails")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings "
                         "and exit 0 (review the diff!)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include findings silenced by gomelint directives")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--version", action="version",
                    version=f"gomelint {TOOL_VERSION}")
    args = ap.parse_args(argv)

    if args.list_rules:
        _ensure_checkers_loaded()
        for rule, desc in rule_catalogue().items():
            print(f"{rule}  {desc}")
        return 0
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
    findings = run_paths(args.paths, select or None,
                         keep_suppressed=args.show_suppressed)
    fingerprinted = fingerprint_findings(findings, root=ROOT)
    if args.update_baseline:
        save_baseline(args.baseline, fingerprinted)
        print(f"gomelint: baseline updated with {len(findings)} "
              f"finding(s) -> {args.baseline}")
        return 0
    base = {} if args.no_baseline else load_baseline(args.baseline)
    new, known = partition(fingerprinted, base)

    payload = [
        dict(f.__dict__, fingerprint=fp, baselined=fp in base)
        for f, fp in fingerprinted
    ]
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(
                {"findings": payload, "count": len(findings),
                 "new": len(new), "baselined": len(known)},
                fh, indent=2,
            )
    sarif_doc = None
    if args.sarif or args.format == "sarif":
        from .sarif import to_sarif
        sarif_doc = to_sarif(fingerprinted, baselined=set(base), root=ROOT)
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(sarif_doc, fh, indent=2)

    if args.format == "json":
        print(json.dumps(payload, indent=2))
    elif args.format == "sarif":
        print(json.dumps(sarif_doc, indent=2))
    else:
        for f, fp in fingerprinted:
            tag = " [baselined]" if fp in base else ""
            print(f.format() + tag)
        summary = f"gomelint: {len(findings)} finding(s)"
        if known:
            summary += f" ({len(known)} baselined, {len(new)} new)"
        print(summary)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
