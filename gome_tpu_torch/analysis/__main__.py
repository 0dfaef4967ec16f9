"""gomelint over the port — run the AST analyzers over the tree.

    python -m gome_tpu_torch.analysis gome_tpu_torch                 # all
    python -m gome_tpu_torch.analysis gome_tpu_torch --select GL5    # one family
    python -m gome_tpu_torch.analysis gome_tpu_torch --format sarif  # annotations
    python -m gome_tpu_torch.analysis gome_tpu_torch --update-baseline
    python -m gome_tpu_torch.analysis gome_tpu_torch --update-universe
    python -m gome_tpu_torch.analysis gome_tpu_torch --journal export.json
    python -m gome_tpu_torch.analysis gome_tpu_torch --traced [--dtype int64]
    python -m gome_tpu_torch.analysis gome_tpu_torch --traced --device cpu
    python -m gome_tpu_torch.analysis --list-rules

The port of ``scripts/gomelint.py``. ``--traced`` is the port's name for
the reference's ``--jaxpr``: it runs the GL2xx dtype envelope
(``analysis/envelope.py``: the engine's device entries recorded op by op)
beside the AST families, through the same suppressions, baseline, SARIF
and --select, on the CUDA card unless ``--device cpu`` (without a card it
stops with a usage error). The reference's other jaxpr audits have no
subject here (see ``analysis/__init__.py``). Whenever
the GL9 family runs (no --select, or one naming GL9), GL905 holds the
port's engine bounds to the committed combo universe
(``gome_tpu_torch/analysis/combo_universe.json``, override with
--universe, regenerate with --update-universe): it imports the port's
engine, not JAX, so it needs no --jaxpr gate. ``--journal FILE`` runs
GL906 over a compile-journal export (``obs.JOURNAL.export()``) against
the same universe. Exit
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
from .surface import DEFAULT_UNIVERSE

#: The checkout's root (the package's parent): relative paths in the
#: baseline and in SARIF URIs are relative to it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="gomelint", description=__doc__)
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument("--select", default="",
                    help="comma-separated rule ids/prefixes (GL4,GL501,...)")
    ap.add_argument("--traced", action="store_true",
                    help="also run the traced-engine audit: the GL2xx "
                         "dtype envelope")
    ap.add_argument("--dtype", default="int32", choices=("int32", "int64"),
                    help="declared book dtype for the traced audit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the traced audit runs the entries "
                         "(default: the CUDA card)")
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
    ap.add_argument("--universe",
                    default=os.path.join(ROOT, DEFAULT_UNIVERSE),
                    help="combo-universe manifest for the GL905 drift "
                         f"ratchet (default: {DEFAULT_UNIVERSE})")
    ap.add_argument("--update-universe", action="store_true",
                    help="rewrite the combo universe to the current "
                         "engine bounds and exit 0 (review the diff!)")
    ap.add_argument("--journal", default="",
                    help="compile-journal export (JSON) to check against "
                         "the committed combo universe (GL906)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include findings silenced by gomelint directives")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--version", action="version",
                    version=f"gomelint {TOOL_VERSION}")
    args = ap.parse_args(argv)

    if args.list_rules:
        _ensure_checkers_loaded()
        from . import envelope  # noqa: F401 - registers GL2xx, no torch
        for rule, desc in rule_catalogue().items():
            print(f"{rule}  {desc}")
        return 0
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
    surface = not select or any(s.startswith("GL9") for s in select)
    if args.update_universe:
        from .surface import extract_universe, save_universe
        universe = extract_universe()
        save_universe(args.universe, universe)
        print(f"gomelint: combo universe updated with "
              f"{len(universe['dimensions'])} dimension(s) -> "
              f"{args.universe}")
        return 0
    traced = args.traced and (
        not select or any(s.startswith("GL2") for s in select))
    if traced:
        from ..engine.book import resolve_device
        try:
            resolve_device(None if args.device == "cuda" else args.device)
        except RuntimeError as exc:
            ap.error(f"--traced: {exc}")
    findings = run_paths(args.paths, select or None,
                         keep_suppressed=args.show_suppressed)
    if traced:
        from .core import apply_file_suppressions
        from .envelope import check_engine_envelope
        found = check_engine_envelope(args.dtype, args.device)
        if not args.show_suppressed:
            found = apply_file_suppressions(found, root=ROOT)
        findings.extend(found)
    if surface:
        from .surface import check_journal_escape, check_universe
        findings.extend(check_universe(args.universe))
        if args.journal:
            findings.extend(check_journal_escape(args.journal,
                                                 args.universe))
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
