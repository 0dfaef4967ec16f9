"""gomelint for the port — the reference's static analysis over
``gome_tpu_torch/``.

The port of ``gome_tpu/analysis``. The engine's thread and transfer
contracts are the reference's, so the families whose subject exists in
the port are ported with the reference's rule ids, messages,
fingerprints and SARIF output:

  GL2xx  dtype envelope    — the engine's device entries run once under a
                             TorchDispatchMode that records every aten op:
                             float64 anywhere (GL201), floats in the integer
                             matching envelope (GL202), a book value wider
                             than the declared dtype (GL203, on a value
                             taint that tells values from PyTorch's int64
                             indexes); K1 and K5 audited at their boundary
                             (analysis.envelope; the CLI's --traced)
  GL4xx  lock-discipline   — `# guarded by self._lock` annotations enforced
                             lexically (analysis.locks); the opt-in runtime
                             assertion mode lives in analysis.runtime
  GL5xx  transfer-hygiene  — host<->device syncs on `# gomelint: hotpath`
                             reachable code, on PyTorch's syncs
                             (analysis.transfers, over the analysis.callgraph
                             hot-path engine)
  GL7xx  thread-escape     — attributes reachable from more than one
                             thread mutated without a `# guarded by` /
                             `# single-writer` contract (analysis.threads);
                             the dynamic companion — an Eraser-style
                             lockset detector + seeded interleaving driver
                             — lives in analysis.racecheck /
                             analysis.interleave
  GL9xx  compile-surface   — the frame-dispatch combo bounded by the
                             `# gomesurface: quantizer` lattice (GL901),
                             its build/replay/persist sites agreeing with
                             engine.frames.COMBO_FIELDS (GL902), the
                             declared device entries replayed at boot
                             (GL903), no hot geometry reset (GL904), the
                             committed combo_universe.json (GL905, which
                             reads the port's engine defaults: no trace)
                             and a compile-journal export inside it
                             (GL906, pure JSON; analysis.surface)

The other families of the reference have no subject here and are not
ported: GL1xx (host leaks inside jit/pallas-traced code), GL3xx (jit
wrappers that bypass the compile cache) and GL6xx (buffer donation) — the
port traces nothing into a compiled graph and donates nothing; of GL8xx,
GL801, GL804 and GL806 (partition specs, donation across shardings, the
jaxpr-derived shard manifest).

Run it via ``python -m gome_tpu_torch.analysis gome_tpu_torch
[--traced [--device cpu]]`` or programmatically through :func:`run_paths`
and ``envelope.check_engine_envelope``. Only findings NOT in the
committed ``gome_tpu_torch/analysis/baseline.json`` fail the gate.
Suppress one line with a trailing ``# gomelint: disable=GL501`` comment,
or a whole file with ``# gomelint: disable-file=GL501`` on any line (see
analysis.core).
"""

from __future__ import annotations

from .core import (
    ALL_RULES,
    TOOL_VERSION,
    Finding,
    Project,
    SourceModule,
    rule_catalogue,
    run_paths,
    run_source,
    run_sources,
)

__version__ = TOOL_VERSION

__all__ = [
    "ALL_RULES",
    "TOOL_VERSION",
    "Finding",
    "Project",
    "SourceModule",
    "rule_catalogue",
    "run_paths",
    "run_source",
    "run_sources",
]
