"""reprolint for the port: static and captured-graph analysis of the
serving stack — the counterpart of ``repro/analysis``.

Two layers:

* Layer 1 (:mod:`repro_torch.analysis.rules`, CLI
  :mod:`repro_torch.analysis.lint`) — an AST rule engine over
  ``src/repro_torch``: capture purity and branches frozen at capture in the
  bodies captured as CUDA graphs, and the name-consistency invariants (rule
  IDs ``RL001``–``RL005``).
* Layer 2 (:mod:`repro_torch.analysis.audit`) — a captured-graph auditor
  that captures the real serving steps on the card and asserts on the
  graphs themselves: no host nodes or host syncs, buffers kept in place,
  every hand-written kernel's nodes equal to its counted launches, one
  capture a Server and a batch size.

See ``docs/analysis_torch.md`` for the rule catalog.
"""

from repro_torch.analysis.findings import Baseline, Finding  # noqa: F401
