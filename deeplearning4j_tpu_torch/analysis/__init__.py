"""Static analysis over the port's programs and repo conventions.

The port of `deeplearning4j_tpu/analysis/`. Two complementary passes share
one `Finding` report model:

  - `program_audit` runs each program of the caches (and any callable
    handed to it) once, eagerly, on clones of its inputs under a torch
    dispatch mode, and flags what should never ship in a captured hot
    path: f64 ops, policy-crossing dtype promotions, materialized [S,S]
    attention scores, train steps and decode states not updated in place,
    host reads, collectives in single-card programs, large folded
    constants. (The JAX package traces jaxprs and runs nothing; the port's
    kernels are launches that no trace reaches.)
  - `repo_lint` parses the port's ASTs and enforces the repo's written
    conventions: the card-query choke point, injectable clocks, the f64
    guard, the fault-point and Prometheus-family registries, lock
    discipline.

Both feed `python -m deeplearning4j_tpu_torch.cli analyze`, which renders
one report (text or JSON) and exits nonzero at a chosen severity floor.
`__all__` is the JAX package's: `audit_jaxpr` audits a recording, and
`iter_eqns` and `collect_shapes` walk its ops.
"""

from deeplearning4j_tpu_torch.analysis.report import (
    Finding,
    REPORT_VERSION,
    SEVERITIES,
    at_or_above,
    counts,
    render_text,
    severity_rank,
    to_report,
)
from deeplearning4j_tpu_torch.analysis.program_audit import (
    assert_no_materialized_scores,
    audit_cache,
    audit_fn,
    audit_jaxpr,
    audit_spec_decode_parity,
    audit_zoo_models,
    collect_shapes,
    iter_eqns,
    score_scale_shapes,
)
from deeplearning4j_tpu_torch.analysis.repo_lint import (
    lint_file,
    lint_package,
    lint_source,
)

__all__ = [
    "Finding", "REPORT_VERSION", "SEVERITIES", "at_or_above", "counts",
    "render_text", "severity_rank", "to_report",
    "assert_no_materialized_scores", "audit_cache", "audit_fn",
    "audit_jaxpr", "audit_spec_decode_parity", "audit_zoo_models",
    "collect_shapes", "iter_eqns",
    "score_scale_shapes",
    "lint_file", "lint_package", "lint_source",
]
