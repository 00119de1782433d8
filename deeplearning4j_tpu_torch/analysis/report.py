"""Finding model + report serialization for the static-analysis layer.

The port's copy of `deeplearning4j_tpu/analysis/report.py` (which imports
no jax): the same `Finding`, severities, report version and renderings, so
that both packages' `analyze` reports read alike.

Every pass in this package (`program_audit`, `repo_lint`) reports
through one shape: a `Finding(rule, severity, location, message)`.  The
CLI `analyze` subcommand and the tier-1 gate consume the same report,
so the JSON schema here is a compatibility surface — bump
`REPORT_VERSION` on any breaking change and keep the old keys readable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

#: severities in escalation order; `--fail-on` thresholds index into this
SEVERITIES = ("info", "warn", "error")

#: schema version stamped into every JSON report
REPORT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    rule:     stable kebab-case rule id (e.g. "materialized-scores") —
              tests key on these, so renaming one is a breaking change.
    severity: "info" | "warn" | "error".
    location: where — "relative/path.py:LINE" for lint findings,
              "program:<cache key or label>" for program-audit findings.
    message:  human-readable explanation with the offending detail.
    """

    rule: str
    severity: str
    location: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r} "
                             f"(choose from {SEVERITIES})")

    def as_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "location": self.location, "message": self.message}


def severity_rank(severity: str) -> int:
    return SEVERITIES.index(severity)


def counts(findings: Iterable[Finding]) -> Dict[str, int]:
    """{"info": n, "warn": n, "error": n} — always all three keys."""
    out = {s: 0 for s in SEVERITIES}
    for f in findings:
        out[f.severity] += 1
    return out


def at_or_above(findings: Iterable[Finding],
                threshold: str) -> List[Finding]:
    """Findings whose severity is >= `threshold`."""
    floor = severity_rank(threshold)
    return [f for f in findings if severity_rank(f.severity) >= floor]


def to_report(findings: List[Finding],
              checked: Optional[dict] = None) -> dict:
    """The stable JSON report the CLI emits (and tests assert on):

    {"version": 1,
     "counts": {"info": n, "warn": n, "error": n},
     "checked": {...pass-specific coverage facts...},
     "findings": [{"rule", "severity", "location", "message"}, ...]}
    """
    ordered = sorted(findings,
                     key=lambda f: (-severity_rank(f.severity), f.rule,
                                    f.location))
    return {"version": REPORT_VERSION,
            "counts": counts(findings),
            "checked": dict(checked or {}),
            "findings": [f.as_dict() for f in ordered]}


def render_text(findings: List[Finding],
                checked: Optional[dict] = None) -> str:
    """Terminal rendering: one line per finding, severity-sorted, with a
    trailing summary line."""
    rep = to_report(findings, checked)
    lines = [f"{f['severity'].upper():5s} {f['rule']:28s} "
             f"{f['location']}: {f['message']}"
             for f in rep["findings"]]
    c = rep["counts"]
    lines.append(f"analyze: {c['error']} error(s), {c['warn']} warning(s), "
                 f"{c['info']} info over {rep['checked']}")
    return "\n".join(lines)
