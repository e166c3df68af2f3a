"""Finding model shared by every flowlint pass.

A finding is one defect (or suspicion) located in a transformation
artifact — a workflow graph, an execution plan, a channel topology, or a
kernel invocation.  Findings carry a stable code (``P…`` plan, ``C…``
concurrency, ``K…`` kernel, ``R…`` RNG), a severity, and a fix hint, so
the CLI/CI gate and the executor's strict mode can filter uniformly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence

SEVERITIES = ("info", "warning", "error")


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(
            f"unknown severity {severity!r}; expected one of {SEVERITIES}")


@dataclass(frozen=True)
class Finding:
    code: str        # stable defect-class id, e.g. "P203"
    severity: str    # "info" | "warning" | "error"
    subject: str     # node / channel / lock / kernel the finding is about
    message: str     # what is wrong
    hint: str = ""   # how to fix it
    pass_name: str = ""  # "plan" | "concurrency" | "kernel" | "rng"

    def __post_init__(self):
        severity_rank(self.severity)  # validate eagerly

    def format(self) -> str:
        loc = f" [{self.subject}]" if self.subject else ""
        out = f"{self.severity.upper():7s} {self.code}{loc}: {self.message}"
        if self.hint:
            out += f"\n        hint: {self.hint}"
        return out


def filter_findings(findings: Iterable[Finding],
                    min_severity: str = "info") -> List[Finding]:
    floor = severity_rank(min_severity)
    return [f for f in findings if severity_rank(f.severity) >= floor]


def max_severity(findings: Sequence[Finding]) -> Optional[str]:
    if not findings:
        return None
    return max(findings, key=lambda f: severity_rank(f.severity)).severity


def format_findings(findings: Sequence[Finding],
                    header: str = "") -> str:
    lines = []
    if header:
        lines.append(header)
    if not findings:
        lines.append("clean: no findings")
    for f in findings:
        lines.append(f.format())
    return "\n".join(lines)


class FlowLintError(RuntimeError):
    """Raised by strict mode when a plan fails static analysis — the run
    is rejected BEFORE any worker executes or any device is rebound."""

    def __init__(self, findings: Sequence[Finding],
                 context: str = "execution plan rejected"):
        self.findings = list(findings)
        super().__init__(
            format_findings(self.findings,
                            header=f"flowlint: {context} "
                                   f"({len(self.findings)} finding(s))"))
