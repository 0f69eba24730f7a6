"""SARIF 2.1.0 export for `python -m kcmc_tpu_torch check --sarif` (the
port's copy of kcmc_tpu/analysis/sarif.py).

Static Analysis Results Interchange Format: the one JSON dialect the
GitHub code-scanning UI ingests natively, so `check` findings
render as inline PR annotations instead of a log line someone has to
go read. The emitter is deliberately minimal-but-valid: one run, one
driver, a rule table built from the rules that actually fired, and one
result per NEW finding (baselined findings are accepted debt — they do
not annotate PRs; baseline-hygiene problems do).

The structural contract is pinned by `tests/test_torch_analysis.py`,
which validates the output against the JAX package's SARIF 2.1.0
subset schema with jsonschema when available and by hand otherwise.
"""

from __future__ import annotations

SARIF_SCHEMA_URI = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

_RULE_HELP = {
    "config-registry": "CorrectorConfig resume-signature classification",
    "lock-order": "lock acquisition graph must be acyclic",
    "daemon-cuda": "kernel builds and card work only on non-daemon threads",
    "span-registry": "telemetry names drawn from obs/registry.py",
    "thread-roots": "concurrent entry points named and resolvable",
    "race": "cross-root shared access needs intersecting lock sets",
    "resource-lifecycle": "acquired resources reach release on all paths",
    "baseline": "baseline entries stay justified and live",
    "parse": "sources must parse",
}

_HELP_URI = "https://github.com/kcmc-tpu/kcmc-tpu/blob/main/README.md"

_LEVELS = {"error": "error", "warning": "warning"}


def to_sarif(result) -> dict:
    """A CheckResult -> SARIF 2.1.0 log dict (new findings + baseline
    problems; baselined findings are deliberately excluded)."""
    findings = list(result.new) + list(result.baseline_problems)
    rule_ids = sorted({f.rule for f in findings} | set(_RULE_HELP))
    rule_index = {r: i for i, r in enumerate(rule_ids)}
    rules = [
        {
            "id": r,
            "name": r.replace("-", " ").title().replace(" ", ""),
            "shortDescription": {
                "text": _RULE_HELP.get(r, r)
            },
            "helpUri": _HELP_URI,
        }
        for r in rule_ids
    ]
    results = []
    for f in findings:
        text = f.message if not f.detail else f"{f.message} ({f.detail})"
        results.append(
            {
                "ruleId": f.rule,
                "ruleIndex": rule_index[f.rule],
                "level": _LEVELS.get(f.severity, "note"),
                "message": {"text": text},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": f.path,
                                "uriBaseId": "%SRCROOT%",
                            },
                            "region": {"startLine": max(1, int(f.line))},
                        }
                    }
                ],
                # stable identity for annotation dedup across pushes
                "partialFingerprints": {
                    "kcmcFindingKey/v1": f.key
                },
            }
        )
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "kcmc-check",
                        "informationUri": _HELP_URI,
                        "rules": rules,
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }
