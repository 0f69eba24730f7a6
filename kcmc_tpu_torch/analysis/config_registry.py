"""Pass 1 — config-registry completeness (`config-registry`); the port's
copy of kcmc_tpu/analysis/config_registry.py.

The resume-checkpoint signature pins every `CorrectorConfig` field that
is declared *signature-neutral* (`SIG_NEUTRAL_FIELDS`) to its default
before hashing; everything else restarts a resume when changed. A new
field added to the dataclass but to NEITHER registry silently lands on
whichever side `dataclasses.replace` happens to give it — corrupting
resume semantics with no test to notice. This pass makes the
classification total, validated, and documented:

* every dataclass field of `CorrectorConfig` appears in exactly one of
  `SIG_NEUTRAL_FIELDS` / `SIG_AFFECTING_FIELDS` (config.py);
* neither registry names a field that no longer exists;
* `__post_init__` calls the runtime validator
  (`_validate_field_classification`), so the invariant also holds for
  anyone vendoring a modified config;
* every field is documented in the API document (backtick-quoted),
  where the index carries one. The port's package index reads no
  documents (`docs/` is the JAX package's), so on the port that half
  does not apply and stays silent.
"""

from __future__ import annotations

import ast

from kcmc_tpu_torch.analysis.core import (
    Finding,
    ModuleIndex,
    attr_chain,
    str_set_from,
)

NEUTRAL_NAME = "SIG_NEUTRAL_FIELDS"
AFFECTING_NAME = "SIG_AFFECTING_FIELDS"
VALIDATOR_NAME = "_validate_field_classification"


class ConfigRegistryPass:
    name = "config-registry"

    def __init__(
        self,
        config_path: str = "kcmc_tpu_torch/config.py",
        config_class: str = "CorrectorConfig",
        api_doc: str = "docs/API.md",
    ):
        self.config_path = config_path
        self.config_class = config_class
        self.api_doc = api_doc

    def run(self, index: ModuleIndex) -> list[Finding]:
        mod = index.get(self.config_path)
        if mod is None:
            return [
                Finding(
                    rule=self.name,
                    path=self.config_path,
                    line=0,
                    severity="error",
                    message="config module not found in the index",
                )
            ]
        out: list[Finding] = []

        cls = next(
            (
                n
                for n in ast.walk(mod.tree)
                if isinstance(n, ast.ClassDef)
                and n.name == self.config_class
            ),
            None,
        )
        if cls is None:
            return [
                Finding(
                    rule=self.name,
                    path=self.config_path,
                    line=0,
                    severity="error",
                    message=f"class {self.config_class} not found",
                )
            ]

        # Dataclass fields: annotated class-body assignments. Walk only
        # the class body's direct statements (nested defs are methods).
        fields: dict[str, int] = {}
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                fields[stmt.target.id] = stmt.lineno

        # The two registries: module-level NAME = frozenset({...}).
        registries: dict[str, tuple[set[str], int]] = {}
        for stmt in mod.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
                value = stmt.value
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id in (
                    NEUTRAL_NAME,
                    AFFECTING_NAME,
                ):
                    members = str_set_from(value)
                    if members is None:
                        out.append(
                            Finding(
                                rule=self.name,
                                path=self.config_path,
                                line=stmt.lineno,
                                severity="error",
                                message=(
                                    f"{t.id} must be a literal frozenset "
                                    "of field-name strings (the checker "
                                    "reads it statically)"
                                ),
                            )
                        )
                        members = set()
                    registries[t.id] = (members, stmt.lineno)

        for reg in (NEUTRAL_NAME, AFFECTING_NAME):
            if reg not in registries:
                out.append(
                    Finding(
                        rule=self.name,
                        path=self.config_path,
                        line=cls.lineno,
                        severity="error",
                        message=f"registry {reg} is not defined",
                    )
                )
        neutral, _ = registries.get(NEUTRAL_NAME, (set(), 0))
        affecting, _ = registries.get(AFFECTING_NAME, (set(), 0))

        # Totality + disjointness + staleness.
        for fname, line in sorted(fields.items()):
            in_n, in_a = fname in neutral, fname in affecting
            if not in_n and not in_a:
                out.append(
                    Finding(
                        rule=self.name,
                        path=self.config_path,
                        line=line,
                        severity="error",
                        message=(
                            f"config field '{fname}' is classified in "
                            f"neither {NEUTRAL_NAME} nor {AFFECTING_NAME}"
                        ),
                        detail=(
                            "decide whether changing it mid-run must "
                            "restart a checkpoint resume"
                        ),
                    )
                )
            elif in_n and in_a:
                out.append(
                    Finding(
                        rule=self.name,
                        path=self.config_path,
                        line=line,
                        severity="error",
                        message=(
                            f"config field '{fname}' is classified in "
                            "BOTH signature registries"
                        ),
                    )
                )
        for reg_name, members in (
            (NEUTRAL_NAME, neutral),
            (AFFECTING_NAME, affecting),
        ):
            line = registries.get(reg_name, (set(), 0))[1]
            for ghost in sorted(members - set(fields)):
                out.append(
                    Finding(
                        rule=self.name,
                        path=self.config_path,
                        line=line,
                        severity="error",
                        message=(
                            f"{reg_name} lists '{ghost}', which is not "
                            f"a {self.config_class} field"
                        ),
                    )
                )

        # __post_init__ must run the validator.
        post = next(
            (
                s
                for s in cls.body
                if isinstance(s, ast.FunctionDef)
                and s.name == "__post_init__"
            ),
            None,
        )
        calls_validator = post is not None and any(
            isinstance(n, ast.Call)
            and attr_chain(n.func).endswith(VALIDATOR_NAME)
            for n in ast.walk(post)
        )
        if not calls_validator:
            out.append(
                Finding(
                    rule=self.name,
                    path=self.config_path,
                    line=post.lineno if post else cls.lineno,
                    severity="error",
                    message=(
                        f"__post_init__ does not call {VALIDATOR_NAME} "
                        "(the runtime totality check)"
                    ),
                )
            )

        # Documentation: every field backtick-quoted in the API doc.
        api = index.docs.get(self.api_doc)
        if api is not None:
            for fname, line in sorted(fields.items()):
                if f"`{fname}`" not in api:
                    out.append(
                        Finding(
                            rule=self.name,
                            path=self.config_path,
                            line=line,
                            severity="error",
                            message=(
                                f"config field '{fname}' is not "
                                f"documented in {self.api_doc}"
                            ),
                        )
                    )
        return out
