"""Leaf data structures of the invariant auditor: :class:`Finding`,
:class:`StepSpec` and :class:`Report`, with the reference's JSON schema
(``repro.analysis.report``).

Import-light (stdlib only): the batchers build ``StepSpec``\\ s in their
``audit_steps()``, and findings flow out through the CLI, so this module
stays a leaf that imports nothing of the runtime.

``StepSpec`` names the arguments a step must write in place
(``inplace``) where the reference names the ones its jit donates
(``donate_argnums``): an eager step has no donation, and the contract it
keeps instead is that the cache it returns is the cache it was given.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

# the rules that bind only where the card runs the kernels: on a host
# device the step runs the kernels' plain versions, so the audit lists
# these as not bound and never as passed
CARD_ONLY_RULES = ("cuda_kernel_launched",
                   "no_f32_upcast_of_quantized_operands")


@dataclass(frozen=True)
class Finding:
    """One contract violation: which rule fired, on which step, and where
    (an op, a dispatch, a source line) it anchored."""
    rule: str                 # rule id, e.g. "no_collectives"
    step: str                 # step name, e.g. "decode" / "paged:chunk"
    message: str              # human-readable statement of the violation
    locus: str = ""           # op / dispatch / source excerpt (truncated)
    cell: str = ""            # audit cell name (filled in by the CLI)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "step": self.step, "cell": self.cell,
                "message": self.message, "locus": self.locus}

    def __str__(self) -> str:
        where = f"{self.cell}/{self.step}" if self.cell else self.step
        tail = f"\n    at: {self.locus}" if self.locus else ""
        return f"[{self.rule}] {where}: {self.message}{tail}"


@dataclass
class StepSpec:
    """One auditable serving step: a callable and example arguments shaped
    as the hot loop calls it (scratch copies of the cache or pool, so an
    audit never disturbs a live batcher).

    ``backend`` is the engine backend the step's contract names ("cuda"
    for the kernels, "torch" for their plain versions); ``run_backend`` is
    what the audit passes to ``fn`` as ``backend=``: set on the card, None
    on a host device (the device decides, as in the hot loop: the engine
    refuses ``cuda`` for host tensors), so a step with a ``run_backend``
    is :attr:`on_card` and the card-only rules bind.  ``inplace``: argument
    positions whose tensors the step must update in place (the cache or
    the pool: every leaf keeps its storage).  ``fused_layers``: the layer
    count where the step promises the fused paged decode (one B4 launch a
    layer); None where that rule does not bind."""
    name: str
    fn: object
    args: tuple
    inplace: tuple = ()
    pure_dp: bool = True      # no collectives allowed
    quantized_acts: bool = False
    quantized_weights: bool = False
    backend: str = "torch"
    run_backend: str | None = None
    fused_layers: int | None = None

    @property
    def on_card(self) -> bool:
        return self.run_backend is not None

    def default_rules(self) -> tuple[str, ...]:
        """The contract set this step must uphold, derived from its wiring
        as the reference derives it: the kernel rules bind where the
        contract's backend is ``cuda`` (the reference's ``pallas``)."""
        rules = []
        if self.pure_dp:
            rules.append("no_collectives")
        if self.inplace:
            rules.append("cache_updated_in_place")
        if self.quantized_acts:
            rules.append("scale_shape_is_per_row")
        if self.quantized_weights and self.backend == "cuda":
            rules += ["cuda_kernel_launched",
                      "no_f32_upcast_of_quantized_operands",
                      "tuning_cache_hit"]
        if self.fused_layers:
            rules.append("fused_decode_single_dispatch")
        return tuple(rules)

    def split_rules(self, rules) -> tuple[tuple[str, ...], tuple[str, ...]]:
        """(bound, not bound) of ``rules`` on this step's device: off the
        card the :data:`CARD_ONLY_RULES` are not bound."""
        bound = tuple(r for r in rules
                      if self.on_card or r not in CARD_ONLY_RULES)
        return bound, tuple(r for r in rules if r not in bound)


@dataclass
class Report:
    """Audit run result: findings (empty == clean) and what was checked.
    A ``checked`` entry of a step names its bound ``rules`` and, off the
    card, the card-only rules it could not bind (``not_bound``)."""
    findings: list[Finding] = field(default_factory=list)
    checked: list[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def extend(self, findings, *, cell: str = "") -> None:
        for f in findings:
            if cell and not f.cell:
                f = Finding(rule=f.rule, step=f.step, message=f.message,
                            locus=f.locus, cell=cell)
            self.findings.append(f)

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "n_findings": len(self.findings),
            "findings": [f.to_dict() for f in self.findings],
            "checked": self.checked,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Report":
        data = json.loads(text)
        return cls(findings=[Finding(**f) for f in data["findings"]],
                   checked=list(data["checked"]))

    def summary(self) -> str:
        n_steps = sum(1 for c in self.checked if "step" in c)
        n_rules = sum(len(c.get("rules", ())) for c in self.checked)
        n_unbound = sum(len(c.get("not_bound", ())) for c in self.checked)
        head = (f"audit: {n_steps} step(s), {n_rules} rule application(s), "
                f"{n_unbound} not bound off the card, "
                f"{len(self.findings)} finding(s)")
        if self.ok:
            return head + " — clean"
        return "\n".join([head] + [str(f) for f in self.findings])
