"""Typed admission errors for the serving front door.

``submit()`` used to signal every rejection as a bare ``ValueError`` whose
only machine-readable content was the message string; callers (and the
regression tests) had to substring-match.  Each rejection now raises a
dedicated :class:`AdmissionError` subclass carrying the structured fields a
router or load-shedder actually needs — remaining budget, required blocks —
while still subclassing ``ValueError`` so pre-redesign ``except ValueError``
call sites keep working.
"""
from __future__ import annotations



class AdmissionError(ValueError):
    """A request was rejected at ``submit()`` time.

    Attributes:
      rid: the rejected request's id (None when unknowable).
    """

    def __init__(self, message: str, *, rid: int | None = None):
        super().__init__(message)
        self.rid = rid


class EmptyPromptError(AdmissionError):
    """Zero-token prompt: there is nothing to prefill and no logits row to
    seed generation from."""


class InvalidBudgetError(AdmissionError):
    """``max_new < 1``: every admitted request emits at least one token (the
    first is sampled from the prefill logits), so a zero/negative budget is
    unsatisfiable.

    Attributes:
      max_new: the offending budget.
    """

    def __init__(self, message: str, *, rid: int | None = None,
                 max_new: int = 0):
        super().__init__(message, rid=rid)
        self.max_new = int(max_new)


class PromptTooLongError(AdmissionError):
    """Prompt does not fit the per-slot sequence budget.

    Attributes:
      length:    prompt length in tokens.
      s_max:     the batcher's sequence capacity.
      remaining: tokens of prompt budget available (``s_max - 1``).
      overflow:  tokens over the remaining budget.
    """

    def __init__(self, message: str, *, rid: int | None = None,
                 length: int = 0, s_max: int = 0):
        super().__init__(message, rid=rid)
        self.length = int(length)
        self.s_max = int(s_max)
        self.remaining = int(s_max) - 1
        self.overflow = int(length) - self.remaining


class PoolFootprintError(AdmissionError):
    """Paged serving: the request's lifetime KV footprint exceeds the whole
    block pool, so it could never finish even as the sole resident.

    Attributes:
      required_blocks:  blocks the request's lifetime footprint needs.
      available_blocks: allocatable blocks the pool holds in total.
      deficit:          blocks short.
    """

    def __init__(self, message: str, *, rid: int | None = None,
                 required_blocks: int = 0, available_blocks: int = 0):
        super().__init__(message, rid=rid)
        self.required_blocks = int(required_blocks)
        self.available_blocks = int(available_blocks)
        self.deficit = int(required_blocks) - int(available_blocks)


class UnknownSLOClassError(AdmissionError):
    """Adaptive serving: the request names an SLO class the server was not
    configured with.

    Attributes:
      slo:     the unknown class name.
      classes: the configured class names.
    """

    def __init__(self, message: str, *, rid: int | None = None,
                 slo: str = "", classes: tuple = ()):
        super().__init__(message, rid=rid)
        self.slo = slo
        self.classes = tuple(classes)
