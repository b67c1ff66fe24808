"""Runtime package: the serving facade (``repro.runtime``'s, as far as it
is ported).

``repro_torch.runtime`` is the stable import surface for serving:

  * :class:`ServingConfig` / :class:`RequestOptions` / :class:`Request` —
    the typed front door (``runtime.serving``);
  * :class:`ContinuousBatcher` (dense) / :class:`PagedBatcher` (paged,
    quantized KV);
  * :class:`Metrics` and the :mod:`repro_torch.runtime.errors`
    admission-error hierarchy;
  * :class:`Tracer` / :class:`TraceConfig` / :class:`MetricsSnapshotter`
    (the serving flight recorder: structured event tracing, Perfetto
    export, crash dumps, metrics snapshots — ``runtime.tracing``) and
    :class:`StepProfiler` (per-step device time against host gap —
    ``runtime.profile``).

Not ported yet: the adaptive server and its policy layer, and the
fault-tolerance helpers of the reference's runtime package.
"""
from __future__ import annotations

from .errors import (AdmissionError, EmptyPromptError,  # noqa: F401
                     InvalidBudgetError, PoolFootprintError,
                     PromptTooLongError, UnknownSLOClassError)
from .kvcache import PagedBatcher  # noqa: F401
from .metrics import Metrics  # noqa: F401
from .profile import StepProfiler  # noqa: F401
from .serving import (ContinuousBatcher, Request,  # noqa: F401
                      RequestOptions, ServingConfig)
from .tracing import (MetricsSnapshotter, TraceConfig,  # noqa: F401
                      Tracer, span_coverage)
