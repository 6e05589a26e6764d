"""Registry of repo lint rules (see :mod:`repro_torch.analysis.lint`)."""
from repro_torch.analysis.rules.asserts import BareAssertRule
from repro_torch.analysis.rules.imports import WorkerImportRule
from repro_torch.analysis.rules.locking import (LockBlockingCallRule,
                                                StatLockRule)
from repro_torch.analysis.rules.mutation import FrozenMutationRule
from repro_torch.analysis.rules.queues import UnboundedQueueRule
from repro_torch.analysis.rules.spans import SpanContextRule

ALL_RULES = (
    WorkerImportRule(),
    LockBlockingCallRule(),
    StatLockRule(),
    SpanContextRule(),
    BareAssertRule(),
    FrozenMutationRule(),
    UnboundedQueueRule(),
)

__all__ = ["ALL_RULES", "WorkerImportRule", "LockBlockingCallRule",
           "StatLockRule", "SpanContextRule", "BareAssertRule",
           "FrozenMutationRule", "UnboundedQueueRule"]
