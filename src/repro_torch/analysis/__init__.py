"""Static verification subsystem: stream/plan verifier + repo-rule linter.

Two pillars (see ``python -m repro_torch.analysis --help``):

* :mod:`repro_torch.analysis.verify` — an encoder-independent checker that
  proves the Serpens stream invariants (RAW window, segment monotonicity,
  sentinel legality, spill consistency, round-trip, ...) over any
  :class:`~repro_torch.core.format.SerpensMatrix` or
  :class:`~repro_torch.core.partition.ChannelShardPlan`, reporting structured
  :class:`~repro_torch.analysis.diagnostics.Diagnostics`.
* :mod:`repro_torch.analysis.lint` — an AST linter for the
  concurrency/packing contracts this repo has shipped bugs against, with
  per-line ``# repro-lint: disable=<rule>`` suppressions.

Numpy-only at import (no torch): safe to run in encode workers.  The
PyTorch port's own copy of the reference package's analysis tools.
"""
from repro_torch.analysis.diagnostics import Diagnostic, Diagnostics
from repro_torch.analysis.lint import lint_paths, lint_source
from repro_torch.analysis.verify import (FULL_ONLY_RULES, VERIFIER_RULES,
                                         VERIFY_MODES, VerificationError,
                                         verify_matrix, verify_plan)

__all__ = [
    "Diagnostic", "Diagnostics", "VerificationError",
    "VERIFY_MODES", "VERIFIER_RULES", "FULL_ONLY_RULES",
    "verify_matrix", "verify_plan", "lint_paths", "lint_source",
]
