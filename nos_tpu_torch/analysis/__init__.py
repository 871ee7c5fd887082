"""noslint: project-native static checks for the nos-tpu tree.

`python -m nos_tpu_torch.analysis` runs rules N001–N012 over
``nos_tpu_torch/`` and exits non-zero on any unsuppressed violation;
``tests/test_torch_analysis.py`` runs the same sweep in tier-1, so a rule
violation is a test failure.  N001–N006 are single-pass AST rules
(rules.py); N007–N010 ride the dataflow engine (dataflow.py: CFG,
def-use, inevitability, escape, cross-file symbol index —
rules_flow.py); N011–N012 certify determinism (rules_det.py), and
determinism.py is its dynamic half.  See docs/static-analysis.md
for the rule catalog, pragma grammar, and the ``@guarded_by`` cookbook,
and nos_tpu_torch/testing/lockcheck.py for the dynamic lock-order half.
"""

from .core import (
    FRAMEWORK_RULE, ModuleSource, Report, Rule, Violation, lint_source, run,
)
from .rules import default_rules
from .rules_flow import flow_rules

__all__ = [
    "FRAMEWORK_RULE", "ModuleSource", "Report", "Rule", "Violation",
    "default_rules", "flow_rules", "lint_source", "run",
]
