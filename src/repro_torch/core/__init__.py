"""The paper's primary contribution: the Star Pattern Fragments interface.

- :mod:`repro_torch.core.patterns`  — pattern algebra + star decomposition
  (Def. 7)
- :mod:`repro_torch.core.bindings`  — fixed-capacity solution-mapping
  tables
- :mod:`repro_torch.core.server`    — seeded star / triple-pattern
  evaluation (Def. 5)
- :mod:`repro_torch.core.engine`    — the four interfaces (TPF / brTPF /
  SPF / endpoint) with the paper's NRS / NTB / load accounting
- :mod:`repro_torch.core.capacity`  — degree-based capacity planning
- :mod:`repro_torch.core.stepper`   — the serial unit step, reseat and the
  host cost account
- :mod:`repro_torch.core.oracle`    — brute-force ground truth (tests)
"""

from repro_torch.core.patterns import (
    BGP,
    C,
    StarPattern,
    Term,
    TriplePattern,
    V,
    bgp_from_tuples,
    count_stars,
    star_decomposition,
)
from repro_torch.core.capacity import CapacityPlanner
from repro_torch.core.engine import (
    INTERFACES,
    EngineConfig,
    QueryEngine,
    QueryStats,
    results_as_numpy,
)

__all__ = [
    "BGP", "C", "StarPattern", "Term", "TriplePattern", "V",
    "bgp_from_tuples", "count_stars", "star_decomposition",
    "INTERFACES", "EngineConfig", "QueryEngine", "QueryStats",
    "results_as_numpy", "CapacityPlanner",
]
