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
- :mod:`repro_torch.core.stepper`   — the serial unit step, the wave
  steps (lane-looped unit step, device digest, device replay), reseat,
  the host cost account, and the sharded-store unit evaluation with its
  k-way merge
- :mod:`repro_torch.core.scheduler` — concurrent query scheduler: mixed
  loads as signature-bucketed, cache-aware lane waves, with live writes
  at wave boundaries
- :mod:`repro_torch.core.fragcache` — shared star-fragment cache over
  canonicalized seeded unit requests (frequency-aware admission,
  negative-result side table, store-epoch invalidation and carry-over)
- :mod:`repro_torch.core.distributed` — the batched engine over a
  subject-hash-sharded store (shards as an axis on one card; the
  collectives are sums, lists and the k-way merge)
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
from repro_torch.core.fragcache import FragmentCache
from repro_torch.core.scheduler import (
    QueryScheduler,
    SchedulerConfig,
    interleave_clients,
)

__all__ = [
    "BGP", "C", "StarPattern", "Term", "TriplePattern", "V",
    "bgp_from_tuples", "count_stars", "star_decomposition",
    "INTERFACES", "EngineConfig", "QueryEngine", "QueryStats",
    "results_as_numpy", "CapacityPlanner", "FragmentCache",
    "QueryScheduler", "SchedulerConfig", "interleave_clients",
]
