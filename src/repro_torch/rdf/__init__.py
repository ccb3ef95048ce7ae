"""RDF substrate: HDT-style triple store and data generators.

- :mod:`repro_torch.rdf.store`   — sorted-index triple store (PSO/POS
  orders, per-predicate CSR, composite int64 keys for batched binary
  search), with a torch device view.
- :mod:`repro_torch.rdf.watdiv`  — WatDiv-like synthetic knowledge-graph
  generator (Aluc et al., ISWC 2014) used by the paper's evaluation.
- :mod:`repro_torch.rdf.queries` — query-load generator: 1-star / 2-stars /
  3-stars / paths / union loads as in the paper's Section 6.
"""

from repro_torch.rdf.store import TripleStore
from repro_torch.rdf.watdiv import WatDivConfig, generate_watdiv
from repro_torch.rdf.queries import QueryLoadConfig, generate_query_load

__all__ = [
    "TripleStore",
    "WatDivConfig",
    "generate_watdiv",
    "QueryLoadConfig",
    "generate_query_load",
]
