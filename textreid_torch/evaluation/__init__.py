from .metrics import (
    evaluation,
    format_results_table,
    get_unique_indices,
    k_reciprocal,
    rank,
)

__all__ = ["evaluation", "format_results_table", "get_unique_indices",
           "k_reciprocal", "rank"]
