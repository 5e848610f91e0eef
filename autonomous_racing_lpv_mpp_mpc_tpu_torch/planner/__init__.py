"""Planner outputs consumed by the tracker (the JAX package's ``planner/``;
only the reference tables are ported so far)."""

from .reftable import RefTable, refs_from_table

__all__ = ["RefTable", "refs_from_table"]
