"""monetdb_tpu — a vectorized analytical query engine in JAX.

Built from scratch in JAX/XLA (Pallas for hot kernels) with the capabilities
of MonetDB's GDK column kernel and SQL stack (reference layout documented in
SURVEY.md). Columns are fixed-width device arrays with host descriptors;
operators are property-dispatched jitted kernels; queries run as a traced
operator DAG; distribution is SPMD sharding over a jax.sharding.Mesh.
"""

from . import config  # noqa: F401  (enables x64 before anything else)
from .column import Cand, Column, StrDict  # noqa: F401
from .dtypes import (BOOL, DATE, F32, F64, I8, I16, I32, I64, OID,  # noqa: F401
                     TIMESTAMP, SQLType, decimal, varchar)
from .table import Catalog, Table  # noqa: F401

__version__ = "0.1.0"
