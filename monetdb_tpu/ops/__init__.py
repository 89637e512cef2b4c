"""Operator kernel library — the device analog of the reference's GDK operator
set (gdk/gdk_select.c, gdk_join.c, gdk_group.c, gdk_aggr.c, gdk_calc*.c,
gdk_batop.c sorting, gdk_firstn.c, gdk_analytic*.c).

Every operator is a host-side wrapper that picks a strategy from column
properties (like the reference's cost models) and dispatches into cached
jitted kernels over bucketed-capacity device arrays.
"""

from . import select, calc, project, group, aggr, sort, join, window  # noqa: F401
