"""Query planning & execution — the re-imagining of the reference's
sql/server relational algebra (sql_rel), rel_optimizer passes, and the MAL
interpreter/dataflow engine (traced jitted operator DAG instead of an
interpreted VM)."""
