"""SSB Q1.1 on the ranks of a mesh: each rank runs the one-card plan
(queries/ssb_q1_1.py) over its share of lineorder; the P partial sums are
gathered (``collect_table``) and summed on rank 0, which returns them."""
from queries.ssb_q1_1 import plan


def dist_answer(T, mesh, tables, p):
    par = T.parallel
    partial = par.dist_map(mesh, lambda share: par.run_local_plan(
        lambda t: plan(T, {**tables, "lineorder": t}, p), share),
        tables["lineorder"])
    whole = par.collect_table(partial, mesh)
    if mesh.rank != 0:
        return None
    return T.execute(T.ScalarAggregate(
        [T.AggSpec(T.Aggregation.SUM, "revenue", "revenue",
                   output_type=T.INT64)], T.ScanTable(whole)))
