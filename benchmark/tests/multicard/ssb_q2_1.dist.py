"""SSB Q2.1 on the ranks of a mesh (the one-card plan is
queries/ssb_q2_1.py): each rank joins its share of lineorder with the
replicated part, supplier and date tables and pregroups the rows it keeps;
the groups are shuffled by key and combined (``dist_group_aggregate``),
gathered (``collect_table``) and sorted on rank 0, which returns them.  As
in the one-card plan, at most 7 x 40 groups: the groups' capacity, so that
the exchange and rank 0's Sort are sized by the groups and not by the fact
table's share."""
from queries.ssb_common import joined, s


def dist_answer(T, mesh, tables, p):
    par = T.parallel
    joins = [
        ("part", "lo_partkey", "p_partkey",
         T.col("p_category").eq(s(T, p["category"])), ["p_brand1"]),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_region").eq(s(T, p["region"])), []),
        ("date", "lo_orderdate", "d_datekey", None, ["d_year"]),
    ]
    kept = par.dist_map(mesh, lambda share: par.run_local_plan(
        lambda t: joined(T, {**tables, "lineorder": t}, None, joins,
                         ["lo_revenue"]), share), tables["lineorder"])
    groups = par.dist_group_aggregate(
        mesh, kept, ["d_year", "p_brand1"],
        [T.AggSpec(T.Aggregation.SUM, "lo_revenue", "revenue",
                   output_type=T.INT64)],
        T.GroupAggregateOptions(estimated_result_row_count=7 * 40))
    whole = par.collect_table(groups, mesh)
    if mesh.rank != 0:
        return None
    return T.execute(T.Sort([T.SortKey("d_year", ascending=True),
                             T.SortKey("p_brand1", ascending=True)],
                            T.ScanTable(whole)))
