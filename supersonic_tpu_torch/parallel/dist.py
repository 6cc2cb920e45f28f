"""Distributed execution: hash-partitioned tables and an all-to-all shuffle
over ``torch.distributed``.

Port of ``supersonic_tpu/parallel/dist.py`` (SURVEY.md §2.9, §5.8:
Supersonic documents the pregroup -> shuffle -> combine contract,
aggregate.h:233-246, and ships a disk-spill exchange).  Every public
function keeps its JAX name and contract; the representation changes:

  * The JAX package holds one single-controller Table whose leaves are
    [P, cap] inside ``shard_map``.  Here each rank (one process, one card)
    holds its own local partition, an ordinary ``Table``, and every
    function is called on every rank with its own partition (SPMD).
  * The "mesh" (``Mesh``) holds the process group, its ``size``, this
    process's ``rank`` and its ``device``.
  * Collectives: ``lax.all_to_all`` -> ``all_to_all_single``, ``psum`` ->
    ``all_reduce``, ``ppermute`` around the ring -> ``batch_isend_irecv``,
    ``all_gather`` -> ``all_gather`` into one tensor.  Validity lanes move
    as uint8, which NCCL and gloo both carry.
  * The port is eager: an exchange overflow is all-reduced and raised on
    every rank at once (no debug callback), and a failure inside
    ``dist_map`` on one rank fails it on every rank, so no rank is left
    waiting in a later collective.

As in the JAX package, every rank's partition has the same capacity (each
operator's output capacity follows from its inputs' capacities), which the
collectives rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..batch import (Column, Table, concat_tables, gather_table,
                     pad_table)
from ..exprs.base import EvaluationError
from ..ops.aggregate import (AggregationSpecification, AggSpec, Aggregation,
                             BestEffortGroupAggregate, GroupAggregate,
                             GroupAggregateOptions)
from ..ops.base import (BindContext, RunContext, compile_plan,
                        prepare_leaves, raise_flags)
from ..ops.filter import compact_by_mask
from ..ops.hash_join import HashJoin, JoinType, KeyUniqueness, bind_fused
from ..ops.keys import group_code_columns, key_operands
from ..ops.scan import ScanTable
from ..ops.sort import Sort, SortOrder
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import torch_dtype
from .hashing import as_u32, hash_of_pairs, partition_of

AXIS = "x"  # the mesh's one axis (the JAX package's shard_map axis name)

_NO_HASH = 0xFFFFFFFF  # unused hot-key slot (a uint32 value)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of a 1-D mesh of ranks: the process group, its
    size, this rank and its device."""

    group: object
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the process group (``multihost.initialize`` joins it).
    ``device`` defaults to this rank's current card under NCCL and to the
    CPU under gloo.  ``n_devices``, when given, must be the group's size:
    a rank cannot leave a group it is in."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize first")
    group = dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"mesh of {n_devices} ranks asked in a process "
                         f"group of {size}")
    if device is None:
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, size, dist.get_rank(group), device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    """A lane as the collectives carry it: bool as uint8."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(torch.bool) if dtype == torch.bool else t


def _all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Equal split of ``x`` ([P * k]) into P blocks, block p to rank p;
    returns the P received blocks in source order."""
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group)
    return _unwire(out, x.dtype)


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each), concatenated in rank order."""
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _unwire(torch.cat(parts), x.dtype)


def _all_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _agree(mesh: Mesh, err: Optional[BaseException]) -> None:
    """Fail on every rank when any rank failed: the failing rank re-raises
    its own error, the others raise an EvaluationError with its text."""
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int64,
                        device=mesh.device)
    if int(_all_sum(mesh, flag).item()) == 0:
        return
    texts = [None] * mesh.size
    dist.all_gather_object(texts, None if err is None else str(err),
                           group=mesh.group)
    if err is not None:
        raise err
    first = next(t for t in texts if t is not None)
    raise EvaluationError(first)


# ---------------------------------------------------------------------------
# distributed-table construction
# ---------------------------------------------------------------------------

def distribute_table(table: Table, mesh: Mesh,
                     keys: Optional[Sequence[str]] = None,
                     cap_per_shard: Optional[int] = None) -> Table:
    """This rank's partition of ``table`` (called on every rank with the
    same table): round-robin, or by key hash (``partition_of``) when
    ``keys`` are given, at the JAX package's capacity rule.  The rows keep
    their order; the partition lies on the mesh's device.  Like a JAX
    shard, it carries no planner statistics."""
    P_ = mesh.size
    n = int(table.num_rows)
    if keys:
        h = hash_of_pairs(group_code_columns(table, list(keys)))
        dest = partition_of(h, P_)[:n]
    else:
        dest = (torch.arange(n, device=table.device) % P_).to(torch.int32)
    sorted_dest, order = torch.sort(dest, stable=True)
    offs = _run_bounds(sorted_dest, P_).cpu()
    counts = offs[1:] - offs[:-1]
    cap = cap_per_shard or max(1, -(-table.capacity // P_) * 2)
    if n and int(counts.max()) > cap:
        cap = int(counts.max())
    sel = order[offs[mesh.rank]:offs[mesh.rank + 1]]
    k = int(counts[mesh.rank])
    cols = {}
    for a in table.schema:
        c = table.columns[a.name]
        vals = torch.zeros(cap, dtype=c.values.dtype, device=mesh.device)
        vals[:k] = c.values[sel].to(mesh.device)
        valid = None
        if c.valid is not None:
            valid = torch.zeros(cap, dtype=torch.bool, device=mesh.device)
            valid[:k] = c.valid[sel].to(mesh.device)
        cols[a.name] = Column(vals, valid)
    return Table(table.schema, cols, k, mesh.device, dict(table.dicts),
                 cap_hint=cap)


def collect_table(dist_table: Table, mesh: Optional[Mesh] = None) -> Table:
    """Every rank's partition gathered into one Table on every rank, in
    rank order (the JAX package's shard-major order)."""
    mesh = mesh or make_mesh()
    local = dist_table
    dev = mesh.device
    n = torch.as_tensor(local.num_rows, device=dev).reshape(1).to(torch.int64)
    counts = _all_gather(mesh, n)
    cap = local.capacity
    cols = {}
    for a in local.schema:
        c = local.columns[a.name]
        cols[a.name] = Column(
            _all_gather(mesh, c.values.to(dev)),
            None if c.valid is None else _all_gather(mesh, c.valid.to(dev)))
    pos = torch.arange(mesh.size * cap, device=dev)
    live = (pos % cap) < counts[pos // cap]
    whole = Table(local.schema, cols, 0, dev, dict(local.dicts),
                  cap_hint=mesh.size * cap)
    return compact_by_mask(whole, live)


# ---------------------------------------------------------------------------
# per-rank plans
# ---------------------------------------------------------------------------

def dist_map(mesh: Mesh, fn: Callable[..., Table],
             *dist_tables: Table) -> Table:
    """Apply a local-table function to this rank's partitions (the
    embarrassingly parallel operators: filter, project, compute, a local
    pregroup).  A failure on any rank fails the call on every rank."""
    out, err = None, None
    try:
        out = fn(*dist_tables)
    except Exception as e:  # re-raised on every rank by _agree
        err = e
    _agree(mesh, err)
    return out


def run_local_plan(plan_builder: Callable[[Table], "object"],
                   table: Table) -> Table:
    """Build and run a single-card plan over one local table.  Its error
    flags are read back at its end and raise ``EvaluationError("evaluation
    failed on a shard: ...")`` ("warning:" flags warn), as
    ``ops/base.py::execute`` raises; deferred host work (CONCAT, unbounded
    rendering) cannot run inside a distributed plan and raises
    ``SchemaError``.  The result is padded to the plan's bound capacity,
    the same on every rank: a join that compacts its output sizes it by
    its own survivors, and the collectives need equal capacities."""
    run, bound, leaves = compile_plan(plan_builder(table))
    out, flags, names = run(prepare_leaves(leaves, run.lazy))
    if run.deferred:
        raise SchemaError(
            "deferred host materialization (CONCAT aggregation / "
            "unbounded ToString/Format/DateFormat rendering) cannot run "
            "inside a distributed plan shard; compute it locally after "
            "collect_table, or use the ops.host helpers")
    try:
        raise_flags(flags, names, run.spies)
    except EvaluationError as e:
        raise EvaluationError(str(e).replace(
            "evaluation failed:", "evaluation failed on a shard:", 1)) \
            from None
    return pad_table(out, bound.capacity)


# ---------------------------------------------------------------------------
# the exchange: per-destination gathers + all_to_all
# ---------------------------------------------------------------------------

def _default_peer_cap(shard_cap: int, num_parts: int,
                      skew_factor: int = 2, floor: int = 128) -> int:
    """Per-peer exchange buffer size when the caller gives none: the
    uniform-hash share (shard_cap / P) times a skew safety factor,
    hard-capped at shard_cap (a source shard can never send more rows to
    one peer than it holds — so dist_sort's factor 2P degrades to the
    overflow-proof exact bound).  A shuffle that still overflows raises
    (ERROR_MEMORY_EXCEEDED semantics, reference: memory.h:465) rather
    than dropping rows — callers pass an explicit ``out_cap_per_peer``
    to size for known-skewed keys.  The receive buffer (and every
    downstream operator's padded capacity) is P x this value, so the
    factor trades skew headroom directly against downstream compute."""
    base = -(-int(shard_cap) // max(num_parts, 1))
    return max(floor, min(base * skew_factor, int(shard_cap)))


def _run_bounds(sorted_dest: torch.Tensor, num_parts: int) -> torch.Tensor:
    """[P + 1] int64: where each destination's run starts in ascending
    ``sorted_dest``, and where destination P (rows sent nowhere) starts.
    A search of the sorted lanes, in place of a histogram pass (CUDA's
    histogram of a few bins serializes on its atomics)."""
    return torch.searchsorted(sorted_dest, torch.arange(
        num_parts + 1, dtype=sorted_dest.dtype, device=sorted_dest.device))


def _exchange_local(local: Table, dest: torch.Tensor, mesh: Mesh,
                    out_cap_per_peer: int):
    """Route this rank's rows to their destinations.

    Radix shuffle (SURVEY.md §5.8): the rows are ordered by destination
    (one stable sort), sliced into ``out_cap_per_peer`` send buffers at
    each destination's run start (one gather of every lane), exchanged with
    ``all_to_all_single``, and the received rows (source-major) compacted
    into a dense prefix by the compaction kernel.  A destination of P
    sends the row nowhere.  Returns ``(received table, dropped, sent)``:
    ``dropped`` is the 0-d count of rows this rank could NOT send because
    a per-peer buffer was full (the capacity exhaustion the reference
    raises as ERROR_MEMORY_EXCEEDED, memory.h:465, aggregate_groups.cc:
    420-427; ``shuffle`` all-reduces and raises it), ``sent`` the [P] rows
    sent to each peer.
    """
    P_ = mesh.size
    dev = local.device
    cap = local.capacity
    dest = torch.where(local.row_mask(), dest.to(torch.int32), P_)
    sorted_dest, perm = torch.sort(dest, stable=True)
    bounds = _run_bounds(sorted_dest, P_)
    counts = bounds[1:] - bounds[:-1]
    offsets = bounds[:-1]
    k = torch.arange(out_cap_per_peer, device=dev)
    send_pos = offsets[:, None] + k[None, :]               # [P, out_cap]
    send_valid = (k[None, :] < counts[:, None]).reshape(-1)
    send_idx = perm[send_pos.clamp(0, cap - 1).reshape(-1)].to(torch.int32)
    sent = torch.minimum(counts, torch.full_like(counts, out_cap_per_peer))
    dropped = (counts - sent).sum()
    recv_counts = _all_to_all(mesh, sent)
    recv_mask = (k[None, :] < recv_counts[:, None]).reshape(-1)
    flat_cap = P_ * out_cap_per_peer
    send = gather_table(local, send_idx, flat_cap)
    cols = {}
    for name in local.schema.names():
        c = send.columns[name]
        valid = None
        if c.valid is not None:
            valid = _all_to_all(mesh, c.valid & send_valid) & recv_mask
        cols[name] = Column(_all_to_all(mesh, c.values), valid)
    recv = Table(local.schema, cols, recv_counts.sum(), dev,
                 dict(local.dicts), cap_hint=flat_cap)
    return compact_by_mask(recv, recv_mask, flat_cap), dropped, sent


def _raise_overflow(lost: int) -> None:
    raise EvaluationError(
        f"distributed exchange overflow: {lost} rows exceeded "
        "out_cap_per_peer (ERROR_MEMORY_EXCEEDED; raise "
        "out_cap_per_peer or repartition skewed keys)")


def check_exchange_overflow(dropped) -> None:
    """Host sync for the exchange's dropped-row counts: raise like the
    single-card error-flag path (ops/base.py::execute) instead of
    returning silently wrong results.  ``dropped`` is a tensor, array or
    int of counts (any shape; ``shuffle(check=False)`` gives the count
    all-reduced over the ranks)."""
    lost = int(torch.as_tensor(dropped).sum().item())
    if lost:
        _raise_overflow(lost)


def table_row_bytes(schema: TupleSchema) -> int:
    """Wire bytes per exchanged row: each column's lane bytes on the
    device plus one uint8 validity byte per nullable column (the tensors
    ``all_to_all_single`` moves; a UINT32 column rides an int64 lane)."""
    total = 0
    for a in schema:
        total += torch.empty(0, dtype=torch_dtype(a.type)).element_size()
        if a.nullable:
            total += 1
    return total


def shuffle(mesh: Mesh, dist_table: Table,
            dest_fn: Callable[[Table], torch.Tensor],
            out_cap_per_peer: Optional[int] = None,
            check: bool = True, stats_out: Optional[dict] = None):
    """Distributed radix shuffle: ``dest_fn`` gives each local row a
    partition.

    Overflow-safe: per-peer buffer exhaustion raises ``EvaluationError``
    on every rank (``check=True``, the default) rather than dropping
    rows.  With ``check=False`` returns ``(table, dropped)``, ``dropped``
    the 0-d count all-reduced over the ranks, so a caller can defer the
    host sync (``check_exchange_overflow``).

    ``stats_out``: pass a dict to receive MEASURED exchange accounting
    (the reference's metric discipline, benchmark/proto/benchmark.proto):
    ``sent_rows`` [P, P] (src -> dst live row counts), ``row_bytes``,
    ``total_bytes``, and ``offmesh_bytes`` (excluding the src == dst
    diagonal, the share that actually crosses the interconnect)."""
    num_parts = mesh.size
    out_cap_per_peer = out_cap_per_peer or _default_peer_cap(
        dist_table.capacity, num_parts)
    recv, dropped, sent = _exchange_local(
        dist_table, dest_fn(dist_table), mesh, out_cap_per_peer)
    dropped = _all_sum(mesh, dropped.reshape(1).to(torch.int64))[0]
    if stats_out is not None:
        m = _all_gather(mesh, sent).cpu().numpy().reshape(num_parts,
                                                          num_parts)
        rb = table_row_bytes(dist_table.schema)
        stats_out["sent_rows"] = m
        stats_out["row_bytes"] = rb
        stats_out["total_bytes"] = int(m.sum()) * rb
        stats_out["offmesh_bytes"] = int(m.sum() - np.trace(m)) * rb
    if not check:
        return recv, dropped
    check_exchange_overflow(dropped)
    return recv


def _key_dest_fn(names: list[str], num_parts: int):
    def dest(local: Table) -> torch.Tensor:
        return partition_of(hash_of_pairs(group_code_columns(local, names)),
                            num_parts)
    return dest


# ---------------------------------------------------------------------------
# distributed operators
# ---------------------------------------------------------------------------

def combine_specification(spec: AggregationSpecification,
                          ) -> AggregationSpecification:
    """Partial-aggregate merge algebra (reference: aggregate_groups.cc:
    545-553 — COUNT combines via SUM; MIN/MAX idempotent; SUM associative;
    FIRST/LAST partition-order-defined)."""
    out = AggregationSpecification()
    for s in spec.specs:
        agg = s.aggregation
        if agg == Aggregation.CONCAT:
            raise SchemaError(
                "CONCAT partial aggregates cannot be combined across "
                "partitions (order-sensitive, variable-length); compute "
                "CONCAT after collecting, or via ops.host.group_concat")
        if agg == Aggregation.COUNT:
            out.add(AggSpec(Aggregation.SUM, s.output, s.output,
                            s.output_type or None))
        else:
            out.add(AggSpec(agg, s.output, s.output, s.output_type))
    return out


class _UnorderedBind:
    """Binds a group-by without its insertion-order re-rank: the shuffle
    that follows erases the pregroup's row order anyway."""

    def __init__(self, inner):
        self.inner = inner

    def bind(self, ctx):
        return self.inner.bind(ctx, _unordered=True)


def dist_group_aggregate(mesh: Mesh, dist_table: Table,
                         group_by: Sequence[str], spec,
                         options: GroupAggregateOptions | None = None,
                         out_cap_per_peer: Optional[int] = None) -> Table:
    """pregroup -> shuffle by key hash -> final combine
    (the BestEffortGroupAggregate distributed contract,
    aggregate.h:233-246)."""
    if not isinstance(spec, AggregationSpecification):
        spec = AggregationSpecification(spec)
    options = options or GroupAggregateOptions()
    num_parts = mesh.size
    names = list(group_by)

    if any(s.distinct for s in spec.specs):
        # raw shuffle then exact local aggregate (distinct can't pre-merge)
        shuffled = shuffle(mesh, dist_table, _key_dest_fn(names, num_parts),
                           out_cap_per_peer)
        return dist_map(
            mesh,
            lambda t: run_local_plan(
                lambda tt: GroupAggregate(names, spec, ScanTable(tt),
                                          options), t),
            shuffled)

    # the pregroup is best-effort: under a memory_quota it emits partial
    # (non-key-unique) groups instead of raising, and the final combine
    # re-aggregates them exactly (aggregate.h:233-246)
    pre = dist_map(
        mesh,
        lambda t: run_local_plan(
            lambda tt: _UnorderedBind(
                BestEffortGroupAggregate(names, spec, ScanTable(tt),
                                         options)), t),
        dist_table)
    shuffled = shuffle(mesh, pre, _key_dest_fn(names, num_parts),
                       out_cap_per_peer)
    final_spec = combine_specification(spec)
    # the quota bounds the per-rank pregroup; the final combine must hold
    # every key of its partition exactly
    final_options = dataclasses.replace(options, memory_quota=None)
    return dist_map(
        mesh,
        lambda t: run_local_plan(
            lambda tt: GroupAggregate(names, final_spec, ScanTable(tt),
                                      final_options), t),
        shuffled)


def dist_hash_join(mesh: Mesh, join_type: JoinType,
                   lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                   lhs: Table, rhs: Table,
                   rhs_key_uniqueness=KeyUniqueness.NOT_UNIQUE,
                   out_cap_per_peer: Optional[int] = None,
                   **join_kwargs) -> Table:
    """Partition both sides by key hash, then join locally (SURVEY.md
    §3.3).  The local join's error flags raise as ``run_local_plan``'s
    do."""
    num_parts = mesh.size
    lsh = shuffle(mesh, lhs, _key_dest_fn(list(lhs_keys), num_parts),
                  out_cap_per_peer)
    # build side: when it is ALREADY partitioned by the join key (the
    # common layout for a dimension table), every rank sends its whole
    # partition to ONE peer, so the build exchange defaults to the full
    # partition capacity (build sides are the small side by design)
    rsh = shuffle(mesh, rhs, _key_dest_fn(list(rhs_keys), num_parts),
                  out_cap_per_peer if out_cap_per_peer is not None
                  else rhs.capacity)
    return dist_map(mesh, lambda lt, rt: run_local_plan(
        lambda _: HashJoin(join_type, list(lhs_keys), list(rhs_keys),
                           ScanTable(lt), ScanTable(rt), rhs_key_uniqueness,
                           **join_kwargs), lt), lsh, rsh)


def _masked_join(lt: Table, rt: Table, lkeys, rkeys):
    """INNER UNIQUE join of ``lt`` against ``rt`` at lt's capacity:
    (table, keep mask), nothing compacted."""
    plan = HashJoin(JoinType.INNER, lkeys, rkeys, ScanTable(lt),
                    ScanTable(rt), KeyUniqueness.UNIQUE)
    ctx = BindContext()
    _, run = bind_fused(plan, ctx)
    return run(RunContext(ctx.leaves))


def _rotate_start(mesh: Mesh, lanes: list[torch.Tensor]):
    """Post the ring rotation of ``lanes`` (to rank + 1, from rank - 1);
    returns (requests, receive buffers)."""
    nxt = (mesh.rank + 1) % mesh.size
    prv = (mesh.rank - 1) % mesh.size
    recv = [torch.empty_like(_wire(x)) for x in lanes]
    ops = []
    for x, r in zip(lanes, recv):
        ops.append(dist.P2POp(dist.isend, _wire(x), nxt, mesh.group))
        ops.append(dist.P2POp(dist.irecv, r, prv, mesh.group))
    return dist.batch_isend_irecv(ops), recv


def dist_hash_join_ring(mesh: Mesh, join_type: JoinType,
                        lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                        lhs: Table, rhs: Table) -> Table:
    """Ring-pipelined join for a UNIQUE build side: probe rows stay put;
    the build partitions rotate around the ring with ``batch_isend_irecv``
    while each rank probes the partition it holds — the rotation of step
    k+1 is posted before the probe of step k runs, so the exchange
    overlaps the compute (SURVEY.md §5.8 ppermute pipelining).

    Avoids repartitioning the (large) probe side entirely: total traffic
    is P rotations of the build side only.  Output is lhs-shaped per
    rank: INNER compacts matched rows, LEFT_OUTER keeps every probe row
    with NULL rhs columns where no partition matched.
    """
    num_parts = mesh.size
    lkeys, rkeys = list(lhs_keys), list(rhs_keys)
    left_outer = join_type == JoinType.LEFT_OUTER
    lt, rt0 = lhs, rhs
    names = rt0.schema.names()
    # the rotating lanes: each column's values and validity, and num_rows
    lanes = []
    for n in names:
        c = rt0.columns[n]
        lanes.append(c.values)
        if c.valid is not None:
            lanes.append(c.valid)
    lanes.append(torch.as_tensor(rt0.num_rows, device=rt0.device)
                 .reshape(1).to(torch.int64))

    def as_table(lanes):
        it = iter(lanes)
        cols = {}
        for n in names:
            vals = next(it)
            cols[n] = Column(vals, next(it) if rt0.columns[n].valid
                             is not None else None)
        return Table(rt0.schema, cols, next(it)[0], rt0.device,
                     dict(rt0.dicts), cap_hint=rt0.capacity)

    def valid_or_true(c):
        return c.valid if c.valid is not None else \
            torch.ones_like(c.values, dtype=torch.bool)

    acc, matched = None, None
    for step in range(num_parts):
        reqs, nxt = ((), None)
        if step < num_parts - 1:
            reqs, nxt = _rotate_start(mesh, lanes)
        out, keep = _masked_join(lt, as_table(lanes), lkeys, rkeys)
        if acc is None:
            acc = {n: (out.columns[n].values, valid_or_true(out.columns[n]))
                   for n in names}
            matched = keep
        else:
            new = keep & ~matched
            acc = {n: (torch.where(new, out.columns[n].values, acc[n][0]),
                       torch.where(new, valid_or_true(out.columns[n]),
                                   acc[n][1]))
                   for n in names}
            matched = matched | keep
        for r in reqs:
            r.wait()
        if nxt is not None:
            lanes = [_unwire(r, x.dtype) for r, x in zip(nxt, lanes)]

    attrs = list(lt.schema) + [
        Attribute(a.name, a.type, a.nullable or left_outer, a.enum)
        for a in rt0.schema]
    cols = dict(lt.columns)
    for a in rt0.schema:
        vals, valid = acc[a.name]
        if left_outer:
            cols[a.name] = Column(vals, valid & matched)
        else:
            cols[a.name] = Column(vals, valid if a.nullable else None)
    keep_rows = lt.row_mask() if left_outer else matched
    out = Table(TupleSchema(attrs), cols, keep_rows.sum(), lt.device,
                {**lt.dicts, **rt0.dicts}, cap_hint=lt.capacity)
    return compact_by_mask(out, keep_rows, lt.capacity)


def _hot_key_hashes(local: Table, keys: list[str], mesh: Mesh,
                    top_h: int, min_count: int) -> torch.Tensor:
    """Globally agreed hot key hashes (int64 uint32 values [top_h];
    0xFFFFFFFF = unused).

    Each rank finds its top-H most frequent key hashes by sorted run
    lengths, all-gathers the candidates, combines counts, and keeps keys
    whose global count reaches ``min_count``.  Deterministic and identical
    on every rank (skew detection per BASELINE north star).
    """
    dev = local.device
    h = as_u32(hash_of_pairs(group_code_columns(local, keys)))
    h = torch.where(local.row_mask(), h, _NO_HASH)
    runs, lengths = torch.unique_consecutive(torch.sort(h).values,
                                             return_counts=True)
    lengths = torch.where(runs == _NO_HASH, 0, lengths)
    order = torch.sort(-lengths, stable=True).indices[:top_h]
    cand_h = torch.full((top_h,), _NO_HASH, dtype=torch.int64, device=dev)
    cand_c = torch.zeros(top_h, dtype=torch.int64, device=dev)
    cand_h[:order.shape[0]] = runs[order]
    cand_c[:order.shape[0]] = lengths[order]
    all_h = _all_gather(mesh, cand_h)                       # [P * H]
    all_c = _all_gather(mesh, cand_c)
    # combine counts for identical hashes (tiny O((PH)^2) compare)
    eq = all_h[:, None] == all_h[None, :]
    totals = torch.where(eq, all_c[None, :], 0).sum(1)
    first = torch.argmax(eq.to(torch.int32), 1) == torch.arange(
        all_h.shape[0], device=dev)
    totals = torch.where(first & (all_h != _NO_HASH), totals, 0)
    sel = torch.sort(-totals, stable=True).indices[:top_h]
    return torch.where(totals[sel] >= min_count, all_h[sel], _NO_HASH)


def dist_hash_join_skew(mesh: Mesh, join_type: JoinType,
                        lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                        lhs: Table, rhs: Table,
                        rhs_key_uniqueness=KeyUniqueness.NOT_UNIQUE,
                        out_cap_per_peer: Optional[int] = None,
                        hot_cap: int = 1024, top_h: int = 16,
                        min_frac: float = 0.01, **join_kwargs) -> Table:
    """Skew-aware repartition join (BASELINE north star): keys hot enough
    to overwhelm one rank are detected from per-rank histograms; their
    BUILD rows are broadcast to every rank and their PROBE rows stay
    local, while cold keys take the normal hash shuffle."""
    num_parts = mesh.size
    lcap = out_cap_per_peer or _default_peer_cap(lhs.capacity, num_parts)
    rcap = out_cap_per_peer or _default_peer_cap(rhs.capacity, num_parts)
    lkeys, rkeys = list(lhs_keys), list(rhs_keys)
    n = torch.as_tensor(lhs.num_rows, device=mesh.device)
    total_rows = int(_all_sum(mesh, n.reshape(1).to(torch.int64)).item())
    min_count = max(int(total_rows * min_frac), 2)

    # probe side: hot rows stay on this rank, cold rows go by hash
    hot = _hot_key_hashes(lhs, lkeys, mesh, top_h, min_count)
    h = hash_of_pairs(group_code_columns(lhs, lkeys))
    is_hot = (as_u32(h)[:, None] == hot[None, :]).any(1)
    dest = torch.where(is_hot, mesh.rank, partition_of(h, num_parts))
    lt, l_dropped, _ = _exchange_local(lhs, dest, mesh, lcap)

    # build side: cold rows by hash (hot rows excluded from the exchange
    # on purpose), hot rows compacted and all-gathered to every rank
    h = hash_of_pairs(group_code_columns(rhs, rkeys))
    is_hot = (as_u32(h)[:, None] == hot[None, :]).any(1) & rhs.row_mask()
    dest = torch.where(is_hot, num_parts, partition_of(h, num_parts))
    cold, r_dropped, _ = _exchange_local(rhs, dest, mesh, rcap)
    hot_local = compact_by_mask(rhs, is_hot, hot_cap)
    counts = _all_gather(mesh, torch.as_tensor(
        hot_local.num_rows, device=mesh.device).reshape(1).to(torch.int64))
    cols = {}
    for name in rhs.schema.names():
        c = hot_local.columns[name]
        cols[name] = Column(_all_gather(mesh, c.values),
                            None if c.valid is None
                            else _all_gather(mesh, c.valid))
    gcap = num_parts * hot_cap
    gpos = torch.arange(gcap, device=mesh.device)
    live_g = (gpos % hot_cap) < counts[gpos // hot_cap]
    hot_all = Table(rhs.schema, cols, counts.sum(), mesh.device,
                    dict(rhs.dicts), cap_hint=gcap)
    rt = concat_tables([cold, compact_by_mask(hot_all, live_g, gcap)])
    # hot rows beyond hot_cap would be silently truncated by the
    # compaction above — count them as overflow too
    r_dropped = r_dropped + (is_hot.sum() - hot_cap).clamp(min=0)
    check_exchange_overflow(_all_sum(
        mesh, (l_dropped + r_dropped).reshape(1).to(torch.int64)))
    return dist_map(mesh, lambda lt, rt: run_local_plan(
        lambda _: HashJoin(join_type, lkeys, rkeys, ScanTable(lt),
                           ScanTable(rt), rhs_key_uniqueness, **join_kwargs),
        lt), lt, rt)


def _lex_sorted(lanes: list[torch.Tensor]) -> list[torch.Tensor]:
    """The lanes reordered by ascending lexicographic order of the row
    tuples (first lane most significant): stable sorts from the last lane
    to the first."""
    perm = torch.arange(lanes[0].shape[0], device=lanes[0].device)
    for lane in reversed(lanes):
        perm = perm[torch.sort(lane[perm], stable=True).indices]
    return [lane[perm] for lane in lanes]


def dist_sort(mesh: Mesh, dist_table: Table, order,
              samples_per_shard: int = 64,
              out_cap_per_peer: Optional[int] = None) -> Table:
    """Distributed sample sort: sample keys -> all_gather -> splitters ->
    range shuffle -> local sort.  The result is globally sorted in rank
    order (rank p holds keys <= rank p+1's), so ``collect_table`` gives
    the sorted rows."""
    order = order if isinstance(order, SortOrder) else SortOrder(order)
    num_parts = mesh.size
    names, ascs = order.names(), order.ascendings()
    # range-partitioned rows concentrate by key range, not hash: size for
    # a whole partition's rows landing on one peer when keys are clustered
    peer_cap = out_cap_per_peer or _default_peer_cap(
        dist_table.capacity, num_parts, skew_factor=2 * num_parts)

    def dest_fn(local: Table) -> torch.Tensor:
        ops = key_operands(local, names, ascs)
        cap = local.capacity
        dev = local.device
        # a local sort of the key tuples, to draw evenly spaced samples
        sorted_ops = _lex_sorted(ops)
        n = torch.as_tensor(local.num_rows, device=dev).clamp(min=1)
        take_at = (torch.arange(samples_per_shard, device=dev) * n
                   ) // samples_per_shard
        take_at = take_at.clamp(0, cap - 1)
        gathered = [_all_gather(mesh, o[take_at]) for o in sorted_ops]
        g_sorted = _lex_sorted(gathered)
        total = num_parts * samples_per_shard
        split_at = (torch.arange(1, num_parts, device=dev) * total
                    ) // num_parts
        splitters = [g[split_at] for g in g_sorted]
        # dest = number of splitters strictly less than the row's key tuple
        dest = torch.zeros(cap, dtype=torch.int32, device=dev)
        for i in range(num_parts - 1):
            lt = torch.zeros(cap, dtype=torch.bool, device=dev)
            eq = torch.ones(cap, dtype=torch.bool, device=dev)
            for s, o in zip(splitters, ops):
                lt = lt | (eq & (s[i] < o))
                eq = eq & (s[i] == o)
            dest = dest + lt.to(torch.int32)
        return dest

    shuffled = shuffle(mesh, dist_table, dest_fn, peer_cap)
    return dist_map(
        mesh,
        lambda t: run_local_plan(lambda tt: Sort(order, ScanTable(tt)), t),
        shuffled)
