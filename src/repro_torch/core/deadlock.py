"""The statically-sequenced baseline and its deadlock analysis (paper Fig. 1).

``StaticOrderExecutor`` models the single-FIFO-queue programming model of
deadlock-prone GPU collectives (Fig. 1(a)): each rank enqueues collectives
in some order; a collective can only start when it reaches the queue head
on EVERY member rank simultaneously (gang start), and a rank's queue head
cannot be bypassed (no preemption, resource holding).  With inconsistent
orders the wait-for graph acquires a cycle and the system deadlocks — which
this module *detects and reports* instead of hanging.

This is both the correctness foil for the deadlock-freedom property tests
(any order set that deadlocks here must complete under OCCL) and the
"statically sequenced NCCL" comparator of the paper's Sec. 5 benchmarks
(when orders are consistent it completes with zero scheduling overhead).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StaticResult:
    deadlocked: bool
    completed: list[int]                 # collective ids, completion order
    blocked_at: dict[int, int] | None    # rank -> queue-head collective
    cycle: list[int] | None              # ranks forming a wait-for cycle


def run_static_order(
    orders: dict[int, list[int]],
    members_of: dict[int, list[int]],
) -> StaticResult:
    """Simulate single-FIFO-queue execution.

    orders: rank -> list of collective ids in issue order.
    members_of: collective id -> member ranks.
    """
    heads = {r: 0 for r in orders}
    completed: list[int] = []
    while True:
        progressed = False
        # A collective fires when it is at the head of every member rank.
        ready: list[int] = []
        for r, order in orders.items():
            if heads[r] >= len(order):
                continue
            c = order[heads[r]]
            if all(
                heads[m] < len(orders[m]) and orders[m][heads[m]] == c
                for m in members_of[c]
            ):
                if c not in ready:
                    ready.append(c)
        for c in ready:
            for m in members_of[c]:
                heads[m] += 1
            completed.append(c)
            progressed = True
        if not progressed:
            break

    blocked = {
        r: orders[r][heads[r]] for r in orders if heads[r] < len(orders[r])
    }
    if not blocked:
        return StaticResult(False, completed, None, None)
    cycle = _find_cycle(blocked, members_of, orders, heads)
    return StaticResult(True, completed, blocked, cycle)


def _find_cycle(blocked, members_of, orders, heads):
    """Wait-for graph: rank r (head collective c) waits on every member of
    c whose head is a different collective.  Returns one cycle if any."""
    graph: dict[int, list[int]] = {}
    for r, c in blocked.items():
        graph[r] = [
            m for m in members_of[c]
            if m != r and blocked.get(m) is not None and blocked[m] != c
        ]
    # DFS cycle detection.
    WHITE, GREY, BLACK = 0, 1, 2
    color = {r: WHITE for r in graph}
    stack: list[int] = []

    def dfs(u):
        color[u] = GREY
        stack.append(u)
        for v in graph.get(u, []):
            if color.get(v, WHITE) == GREY:
                return stack[stack.index(v):]
            if color.get(v, WHITE) == WHITE:
                got = dfs(v)
                if got:
                    return got
        stack.pop()
        color[u] = BLACK
        return None

    for r in graph:
        if color[r] == WHITE:
            got = dfs(r)
            if got:
                return got
    return None


def consistent_order_exists(orders: dict[int, list[int]],
                            members_of: dict[int, list[int]]) -> bool:
    """Whether the per-rank orders admit a deadlock-free static schedule
    (i.e. run_static_order drains everything)."""
    return not run_static_order(orders, members_of).deadlocked
