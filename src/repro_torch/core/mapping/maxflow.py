"""Dinic max-flow fast path for the mapping ILP when fan-out is slack.

When constraint (7) does not bind (fanout_m >= |S_m| for all sources — the
common case after pruning, since the paper's fan-out limit models dispatch
bandwidth, not connectivity), the ILP reduces to a max-cardinality capacitated
assignment: neurons (cap 1 each) into engines (cap N each).  That problem's
constraint matrix is totally unimodular, so max-flow gives the certified ILP
optimum in O(E sqrt(V)) instead of branch-and-cut.  (The optimum is trivially
min(N1, M*N) here, but we keep the general flow machinery because the engine
graph becomes non-trivial once per-engine affinity restrictions are added —
see ``allowed``.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mapping.ilp import (MappingError, MappingProblem,
                                          MappingSolution,
                                          _expand_engines_to_caps)


class Dinic:
    def __init__(self, n: int):
        self.n = n
        self.head: list[list[int]] = [[] for _ in range(n)]
        self.to: list[int] = []
        self.cap: list[int] = []

    def add_edge(self, u: int, v: int, c: int) -> int:
        eid = len(self.to)
        self.head[u].append(eid)
        self.to.append(v)
        self.cap.append(c)
        self.head[v].append(eid + 1)
        self.to.append(u)
        self.cap.append(0)
        return eid

    def bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        q = [s]
        while q:
            nq = []
            for u in q:
                for eid in self.head[u]:
                    v = self.to[eid]
                    if self.cap[eid] > 0 and self.level[v] < 0:
                        self.level[v] = self.level[u] + 1
                        nq.append(v)
            q = nq
        return self.level[t] >= 0

    def dfs(self, u: int, t: int, f: int) -> int:
        if u == t:
            return f
        while self.it[u] < len(self.head[u]):
            eid = self.head[u][self.it[u]]
            v = self.to[eid]
            if self.cap[eid] > 0 and self.level[v] == self.level[u] + 1:
                d = self.dfs(v, t, min(f, self.cap[eid]))
                if d > 0:
                    self.cap[eid] -= d
                    self.cap[eid ^ 1] += d
                    return d
            self.it[u] += 1
        return 0

    def max_flow(self, s: int, t: int) -> int:
        flow = 0
        while self.bfs(s, t):
            self.it = [0] * self.n
            while True:
                f = self.dfs(s, t, 1 << 60)
                if f == 0:
                    break
                flow += f
        return flow


def max_flow_assignment(p: MappingProblem,
                        allowed: np.ndarray | None = None) -> MappingSolution:
    """Exact assignment via max-flow.  ``allowed[i, j]`` optionally restricts
    which engines neuron i may use (default: all).  Requires slack fan-out;
    asserts it."""
    p.validate()
    if not (p.fanout >= p.conn.sum(axis=1)).all():
        raise MappingError(
            "max-flow path requires slack fan-out; use the ILP solver")
    n1, m_eng = p.n_dest, p.n_engines
    if allowed is None:
        allowed = np.ones((n1, m_eng), dtype=bool)
    s, t = 0, 1
    neuron0, engine0 = 2, 2 + n1
    g = Dinic(2 + n1 + m_eng)
    edge_of = {}
    for i in range(n1):
        g.add_edge(s, neuron0 + i, 1)
        for j in range(m_eng):
            if allowed[i, j]:
                edge_of[(i, j)] = g.add_edge(neuron0 + i, engine0 + j, 1)
    for j in range(m_eng):
        g.add_edge(engine0 + j, t, p.n_caps)
    g.max_flow(s, t)
    engine = np.full(n1, -1, dtype=np.int64)
    for (i, j), eid in edge_of.items():
        if g.cap[eid] == 0:  # saturated forward edge = assignment
            engine[i] = j
    sol = _expand_engines_to_caps(p, engine)
    return dataclasses.replace(sol, solver="maxflow")
