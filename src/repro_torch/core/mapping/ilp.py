"""ILP-based mapping of destination-layer neurons onto A-NEURON capacitors.

Paper §III-D, eqs. (3)-(7):

  variables   x_{i,j,k} ∈ {0,1}   — neuron i → capacitor k of A-NEURON j   (3)
  objective   min Σ_{i,j,k} (1 - x_{i,j,k})   ≡   max Σ x  (assigned count) (4)
  (5) engine capacity:       Σ_{i,k} x_{i,j,k} ≤ N            ∀ j
  (6) unique assignment:     Σ_{j,k} x_{i,j,k} ≤ 1            ∀ i
  (7) source fan-out:        Σ_{i∈S_m} Σ_{j,k} x_{i,j,k} ≤ fanout_m  ∀ m

Note on (6): the paper states "= 1" but simultaneously minimizes the number
of *unassigned* neurons, which is only meaningful when full assignment may be
infeasible (N1 > M*N, or fan-out limits bind).  We therefore use "≤ 1" and
maximize assignments — the paper's stated objective — and expose
``require_all`` to assert the "=1" reading when feasible.

Solvers:
  * ``solve_mapping_full_ilp``    — the literal x_{i,j,k} ILP via scipy HiGHS.
  * ``solve_mapping_reduced_ilp`` — capacitor symmetry removes k:
        y_{i,j} ∈ {0,1}, Σ_i y_{i,j} ≤ N, Σ_j y_{i,j} ≤ 1, fan-out as before.
    Equivalent optimum (capacitors within an engine are interchangeable:
    any y solution expands to an x solution by enumerating free capacitors,
    and any x solution projects to y).  Scales to real layers.
  * ``solve_mapping_greedy``      — the fast heuristic used online.
  * ``solve_mapping_bruteforce``  — exhaustive, for tiny test instances.
  * maxflow (see maxflow.py)      — exact when fan-out constraints are slack.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import warnings

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp


class MappingError(RuntimeError):
    """A mapping could not be produced or violates the paper's constraints.

    Raised — never ``assert``-ed, so ``python -O`` cannot strip the check —
    when a solver returns no feasible incumbent, when a solution fails
    :meth:`MappingSolution.check`, or when ``map_model`` cannot fit a layer
    (SRAM budget, unassignable neurons)."""


@contextlib.contextmanager
def _quiet_cstdout():
    """Silence HiGHS's C++ stdout chatter (incumbent-improvement spam when a
    time limit binds) without touching Python-level stdout semantics."""
    try:
        fd = os.dup(1)
    except OSError:
        yield
        return
    try:
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 1)
        os.close(devnull)
        yield
    finally:
        os.dup2(fd, 1)
        os.close(fd)


@dataclasses.dataclass(frozen=True)
class MappingProblem:
    """One layer's mapping instance.

    n_dest:     N1 — neurons in the destination layer (to be assigned)
    n_engines:  M  — A-NEURON engines in the MX-NEURACORE
    n_caps:     N  — capacitors (virtual neurons) per A-NEURON
    conn:       bool[n_src, n_dest] — synaptic connectivity (pruned weights != 0);
                S_m = {i : conn[m, i]}
    fanout:     int[n_src] — per-source fan-out limits (constraint (7))
    """

    n_dest: int
    n_engines: int
    n_caps: int
    conn: np.ndarray
    fanout: np.ndarray

    @property
    def n_src(self) -> int:
        return self.conn.shape[0]

    def validate(self) -> None:
        if self.conn.shape != (self.n_src, self.n_dest):
            raise ValueError(f"conn shape {self.conn.shape} != "
                             f"({self.n_src}, {self.n_dest})")
        if self.fanout.shape != (self.n_src,):
            raise ValueError(f"fanout shape {self.fanout.shape} != "
                             f"({self.n_src},)")

    @staticmethod
    def from_weights(w: np.ndarray, n_engines: int, n_caps: int,
                     fanout: np.ndarray | int | None = None) -> "MappingProblem":
        """Build from a (n_src, n_dest) pruned weight matrix."""
        conn = np.asarray(w) != 0
        n_src, n_dest = conn.shape
        if fanout is None:
            fanout = np.full(n_src, n_dest, dtype=np.int64)  # slack
        elif np.isscalar(fanout):
            fanout = np.full(n_src, int(fanout), dtype=np.int64)
        return MappingProblem(n_dest=n_dest, n_engines=n_engines, n_caps=n_caps,
                              conn=conn, fanout=np.asarray(fanout, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class MappingSolution:
    """assignment[i] = (engine j, capacitor k) or (-1, -1) if unassigned."""

    engine: np.ndarray      # int[n_dest], -1 = unassigned
    capacitor: np.ndarray   # int[n_dest], -1 = unassigned
    n_assigned: int
    objective: int          # paper's (4): number of unassigned neurons
    solver: str
    mip_gap: float = 0.0    # HiGHS relative optimality gap of the accepted
                            # incumbent; 0.0 = proven optimal (or not an ILP)

    def check(self, p: MappingProblem, require_all: bool = False) -> None:
        """Verify constraints (5)-(7) hold; raises :class:`MappingError`
        (a real exception — this is a load-bearing correctness gate, not a
        debugging aid ``python -O`` may strip)."""
        assigned = self.engine >= 0
        # (6) unique by construction (one entry per i); capacitor uniqueness:
        for j in range(p.n_engines):
            caps = self.capacitor[(self.engine == j)]
            if len(caps) != len(set(caps.tolist())):
                raise MappingError(f"capacitor reuse in engine {j}")
            if len(caps) > p.n_caps:                                       # (5)
                raise MappingError(
                    f"engine {j} capacity exceeded: {len(caps)} > {p.n_caps}")
        for m in range(p.n_src):
            used = int(np.sum(assigned & p.conn[m]))
            if used > p.fanout[m]:                                         # (7)
                raise MappingError(
                    f"fanout violated for source {m}: {used} > {p.fanout[m]}")
        if require_all and not assigned.all():
            raise MappingError(
                f"not all neurons assigned: {int((~assigned).sum())} missing")
        if self.n_assigned != int(assigned.sum()):
            raise MappingError(
                f"n_assigned={self.n_assigned} inconsistent with engine "
                f"vector ({int(assigned.sum())} assigned)")


def _expand_engines_to_caps(p: MappingProblem, engine_of: np.ndarray) -> MappingSolution:
    """Given engine choice per neuron (-1 = none), allocate capacitor indices."""
    cap = np.full(p.n_dest, -1, dtype=np.int64)
    next_free = np.zeros(p.n_engines, dtype=np.int64)
    for i in range(p.n_dest):
        j = engine_of[i]
        if j >= 0:
            cap[i] = next_free[j]
            next_free[j] += 1
    n_assigned = int((engine_of >= 0).sum())
    return MappingSolution(engine=engine_of.astype(np.int64), capacitor=cap,
                           n_assigned=n_assigned,
                           objective=p.n_dest - n_assigned, solver="")


def _accept_milp(res, solver: str) -> float:
    """Vet a scipy ``milp`` result: no incumbent is a hard
    :class:`MappingError`; a time-limit incumbent is accepted (it is
    feasible) but its HiGHS optimality gap is surfaced — returned for
    :attr:`MappingSolution.mip_gap` and warned about — instead of being
    silently passed off as the optimum."""
    if res.x is None:
        raise MappingError(
            f"{solver}: HiGHS found no feasible solution "
            f"(status {res.status}): {res.message}")
    gap = float(getattr(res, "mip_gap", 0.0) or 0.0)
    if res.status != 0 and gap > 0.0:
        warnings.warn(
            f"{solver}: accepted a time-limit incumbent with relative "
            f"optimality gap {gap:.3g} — not proven optimal",
            RuntimeWarning, stacklevel=3)
    return gap


def solve_mapping_full_ilp(p: MappingProblem, time_limit: float = 60.0) -> MappingSolution:
    """The literal paper formulation over x_{i,j,k}.  O(N1*M*N) variables —
    use only on small instances; ``solve_mapping_reduced_ilp`` is equivalent."""
    p.validate()
    n1, m_eng, n_cap = p.n_dest, p.n_engines, p.n_caps
    nvar = n1 * m_eng * n_cap

    def vid(i, j, k):
        return (i * m_eng + j) * n_cap + k

    c = -np.ones(nvar)  # max Σx  ≡  min Σ(1-x)
    rows, cols, vals, lb, ub = [], [], [], [], []
    r = 0
    # (5) engine capacity
    for j in range(m_eng):
        for i in range(n1):
            for k in range(n_cap):
                rows.append(r); cols.append(vid(i, j, k)); vals.append(1.0)
        lb.append(-np.inf); ub.append(n_cap); r += 1
    # (6) unique assignment (≤ 1, see module docstring)
    for i in range(n1):
        for j in range(m_eng):
            for k in range(n_cap):
                rows.append(r); cols.append(vid(i, j, k)); vals.append(1.0)
        lb.append(-np.inf); ub.append(1.0); r += 1
    # capacitor exclusivity (implicit in the paper's hardware: one neuron per
    # capacitor): Σ_i x_{i,j,k} ≤ 1  ∀ j,k
    for j in range(m_eng):
        for k in range(n_cap):
            for i in range(n1):
                rows.append(r); cols.append(vid(i, j, k)); vals.append(1.0)
            lb.append(-np.inf); ub.append(1.0); r += 1
    # (7) fan-out
    for m in range(p.n_src):
        idx = np.nonzero(p.conn[m])[0]
        if len(idx) == 0:
            continue
        for i in idx:
            for j in range(m_eng):
                for k in range(n_cap):
                    rows.append(r); cols.append(vid(i, j, k)); vals.append(1.0)
        lb.append(-np.inf); ub.append(float(p.fanout[m])); r += 1

    from scipy.sparse import csr_matrix
    a = csr_matrix((vals, (rows, cols)), shape=(r, nvar))
    with _quiet_cstdout():
        res = milp(c=c,
                   constraints=LinearConstraint(a, np.array(lb), np.array(ub)),
                   integrality=np.ones(nvar), bounds=Bounds(0, 1),
                   options={"time_limit": time_limit})
    # status 0 = proven optimal; 1/3 = limit reached with an incumbent —
    # accept the incumbent (feasible) but surface its optimality gap
    gap = _accept_milp(res, "full_ilp")
    x = np.round(res.x).astype(np.int64).reshape(n1, m_eng, n_cap)
    engine = np.full(n1, -1, dtype=np.int64)
    cap = np.full(n1, -1, dtype=np.int64)
    for i in range(n1):
        jk = np.argwhere(x[i] == 1)
        if len(jk):
            engine[i], cap[i] = jk[0]
    n_assigned = int((engine >= 0).sum())
    return MappingSolution(engine=engine, capacitor=cap, n_assigned=n_assigned,
                           objective=n1 - n_assigned, solver="full_ilp",
                           mip_gap=gap)


def solve_mapping_reduced_ilp(p: MappingProblem, time_limit: float = 120.0) -> MappingSolution:
    """Capacitor-symmetry-reduced ILP over y_{i,j}.  Exact (same optimum as
    the full formulation — capacitors within an engine are interchangeable)."""
    p.validate()
    n1, m_eng = p.n_dest, p.n_engines
    nvar = n1 * m_eng

    def vid(i, j):
        return i * m_eng + j

    c = -np.ones(nvar)
    rows, cols, vals, lb, ub = [], [], [], [], []
    r = 0
    for j in range(m_eng):                       # (5)
        for i in range(n1):
            rows.append(r); cols.append(vid(i, j)); vals.append(1.0)
        lb.append(-np.inf); ub.append(p.n_caps); r += 1
    for i in range(n1):                          # (6)
        for j in range(m_eng):
            rows.append(r); cols.append(vid(i, j)); vals.append(1.0)
        lb.append(-np.inf); ub.append(1.0); r += 1
    for m in range(p.n_src):                     # (7)
        idx = np.nonzero(p.conn[m])[0]
        if len(idx) == 0:
            continue
        for i in idx:
            for j in range(m_eng):
                rows.append(r); cols.append(vid(i, j)); vals.append(1.0)
        lb.append(-np.inf); ub.append(float(p.fanout[m])); r += 1

    from scipy.sparse import csr_matrix
    a = csr_matrix((vals, (rows, cols)), shape=(r, nvar))
    with _quiet_cstdout():
        res = milp(c=c,
                   constraints=LinearConstraint(a, np.array(lb), np.array(ub)),
                   integrality=np.ones(nvar), bounds=Bounds(0, 1),
                   options={"time_limit": time_limit})
    gap = _accept_milp(res, "reduced_ilp")
    y = np.round(res.x).astype(np.int64).reshape(n1, m_eng)
    engine = np.where(y.sum(axis=1) > 0, y.argmax(axis=1), -1)
    sol = _expand_engines_to_caps(p, engine)
    return dataclasses.replace(sol, solver="reduced_ilp", mip_gap=gap)


def solve_mapping_greedy(p: MappingProblem) -> MappingSolution:
    """Online heuristic: assign neurons in decreasing fan-in order to the
    least-loaded engine, respecting capacity and fan-out budgets."""
    p.validate()
    fanin = p.conn.sum(axis=0)
    order = np.argsort(-fanin, kind="stable")
    load = np.zeros(p.n_engines, dtype=np.int64)
    budget = p.fanout.astype(np.int64).copy()
    engine = np.full(p.n_dest, -1, dtype=np.int64)
    for i in order:
        srcs = np.nonzero(p.conn[:, i])[0]
        if len(srcs) and (budget[srcs] <= 0).any():
            continue  # assigning i would break some source's fan-out
        j = int(np.argmin(load))
        if load[j] >= p.n_caps:
            continue  # all engines full
        engine[i] = j
        load[j] += 1
        budget[srcs] -= 1
    sol = _expand_engines_to_caps(p, engine)
    return dataclasses.replace(sol, solver="greedy")


def solve_mapping_bruteforce(p: MappingProblem) -> MappingSolution:
    """Exhaustive search over engine choices (None/0..M-1 per neuron).
    Only for tiny instances in tests."""
    p.validate()
    if (p.n_engines + 1) ** p.n_dest > 2_000_000:
        raise ValueError("instance too large for brute force")
    best, best_count = None, -1
    for choice in itertools.product(range(-1, p.n_engines), repeat=p.n_dest):
        eng = np.array(choice, dtype=np.int64)
        loads = np.bincount(eng[eng >= 0], minlength=p.n_engines)
        if (loads > p.n_caps).any():
            continue
        assigned = eng >= 0
        ok = True
        for m in range(p.n_src):
            if int(np.sum(assigned & p.conn[m])) > p.fanout[m]:
                ok = False
                break
        if not ok:
            continue
        cnt = int(assigned.sum())
        if cnt > best_count:
            best, best_count = eng, cnt
    sol = _expand_engines_to_caps(p, best)
    return dataclasses.replace(sol, solver="bruteforce")


def solve_mapping(p: MappingProblem, method: str = "auto") -> MappingSolution:
    """Entry point.  method: auto | full_ilp | reduced_ilp | greedy | maxflow."""
    if method == "auto":
        slack_fanout = bool((p.fanout >= p.conn.sum(axis=1)).all())
        if slack_fanout:
            from repro_torch.core.mapping.maxflow import max_flow_assignment
            return max_flow_assignment(p)
        method = "reduced_ilp" if p.n_dest * p.n_engines > 64 else "full_ilp"
    if method == "full_ilp":
        return solve_mapping_full_ilp(p)
    if method == "reduced_ilp":
        return solve_mapping_reduced_ilp(p)
    if method == "greedy":
        return solve_mapping_greedy(p)
    if method == "maxflow":
        from repro_torch.core.mapping.maxflow import max_flow_assignment
        return max_flow_assignment(p)
    raise ValueError(f"unknown method {method!r}")
