"""Workflow graph: JIT extraction from traced communication + s-t cuts.

The graph is extracted just-in-time during the profiling run: every
channel ``put``/``get`` is traced as (producer → channel → consumer), and
weight-update synchronization edges are added by the runner.  Cycles
(embodied sim ↔ generation, deep-research tool loops) are collapsed into
single nodes before scheduling (paper Algorithm 1 line 2).

Counterpart of the JAX package's ``core/flowgraph.py``, which keeps its
graph in ``networkx``.  The port keeps it in :class:`DiGraph`, adjacency
dicts in insertion order, with the few algorithms the runtime needs
written out in the standard library.  The order of nodes decides the plan
(``st_cuts`` enumerates combinations over the topological order and the
scheduler keeps the first of equal candidates), so every function here
yields exactly the order networkx 3.x yields for the same graph built the
same way: Kahn's generations for :func:`topological_sort`, Pearce's
iterative Tarjan for :func:`strongly_connected_components`, and the node
order of networkx's induced-subgraph views for :meth:`DiGraph.subgraph`.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, Iterator, List, Optional, Sequence, Set, Tuple


class GraphCycleError(ValueError):
    """A topological order was asked of a graph that has a cycle."""


class DiGraph:
    """A directed graph as insertion-ordered adjacency dicts.

    ``_succ[u][v]`` and ``_pred[v][u]`` hold the edge's attribute dict;
    ``_node[n]`` the node's.  Adding an edge adds its end nodes, and
    adding an edge or node twice keeps its first position and updates its
    attributes, as networkx's ``DiGraph`` does."""

    def __init__(self):
        self._node: Dict[str, Dict[str, Any]] = {}
        self._succ: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._pred: Dict[str, Dict[str, Dict[str, Any]]] = {}

    def add_node(self, n: str, **attrs) -> None:
        if n not in self._node:
            self._node[n] = {}
            self._succ[n] = {}
            self._pred[n] = {}
        self._node[n].update(attrs)

    def add_edge(self, u: str, v: str, **attrs) -> None:
        self.add_node(u)
        self.add_node(v)
        data = self._succ[u].get(v, {})
        data.update(attrs)
        self._succ[u][v] = data
        self._pred[v][u] = data

    @property
    def nodes(self) -> List[str]:
        return list(self._node)

    @property
    def edges(self) -> List[Tuple[str, str]]:
        return [(u, v) for u, nbrs in self._succ.items() for v in nbrs]

    def edge_data(self, u: str, v: str) -> Dict[str, Any]:
        return self._succ[u][v]

    def successors(self, n: str) -> Iterator[str]:
        return iter(self._succ[n])

    def predecessors(self, n: str) -> Iterator[str]:
        return iter(self._pred[n])

    def in_degree(self, n: str) -> int:
        return len(self._pred[n])

    def __iter__(self) -> Iterator[str]:
        return iter(self._node)

    def subgraph(self, nodes: Iterable[str]) -> "DiGraph":
        """The induced subgraph on ``nodes``, as a new graph.

        Its node order is that of networkx's ``G.subgraph(nodes).copy()``:
        the graph's own order, except when the kept nodes are fewer than
        half of the graph's, where networkx walks its set of kept nodes
        instead (the same set, built the same way, iterates alike).  Each
        node's edges keep the graph's order."""
        keep = set(n for n in nodes if n in self._node)
        if 2 * len(keep) < len(self._node):
            order = list(keep)
        else:
            order = [n for n in self._node if n in keep]
        sub = DiGraph()
        for n in order:
            sub.add_node(n, **self._node[n])
        for u in order:
            for v, data in self._succ[u].items():
                if v in keep:
                    sub.add_edge(u, v, **data)
        return sub


def topological_generations(g: DiGraph) -> Iterator[List[str]]:
    """Kahn's algorithm by generations: the first generation is the
    nodes without predecessors in node order; each later one the children
    whose in-degree reached 0, in the order their last parent released
    them (parents in generation order, children in edge order)."""
    indegree = {v: g.in_degree(v) for v in g if g.in_degree(v) > 0}
    zero = [v for v in g if g.in_degree(v) == 0]
    while zero:
        this, zero = zero, []
        for node in this:
            for child in g.successors(node):
                indegree[child] -= 1
                if indegree[child] == 0:
                    zero.append(child)
                    del indegree[child]
        yield this
    if indegree:
        raise GraphCycleError("graph contains a cycle")


def topological_sort(g: DiGraph) -> Iterator[str]:
    """The nodes of a DAG, generation after generation."""
    for generation in topological_generations(g):
        yield from generation


def strongly_connected_components(g: DiGraph) -> Iterator[Set[str]]:
    """Tarjan's components by Pearce's iterative walk (Nuutila's
    variant), roots taken in node order and neighbours in edge order, so
    the components come out in networkx's order: each as soon as its
    root finishes, sinks first."""
    preorder: Dict[str, int] = {}
    lowlink: Dict[str, int] = {}
    found: Set[str] = set()
    stack: List[str] = []
    i = 0
    neighbors = {v: iter(g._succ[v]) for v in g}
    for source in g:
        if source in found:
            continue
        queue = [source]
        while queue:
            v = queue[-1]
            if v not in preorder:
                i += 1
                preorder[v] = i
            done = True
            for w in neighbors[v]:
                if w not in preorder:
                    queue.append(w)
                    done = False
                    break
            if not done:
                continue
            lowlink[v] = preorder[v]
            for w in g._succ[v]:
                if w not in found:
                    if preorder[w] > preorder[v]:
                        lowlink[v] = min(lowlink[v], lowlink[w])
                    else:
                        lowlink[v] = min(lowlink[v], preorder[w])
            queue.pop()
            if lowlink[v] == preorder[v]:
                scc = {v}
                while stack and preorder[stack[-1]] > preorder[v]:
                    scc.add(stack.pop())
                found.update(scc)
                yield scc
            else:
                stack.append(v)


def condensation(g: DiGraph) -> Tuple[DiGraph, Dict[int, Set[str]]]:
    """The DAG of strongly connected components: node ``i`` is the
    ``i``-th component :func:`strongly_connected_components` yields, and
    the edges between components follow the graph's edge order.  Returns
    (dag over the ints, {component: its members})."""
    members: Dict[int, Set[str]] = {}
    mapping: Dict[str, int] = {}
    for i, comp in enumerate(strongly_connected_components(g)):
        members[i] = comp
        mapping.update((n, i) for n in comp)
    dag = DiGraph()
    for i in members:
        dag.add_node(i)
    for u, v in g.edges:
        if mapping[u] != mapping[v]:
            dag.add_edge(mapping[u], mapping[v])
    return dag, members


def ancestors(g: DiGraph, n: str) -> Set[str]:
    """Every node with a path to ``n`` (``n`` itself excluded)."""
    seen: Set[str] = set()
    todo = list(g.predecessors(n))
    while todo:
        v = todo.pop()
        if v not in seen:
            seen.add(v)
            todo.extend(g.predecessors(v))
    seen.discard(n)
    return seen


@dataclass(frozen=True)
class TraceEvent:
    kind: str  # "put" | "get"
    worker: str
    channel: str
    t: float
    nbytes: int = 0


def cycle_node_name(members: Iterable[str]) -> str:
    """Canonical name of a collapsed cycle node — the single place the
    naming convention lives (condense, cycle-spec registration, tests)."""
    ms = tuple(sorted(members))
    return ms[0] if len(ms) == 1 else "cycle(" + "+".join(ms) + ")"


class FlowGraph:
    """Directed workflow graph over worker (group) names."""

    def __init__(self):
        self.g = DiGraph()
        self._key: Optional[FrozenSet[str]] = None

    # -- construction ------------------------------------------------------
    def add_worker(self, name: str, **attrs) -> None:
        self.g.add_node(name, **attrs)
        self._key = None

    def add_edge(self, src: str, dst: str, *, channel: str = "",
                 nbytes: int = 0) -> None:
        self.g.add_edge(src, dst, channel=channel, nbytes=nbytes)
        self._key = None

    @classmethod
    def from_trace(cls, events: Sequence[TraceEvent]) -> "FlowGraph":
        fg = cls()
        producers: Dict[str, Set[str]] = {}
        consumers: Dict[str, Set[str]] = {}
        traffic: Dict[str, int] = {}
        for ev in events:
            fg.add_worker(ev.worker)
            d = producers if ev.kind == "put" else consumers
            d.setdefault(ev.channel, set()).add(ev.worker)
            traffic[ev.channel] = traffic.get(ev.channel, 0) + ev.nbytes
        for ch in set(producers) | set(consumers):
            for p in producers.get(ch, ()):
                for c in consumers.get(ch, ()):
                    if p != c:
                        fg.add_edge(p, c, channel=ch,
                                    nbytes=traffic.get(ch, 0))
        return fg

    # -- properties ----------------------------------------------------------
    @property
    def nodes(self) -> List[str]:
        return self.g.nodes

    def edges(self) -> List[Tuple[str, str]]:
        return self.g.edges

    def successors(self, n: str) -> List[str]:
        return list(self.g.successors(n))

    # -- cycle collapse (ConvertCircleToNode) ---------------------------------
    def condense(self) -> Tuple["FlowGraph", Dict[str, Tuple[str, ...]]]:
        """Collapse strongly-connected components into single nodes.

        Returns (dag, members) where members maps the collapsed node name
        to its original workers.  Collapsed nodes are scheduled as a unit
        (paper §3.4 last paragraph) and executed as a closed loop by the
        ExecutionFlowManager (Leaf.cycle_mode realization).
        """
        comp, comp_members = condensation(self.g)
        dag = FlowGraph()
        members: Dict[str, Tuple[str, ...]] = {}
        names: Dict[int, str] = {}
        for cid in comp:
            ms = tuple(sorted(comp_members[cid]))
            name = cycle_node_name(ms)
            names[cid] = name
            members[name] = ms
            dag.add_worker(name)
        for a, b in comp.edges:
            dag.add_edge(names[a], names[b])
        return dag, members

    # -- s-t cuts ---------------------------------------------------------------
    def st_cuts(self) -> Iterable[Tuple[FrozenSet[str], FrozenSet[str]]]:
        """Enumerate ordered 2-partitions (G_s, G_t) with every edge going
        s→t (i.e. G_s is a down-set of the DAG) — the s-t cuts of
        Algorithm 1 line 12.  Exponential in nodes; workflow graphs have
        ≤ ~8 components."""
        nodes = list(topological_sort(self.g))
        n = len(nodes)
        anc = {v: ancestors(self.g, v) for v in nodes}
        seen = set()
        for r in range(1, n):
            for combo in itertools.combinations(nodes, r):
                s = frozenset(combo)
                if s in seen:
                    continue
                seen.add(s)
                # closed under ancestors?
                if any(not anc[v] <= s for v in s):
                    continue
                t = frozenset(set(nodes) - s)
                yield s, t

    def subgraph(self, nodes: Iterable[str]) -> "FlowGraph":
        fg = FlowGraph()
        fg.g = self.g.subgraph(nodes)
        return fg

    def key(self) -> FrozenSet[str]:
        # cached: the scheduler's memoized recursion calls key() on every
        # lookup, and the node set only changes through the mutators above
        if self._key is None:
            self._key = frozenset(self.g.nodes)
        return self._key

    def __repr__(self) -> str:
        return f"FlowGraph({self.g.nodes}, edges={self.g.edges})"


class GraphTracer:
    """Collects TraceEvents during a profiling execution of the workflow."""

    def __init__(self):
        self.events: List[TraceEvent] = []

    def record(self, kind: str, worker: str, channel: str, t: float,
               nbytes: int = 0) -> None:
        self.events.append(TraceEvent(kind, worker, channel, t, nbytes))

    def graph(self) -> FlowGraph:
        return FlowGraph.from_trace(self.events)
