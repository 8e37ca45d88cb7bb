"""Small undirected graph for the router's bipartite threading
(graph/undirected_graph.{h,cc})."""

from __future__ import annotations


class UEdge:
    __slots__ = ("a", "b", "eid")

    def __init__(self, a, b, eid):
        self.a = a
        self.b = b
        self.eid = eid

    def neighbor(self, x):
        return self.b if x == self.a else self.a

    def source(self):
        return self.a

    def target(self):
        return self.b


class UGraph:
    def __init__(self):
        self._adj = []       # per-vertex ordered dict UEdge -> None
        self._edges = {}     # UEdge -> None (ordered)
        self._next = 0

    def add_vertex(self):
        self._adj.append({})
        return len(self._adj) - 1

    def num_vertices(self):
        return len(self._adj)

    def num_edges(self):
        return len(self._edges)

    def add_edge(self, a, b):
        e = UEdge(a, b, self._next)
        self._next += 1
        self._adj[a][e] = None
        self._adj[b][e] = None
        self._edges[e] = None
        return e

    def degree(self, v):
        return len(self._adj[v])

    def edges(self):
        return list(self._edges)

    def out_edges(self, v):
        return list(self._adj[v])

    def clear_vertex(self, v):
        for e in list(self._adj[v]):
            del self._adj[e.a][e]
            if e.b != e.a:
                del self._adj[e.b][e]
            del self._edges[e]

    def compute_connected_components(self):
        """list of sorted vertex sets (undirected_graph.cc)."""
        n = len(self._adj)
        seen = [False] * n
        comps = []
        for i in range(n):
            if seen[i]:
                continue
            comp = []
            stack = [i]
            seen[i] = True
            while stack:
                x = stack.pop()
                comp.append(x)
                for e in self._adj[x]:
                    y = e.neighbor(x)
                    if not seen[y]:
                        seen[y] = True
                        stack.append(y)
            comps.append(sorted(comp))
        return comps

    def assign_connected_components(self):
        comps = self.compute_connected_components()
        v = [0] * len(self._adj)
        for ci, comp in enumerate(comps):
            for x in comp:
                v[x] = ci
        return v
