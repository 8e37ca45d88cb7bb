"""Double subset-sum partitioning (scallop/subsetsum.{h,cc}).

Partitions in-edge and out-edge weight sets into two pairs with closest sums.
Weights are rescaled to ubound <= 1000; two boolean DP tables are filled and
the closest achievable (source, target) sums are backtraced.
"""

from __future__ import annotations


class Equation:
    """scallop/equation.h"""
    __slots__ = ("e", "s", "t")

    def __init__(self):
        self.e = -1.0
        self.s = []
        self.t = []

    def clear(self):
        self.e = -1.0
        self.s = []
        self.t = []


class SubsetSum:
    def __init__(self, source, target):
        # source/target: list of (weight, id)
        self.source = [list(x) for x in source]
        self.target = [list(x) for x in target]
        self.eqn = Equation()

    def solve(self):
        self._rescale()
        self.table1 = self._fill(self.source, self.ubound1)
        self.table2 = self._fill(self.target, self.ubound2)
        self._optimize()
        return self.eqn

    def _rescale(self):
        """subsetsum.cc:31-71"""
        s1 = sum(x[0] for x in self.source)
        s2 = sum(x[0] for x in self.target)
        ubound = min(max(s1, s2), 1000)
        r1 = ubound / s1
        r2 = ubound / s2
        for x in self.source:
            x[0] = max(int(x[0] * r1), 1)
        for x in self.target:
            x[0] = max(int(x[0] * r2), 1)
        self.ubound1 = sum(x[0] for x in self.source) - 1
        self.ubound2 = sum(x[0] for x in self.target) - 1
        self.source.sort()
        self.target.sort()

    @staticmethod
    def _fill(vv, ubound):
        """subsetsum.cc:73-112; table[i][j] = max index usable to reach j."""
        n = len(vv)
        table = [[-1] * (ubound + 1) for _ in range(n + 1)]
        for i in range(n + 1):
            table[i][0] = 0
        for j in range(1, ubound + 1):
            for i in range(1, n + 1):
                s = vv[i - 1][0]
                if j >= s and table[i - 1][j - s] >= 0:
                    table[i][j] = i
                if table[i - 1][j] >= 0:
                    table[i][j] = table[i - 1][j]
        return table

    @staticmethod
    def _backtrace(t, vv, table):
        """subsetsum.cc:114-135"""
        ss = []
        if len(table) <= 0 or t <= 0 or t > len(table[0]):
            return ss
        n = len(vv)
        if table[n][t] == -1:
            return ss
        x = t
        s = table[n][t]
        while x >= 1 and s >= 1:
            ss.append(vv[s - 1][1])
            x -= vv[s - 1][0]
            s = table[s - 1][x]
        return ss

    def _optimize(self):
        """subsetsum.cc:137-206"""
        v = []
        n1, n2 = len(self.source), len(self.target)
        for i in range(1, self.ubound1 + 1):
            if self.table1[n1][i] >= 0:
                v.append((i, 1))
        for i in range(1, self.ubound2 + 1):
            if self.table2[n2][i] >= 0:
                v.append((i, 2))
        v.sort()
        d = 1 << 60
        k = -1
        for i in range(len(v) - 1):
            if v[i][1] == v[i + 1][1]:
                continue
            if v[i + 1][0] - v[i][0] >= d:
                continue
            d = v[i + 1][0] - v[i][0]
            k = i
        assert k != -1
        for idx in (k, k + 1):
            if v[idx][1] == 1:
                self.eqn.s = self._backtrace(v[idx][0], self.source, self.table1)
            else:
                self.eqn.t = self._backtrace(v[idx][0], self.target, self.table2)
        s = sum(x[0] for x in self.source) + sum(x[0] for x in self.target)
        self.eqn.e = d / (s / 2.0)
