"""Ordered tree edit distance (Zhang-Shasha, 1989): the port's own copy of
:mod:`pixparse_tpu.utils.tree_edit`.

Used only for evaluation (CORD nTED accuracy) on small JSON trees, so plain
Python host code. :class:`TreeNode` (ordered, labeled) and
:func:`tree_edit_distance` with pluggable insert / remove / update cost
functions (the cost-function interface of ``zss.distance``, which is not
needed).
"""

from __future__ import annotations

from typing import Callable, List


class TreeNode:
    """An ordered, labeled tree node."""

    __slots__ = ("label", "children")

    def __init__(self, label: str, children: List["TreeNode"] | None = None):
        self.label = label
        self.children: List[TreeNode] = children if children is not None else []

    def addkid(self, node: "TreeNode") -> "TreeNode":
        self.children.append(node)
        return self

    def __repr__(self):  # pragma: no cover - debug aid
        return f"TreeNode({self.label!r}, {len(self.children)} kids)"


class _Annotated:
    """Post-order node list + leftmost-leaf-descendants + LR keyroots."""

    def __init__(self, root: TreeNode):
        self.nodes: List[TreeNode] = []  # nodes in post-order
        self.lmds: List[int] = []  # lmds[i] = post-order idx of leftmost leaf of i
        self._walk(root)
        # Keyroots: for each distinct lmd value, the node with the largest
        # post-order index having that lmd (i.e. nodes with a left sibling,
        # plus the root).
        keyroot_by_lmd = {}
        for i, lmd in enumerate(self.lmds):
            keyroot_by_lmd[lmd] = i
        self.keyroots = sorted(keyroot_by_lmd.values())

    def _walk(self, root: TreeNode) -> int:
        # Iterative post-order to avoid recursion limits on deep JSON.
        # Returns post-order index of `root`; fills nodes/lmds.
        stack = [(root, False)]
        lmd_of = {}
        while stack:
            node, expanded = stack.pop()
            if expanded:
                idx = len(self.nodes)
                self.nodes.append(node)
                if node.children:
                    lmd = lmd_of[id(node.children[0])]
                else:
                    lmd = idx
                lmd_of[id(node)] = lmd
                self.lmds.append(lmd)
            else:
                stack.append((node, True))
                for child in reversed(node.children):
                    stack.append((child, False))
        return len(self.nodes) - 1


def tree_edit_distance(
    tree_a: TreeNode,
    tree_b: TreeNode,
    insert_cost: Callable[[TreeNode], float],
    remove_cost: Callable[[TreeNode], float],
    update_cost: Callable[[TreeNode, TreeNode], float],
) -> float:
    """Exact ordered tree edit distance between ``tree_a`` and ``tree_b``.

    Zhang-Shasha O(|A|^2 |B|^2) worst case; our trees (CORD receipts) have at
    most a few hundred nodes.
    """
    A = _Annotated(tree_a)
    B = _Annotated(tree_b)
    la, lb = A.lmds, B.lmds
    na, nb = A.nodes, B.nodes
    treedist = [[0.0] * len(nb) for _ in range(len(na))]

    def _compute(i: int, j: int):
        """Fill treedist for keyroot pair (i, j) via forest distances."""
        m = i - la[i] + 2
        n = j - lb[j] + 2
        # fd[x][y]: distance between forest A[la[i]..la[i]+x-1], B[lb[j]..lb[j]+y-1]
        fd = [[0.0] * n for _ in range(m)]
        ioff = la[i] - 1
        joff = lb[j] - 1
        for x in range(1, m):
            fd[x][0] = fd[x - 1][0] + remove_cost(na[x + ioff])
        for y in range(1, n):
            fd[0][y] = fd[0][y - 1] + insert_cost(nb[y + joff])
        for x in range(1, m):
            for y in range(1, n):
                node_a = na[x + ioff]
                node_b = nb[y + joff]
                if la[i] == la[x + ioff] and lb[j] == lb[y + joff]:
                    # Both sub-forests are whole trees: record tree distance.
                    fd[x][y] = min(
                        fd[x - 1][y] + remove_cost(node_a),
                        fd[x][y - 1] + insert_cost(node_b),
                        fd[x - 1][y - 1] + update_cost(node_a, node_b),
                    )
                    treedist[x + ioff][y + joff] = fd[x][y]
                else:
                    p = la[x + ioff] - 1 - ioff
                    q = lb[y + joff] - 1 - joff
                    fd[x][y] = min(
                        fd[x - 1][y] + remove_cost(node_a),
                        fd[x][y - 1] + insert_cost(node_b),
                        fd[p][q] + treedist[x + ioff][y + joff],
                    )

    for i in A.keyroots:
        for j in B.keyroots:
            _compute(i, j)
    return treedist[-1][-1]
