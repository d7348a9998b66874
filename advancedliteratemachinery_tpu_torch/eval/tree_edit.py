"""Zhang-Shasha ordered tree edit distance.

Self-contained replacement for the `apted` dependency used by the CC-OCR
evaluators (reference Benchmarks/CC-OCR/evaluation/evaluator/
doc_parsing_evaluator.py:101 TEDS, kie_evaluator.py:226 cal_acc nTED —
the environment has no apted/zss). Supports a pluggable node-rename cost,
which is how TEDS injects its content-edit-distance cost for <td> cells.

The port's copy of `advancedliteratemachinery_tpu/eval/tree_edit.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass
class Node:
    label: str
    children: List["Node"] = dataclasses.field(default_factory=list)
    # payload slots used by TEDS
    colspan: int = 1
    rowspan: int = 1
    content: Optional[list] = None


def _postorder(root: Node):
    """Returns (nodes in postorder, leftmost-leaf index per node)."""
    nodes: List[Node] = []
    lml: List[int] = []

    def walk(n: Node) -> int:
        if not n.children:
            nodes.append(n)
            lml.append(len(nodes) - 1)
            return len(nodes) - 1
        first = None
        for c in n.children:
            idx = walk(c)
            if first is None:
                first = lml[idx]
        nodes.append(n)
        lml.append(first)
        return len(nodes) - 1

    walk(root)
    return nodes, lml


def _keyroots(lml: List[int]) -> List[int]:
    seen = set()
    out = []
    for i in range(len(lml) - 1, -1, -1):
        if lml[i] not in seen:
            out.append(i)
            seen.add(lml[i])
    return sorted(out)


def default_rename(a: Node, b: Node) -> float:
    return 0.0 if a.label == b.label else 1.0


def tree_edit_distance(t1: Node, t2: Node,
                       rename: Callable[[Node, Node], float] = default_rename,
                       insert_cost: float = 1.0,
                       delete_cost: float = 1.0) -> float:
    """Zhang & Shasha (1989) O(n² m²) worst case — fine for table/KIE trees."""
    n1, l1 = _postorder(t1)
    n2, l2 = _postorder(t2)
    kr1, kr2 = _keyroots(l1), _keyroots(l2)
    N, M = len(n1), len(n2)
    td = [[0.0] * M for _ in range(N)]

    for i in kr1:
        for j in kr2:
            # forest distance over subtrees rooted at i, j
            li, lj = l1[i], l2[j]
            rows = i - li + 2
            cols = j - lj + 2
            fd = [[0.0] * cols for _ in range(rows)]
            for a in range(1, rows):
                fd[a][0] = fd[a - 1][0] + delete_cost
            for b in range(1, cols):
                fd[0][b] = fd[0][b - 1] + insert_cost
            for a in range(1, rows):
                for b in range(1, cols):
                    ia = li + a - 1
                    jb = lj + b - 1
                    if l1[ia] == li and l2[jb] == lj:
                        fd[a][b] = min(
                            fd[a - 1][b] + delete_cost,
                            fd[a][b - 1] + insert_cost,
                            fd[a - 1][b - 1] + rename(n1[ia], n2[jb]),
                        )
                        td[ia][jb] = fd[a][b]
                    else:
                        fd[a][b] = min(
                            fd[a - 1][b] + delete_cost,
                            fd[a][b - 1] + insert_cost,
                            fd[l1[ia] - li][l2[jb] - lj] + td[ia][jb],
                        )
    return td[N - 1][M - 1]


def tree_size(root: Node) -> int:
    return 1 + sum(tree_size(c) for c in root.children)
