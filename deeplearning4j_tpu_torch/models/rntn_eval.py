"""RNTN tree-level evaluation.

Counterpart of `deeplearning4j_tpu/models/rntn_eval.py` (reference
`models/rntn/RNTNEval.java`): forward the trees, then count (gold label,
argmax prediction) for every supervised non-leaf node into a
ConfusionMatrix, with the framework Evaluation's summary
(precision/recall/F1/accuracy/stats). The JAX package forwards a tree at a
time; here `eval` forwards all its trees in one batch on the model's
device (`RNTN._predict_plans`) and counts the same nodes.
"""

from __future__ import annotations

from typing import Sequence

from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
from deeplearning4j_tpu_torch.models.rntn import RNTN, TreeNode


class RNTNEval:
    def __init__(self):
        self.evaluation = Evaluation()

    def eval(self, rntn: RNTN, trees: Sequence["str | TreeNode"]) -> None:
        """Accumulate per-node confusion counts over `trees` (the
        reference counts non-leaf nodes with a prediction; unsupervised
        nodes — label < 0 — are skipped)."""
        for plan, node_preds in rntn._predict_plans(trees):
            for i in range(plan.n_nodes):
                if plan.is_leaf[i] or plan.label[i] < 0:
                    continue
                self.evaluation.add(int(plan.label[i]), int(node_preds[i]))

    # summary surface (RNTNEval.stats -> Evaluation parity)
    def accuracy(self) -> float:
        return self.evaluation.accuracy()

    def f1(self) -> float:
        return self.evaluation.f1()

    def stats(self) -> str:
        return self.evaluation.stats()
