"""RNTN — recursive neural tensor network over binary parse trees.

Counterpart of `deeplearning4j_tpu/models/rntn.py` (reference
`models/rntn/RNTN.java`: Socher et al.'s sentiment RNTN, a tanh composition
with a bilinear tensor term at every internal node, a softmax classifier
at every node, AdaGrad over trees). Trees are PTB/SST s-expressions,
"(3 (2 a) (2 (2 b) (1 c)))", parsed and planned exactly as the JAX package
does: a post-order plan per tree (is_leaf, word_id, left, right, label,
valid), padded to `max_nodes` with leaves of word 0 that nothing reads.

The device design. JAX scans each plan's `max_nodes` steps, `vmap`ped over
trees; every step computes both the leaf vector and the composition and
selects one. Here a batch of plans [B, max_nodes] runs together:

- the leaf vectors of every step come in one gather before the loop,
  `nd/kernels.gather_rows(E, word_id)`, whose backward is the scatter-add
  kernel (one launch a train step);
- `TreeScan` loops over the plan steps: step i reads each tree's two
  children from the node buffer [B, max_nodes, d] (`index_select` of rows),
  composes them, and writes the leaf vector or the composition into row i.
  It saves only the buffer for its backward, which walks the steps in
  reverse, recomputes step i's composition under autograd from the saved
  children and takes the gradients of its children and of the cell's
  params there (the node gradients go back into a buffer of the same
  shape). No step's intermediates outlive it: at B = 8,544 trees, 128
  steps and d = 25 the saved state is the buffer's 109.4 MB, where keeping
  each step's [B, d, 2d] tensor-term product would take 5.5 GB;
- the tensor term stays a plain product (JAX computes it outside any
  Pallas kernel): [B, 2d] x [2d, d * 2d], then a batched dot with [a; b].

`fit` runs each AdaGrad step (loss, gradient, hist += g^2,
p -= lr * g / sqrt(hist), hist starting at 1e-8) as one program of a
`TreeStepCache` keyed by (B, max_nodes, vocab size): on a CUDA device a
captured CUDA graph replayed every epoch, on the CPU (or with the
cache's `capture` off) the same program run eagerly. A later `fit` that
grows the vocabulary changes the key. Initial params and grown embedding rows
are threefry draws bitwise the JAX package's (`nd/random`);
`state_from_numpy` carries a JAX param dict and its AdaGrad history
across.

`predict` takes one tree, as in JAX; `accuracy` forwards all its trees in
one batch (a tree at a time would be a launch storm on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.kernels import gather_rows
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.optimize.step_cache import CompiledProgramCache

#: the plan fields, in the order the step programs take them
PLAN_KEYS = ("is_leaf", "word_id", "left", "right", "label", "valid")


# --------------------------------------------------------------- tree plans

@dataclasses.dataclass
class TreeNode:
    label: int
    word: Optional[str] = None
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return self.word is not None


def parse_tree(s: str) -> TreeNode:
    """Parse one PTB-style s-expression into a binary TreeNode."""
    toks = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def rec() -> TreeNode:
        nonlocal pos
        assert toks[pos] == "(", f"expected '(' at {pos}"
        pos += 1
        label = int(toks[pos])
        pos += 1
        if toks[pos] != "(":  # leaf: "(label word)"
            word = toks[pos]
            pos += 1
            assert toks[pos] == ")"
            pos += 1
            return TreeNode(label=label, word=word)
        left = rec()
        if toks[pos] == ")":  # unary "(label (subtree))": collapse, relabel
            pos += 1
            return TreeNode(label=label, word=left.word, left=left.left,
                            right=left.right)
        right = rec()
        assert toks[pos] == ")", f"expected ')' at {pos}"
        pos += 1
        return TreeNode(label=label, left=left, right=right)

    return rec()


def tree_tokens(t: TreeNode) -> List[str]:
    if t.is_leaf:
        return [t.word]
    return tree_tokens(t.left) + tree_tokens(t.right)


@dataclasses.dataclass
class TreePlan:
    """Padded static-shape encoding of one tree (post-order).

    Arrays of length `max_nodes`:  is_leaf/word_id/left/right/label/valid.
    The root is the last valid step.
    """
    is_leaf: np.ndarray
    word_id: np.ndarray
    left: np.ndarray
    right: np.ndarray
    label: np.ndarray
    valid: np.ndarray
    n_nodes: int


def plan_tree(t: TreeNode, vocab: Dict[str, int], max_nodes: int) -> TreePlan:
    is_leaf, word_id, left, right, label = [], [], [], [], []

    def rec(node: TreeNode) -> int:
        if node.is_leaf:
            li = ri = 0
            wid = vocab.get(node.word, 0)
            leaf = True
        else:
            li = rec(node.left)
            ri = rec(node.right)
            wid = 0
            leaf = False
        idx = len(is_leaf)
        is_leaf.append(leaf)
        word_id.append(wid)
        left.append(li)
        right.append(ri)
        label.append(node.label)
        return idx

    rec(t)
    n = len(is_leaf)
    if n > max_nodes:
        raise ValueError(f"tree has {n} nodes > max_nodes={max_nodes}")

    def pad(xs, fill=0):
        return np.asarray(xs + [fill] * (max_nodes - n))

    return TreePlan(is_leaf=pad(is_leaf, True).astype(bool),
                    word_id=pad(word_id), left=pad(left), right=pad(right),
                    label=pad(label), valid=pad([True] * n, False).astype(bool),
                    n_nodes=n)


def stack_plans(plans: Sequence[TreePlan], device=None
                ) -> Dict[str, torch.Tensor]:
    """List of TreePlan -> dict of [B, max_nodes] tensors on `device` (CUDA
    unless the caller passes "cpu"): is_leaf and valid bool, the rest
    int64."""
    dev = resolve_device(device)
    out = {}
    for k in PLAN_KEYS:
        a = np.stack([getattr(p, k) for p in plans])
        out[k] = torch.as_tensor(a if a.dtype == bool else a.astype(np.int64),
                                 device=dev)
    return out


# ----------------------------------------------------------------- the scan

class TreeScan(torch.autograd.Function):
    """The plan-step loop over a batch of trees.

    apply(cell, leaf [B, N, d], left [B, N], right [B, N], is_leaf [B, N],
    *params) -> (nodes [B, N, d], errors [B, N]): step i sets node i of
    every tree to its leaf vector where is_leaf[:, i], else to
    `cell(params, node[left[:, i]], node[right[:, i]])[0]`; errors[:, i] is
    the cell's second output there (a per-node error) and 0 at leaves (and
    everywhere for a cell that returns None). The backward recomputes each
    step's cell from the saved nodes (see the module docstring)."""

    @staticmethod
    def forward(ctx, cell: Callable, leaf, left, right, is_leaf, *params):
        b, n, d = leaf.shape
        nodes = leaf.new_zeros((b, n, d))
        flat = nodes.view(b * n, d)
        lrow, rrow = _child_rows(left, right)
        errors = leaf.new_zeros((n, b))
        for i in range(n):
            h, err = cell(params, flat.index_select(0, lrow[i]),
                          flat.index_select(0, rrow[i]))
            nodes[:, i] = torch.where(is_leaf[:, i, None], leaf[:, i], h)
            if err is not None:
                errors[i] = torch.where(is_leaf[:, i], 0.0, err)
        ctx.cell = cell
        ctx.save_for_backward(nodes, lrow, rrow, is_leaf, *params)
        return nodes, errors.t()

    @staticmethod
    def backward(ctx, g_nodes, g_errors):
        nodes, lrow, rrow, is_leaf, *params = ctx.saved_tensors
        b, n, d = nodes.shape
        flat = nodes.view(b * n, d)
        gflat = g_nodes.contiguous().clone().view(b * n, d)
        gnodes = gflat.view(b, n, d)
        composed = (~is_leaf).to(nodes.dtype)
        leaves = [p.detach().requires_grad_() for p in params]
        gparams = [torch.zeros_like(p) for p in params]
        with torch.enable_grad():
            for i in reversed(range(n)):
                a = flat.index_select(0, lrow[i]).requires_grad_()
                c = flat.index_select(0, rrow[i]).requires_grad_()
                h, err = ctx.cell(leaves, a, c)
                outs = [h]
                grads_out = [gnodes[:, i] * composed[:, i, None]]
                if err is not None and g_errors is not None:
                    outs.append(err)
                    grads_out.append(g_errors[:, i] * composed[:, i])
                ga, gc, *gp = torch.autograd.grad(
                    outs, [a, c] + leaves, grads_out, allow_unused=True)
                # each tree's children are rows of its own: no two trees
                # add into one row
                gflat.index_add_(0, lrow[i], ga)
                gflat.index_add_(0, rrow[i], gc)
                for acc, g in zip(gparams, gp):
                    if g is not None:
                        acc += g
        g_leaf = gnodes * is_leaf[..., None].to(nodes.dtype)
        return (None, g_leaf, None, None, None) + tuple(gparams)


def _child_rows(left: torch.Tensor, right: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of the flattened node buffer [B * N, d] holding each step's
    children, step-major ([N, B]) so that step i's are contiguous."""
    b, n = left.shape
    base = torch.arange(b, device=left.device)[:, None] * n
    return ((base + left).t().contiguous(),
            (base + right).t().contiguous())


def tree_scan(cell: Callable, params: Sequence[torch.Tensor],
              E: torch.Tensor, plans: Dict[str, torch.Tensor]):
    """(nodes [B, N, d], errors [B, N]) of `cell` over the stacked plans,
    the leaf vectors gathered from E through `gather_rows`."""
    leaf = gather_rows(E, plans["word_id"])
    return TreeScan.apply(cell, leaf, plans["left"], plans["right"],
                          plans["is_leaf"], *params)


# -------------------------------------------------------------------- model

def init_rntn_params(key, vocab_size: int, dim: int, n_classes: int,
                     dtype=torch.float32, device=None
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's initial params, bitwise: `key` (an int64 [2]
    threefry key, `nd.random.prng_key(seed)`) split in four for E, W, V
    and Ws, each `jax.random.uniform` in its range; drawn on the key's
    device and moved to `device` (the key's when None)."""
    ke, kw, kv, ks = nd_random.split(key, 4)
    r = 1.0 / np.sqrt(dim)
    params = {
        "E": nd_random.uniform_dtype(ke, (vocab_size, dim), dtype, -r, r),
        "W": nd_random.uniform_dtype(kw, (2 * dim, dim), dtype, -r, r),
        "b": torch.zeros((dim,), dtype=dtype, device=key.device),
        # bilinear tensor: V[k] is the [2d, 2d] form for output channel k
        "V": nd_random.uniform_dtype(kv, (dim, 2 * dim, 2 * dim), dtype,
                                     -r / dim, r / dim),
        "Ws": nd_random.uniform_dtype(ks, (dim, n_classes), dtype, -r, r),
        "bs": torch.zeros((n_classes,), dtype=dtype, device=key.device),
    }
    return {k: p.to(device or key.device) for k, p in params.items()}


def state_from_numpy(params: Dict[str, np.ndarray],
                     hist: Optional[Dict[str, np.ndarray]] = None,
                     device=None):
    """(params, AdaGrad history) as tensors on `device` (CUDA unless the
    caller passes "cpu") from the JAX package's numpy dicts (an RNTN's E, W,
    b, V, Ws, bs or an autoencoder's E, We, be, Wd, bd); a missing history
    starts at 1e-8, as `fit` starts it."""
    dev = resolve_device(device)
    p = {k: torch.as_tensor(np.asarray(v), device=dev).clone()
         for k, v in params.items()}
    if hist is None:
        h = {k: torch.full_like(v, 1e-8) for k, v in p.items()}
    else:
        h = {k: torch.as_tensor(np.asarray(hist[k]), device=dev).clone()
             for k in p}
    return p, h


def _rntn_cell(params, a, b):
    """RNTN composition: tanh([a;b]W + b + [a;b]^T V [a;b]), a batch of
    rows at once; params (W, b, V)."""
    w, bias, v = params
    ab = torch.cat([a, b], dim=-1)                      # [B, 2d]
    d, d2 = v.shape[0], v.shape[1]
    std = ab @ w + bias
    # u[b, k, j] = sum_i ab[b, i] V[k, i, j]
    u = (ab @ v.permute(1, 0, 2).reshape(d2, d * d2)).view(-1, d, d2)
    tensor = torch.bmm(u, ab.unsqueeze(2)).squeeze(2)
    return torch.tanh(std + tensor), None


def _forward(params, plans):
    """Node vectors [B, N, d] and per-node class logits [B, N, C]."""
    nodes, _ = tree_scan(_rntn_cell, (params["W"], params["b"], params["V"]),
                         params["E"], plans)
    return nodes, nodes @ params["Ws"] + params["bs"]


def rntn_loss(params, plans, l2: float = 1e-4) -> torch.Tensor:
    """Mean per-node softmax cross-entropy over a stacked batch of plans.

    Nodes with label < 0 are UNSUPERVISED (masked out of the loss) — the
    TreeParser's skip-neutral option for binary sentiment, where a
    sentiment-free span has no honest class."""
    _, logits = _forward(params, plans)
    logp = torch.log_softmax(logits, dim=-1)
    lbl = torch.clamp_min(plans["label"], 0)
    nll = -logp.gather(-1, lbl[..., None]).squeeze(-1)
    w = (plans["valid"] & (plans["label"] >= 0)).to(logp.dtype)
    loss = torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)
    reg = sum(torch.sum(p ** 2) for k, p in params.items()
              if k in ("W", "V", "Ws"))
    return loss + l2 * reg


class TreeStepCache(CompiledProgramCache):
    """The AdaGrad steps of the tree models, one captured program per key
    (`optimize/step_cache.py`'s machinery: a CUDA graph on the card, the
    same program run eagerly on the CPU or with `capture` False)."""

    kind = "tree-step-cache"


def adagrad_step(cache: TreeStepCache, loss_fn: Callable, state,
                 plans: Dict[str, torch.Tensor], lr: float, l2: float,
                 key: Tuple) -> torch.Tensor:
    """One AdaGrad step of `loss_fn(params, plans, l2)` over state
    {"params", "hist"}, written into state's tensors in place, through the
    program of `key` in `cache`: loss and gradient, hist += g^2, p -= lr *
    g / sqrt(hist). Returns the loss (a 0-d tensor, not read back)."""
    names = sorted(state["params"])

    def build():
        def program(st, *plan_args):
            pl = dict(zip(PLAN_KEYS, plan_args))
            with torch.enable_grad():
                ps = {k: st["params"][k].detach().requires_grad_()
                      for k in names}
                loss = loss_fn(ps, pl, l2)
                grads = torch.autograd.grad(loss, [ps[k] for k in names])
            hist = {k: st["hist"][k] + g * g for k, g in zip(names, grads)}
            new = {k: st["params"][k] - lr * g / torch.sqrt(hist[k])
                   for k, g in zip(names, grads)}
            return loss.detach(), new, hist

        return program

    def write(st, out):
        loss, new, hist = out
        with torch.no_grad():
            for k in names:
                st["params"][k].copy_(new[k])
                st["hist"][k].copy_(hist[k])
        return loss

    return cache._run(key, build, state, tuple(plans[k] for k in PLAN_KEYS),
                      read=lambda loss: loss.clone(), write=write)


class _TreeModel:
    """What the RNTN and the recursive autoencoder share: the vocabulary,
    parsing and planning, params on `device` with their AdaGrad history,
    vocabulary growth, and the cached AdaGrad step."""

    kind = "tree"

    def __init__(self, dim: int, max_nodes: int, lr: float, l2: float,
                 seed: int, device=None):
        self.dim = dim
        self.max_nodes = max_nodes
        self.lr = lr
        self.l2 = l2
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = {"<unk>": 0}
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self._hist: Optional[Dict[str, torch.Tensor]] = None
        self.step_cache = TreeStepCache()

    def build_vocab(self, trees: Sequence[TreeNode]) -> None:
        for t in trees:
            for tok in tree_tokens(t):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab)

    def _plans(self, trees: Sequence["str | TreeNode"]
              ) -> Dict[str, torch.Tensor]:
        """The stacked plans of `trees` (s-expressions or TreeNodes) on the
        model's device, over its vocabulary (the programs' input)."""
        trees = [parse_tree(t) if isinstance(t, str) else t for t in trees]
        return stack_plans([plan_tree(t, self.vocab, self.max_nodes)
                            for t in trees], self.device)

    def _init_params(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _prepare(self, trees) -> List[TreeNode]:
        """Parse, grow the vocabulary, and make or grow the params."""
        trees = [parse_tree(t) if isinstance(t, str) else t for t in trees]
        self.build_vocab(trees)
        if self.params is None:
            self.params = self._init_params()
            self._hist = {k: torch.full_like(p, 1e-8)
                          for k, p in self.params.items()}
        elif len(self.vocab) > self.params["E"].shape[0]:
            # a later fit may grow the vocabulary: extend the embedding
            # table (and its AdaGrad history) for the new words
            n_new = len(self.vocab) - self.params["E"].shape[0]
            r = 1.0 / np.sqrt(self.dim)
            rows = nd_random.uniform_dtype(
                nd_random.prng_key(self.seed + len(self.vocab)),
                (n_new, self.dim), self.params["E"].dtype, -r, r
            ).to(self.device)
            self.params["E"] = torch.cat([self.params["E"], rows])
            self._hist["E"] = torch.cat(
                [self._hist["E"], torch.full_like(rows, 1e-8)])
        return trees

    def _loss_fn(self) -> Callable:
        raise NotImplementedError

    def _step(self, plans: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One AdaGrad step over `plans` (from `_plans(trees)`, every word
        in the vocabulary the params cover); the loss, not read back."""
        b, n = plans["word_id"].shape
        key = (self.kind, b, n, int(self.params["E"].shape[0]), self.dim,
               getattr(self, "n_classes", 0), self.lr, self.l2)
        return adagrad_step(self.step_cache, self._loss_fn(),
                            {"params": self.params, "hist": self._hist},
                            plans, self.lr, self.l2, key)

    def fit(self, trees: Sequence["str | TreeNode"], epochs: int) -> float:
        trees = self._prepare(trees)
        plans = self._plans(trees)
        loss = None
        for _ in range(epochs):
            loss = self._step(plans)
        return float("inf") if loss is None else float(loss)


class RNTN(_TreeModel):
    """Socher sentiment RNTN trained with AdaGrad (reference parity:
    `RNTN.java` adagrad at :81 ctor args + `getParameters` flattening), on
    `device` (CUDA unless the caller passes "cpu")."""

    kind = "rntn"

    def __init__(self, dim: int = 16, n_classes: int = 5,
                 max_nodes: int = 64, lr: float = 0.05, l2: float = 1e-4,
                 seed: int = 0, device=None):
        super().__init__(dim, max_nodes, lr, l2, seed, device)
        self.n_classes = n_classes

    def _init_params(self):
        return init_rntn_params(nd_random.prng_key(self.seed),
                                len(self.vocab), self.dim, self.n_classes,
                                device=self.device)

    def _loss_fn(self):
        return rntn_loss

    def fit(self, trees: Sequence["str | TreeNode"], epochs: int = 30
            ) -> float:
        return super().fit(trees, epochs)

    # -- inference
    def _node_predictions(self, plans: Dict[str, torch.Tensor]) -> np.ndarray:
        """Per-node argmax classes [B, max_nodes] of stacked plans, in one
        forward and one read-back."""
        with torch.no_grad():
            _, logits = _forward(self.params, plans)
            return torch.argmax(logits, dim=-1).cpu().numpy()

    def predict(self, tree: "str | TreeNode", return_plan: bool = False):
        """(root label prediction, per-node predictions[, the TreePlan]).

        `return_plan=True` hands back the plan built for the forward so
        evaluators don't re-plan the same tree."""
        t = parse_tree(tree) if isinstance(tree, str) else tree
        plan_obj = plan_tree(t, self.vocab, self.max_nodes)
        preds = self._node_predictions(stack_plans([plan_obj],
                                                  self.device))[0]
        out = (int(preds[plan_obj.n_nodes - 1]), preds[:plan_obj.n_nodes])
        return out + (plan_obj,) if return_plan else out

    def _predict_plans(self, trees: Sequence["str | TreeNode"]):
        """[(TreePlan, per-node predictions)] of every tree, forwarded in
        one batch."""
        trees = [parse_tree(t) if isinstance(t, str) else t for t in trees]
        plans = [plan_tree(t, self.vocab, self.max_nodes) for t in trees]
        if not plans:
            return []
        preds = self._node_predictions(stack_plans(plans, self.device))
        return [(p, preds[i, :p.n_nodes]) for i, p in enumerate(plans)]

    def accuracy(self, trees: Sequence["str | TreeNode"],
                 root_only: bool = True) -> float:
        correct = total = 0
        for plan, node_preds in self._predict_plans(trees):
            if root_only:
                if plan.label[plan.n_nodes - 1] >= 0:  # supervised root
                    correct += int(node_preds[plan.n_nodes - 1]
                                   == plan.label[plan.n_nodes - 1])
                    total += 1
            else:
                lbl = plan.label[:plan.n_nodes]
                sup = lbl >= 0  # skip unsupervised (masked) nodes
                correct += int((node_preds[sup] == lbl[sup]).sum())
                total += int(sup.sum())
        return correct / max(total, 1)
