"""Network weight/activation plotting.

The port of `deeplearning4j_tpu/plot/plotter.py` (reference
`plot/NeuralNetPlotter.java`, which dumps matrices to CSV and shells out to
`python plot.py` — :175,207,256 — and `plot/FilterRenderer`, weight-filter
grids, plus the render iteration listeners `plot/iterationlistener/*`).

No subprocess hop: matplotlib is called directly (Agg backend, file
output), and imported only when a plot is drawn, so the package imports
without it. Histograms and filter grids read the port's params tree (a
tuple of per-layer dicts of tensors), a flat parameter vector or numpy
arrays: each tensor comes to the host with one `.cpu()`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host_array(node) -> np.ndarray:
    """A leaf on the host: a tensor (on any device, any dtype) with one
    `.cpu()`, as float32 where numpy has no such dtype (bfloat16)."""
    import torch

    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(node)


def _to_host(tree) -> Dict[str, np.ndarray]:
    """Flatten a layer-params tree into {'0/W': arr, ...} (a single flat
    vector or array is {'': arr})."""
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            flat[prefix] = _host_array(node)

    rec(tree, "")
    return flat


class NeuralNetPlotter:
    """Histogram + activation plotting to files
    (`NeuralNetPlotter.plotNetworkGradient` capability)."""

    def __init__(self, out_dir: str = "plots"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def plot_weight_histograms(self, params, name: str = "weights"
                               ) -> str:
        plt = _plt()
        flat = _to_host(params)
        n = len(flat)
        if n == 0:
            raise ValueError("empty param tree")
        cols = min(4, n)
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                                 squeeze=False)
        for ax in axes.ravel()[n:]:
            ax.axis("off")
        for ax, (key, arr) in zip(axes.ravel(), sorted(flat.items())):
            ax.hist(arr.ravel(), bins=50)
            ax.set_title(f"{key} {tuple(arr.shape)}", fontsize=8)
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=80)
        plt.close(fig)
        return path

    def plot_activations(self, activations,
                         name: str = "activations") -> str:
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        im = ax.imshow(_host_array(activations), aspect="auto",
                       cmap="viridis")
        fig.colorbar(im, ax=ax)
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        return path

    def plot_score_curve(self, scores, name: str = "score") -> str:
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(scores)
        ax.set_xlabel("iteration")
        ax.set_ylabel("score")
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        return path


class FilterRenderer:
    """First-layer weight filters as an image grid
    (`plot/FilterRenderer.java` capability)."""

    def __init__(self, out_dir: str = "plots"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def render_filters(self, w, patch_shape=None,
                       name: str = "filters") -> str:
        """w: (n_in, n_out) dense weights (each column one filter) or
        (h, w_, c_in, c_out) conv kernels, as the JAX package lays them
        out; a tensor or an array."""
        plt = _plt()
        w = _host_array(w)
        if w.ndim == 4:
            filters = [w[:, :, 0, j] for j in range(w.shape[3])]
        else:
            side = int(np.sqrt(w.shape[0])) if patch_shape is None else None
            shape = patch_shape or (side, side)
            if shape[0] * shape[1] != w.shape[0]:
                raise ValueError(
                    f"cannot reshape {w.shape[0]}-dim filters to {shape}")
            filters = [w[:, j].reshape(shape) for j in range(w.shape[1])]
        n = len(filters)
        cols = int(np.ceil(np.sqrt(n)))
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols,
                                 figsize=(1.2 * cols, 1.2 * rows),
                                 squeeze=False)
        for ax in axes.ravel():
            ax.axis("off")
        for ax, f in zip(axes.ravel(), filters):
            ax.imshow(f, cmap="gray")
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.tight_layout(pad=0.1)
        fig.savefig(path, dpi=80)
        plt.close(fig)
        return path


class PlotIterationListener(IterationListener):
    """Render weight histograms every N iterations
    (`NeuralNetPlotterIterationListener` parity)."""

    def __init__(self, out_dir: str = "plots", every: int = 10):
        self.plotter = NeuralNetPlotter(out_dir)
        self.every = max(1, every)
        self.scores: list = []

    def iteration_done(self, model, iteration: int, score: float) -> None:
        self.scores.append(score)
        if iteration % self.every == 0:
            params = getattr(model, "params", None)
            if params is None and hasattr(model, "state"):
                params = model.state.params
            if params is not None:
                self.plotter.plot_weight_histograms(
                    params, name=f"weights-{iteration:06d}")
            self.plotter.plot_score_curve(self.scores)
