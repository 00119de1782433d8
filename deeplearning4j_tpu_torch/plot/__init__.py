"""t-SNE embeddings.

The port of `deeplearning4j_tpu/plot/`'s two t-SNE modules (reference
`plot/Tsne.java:49`, exact t-SNE on the device, and `BarnesHutTsne.java:62`,
theta-approximate t-SNE over the SpTree on the host) and of the network
plotter (`plot/plotter.py`: `NeuralNetPlotter`, `FilterRenderer`,
`PlotIterationListener`; matplotlib is imported only when a plot is
drawn).
"""

from deeplearning4j_tpu_torch.plot.tsne import Tsne
from deeplearning4j_tpu_torch.plot.barnes_hut_tsne import BarnesHutTsne

__all__ = ["Tsne", "BarnesHutTsne"]
