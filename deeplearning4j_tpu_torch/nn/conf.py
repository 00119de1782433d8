"""Configuration: `NeuralNetConfiguration`, `MultiLayerConfiguration` and
the fluent `ListBuilder` (`list_builder`).

Counterpart of `deeplearning4j_tpu/nn/conf.py`, field for field, so that
`from_json` reads the JAX package's configuration JSON unchanged and
`to_json` writes it back the same. Unknown keys are dropped on read, as the
reference does. Frozen dataclasses; `replace(**kw)` gives a changed copy.
Fields that only the JAX package acts on (remat, the step caches'
flags) are kept so the JSON round-trips.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nd.losses import LossFunction
from deeplearning4j_tpu_torch.nd.ops import Activation
from deeplearning4j_tpu_torch.nn.weights import WeightInit


class OptimizationAlgorithm(str, enum.Enum):
    """Parity: `nn/api/OptimizationAlgorithm` + `Solver.java:54-70` dispatch."""

    GRADIENT_DESCENT = "gradient_descent"          # line-searched GD
    ITERATION_GRADIENT_DESCENT = "iteration_gradient_descent"  # plain SGD steps
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"
    HESSIAN_FREE = "hessian_free"

    def __str__(self) -> str:
        return self.value


class LayerType(str, enum.Enum):
    DENSE = "dense"
    OUTPUT = "output"
    AUTOENCODER = "autoencoder"
    RBM = "rbm"
    RECURSIVE_AUTOENCODER = "recursive_autoencoder"
    LSTM = "lstm"
    GRAVES_LSTM = "graves_lstm"
    CONVOLUTION = "convolution"
    SUBSAMPLING = "subsampling"
    BATCH_NORM = "batch_norm"
    EMBEDDING = "embedding"
    ATTENTION = "attention"
    TRANSFORMER_FFN = "transformer_ffn"

    def __str__(self) -> str:
        return self.value


class RBMUnit(str, enum.Enum):
    """RBM visible/hidden unit types — parity: `RBM.java:83-89` (4 x 4)."""

    BINARY = "binary"
    GAUSSIAN = "gaussian"
    RECTIFIED = "rectified"
    SOFTMAX = "softmax"

    def __str__(self) -> str:
        return self.value


class PoolingType(str, enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    NONE = "none"

    def __str__(self) -> str:
        return self.value


@dataclass(frozen=True)
class Distribution:
    """Weight-init distribution spec (parity: `nn/conf/distribution`)."""

    kind: str = "normal"  # normal | uniform | binomial
    mean: float = 0.0
    std: float = 1.0
    lo: float = -1.0
    hi: float = 1.0
    p: float = 0.5

    def sampler(self):
        """`(key, shape) -> tensor` drawing from this distribution with a
        threefry key (`nd/random.py`), as the JAX package draws it."""
        from deeplearning4j_tpu_torch.nd import random as nd_random

        if self.kind == "normal":
            return lambda key, shape: nd_random.normal(key, self.mean,
                                                       self.std, shape)
        if self.kind == "uniform":
            return lambda key, shape: nd_random.uniform_dtype(
                key, shape, torch.float32, self.lo, self.hi)
        if self.kind == "binomial":
            return lambda key, shape: nd_random.binomial(key, self.p, shape)
        raise ValueError(f"unknown distribution kind {self.kind}")


@dataclass(frozen=True)
class NeuralNetConfiguration:
    """Per-layer hyperparameters (reference `NeuralNetConfiguration.java:52-115`)."""

    layer_type: LayerType = LayerType.DENSE
    n_in: int = 0
    n_out: int = 0

    activation: Activation = Activation.SIGMOID
    weight_init: WeightInit = WeightInit.VI
    dist: Optional[Distribution] = None
    loss_function: LossFunction = LossFunction.MCXENT

    # optimization
    optimization_algo: OptimizationAlgorithm = OptimizationAlgorithm.CONJUGATE_GRADIENT
    lr: float = 1e-1
    num_iterations: int = 100
    momentum: float = 0.5
    momentum_after: Tuple[Tuple[int, float], ...] = ()  # (iteration, momentum) schedule
    l1: float = 0.0
    l2: float = 0.0
    use_regularization: bool = False
    use_adagrad: bool = True
    adagrad_reset_iterations: int = 0  # 0 = never reset (ref: resetAdaGradIterations)
    constrain_gradient_to_unit_norm: bool = False
    gradient_clip_norm: float = 0.0  # 0 = off (new capability)
    minimize: bool = True
    step_function: str = "default"  # default | gradient | negative_default
                                    # | negative_gradient (stepfunctions/*)
    # pluggable termination conditions (ref optimize/terminations/*):
    # any of "eps" (EpsTermination), "norm2" (Norm2Termination),
    # "zero_direction" (ZeroDirection); empty tuple = run all iterations
    termination_conditions: Tuple[str, ...] = ("eps", "norm2")
    termination_eps: float = 1e-6
    termination_norm2: float = 1e-8
    # updater selection: "" = legacy chain (use_adagrad flag + momentum),
    # or one of sgd | adagrad | nesterov | adam | rmsprop (parity-plus:
    # the reference stops at AdaGrad/momentum, GradientAdjustment.java:159)
    updater: str = ""
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    rmsprop_decay: float = 0.95
    num_line_search_iterations: int = 20
    lbfgs_memory: int = 4          # two-loop history (LBFGS.java m=4)
    hf_cg_iterations: int = 32     # inner CG trip count (Martens HF)
    hf_initial_lambda: float = 1.0  # initial LM damping (HF)

    # stochastic regularization
    dropout: float = 0.0
    drop_connect: bool = False

    # pretrain-layer knobs
    corruption_level: float = 0.3   # denoising AE
    sparsity: float = 0.0
    k: int = 1                      # CD-k Gibbs steps (RBM.java:121-201)
    visible_unit: RBMUnit = RBMUnit.BINARY
    hidden_unit: RBMUnit = RBMUnit.BINARY

    # attention knobs (new scope — no attention in the 2015 reference)
    n_heads: int = 4
    causal: bool = False
    attention_block_size: int = 0  # 0 = full attention; >0 = blockwise/flash
    attention_impl: str = "auto"   # auto | full | blockwise | flash (kernel)
    # skip the mask arithmetic on fully-unmasked causal flash tiles (MFU
    # campaign leg d; value-identical, gated for A/B benching)
    attention_block_skip: bool = False
    ffn_hidden: int = 0            # transformer FFN width (0 = 4*n_in)
    max_seq_len: int = 0           # >0: learned positional embedding table
    lstm_impl: str = "auto"        # auto | scan | fused (kernel cell)

    # MFU campaign hot-path flags (each bitwise-f32-identical to the path
    # it replaces; parity-tested in tests/test_mfu_paths.py)
    sparse_labels: bool = False    # int class-id labels: gather mcxent, no
                                   # [rows, vocab] one-hot gemm
    fused_updater: bool = False    # flat-buffer updater step instead of
                                   # O(leaves) per-leaf tree_maps
    attention_fused_bwd: bool = False  # flash bwd via fused kernels
                                   # over saved logsumexp residuals (no
                                   # fwd recompute); only consulted when
                                   # the flash impl dispatches — training-
                                   # only, never an infer-cache key
                                   # (allclose, not bitwise, vs recompute)

    # batch-norm running-stat decay (ema = m*ema + (1-m)*batch)
    batch_norm_momentum: float = 0.9

    # conv knobs (NCHW)
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    n_channels: int = 1
    pooling: PoolingType = PoolingType.MAX

    # misc
    batch_size: int = 0             # 0 = whatever the iterator yields
    seed: int = 123
    dtype: str = "float32"          # params (master-weight) dtype
    compute_dtype: str = ""         # matmul/conv operand dtype ("" = dtype);
                                    # "bfloat16" = mixed precision: bf16 matmul
                                    # inputs, f32 accumulation, f32 params
    remat: bool = False             # recompute activations in backward,
                                    # trading FLOPs for memory (big batches)

    def replace(self, **kwargs) -> "NeuralNetConfiguration":
        return dataclasses.replace(self, **kwargs)

    # --- JSON serde (parity: toJson/fromJson, NeuralNetConfiguration.java:809-878)
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, enum.Enum):
                d[k] = v.value
        if d.get("dist") is not None and isinstance(self.dist, Distribution):
            d["dist"] = dataclasses.asdict(self.dist)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NeuralNetConfiguration":
        d = dict(d)
        conv = {
            "layer_type": LayerType,
            "activation": Activation,
            "weight_init": WeightInit,
            "loss_function": LossFunction,
            "optimization_algo": OptimizationAlgorithm,
            "visible_unit": RBMUnit,
            "hidden_unit": RBMUnit,
            "pooling": PoolingType,
        }
        for k, e in conv.items():
            if k in d and d[k] is not None:
                d[k] = e(d[k])
        if d.get("dist") is not None:
            d["dist"] = Distribution(**d["dist"])
        for k in ("momentum_after",):
            if k in d and d[k] is not None:
                d[k] = tuple(tuple(x) for x in d[k])
        for k in ("kernel_size", "stride", "padding",
                  "termination_conditions"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "NeuralNetConfiguration":
        return cls.from_dict(json.loads(s))


@dataclass(frozen=True)
class MultiLayerConfiguration:
    """Stacked-network config (reference `MultiLayerConfiguration.java:34-46`).

    `confs` is one `NeuralNetConfiguration` per layer (the last is normally an
    OUTPUT layer).  `pretrain`/`backprop` gate the phases of
    `MultiLayerNetwork.fit` exactly as the reference's `pretrain`/`backward`
    flags do (`MultiLayerNetwork.java:928-992`).  `input_preprocessors` maps
    layer index -> preprocessor name (see nn/layers/preprocessor.py).
    """

    confs: Tuple[NeuralNetConfiguration, ...] = ()
    pretrain: bool = False
    backprop: bool = True
    use_drop_connect: bool = False
    damping_factor: float = 10.0
    input_preprocessors: Tuple[Tuple[int, str], ...] = ()

    @property
    def n_layers(self) -> int:
        return len(self.confs)

    def conf(self, i: int) -> NeuralNetConfiguration:
        return self.confs[i]

    def preprocessor(self, i: int) -> Optional[str]:
        for idx, name in self.input_preprocessors:
            if idx == i:
                return name
        return None

    def override(self, i: int, **kwargs) -> "MultiLayerConfiguration":
        """A new conf whose layer `i` has `kwargs` replaced:
        `ListBuilder.override`'s per-layer override, on a built conf."""
        confs = list(self.confs)
        confs[i] = confs[i].replace(**kwargs)
        return dataclasses.replace(self, confs=tuple(confs))

    def replace(self, **kwargs) -> "MultiLayerConfiguration":
        return dataclasses.replace(self, **kwargs)

    def with_compute_dtype(self, compute_dtype: str) -> "MultiLayerConfiguration":
        """Every layer's matmul compute dtype set at once (what
        `layers.base.mixed_matmul` casts to); the param dtype stays."""
        return self.replace(confs=tuple(
            c.replace(compute_dtype=compute_dtype) for c in self.confs))

    def to_json(self) -> str:
        return json.dumps(
            {
                "confs": [c.to_dict() for c in self.confs],
                "pretrain": self.pretrain,
                "backprop": self.backprop,
                "use_drop_connect": self.use_drop_connect,
                "damping_factor": self.damping_factor,
                "input_preprocessors": [list(x) for x in self.input_preprocessors],
            },
            indent=2,
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return cls(
            confs=tuple(NeuralNetConfiguration.from_dict(c) for c in d["confs"]),
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True),
            use_drop_connect=d.get("use_drop_connect", False),
            damping_factor=d.get("damping_factor", 10.0),
            input_preprocessors=tuple(
                (int(i), str(n)) for i, n in d.get("input_preprocessors", [])
            ),
        )


class ListBuilder:
    """Fluent builder of a stacked-network conf, the JAX package's
    `ListBuilder`: `n_layers` copies of `base`, each changed by
    `hidden_layer_sizes` (n_in / n_out from the input width, the hidden
    widths and the output width) and `override(i, **fields)`, then
    `build()`. The conf it builds gives the JAX builder's `to_json`."""

    def __init__(self, base: NeuralNetConfiguration, n_layers: int):
        self._confs = [base] * n_layers
        self._pretrain = False
        self._backprop = True
        self._preprocessors: Dict[int, str] = {}

    def hidden_layer_sizes(self, sizes, n_in: int,
                           n_out: int) -> "ListBuilder":
        """Set n_in / n_out of every layer from the input width, the hidden
        widths and the output width."""
        dims = [n_in] + list(sizes) + [n_out]
        for i in range(len(self._confs)):
            self._confs[i] = self._confs[i].replace(n_in=dims[i],
                                                    n_out=dims[i + 1])
        return self

    def override(self, i: int, **kwargs) -> "ListBuilder":
        self._confs[i] = self._confs[i].replace(**kwargs)
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def input_preprocessor(self, i: int, name: str) -> "ListBuilder":
        self._preprocessors[i] = name
        return self

    def build(self) -> MultiLayerConfiguration:
        return MultiLayerConfiguration(
            confs=tuple(self._confs), pretrain=self._pretrain,
            backprop=self._backprop,
            input_preprocessors=tuple(sorted(self._preprocessors.items())))


def list_builder(base: NeuralNetConfiguration, n_layers: int) -> ListBuilder:
    return ListBuilder(base, n_layers)
