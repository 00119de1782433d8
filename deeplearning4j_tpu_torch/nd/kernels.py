"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

The counterpart of `deeplearning4j_tpu/nd/pallas_kernels.py`. Each kernel
lives in `deeplearning4j_tpu_torch/csrc/` as CUDA C++ with a plain C
interface. It is compiled with `nvcc` for `sm_90a` into a shared library at
first use (into `deeplearning4j_tpu_torch/_build/`, which git ignores) and
called through `ctypes`.

Each kernel has, beside it here:
- a wrapper that checks device, dtype, shape and strides, allocates the
  outputs with `torch.empty`, launches on the current stream and raises if
  the launch is refused. On a CPU tensor, and only there, the wrapper
  computes the plain version instead; on a CUDA tensor it launches the
  kernel or raises;
- a plain PyTorch version that repeats the kernel's arithmetic, for the CPU
  and for holding the kernel to on the card;
- a launch count in `LAUNCHES`, raised by one where the kernel launches
  (and, for a replayed CUDA graph, by what its capture launched:
  `count_launches`).

Kernels ported so far (see ROADMAP.md queue B for the rest):
- `flash_attention`: `_flash_attn_kernel` forward, with the optional
  logsumexp residual (`csrc/flash_attn_fwd.cu`; bf16 on TMA and `wgmma`,
  f32 on the tensor cores as 3xTF32 `mma.sync` with a `cp.async` ring);
- `flash_bwd_delta`, `flash_bwd_dkv`, `flash_bwd_dq`: the three kernels of
  the fused backward, `_flash_bwd_delta_kernel`, `_flash_bwd_dkv_kernel`
  and `_flash_bwd_dq_kernel` (`csrc/flash_attn_bwd.cu`; bf16 dK/dV and dQ
  on TMA and `wgmma`, f32 dK/dV and dQ as 3xTF32 `mma.sync` with
  `cp.async` staging), wired to the forward by `FlashAttentionFunction`;
- `lstm_cell`: `_lstm_cell_kernel`, one fused LSTM cell update
  (`csrc/lstm_cell.cu`), with `LSTMCellFunction` for its gradient;
- `scatter_add_rows`: `_scatter_add_kernel`, the embedding-row scatter-add
  (`csrc/scatter_add.cu`; f32 at D > 1 sums equal indices of a sorted
  chunk before its atomics, at D = 1 a thread an update), the backward of
  `gather_rows`.

The bf16 flash forward, dK/dV and dQ kernels read their inputs by TMA,
which takes a head dim of 64 or 128 on 16-byte aligned rows; `tma_heads` is
the rule for other inputs (zero-padded contiguous copies, counted in
`PAD_COPIES`). `csrc/hopper.cuh` holds what those kernels share;
`csrc/warp_mma.cuh` the `cp.async` copies and the 3xTF32 split and
`mma.sync` products of the f32 forward, dK/dV and dQ (its copies serve
the LSTM cell too). The f32 kernels take any head dim up to 128 in place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

import torch

from deeplearning4j_tpu_torch.nd.platform import is_hopper

_NEG_BIG = -1e30

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")

#: kernel library name -> its source under csrc/
SOURCES: Dict[str, str] = {"flash_attn_fwd": "flash_attn_fwd.cu",
                           "flash_attn_bwd": "flash_attn_bwd.cu",
                           "lstm_cell": "lstm_cell.cu",
                           "scatter_add": "scatter_add.cu"}

#: kernel (the C entry point) -> the library that holds it
KERNELS: Dict[str, str] = {"flash_attn_fwd": "flash_attn_fwd",
                           "flash_bwd_delta": "flash_attn_bwd",
                           "flash_bwd_dkv": "flash_attn_bwd",
                           "flash_bwd_dq": "flash_attn_bwd",
                           "lstm_cell": "lstm_cell",
                           "scatter_add_rows": "scatter_add"}

#: kernel name -> launches since the last `reset_launches()`
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: the flash forward's tile variants, "dtype:block_qxblock_k" -> launches of
#: that body since the last `reset_launches()` (each also counts in
#: LAUNCHES["flash_attn_fwd"])
TILE_LAUNCHES: Dict[str, int] = {"bf16:128x128": 0, "bf16:128x64": 0,
                                 "f32:64x32": 0, "f32:64x64": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: library name -> the compiler's output of its build (ptxas -v), also kept
#: beside the library as `<library>.log`
BUILD_LOGS: Dict[str, str] = {}


def reset_launches() -> None:
    with _lock:
        for counts in (LAUNCHES, TILE_LAUNCHES):
            for name in counts:
                counts[name] = 0


def _count(name: str, tile: Optional[str] = None) -> None:
    with _lock:
        LAUNCHES[name] += 1
        if tile is not None:
            TILE_LAUNCHES[tile] += 1


def launch_snapshot() -> Dict[str, int]:
    """LAUNCHES and TILE_LAUNCHES in one dict (their keys do not meet), for
    `count_launches` of a difference."""
    with _lock:
        out = dict(LAUNCHES)
        out.update(TILE_LAUNCHES)
        return out


def count_launches(counts: Dict[str, int]) -> None:
    """Add `counts` (kernel or tile-variant name -> launches, negative to
    take back) to LAUNCHES and TILE_LAUNCHES. The wrappers count on the
    host, so a CUDA-graph replay, which launches the kernels without running
    their wrappers, is counted here by what its capture counted
    (`optimize/step_cache.py`)."""
    with _lock:
        for name, n in counts.items():
            (TILE_LAUNCHES if name in TILE_LAUNCHES else LAUNCHES)[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_files(path: str, csrc: str) -> List[str]:
    """`path` and every header under `csrc` that it includes with quotes,
    directly or through another header, each once, in include order."""
    seen: List[str] = []
    todo = [path]
    while todo:
        cur = todo.pop(0)
        if cur in seen:
            continue
        seen.append(cur)
        with open(cur, encoding="utf-8") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            hdr = os.path.join(csrc, inc)
            if os.path.exists(hdr):
                todo.append(hdr)
    return seen


def _lib_path(name: str, csrc: str = _CSRC,
              build_dir: str = BUILD_DIR) -> str:
    """Where the library `name` is built: named by a hash of its source and
    of every header under `csrc` the source includes, so that a changed
    header builds a new library."""
    digest = hashlib.sha256()
    for path in _source_files(os.path.join(csrc, SOURCES[name]), csrc):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel libraries (all by default) for sm_90a, one
    `nvcc` per source, all started together; returns name -> library path.
    A library whose source is unchanged is not rebuilt."""
    if not is_hopper():
        raise RuntimeError("the port's kernels are built for sm_90a and need "
                           "a Hopper GPU (compute capability 9.0)")
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            if os.path.exists(out + ".log"):
                with open(out + ".log", encoding="utf-8") as f:
                    BUILD_LOGS[name] = f.read()
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        with open(out + ".log", "w", encoding="utf-8") as f:
            f.write(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {name: _lib_path(name) for name in names}


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    lib = ctypes.CDLL(path)
    if name == "flash_attn_fwd":
        fn = lib.flash_attn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    elif name == "flash_attn_bwd":
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_bwd_delta.argtypes = ([ptr] * 3 + [i32] * 4 + [i64] * 4
                                        + [i32, ptr])
        strides = [i64] * 8 + [ctypes.c_float, i32, i32, ptr]
        lib.flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 4 + strides
        lib.flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 4 + strides
        for fn in (lib.flash_bwd_delta, lib.flash_bwd_dkv, lib.flash_bwd_dq):
            fn.restype = ctypes.c_int
    elif name == "lstm_cell":
        lib.lstm_cell.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                                  + [ctypes.c_longlong] * 5
                                  + [ctypes.c_int, ctypes.c_void_p])
        lib.lstm_cell.restype = ctypes.c_int
    elif name == "scatter_add":
        lib.scatter_add_rows.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.scatter_add_rows.restype = ctypes.c_int
    with _lock:
        _libs.setdefault(name, lib)
        return _libs[name]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ---------------------------------------------------------------- attention

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              with_lse: bool = False,
                              scale: Optional[float] = None):
    """Plain PyTorch version of the flash-attention forward kernel, with the
    kernel's numerics: q * scale rounded in the input dtype, f32 scores,
    -1e30 causal masking, p rounded to v's dtype before P.V, and
    o = acc / max(l, 1e-30). It takes the softmax over the whole row at
    once (the kernel's online rescaling changes only f32 rounding).

    q, k, v: [B, S, H, D]. Returns o [B, S, H, D] in q's dtype and, with
    `with_lse`, the logsumexp residual [B*H, S, 1] f32. `scale` defaults to
    1 / sqrt(D) (a zero-padded D keeps the original one)."""
    b, s, h, d = q.shape
    # the scale rounded to q's dtype on the host, as the kernel rounds it;
    # a Python float keeps the function free of host-to-device copies
    scale = float(torch.tensor(1.0 / (d ** 0.5) if scale is None else scale,
                               dtype=q.dtype))
    qs = (q * scale).permute(0, 2, 1, 3).float()          # [B, H, S, D]
    kf = k.permute(0, 2, 1, 3).float()
    scores = qs @ kf.transpose(-1, -2)                     # [B, H, S, S]
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[None, :] > pos[:, None], _NEG_BIG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = p.to(v.dtype).float() @ v.permute(0, 2, 1, 3).float()
    o = (pv / l).to(q.dtype).permute(0, 2, 1, 3)
    if not with_lse:
        return o
    return o, (m + torch.log(l)).reshape(b * h, s, 1)


def _all_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_heads(what: str, **ts: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA [B, S, H, D] tensor of one shape,
    device and dtype (float32 or bfloat16), with unit stride over D and
    stride D over H (the heads of a fused projection qualify)."""
    names = ", ".join(ts)
    first = next(iter(ts.values()))
    if not all(t.is_cuda for t in ts.values()):
        raise ValueError(f"{what}: {names} must all be CUDA tensors (or all "
                         f"CPU tensors)")
    if any(t.device != first.device for t in ts.values()):
        raise ValueError(f"{what}: {names} are on different devices")
    if first.dim() != 4 or any(t.shape != first.shape for t in ts.values()):
        raise ValueError(f"{what}: {names} must share one [B, S, H, D] "
                         f"shape; got "
                         f"{[tuple(t.shape) for t in ts.values()]}")
    if first.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != first.dtype for t in ts.values()):
        raise ValueError(f"{what}: dtype must be float32 or bfloat16 for "
                         f"all of {names}; got "
                         f"{[t.dtype for t in ts.values()]}")
    d = first.shape[3]
    if not 1 <= d <= 128:
        raise ValueError(f"{what}: head_dim {d} not in [1, 128]")
    for name, t in ts.items():
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{what}: {name} needs unit stride over D and "
                             f"stride D over H; got strides {t.stride()}")


def _check_rows(what: str, like: torch.Tensor, **ts: torch.Tensor) -> None:
    """Raise unless each tensor is a contiguous [B*H, S, 1] float32 tensor
    beside `like` ([B, S, H, D]): the lse and delta layout."""
    b, s, h, _ = like.shape
    for name, t in ts.items():
        if (t.device != like.device or t.dtype != torch.float32
                or tuple(t.shape) != (b * h, s, 1) or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"[{b * h}, {s}, 1] tensor on {like.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _dtype_code(t: torch.Tensor) -> int:
    return 0 if t.dtype == torch.float32 else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


#: plain PyTorch copies made around the bf16 TMA kernels for inputs that a
#: tensor map cannot describe (`tma_heads`, `tma_slice`); the serving and
#: training paths make none
PAD_COPIES = 0


def tma_width(d: int) -> int:
    """The head dim the bf16 TMA kernels run a head dim d at: 64 or 128."""
    return 64 if d <= 64 else 128


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether a tensor map reads t ([B, S, H, D], unit stride over D and
    stride D over H) in place: D of 64 or 128, the sequence and batch
    strides and the base 16-byte aligned in bf16."""
    return (t.shape[3] in (64, 128) and t.stride(1) % 8 == 0
            and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0)


def _count_copy() -> None:
    global PAD_COPIES
    with _lock:
        PAD_COPIES += 1


def tma_heads(*ts: torch.Tensor) -> List[torch.Tensor]:
    """The rule for [B, S, H, D] inputs of one D that the bf16 TMA kernels
    cannot read in place: each comes back as it is where a tensor map can
    describe it, else as a contiguous copy zero-padded along D to
    `tma_width(D)`. Zero columns change neither Q.K^T nor the first D
    columns of P.V, dK or dV; the caller keeps the original D's scale and
    cuts the outputs back with `tma_slice`. Plain copies around the kernel,
    not a fallback: the kernel still runs. Each copy counts in
    PAD_COPIES."""
    d = ts[0].shape[3]
    width = tma_width(d)
    out = []
    for t in ts:
        if d == width and _tma_ready(t):
            out.append(t)
            continue
        padded = t.new_zeros(tuple(t.shape[:3]) + (width,))
        padded[..., :d] = t
        out.append(padded)
        _count_copy()
    return out


def tma_slice(t: torch.Tensor, d: int) -> torch.Tensor:
    """An output of a padded launch cut back to head dim d, contiguous (a
    counted copy); t itself when it already has d."""
    if t.shape[3] == d:
        return t
    _count_copy()
    return t[..., :d].contiguous()


def fwd_tiles(dtype: torch.dtype, head_dim: int):
    """The (block_q, block_k) tiles the flash forward's body for `dtype` is
    built with at `head_dim`, its default first: bf16 (the TMA body) 128
    queries a block and 128 or 64 keys a tile; f32 (the 3xTF32 body) 64
    queries and, by head-dim bucket, 32 (D <= 32), 64 or 32 (D <= 64), 32 or
    64 (D <= 128)."""
    if dtype == torch.bfloat16:
        return ((128, 128), (128, 64))
    if head_dim <= 32:
        return ((64, 32),)
    if head_dim <= 64:
        return ((64, 64), (64, 32))
    return ((64, 32), (64, 64))


def bwd_tile(dtype: torch.dtype, head_dim: int):
    """The one (block_q, block_k) tile the dK/dV kernel is built with for
    `dtype` at `head_dim` (the dQ kernel's is its transpose in bf16)."""
    if dtype == torch.bfloat16:
        return (64, 128)
    return (16, 64) if head_dim > 64 else (32, 64)


def tile_name(dtype: torch.dtype, tile) -> str:
    """The TILE_LAUNCHES key of a tile variant, e.g. "bf16:128x64"."""
    return "%s:%dx%d" % ("bf16" if dtype == torch.bfloat16 else "f32",
                         tile[0], tile[1])


def resolve_fwd_tile(dtype: torch.dtype, seq: int, head_dim: int,
                     tile=None):
    """The forward tile of a call at (seq, head_dim): `tile` when given,
    else the `attention.block_fwd` tunable at "{seq}x{head_dim}" (an
    installed tuned table's entry; None is the body's default). Raises
    ValueError on a tile the body is not built with."""
    if tile is None:
        from deeplearning4j_tpu_torch.optimize import tunables

        tile = tunables.resolve("attention.block_fwd",
                                "%dx%d" % (seq, head_dim))
    tiles = fwd_tiles(dtype, head_dim)
    if tile is None:
        return tiles[0]
    tile = tuple(int(t) for t in tile)
    if tile not in tiles:
        raise ValueError(
            f"attention.block_fwd {tile} at {seq}x{head_dim}: the "
            f"{str(dtype).replace('torch.', '')} forward is built with "
            f"the tiles {list(tiles)}")
    return tile


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, with_lse: bool = False,
                   tile=None):
    """Wrapper of the flash-attention forward kernel over [B, S, H, D]
    inputs (any S, head_dim up to 128, float32 or bfloat16). Returns o
    [B, S, H, D] and, with `with_lse`, the logsumexp residual [B*H, S, 1]
    float32 that the fused backward consumes. No autograd: see
    `flash_attention`.

    CUDA tensors launch `csrc/flash_attn_fwd.cu`; CPU tensors take
    `flash_attention_reference`. Inputs may be views (the heads of a fused
    qkv projection) as long as D has unit stride and H stride D. `tile`
    ((block_q, block_k), one of `fwd_tiles`) picks the body's variant; None
    resolves it (`resolve_fwd_tile`). The plain version is the same for
    every tile."""
    tile = resolve_fwd_tile(q.dtype, q.shape[1], q.shape[3], tile)
    if _all_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal, with_lse)
    _check_heads("flash_attention", q=q, k=k, v=v)
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    if q.dtype == torch.bfloat16:
        q, k, v = tma_heads(q, k, v)
    width = q.shape[3]
    lib = _library("flash_attn_fwd")
    o = torch.empty((b, s, h, width), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, s, width,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), scale, int(bool(causal)),
            _dtype_code(q), tile[1], _stream(q))
    _check(err, "flash_attn_fwd")
    _count("flash_attn_fwd", tile_name(q.dtype, tile))
    o = tma_slice(o, d)
    return (o, lse) if with_lse else o


# ------------------------------------------------------- fused flash bwd

def _to_bhsd(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B, H, S, D] float32."""
    return t.permute(0, 2, 1, 3).float()


def _rows(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B*H, S, 1] lse or delta as [B, H, S, 1] beside `like`."""
    b, s, h, _ = like.shape
    return t.reshape(b, h, s, 1)


def _bwd_probs(q, k, v, do, lse, delta, causal, scale=None):
    """What the dK/dV and dQ kernels share: f32 q, k and dO in [B, H, S, D]
    and, over the whole [S, S], p = exp(s * scale - lse) with -1e30 causal
    masking and ds = p * (dO V^T - delta) * scale, in f32 (scale 1 /
    sqrt(D) unless given). q is not pre-rounded, unlike the forward."""
    s_len, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    qf, kf, vf, dof = (_to_bhsd(t) for t in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(s_len, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], _NEG_BIG)
    p = torch.exp(s - _rows(lse, q))
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - _rows(delta, q)) * scale
    return qf, kf, dof, p, ds


def _from_bhsd(t: torch.Tensor, dtype) -> torch.Tensor:
    """[B, H, S, D] f32 -> contiguous [B, S, H, D] in `dtype`."""
    return t.to(dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_delta_reference(o: torch.Tensor,
                              do: torch.Tensor) -> torch.Tensor:
    """Plain version of the delta kernel: rowsum(f32(dO) * f32(O)) per
    (batch*head, row), as [B*H, S, 1] float32."""
    b, s, h, _ = o.shape
    rows = (o.float() * do.float()).sum(dim=-1)            # [B, S, H]
    return rows.permute(0, 2, 1).reshape(b * h, s, 1).contiguous()


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain version of the dK/dV kernel, its arithmetic over the whole
    [S, S] at once: dV = P^T dO and dK = dS^T Q in f32, cast to k's and
    v's dtype. Inputs [B, S, H, D], lse and delta [B*H, S, 1]; returns
    (dk, dv) as contiguous [B, S, H, D]. `scale` defaults to 1 / sqrt(D)."""
    qf, _, dof, p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dv = p.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf
    return _from_bhsd(dk, k.dtype), _from_bhsd(dv, v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None):
    """Plain version of the dQ kernel: dQ = dS K in f32, cast to q's
    dtype, as a contiguous [B, S, H, D]. `scale` defaults to
    1 / sqrt(D)."""
    _, kf, _, _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return _from_bhsd(ds @ kf, q.dtype)


def _unit_stride(do: torch.Tensor) -> torch.Tensor:
    """dO as autograd hands it over may have any strides; the kernels take
    unit stride over D and stride D over H (else one copy is made)."""
    d = do.shape[3]
    return do if do.stride(3) == 1 and do.stride(2) == d else \
        do.contiguous()


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Wrapper of the delta kernel: o and dO [B, S, H, D] -> delta
    [B*H, S, 1] float32. CUDA tensors launch `csrc/flash_attn_bwd.cu`; CPU
    tensors take `flash_bwd_delta_reference`."""
    if _all_cpu(o, do):
        return flash_bwd_delta_reference(o, do)
    do = _unit_stride(do)
    _check_heads("flash_bwd_delta", o=o, do=do)
    b, s, h, d = o.shape
    lib = _library("flash_attn_bwd")
    delta = torch.empty((b * h, s, 1), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = lib.flash_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, h, s, d,
            o.stride(0), o.stride(1), do.stride(0), do.stride(1),
            _dtype_code(o), _stream(o))
    _check(err, "flash_bwd_delta")
    _count("flash_bwd_delta")
    return delta


def _bwd_launch(name, q, k, v, do, lse, delta, causal, n_out):
    """Launch the dK/dV (`n_out` 2) or dQ (1) kernel on CUDA tensors: the
    inputs checked, bf16 inputs through `tma_heads` at the original head
    dim's scale, the outputs allocated as contiguous [B, S, H, D] in the
    inputs' dtype and cut back with `tma_slice`."""
    do = _unit_stride(do)
    _check_heads(name, q=q, k=k, v=v, do=do)
    _check_rows(name, q, lse=lse, delta=delta)
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    if q.dtype == torch.bfloat16:
        q, k, v, do = tma_heads(q, k, v, do)
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
            for _ in range(n_out)]
    lib = _library("flash_attn_bwd")
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b, h, s, q.shape[3], q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), do.stride(0),
            do.stride(1), scale, int(bool(causal)), _dtype_code(q),
            _stream(q))
    _check(err, name)
    _count(name)
    return [tma_slice(t, d) for t in outs]


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """Wrapper of the dK/dV kernel. q, k, v, dO [B, S, H, D] (views with
    unit stride over D and stride D over H), lse and delta [B*H, S, 1]
    float32; returns (dk, dv), contiguous [B, S, H, D] in the inputs'
    dtype. CUDA tensors launch `csrc/flash_attn_bwd.cu` (bf16 through
    `tma_heads`); CPU tensors take `flash_bwd_dkv_reference`."""
    if _all_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    dk, dv = _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, causal, 2)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """Wrapper of the dQ kernel; arguments as `flash_bwd_dkv`. Returns dq,
    contiguous [B, S, H, D] in q's dtype. CUDA tensors launch
    `csrc/flash_attn_bwd.cu` (bf16 through `tma_heads`); CPU tensors take
    `flash_bwd_dq_reference`."""
    if _all_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    (dq,) = _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, causal, 1)
    return dq


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a backward, mirroring the JAX package's
    `flash_attention` custom_vjp (pallas_kernels.py:439-524).

    `fused_bwd=True`: the forward also emits the logsumexp residual and
    saves (q, k, v, o, lse); the backward runs delta -> dK/dV -> dQ, the
    three kernels (their plain versions on CPU tensors). Unlike the JAX
    package, a ragged S takes this path too: the kernels mask the tail.
    `fused_bwd=False`: the backward recomputes attention through autograd
    of `nd/attention.blockwise_attention`, as the JAX package's flag-off
    path does (:518-521). The flag chooses the path; nothing falls back."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, fused_bwd: bool):
        ctx.causal, ctx.fused_bwd = bool(causal), bool(fused_bwd)
        if ctx.fused_bwd:
            o, lse = flash_attn_fwd(q, k, v, causal, with_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = flash_attn_fwd(q, k, v, causal)
            ctx.save_for_backward(q, k, v)
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.fused_bwd:
            q, k, v, o, lse = ctx.saved_tensors
            delta = flash_bwd_delta(o, g)
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.causal)
            dq = flash_bwd_dq(q, k, v, g, lse, delta, ctx.causal)
            return dq, dk, dv, None, None
        from deeplearning4j_tpu_torch.nd.attention import blockwise_attention

        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = blockwise_attention(q, k, v, block_size=512,
                                      causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, with_lse: bool = False,
                    fused_bwd: bool = False):
    """Flash attention over [B, S, H, D] inputs: o [B, S, H, D] and, with
    `with_lse`, the logsumexp residual [B*H, S, 1] float32.

    Without grad (inference, `inference_mode`) this is the forward kernel's
    wrapper `flash_attn_fwd` alone, which launches without the lse unless
    asked. When autograd needs a gradient of q, k or v it goes through
    `FlashAttentionFunction`, whose backward is the fused kernels
    (`fused_bwd=True`) or a blockwise recompute; `with_lse` has no
    gradient and raises there."""
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if not needs_grad:
        return flash_attn_fwd(q, k, v, causal, with_lse)
    if with_lse:
        raise ValueError("flash_attention: with_lse=True has no gradient; "
                         "call it without grad")
    return FlashAttentionFunction.apply(q, k, v, causal, fused_bwd)


# ---------------------------------------------------------------- LSTM cell

def lstm_cell_reference(x, h, c, wx, wh, b):
    """Plain PyTorch version of the fused LSTM cell, the twin of the JAX
    package's `_lstm_reference` with the kernel's numerics: z = (x.Wx +
    h.Wh) + b in f32 (bf16 operands widened first, as the kernel sums them
    in f32), gates [i | f | o | g], c' = sigmoid(f) * c + sigmoid(i) *
    tanh(g) and h' = sigmoid(o) * tanh(c') in f32, h' and c' rounded once
    to h's and c's dtype.

    x [B, I], h and c [B, H], wx [I, 4H], wh [H, 4H], b [4H] -> (h', c')."""
    hdim = h.shape[1]
    z = (x.float() @ wx.float() + h.float() @ wh.float()) + b.float()
    i = torch.sigmoid(z[:, :hdim])
    f = torch.sigmoid(z[:, hdim:2 * hdim])
    o = torch.sigmoid(z[:, 2 * hdim:3 * hdim])
    g = torch.tanh(z[:, 3 * hdim:])
    c_new = f * c.float() + i * g
    return (o * torch.tanh(c_new)).to(h.dtype), c_new.to(c.dtype)


def _check_cell(x, h, c, wx, wh, b) -> None:
    """Raise unless the six operands are CUDA tensors of one device and one
    dtype (float32 or bfloat16) with the cell's shapes, unit stride over
    their last dimension (row-strided views are taken) and b contiguous."""
    ts = {"x": x, "h": h, "c": c, "wx": wx, "wh": wh, "b": b}
    if not all(t.is_cuda for t in ts.values()):
        raise ValueError("lstm_cell: x, h, c, wx, wh, b must all be CUDA "
                         "tensors (or all CPU tensors)")
    if any(t.device != x.device for t in ts.values()):
        raise ValueError("lstm_cell: the operands are on different devices")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in ts.values()):
        raise ValueError(f"lstm_cell: dtype must be float32 or bfloat16 for "
                         f"all operands; got "
                         f"{[str(t.dtype) for t in ts.values()]}")
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"lstm_cell: x and h must be 2-D; got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    bsz, n_in = x.shape
    n_h = h.shape[1]
    want = {"x": (bsz, n_in), "h": (bsz, n_h), "c": (bsz, n_h),
            "wx": (n_in, 4 * n_h), "wh": (n_h, 4 * n_h), "b": (4 * n_h,)}
    for name, t in ts.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"lstm_cell: {name} must have shape "
                             f"{want[name]}; got {tuple(t.shape)}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"lstm_cell: {name} needs unit stride over its "
                             f"last dimension; got strides {t.stride()}")


def lstm_cell(x, h, c, wx, wh, b):
    """Wrapper of the fused LSTM cell kernel: (h', c') from x [B, I], h and
    c [B, H], wx [I, 4H], wh [H, 4H] and b [4H], in h's and c's dtype
    (contiguous [B, H]). No autograd: see `fused_lstm_step`.

    CUDA tensors launch `csrc/lstm_cell.cu`; CPU tensors take
    `lstm_cell_reference`. x, h, c, wx and wh may be row-strided views (a
    time step of [B, T, I]; the two row blocks of one fused W)."""
    if _all_cpu(x, h, c, wx, wh, b):
        return lstm_cell_reference(x, h, c, wx, wh, b)
    _check_cell(x, h, c, wx, wh, b)
    bsz, n_in = x.shape
    n_h = h.shape[1]
    h_out = torch.empty((bsz, n_h), dtype=h.dtype, device=h.device)
    c_out = torch.empty((bsz, n_h), dtype=c.dtype, device=c.device)
    lib = _library("lstm_cell")
    with torch.cuda.device(x.device):
        err = lib.lstm_cell(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
            wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            bsz, n_in, n_h, x.stride(0), h.stride(0), c.stride(0),
            wx.stride(0), wh.stride(0), _dtype_code(x), _stream(x))
    _check(err, "lstm_cell")
    _count("lstm_cell")
    return h_out, c_out


class LSTMCellFunction(torch.autograd.Function):
    """The fused LSTM cell with a backward, mirroring the JAX package's
    `fused_lstm_step` custom_vjp (pallas_kernels.py:573-592): the forward
    is the kernel (`lstm_cell`) and saves its six operands; the backward
    recomputes the cell through `lstm_cell_reference` and returns its
    gradients, as `_lstm_bwd` takes the VJP of `_lstm_reference`. Those are
    plain matmuls outside any TPU kernel; the JAX package has no backward
    kernel for the cell."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return lstm_cell(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, gh, gc):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = lstm_cell_reference(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, (gh, gc)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def fused_lstm_step(x, h, c, wx, wh, b):
    """One fused LSTM cell update, x [B, I], h and c [B, H], wx [I, 4H],
    wh [H, 4H], b [4H] -> (h', c'); the port of the JAX package's
    `fused_lstm_step`. Without grad (inference, `inference_mode`) this is
    the kernel's wrapper `lstm_cell` alone; when autograd needs a gradient
    of any operand it goes through `LSTMCellFunction`."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, h, c, wx, wh, b))
    if not needs_grad:
        return lstm_cell(x, h, c, wx, wh, b)
    return LSTMCellFunction.apply(x, h, c, wx, wh, b)


# -------------------------------------------------------------- scatter-add

def _check_scatter(table: torch.Tensor, indices: torch.Tensor,
                   updates: torch.Tensor) -> None:
    """Raise TypeError unless the table is float32 or bfloat16 (bfloat16
    with an even row width), the indices int32 or int64 and the updates of
    the table's dtype; ValueError unless table [R, D] or [R], indices [N]
    and updates [N, D] or [N] agree."""
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_add_rows: the table must be float32 or "
                        f"bfloat16; got {table.dtype}")
    if indices.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add_rows: indices must be int32 or int64; "
                        f"got {indices.dtype}")
    if updates.dtype != table.dtype:
        raise TypeError(f"scatter_add_rows: updates must have the table's "
                        f"dtype {table.dtype}; got {updates.dtype}")
    if table.dim() not in (1, 2) or indices.dim() != 1 or tuple(
            updates.shape) != (indices.shape[0],) + tuple(table.shape[1:]):
        raise ValueError(f"scatter_add_rows: want table [R, D] or [R], "
                         f"indices [N] and updates [N, D] or [N]; got "
                         f"{tuple(table.shape)}, {tuple(indices.shape)} and "
                         f"{tuple(updates.shape)}")
    width = table.shape[1] if table.dim() == 2 else 1
    if table.dtype == torch.bfloat16 and width % 2:
        raise TypeError(f"scatter_add_rows: bfloat16 tables add column "
                        f"pairs and need an even row width; got {width}")


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """A 1-D table or update vector (a bias) as an [n, 1] view."""
    return t.unsqueeze(1) if t.dim() == 1 else t


def scatter_add_rows_reference(table: torch.Tensor, indices: torch.Tensor,
                               updates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the scatter-add kernel: a new tensor, the
    table with updates[n] added to row indices[n] for every n, duplicates
    accumulating in the table's dtype. Rows outside [0, R) are skipped, as
    the kernel skips them: they are sent to a spare row that is dropped, so
    the function holds no host sync and can be graph-captured.

    On the CPU the sums are the JAX kernel's: each row adds its updates
    one at a time in the order of n, rounding to the table's dtype after
    every add, the same on every run whatever the thread count. float32
    goes through `index_add_`, which walks n serially there (`index_put_`
    with accumulate adds float32 with parallel atomics from 32,768
    elements up); bfloat16 through `index_put_`, which is serial for every
    dtype but float32 (`index_add_` would sum bfloat16 in float32). On
    CUDA `index_put_` sorts the indices and adds each row's updates in
    order.

    table [R, D] or [R] (float32 or bfloat16), indices [N] (int32 or
    int64), updates [N, D] or [N] in the table's dtype."""
    _check_scatter(table, indices, updates)
    rows = _as_rows(table)
    r = rows.shape[0]
    idx = indices.long()
    idx = torch.where((idx >= 0) & (idx < r), idx, r)
    ext = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    upd = _as_rows(updates)
    if ext.is_cuda or ext.dtype != torch.float32:
        ext.index_put_((idx,), upd, accumulate=True)
    else:
        # unit column stride keeps index_add_ on its serial row loop
        ext.index_add_(0, idx, upd.contiguous())
    return ext[:r].reshape(table.shape)


def scatter_add_rows_(table: torch.Tensor, indices: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """In place: table[indices[n]] += updates[n] for every n, duplicates
    accumulating, rows outside [0, R) skipped; returns the table. Shapes
    and dtypes as `scatter_add_rows_reference` (TypeError for any other
    dtype, or bfloat16 with an odd row width).

    CUDA tensors launch `csrc/scatter_add.cu` (no launch when N is 0);
    CPU tensors take the plain version. The table needs unit column stride
    (and, in bfloat16, an even row stride); updates may be row-strided."""
    _check_scatter(table, indices, updates)
    if _all_cpu(table, indices, updates):
        return table.copy_(scatter_add_rows_reference(table, indices,
                                                      updates))
    if not (table.is_cuda and indices.is_cuda and updates.is_cuda):
        raise ValueError("scatter_add_rows: table, indices and updates must "
                         "all be CUDA tensors (or all CPU tensors)")
    if indices.device != table.device or updates.device != table.device:
        raise ValueError("scatter_add_rows: the operands are on different "
                         "devices")
    rows, upd = _as_rows(table), _as_rows(updates)
    r, d = rows.shape
    if rows.stride(1) != 1 and d > 1:
        raise ValueError(f"scatter_add_rows: the table needs unit column "
                         f"stride; got strides {rows.stride()}")
    if table.dtype == torch.bfloat16 and (rows.stride(0) % 2
                                          or rows.data_ptr() % 4):
        raise ValueError("scatter_add_rows: a bfloat16 table needs an even "
                         "row stride and 4-byte alignment")
    if upd.stride(1) != 1 and d > 1:
        upd = upd.contiguous()
    idx = indices.contiguous()
    n = idx.shape[0]
    if n == 0 or r == 0:
        return table
    lib = _library("scatter_add")
    with torch.cuda.device(table.device):
        err = lib.scatter_add_rows(
            rows.data_ptr(), idx.data_ptr(), upd.data_ptr(), r, n, d,
            rows.stride(0), upd.stride(0), int(idx.dtype == torch.int64),
            _dtype_code(rows), _stream(rows))
    _check(err, "scatter_add_rows")
    _count("scatter_add_rows")
    return table


def scatter_add_rows(table: torch.Tensor, indices: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """table[indices[n]] += updates[n] with duplicate indices accumulating,
    as a new tensor (the table is not changed), like the JAX package's
    `scatter_add_rows`. CUDA tensors launch `csrc/scatter_add.cu` on a
    contiguous copy of the table; CPU tensors take
    `scatter_add_rows_reference`."""
    if _all_cpu(table, indices, updates):
        return scatter_add_rows_reference(table, indices, updates)
    return scatter_add_rows_(table.clone(memory_format=torch.contiguous_format),
                             indices, updates)


class GatherRowsFunction(torch.autograd.Function):
    """table[idx] for a table [R, D] or [R] and integer idx of any shape
    (result idx.shape + table.shape[1:]), whose backward is the scatter-add
    kernel. The forward is plain indexing (the JAX package's gather is no
    Pallas kernel) and needs indices in [0, R); the gradient of the table
    is a fresh zero table of its shape and dtype with the output's gradient
    rows added at idx (`scatter_add_rows_`: the kernel on CUDA tensors, its
    plain version on CPU tensors), the `zeros_like(table).at[idx].add(g)`
    that `jax.grad` takes of a gather."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        grad = g.new_zeros(shape)
        scatter_add_rows_(grad, idx.reshape(-1), g.reshape(-1, *shape[1:]))
        return grad, None


#: gather_rows(table, idx): table[idx] with the scatter-add kernel as its
#: backward (`GatherRowsFunction`)
gather_rows = GatherRowsFunction.apply
