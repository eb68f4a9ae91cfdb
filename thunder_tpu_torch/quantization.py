"""Int8 serving: per-output-channel weight quantization and the W8A8 products.

Port of ``thunder_tpu/quantization.py``, for the port's ``state_dict`` names
(dotted keys; ``bridge.py`` maps them onto flax paths):

- :func:`quantize_array`: the one recipe, per-output-channel symmetric int8
  with a float32 scale, the same numpy steps as the JAX package's, so the
  int8 values and scales are bit-equal to its;
- :func:`quantize_tree` (weight-only: every Dense kernel and 1x1 conv kernel
  ``k`` becomes ``k.__q8_values`` + ``k.__q8_scale``) and :func:`dequantize`,
  which rebuilds compute-dtype kernels as ``q.to(dtype) * scale.to(dtype)``;
- :func:`quantize_tree_compute` (W8A8: the transformer's four big Dense
  layers, :data:`INT8_COMPUTE_DENSE_NAMES`, and the feature extractor's convs
  with at least 64 input channels a group; ``k`` becomes ``kernel_q8`` +
  ``kernel_scale``), consumed by :func:`dynamic_int8_matmul` and
  :func:`dynamic_int8_conv`;
- :func:`quantize_variables`, :func:`dequantize_variables` and
  :func:`quantization_summary` over a whole ``state_dict``.

The two dynamic products quantize the activations in float32 with plain
PyTorch ops in the JAX functions' order (absmax / 127, at least 1e-12,
divide, round half to even, cast), so their int8 operands are bit-equal to
the JAX functions' on the same input. The integer product (:func:`int8_mm`)
is ``torch._int_mm`` on the card (cuBLASLt's int8 tensor-core GEMM with
int32 accumulation; the JAX package leaves this product to XLA, it is not one
of its Pallas kernels) and an exact float64 product on the CPU. Either way the
sums are exact: ``127 * 127 * K`` stays below 2**31 for K up to 133,000.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "INT8_COMPUTE_DENSE_NAMES",
    "quantize_array",
    "quantize_tree",
    "quantize_tree_compute",
    "dequantize",
    "int8_mm",
    "int8_mm_reference",
    "column_major",
    "dynamic_int8_matmul",
    "dynamic_int8_conv",
    "quantize_variables",
    "dequantize_variables",
    "quantization_summary",
]

#: Dense submodule names whose GEMMs run in int8 under ``int8_compute`` serving (the transformer's four big
#: products; the convs below 64 input channels, the norms, ``fp_projection`` and the head stay in the compute dtype)
INT8_COMPUTE_DENSE_NAMES = ("qkv_proj", "out_proj", "intermediate_dense", "output_dense")

#: ``torch._int_mm`` wants more than 16 rows and both widths a multiple of 8: :func:`int8_mm` pads to these
INT_MM_MIN_ROWS, INT_MM_MULTIPLE = 17, 8

VALUES, SCALE = "__q8_values", "__q8_scale"


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _should_quantize(name: str, x) -> bool:
    """Matmul weights: Dense kernels (2-D) and pointwise conv kernels (k = 1); wide time convs stay float."""
    if name.rsplit(".", 1)[-1] != "kernel" or np.ndim(x) < 2:
        return False
    return np.ndim(x) == 2 or (np.ndim(x) == 3 and np.shape(x)[0] == 1)


def quantize_array(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: ``(int8 values, float32 scale)``, the scale with the leading axes
    kept as 1 (the JAX function's recipe, step for step)."""
    w = np.asarray(_numpy(w), np.float32)
    absmax = np.abs(w).max(axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_tree(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state_dict`` -> the same with every matmul kernel ``k`` as ``k.__q8_values`` (int8) and ``k.__q8_scale``
    (float32); every other entry as it is. CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, x in state.items():
        if _should_quantize(name, x):
            q, scale = quantize_array(x)
            out[f"{name}.{VALUES}"], out[f"{name}.{SCALE}"] = torch.from_numpy(q), torch.from_numpy(scale)
        else:
            out[name] = x
    return out


def dequantize(state: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Compute-dtype kernels from a :func:`quantize_tree` tree: ``q.to(dtype) * scale.to(dtype)`` (the JAX
    package's ``dequantize_tree_jax``); every other entry as it is."""
    out: Dict[str, torch.Tensor] = {}
    for name, x in state.items():
        if name.endswith(f".{VALUES}"):
            base = name[: -len(VALUES) - 1]
            out[base] = x.to(dtype) * state[f"{base}.{SCALE}"].to(dtype)
        elif not name.endswith(f".{SCALE}"):
            out[name] = x
    return out


def quantize_tree_compute(state: Mapping[str, torch.Tensor], extractor_convs: bool = True) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a wav2vec2 encoder -> the ``int8_compute`` serving tree: each kernel of a Dense named in
    :data:`INT8_COMPUTE_DENSE_NAMES`, and (``extractor_convs``) each 3-D kernel under ``feature_extractor`` with
    at least 64 input channels, becomes ``kernel_q8`` (int8, its shape) and ``kernel_scale`` (float32, one a
    output channel)."""
    out: Dict[str, torch.Tensor] = {}
    for name, x in state.items():
        parts = name.split(".")
        dense_hit = (parts[-1] == "kernel" and len(parts) >= 2 and parts[-2] in INT8_COMPUTE_DENSE_NAMES
                     and np.ndim(x) == 2)
        conv_hit = (extractor_convs and parts[-1] == "kernel" and "feature_extractor" in parts and np.ndim(x) == 3
                    and np.shape(x)[1] >= 64)
        if dense_hit or conv_hit:
            q, scale = quantize_array(x)
            prefix = ".".join(parts[:-1])
            out[f"{prefix}.kernel_q8"], out[f"{prefix}.kernel_scale"] = (torch.from_numpy(q),
                                                                         torch.from_numpy(scale.reshape(-1)))
        else:
            out[name] = x
    return out


def int8_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_mm`: the product in float64, exact (every partial sum is an integer below
    2**53), as int32; on any device."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def column_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` with its last axis outermost in memory (same shape and values): an int8 weight ``(K, N)`` (or
    ``(taps, C_in, C_out)``) laid out as :func:`int8_mm` takes it fastest. cuBLASLt's int8 tensor-core kernels
    on Hopper want both operands K-major; with a row-major ``(K, N)`` it falls back to a slower kernel."""
    return q.movedim(-1, 0).contiguous().movedim(0, -1)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (K, N) int8 -> (M, N) int32``, exact.

    Rows are padded with zeros to at least :data:`INT_MM_MIN_ROWS` and K and N to multiples of
    :data:`INT_MM_MULTIPLE` (zero rows and columns add nothing), then sliced back: on the card the product is
    ``torch._int_mm``, which refuses other sizes; on the CPU it is :func:`int8_mm_reference`. ``b`` is taken in
    the layout it comes in (:func:`column_major` is the fast one on the card). ``launches`` counts the
    ``torch._int_mm`` calls."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_mm takes int8 (M, K) @ (K, N), got {a.dtype} {tuple(a.shape)} @ {b.dtype} "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(INT_MM_MIN_ROWS - m, 0), -k % INT_MM_MULTIPLE, -n % INT_MM_MULTIPLE
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    if a.device.type == "cpu":
        out = int8_mm_reference(a, b)
    elif a.device.type == "cuda":
        out = torch._int_mm(a.contiguous(), b)
        int8_mm.launches += 1
    else:
        raise ValueError(f"int8_mm runs on cuda or cpu tensors, got {a.device}")
    return out[:m, :n] if pad_m or pad_n else out


int8_mm.launches = 0


def _quantize_rows(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> ``(int8 values, float32 scale)``, one symmetric absmax scale over ``dims``: the JAX functions'
    float32 steps, ``max|x| / 127``, at least 1e-12, ``round(x / s)``. The absmax is taken in ``x``'s own
    dtype (exact) and the quotient by 127 in float64 then rounded to float32, which is the correctly rounded
    float32 quotient on every device (a float32 division by a Python number multiplies by its reciprocal on
    the card)."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=dims, keepdim=True)
    s = (amax.double() / 127.0).float().clamp_min(1e-12)
    return torch.div(x, s).round_().to(torch.int8), s


def dynamic_int8_matmul(x: torch.Tensor, kernel_q8: torch.Tensor, kernel_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(kernel)`` as an int8 x int8 -> int32 product, float32 out.

    ``x``: float ``(..., K)``, quantized per row (absmax / 127); ``kernel_q8``: int8 ``(K, N)``; ``kernel_scale``:
    float32 ``(N,)``. Returns ``acc * s * kernel_scale`` in float32, ``(..., N)``."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, s = _quantize_rows(x, -1)
    acc = int8_mm(xq.reshape(-1, k), kernel_q8)
    return (acc.float() * s.reshape(-1, 1) * kernel_scale).reshape(*lead, -1)


def dynamic_int8_conv(x: torch.Tensor, kernel_q8: torch.Tensor, kernel_scale: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """A VALID 1-D conv as an int8 x int8 -> int32 product, float32 out.

    ``x``: float ``(B, T, C_in)``, quantized with one absmax scale a sample; ``kernel_q8``: int8 ``(K, C_in,
    C_out)``; ``kernel_scale``: float32 ``(C_out,)``. The product is one :func:`int8_mm` over the frames'
    windows laid out as rows (an int8 im2col, ``(B T_out, K C_in)``, taps outermost as in the kernel). Returns
    ``(B, T_out, C_out)``."""
    batch, _, c_in = x.shape
    taps, _, c_out = kernel_q8.shape
    xq, s = _quantize_rows(x, (1, 2))
    windows = xq.unfold(1, taps, stride)  # (B, T_out, C_in, K)
    t_out = windows.shape[1]
    rows = windows.transpose(2, 3).reshape(batch * t_out, taps * c_in)
    acc = int8_mm(rows, kernel_q8.reshape(taps * c_in, c_out))
    return acc.float().reshape(batch, t_out, c_out) * s * kernel_scale


def quantize_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A model's ``state_dict`` with its matmul kernels quantized (:func:`quantize_tree`); the batch-norm
    statistics and every other entry as they are."""
    return quantize_tree(state)


def dequantize_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_variables`: float32 kernels, ``q * scale`` in float32."""
    return dequantize(state, torch.float32)


def quantization_summary(state: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Bytes of the quantized entries (values and scales) and of the rest."""
    f32 = q8 = 0
    for name, x in state.items():
        nbytes = _numpy(x).nbytes
        if name.endswith((f".{VALUES}", f".{SCALE}")):
            q8 += nbytes
        else:
            f32 += nbytes
    return {"float_bytes": float(f32), "quantized_bytes": float(q8)}
