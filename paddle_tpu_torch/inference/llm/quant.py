"""Quantized serving: int8 weights and quantized KV pages.

Counterpart of ``paddle_tpu/inference/llm/quant.py``. Two independent
knobs:

- **KV pages** (``QuantConfig.kv``): ``int8`` stores the K/V pools as
  symmetric int8 codes beside a float32 SCALE POOL ``[L, pages, page,
  H]`` — one scale per page position per head, absmax over the head
  dim — and the ragged attention kernel dequantizes as it stages each
  page, so full-width K/V never exists in device memory. ``fp8``
  stores e4m3 codes (``torch.float8_e4m3fn``) with the same scale
  layout. Scales are per token write, never per page: a page fills
  over several steps, and a per-position scale makes every stored byte
  a function of that token's own forward pass alone, whatever shared
  its step.
- **weights** (``QuantConfig.weights``): ``int8`` re-stores every
  serving matmul weight (``wqkv``/``wo``/``wfc``/``wproj``) as int8
  codes with per-output-channel scales, dequantized in front of the
  matmul (``model._w``). Embedding, positions and LayerNorm stay
  float32.

``off`` everywhere is the float engine exactly. ``coll`` (quantized
mesh collectives) and ``weight_matmul`` (the int8 x int8 matmul) exist
so that a config reads as it does on the JAX side; the slices that
bring them are not ported, so only ``"off"`` is accepted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ...kernels.int8 import SCALE_EPS, quantize_absmax
from . import policy

__all__ = ["QuantConfig", "FP8_E4M3_MAX", "kv_pool_dtype", "kv_scale_shape",
           "quantize_kv", "dequantize_kv", "quantized_weight_names",
           "quantize_lm_weights", "modeled_weight_bytes"]

# largest finite e4m3 magnitude: the per-position absmax maps onto it
FP8_E4M3_MAX = 448.0


def _not_ported(knob: str, value, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} needs the {slice_name} slice of the PyTorch "
        "port, which is not ported yet")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The engine's quantized-serving switch: ``kv`` in {off, int8,
    fp8}, ``weights`` in {off, int8}; ``scale_dtype`` is the scale
    pool's storage dtype (float32, the only one the kernels read) and
    part of the prefix-cache content-hash salt."""

    kv: str = "off"
    weights: str = "off"
    scale_dtype: str = "float32"
    coll: str = "off"
    weight_matmul: str = "off"

    def __post_init__(self):
        if self.kv not in policy.KV_QUANT_MODES:
            raise ValueError(f"kv quant mode {self.kv!r} not in "
                             f"{policy.KV_QUANT_MODES}")
        if self.weights not in policy.WEIGHT_QUANT_MODES:
            raise ValueError(f"weight quant mode {self.weights!r} not in "
                             f"{policy.WEIGHT_QUANT_MODES}")
        if self.scale_dtype != "float32":
            raise _not_ported("scale_dtype", self.scale_dtype,
                              "narrow-scale KV")
        if self.coll != "off":
            raise _not_ported("coll", self.coll, "tensor-parallel mesh")
        if self.weight_matmul != "off":
            raise _not_ported("weight_matmul", self.weight_matmul,
                              "int8-matmul")

    @property
    def active(self) -> bool:
        return self.kv != "off" or self.weights != "off"

    @property
    def kv_active(self) -> bool:
        return self.kv != "off"


def kv_pool_dtype(mode: str) -> torch.dtype:
    """Storage dtype of the quantized K/V pools (1 byte per element)."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"no quantized pool dtype for mode {mode!r}")


def kv_scale_shape(pool_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Scale pool shape for a K/V pool ``[L, pages, page, H, D]``: one
    scale per page position per head."""
    return tuple(pool_shape[:-1])


def quantize_kv(x: torch.Tensor, mode: str, scale_dtype: str = "float32"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New K/V values ``x [..., H, D]`` -> ``(codes [..., H, D] (1
    byte), scales [..., H] float32)``, per-(position, head) symmetric
    absmax over D: each code depends only on its own row of ``x``."""
    if scale_dtype != "float32":
        raise _not_ported("scale_dtype", scale_dtype, "narrow-scale KV")
    xf = x.to(torch.float32)
    if mode == "int8":
        q, scale = quantize_absmax(xf, axis=-1)
        return q, scale[..., 0]
    if mode == "fp8":
        amax = xf.abs().amax(dim=-1)
        scale = torch.clamp(amax / FP8_E4M3_MAX, min=SCALE_EPS)
        return (xf / scale[..., None]).to(torch.float8_e4m3fn), scale
    raise ValueError(f"quantize_kv with mode {mode!r}")


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``codes [..., H, D]`` x ``scales [..., H]`` -> full-width K/V:
    the product the kernels form as they stage a page."""
    return (q.to(torch.float32) * scale.to(torch.float32)[..., None]
            ).to(dtype)


def quantized_weight_names(spec) -> Tuple[str, ...]:
    """The serving matmul weights the int8 weight path re-stores."""
    names = []
    for l in range(spec.num_layers):
        names += [f"l{l}.wqkv", f"l{l}.wo", f"l{l}.wfc", f"l{l}.wproj"]
    return tuple(names)


def modeled_weight_bytes(spec, quant: "QuantConfig",
                         itemsize: int = 4) -> int:
    """Total parameter bytes ONE step streams from device memory under
    this quant config — the weight-traffic term of the cost ledger's
    byte model (``pd_cost_bytes_component_total{component="weights"}``).

    Counts what :func:`~.model.init_lm_params` allocates (+ the int8
    re-storage of :func:`quantize_lm_weights`): the per-layer quartet
    (wqkv/wo/wfc/wproj) at 1 byte/element + float32 per-output-channel
    scale rows when ``quant.weights == "int8"``, ``itemsize``
    bytes/element otherwise; embedding, positions and the LayerNorm
    vectors always full width (the tied embedding doubles as the LM
    head, so it is not counted twice)."""
    d, hd, v = spec.d_model, spec.num_heads * spec.head_dim, spec.vocab
    mm_elems = spec.num_layers * (d * 3 * hd + hd * d
                                  + d * 4 * d + 4 * d * d)
    # per-output-channel scales (absmax over the input axis, float32)
    scale_elems = spec.num_layers * (3 * hd + d + 4 * d + d)
    full_elems = (v * d + spec.max_seq_len * d      # embed + pos
                  + spec.num_layers * 4 * d         # ln1/ln2 g+b
                  + 2 * d)                          # lnf g+b
    if quant is not None and quant.weights == "int8":
        return mm_elems * 1 + scale_elems * 4 + full_elems * itemsize
    return (mm_elems + full_elems) * itemsize


def quantize_lm_weights(params: Dict[str, torch.Tensor], spec
                        ) -> Dict[str, torch.Tensor]:
    """Weight-only int8: every name of :func:`quantized_weight_names`
    becomes ``<name>@q`` (int8 codes, absmax over the input axis 0 per
    output channel) plus ``<name>@s`` (float32 scales, keepdims); every
    other entry passes through."""
    out: Dict[str, torch.Tensor] = {}
    targets = set(quantized_weight_names(spec))
    for name, arr in params.items():
        if name in targets:
            q, s = quantize_absmax(arr, axis=0)
            out[name + "@q"] = q
            out[name + "@s"] = s
        else:
            out[name] = arr
    return out
