"""Quantized serving: int8 weights, the int8 weight matmul and
quantized KV pages.

Counterpart of ``paddle_tpu/inference/llm/quant.py``. Three knobs:

- **KV pages** (``QuantConfig.kv``): ``int8`` stores the K/V pools as
  symmetric int8 codes beside a SCALE POOL ``[L, pages, page, H]`` —
  one scale per page position per head, absmax over the head dim —
  and the ragged attention kernel dequantizes as it stages each page,
  so full-width K/V never exists in device memory. ``fp8`` stores e4m3
  codes (``torch.float8_e4m3fn``) with the same scale layout. Scales
  are per token write, never per page: a page fills over several
  steps, and a per-position scale makes every stored byte a function
  of that token's own forward pass alone, whatever shared its step.
  ``scale_dtype`` (float32, float16 or bfloat16) is the scale pool's
  storage dtype: the codes are computed with the float32 scale and
  only then is the scale rounded to it, and the kernels read the pool
  in that dtype and widen each scale in registers.
- **weights** (``QuantConfig.weights``): ``int8`` re-stores every
  serving matmul weight (``wqkv``/``wo``/``wfc``/``wproj``) as int8
  codes with per-output-channel scales, dequantized in front of the
  matmul (``model._w``). Embedding, positions and LayerNorm stay
  float32.
- **weight matmul** (``QuantConfig.weight_matmul``): ``int8`` (with
  int8 weights) quantizes each activation row by its absmax and
  multiplies int8 x int8 with int32 sums, rescaled once in the
  epilogue (``model._int8_dot``, the kernel of ``kernels/int8.py``),
  instead of dequantizing the weights first. Without int8 weights the
  engine degrades it to off.

``off`` everywhere is the float engine exactly. ``coll`` (quantized
mesh collectives) exists so that a config reads as it does on the JAX
side; the tensor-parallel slice that brings it is not ported, so only
``"off"`` is accepted.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import torch

from ...kernels.int8 import SCALE_EPS, quantize_absmax
from . import policy

__all__ = ["QuantConfig", "FP8_E4M3_MAX", "SCALE_DTYPES", "kv_pool_dtype",
           "kv_scale_shape", "kv_scale_dtype", "quantize_kv",
           "dequantize_kv", "quantized_weight_names", "quantize_lm_weights",
           "modeled_weight_bytes", "time_quant_roundtrip",
           "quant_roundtrip_events", "resolve_quant",
           "align_cache_config", "prepare_model"]

# largest finite e4m3 magnitude: the per-position absmax maps onto it
FP8_E4M3_MAX = 448.0
# the scale pool's storage dtypes, by name
SCALE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


def _not_ported(knob: str, value, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} needs the {slice_name} slice of the PyTorch "
        "port, which is not ported yet")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The engine's quantized-serving switch: ``kv`` in {off, int8,
    fp8}, ``weights`` in {off, int8}, ``weight_matmul`` in {off, int8};
    ``scale_dtype`` (float32, float16, bfloat16) is the scale pool's
    storage dtype. ``scale_dtype`` and ``weight_matmul`` are part of
    the prefix-cache content-hash salt."""

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
        if self.weight_matmul not in policy.WEIGHT_MATMUL_MODES:
            raise ValueError(
                f"weight matmul mode {self.weight_matmul!r} not in "
                f"{policy.WEIGHT_MATMUL_MODES}")
        if self.scale_dtype not in SCALE_DTYPES:
            raise ValueError(f"scale dtype {self.scale_dtype!r} not in "
                             f"{tuple(SCALE_DTYPES)}")
        if self.coll != "off":
            raise _not_ported("coll", self.coll,
                              "tensor-parallel mesh (ROADMAP A.11)")

    @property
    def active(self) -> bool:
        return self.kv != "off" or self.weights != "off"

    @property
    def kv_active(self) -> bool:
        return self.kv != "off"


def resolve_quant(quant: "QuantConfig | None", scheduler_config
                  ) -> "QuantConfig | None":
    """The quant config an engine serves with (the JAX engine's rules):
    ``None`` reads the scheduler config's ``kv_quant``/``weight_quant``/
    ``weight_matmul`` knobs; the int8 weight matmul without int8 weights
    has nothing to multiply and degrades to off; a config with nothing
    on is ``None`` (the float engine)."""
    if quant is None:
        quant = QuantConfig(kv=scheduler_config.kv_quant,
                            weights=scheduler_config.weight_quant,
                            weight_matmul=scheduler_config.weight_matmul)
    if quant.weight_matmul != "off" and quant.weights != "int8":
        quant = dataclasses.replace(quant, weight_matmul="off")
    return quant if quant.active else None


def prepare_model(model, quant: "QuantConfig | None"):
    """``model`` (a ``TorchLM``) prepared for ``quant``'s weight modes,
    as every engine, every fabric and the smoke's teacher-forced runs
    prepare it: int8 weights re-stored as codes and scales
    (``quantize_weights``), and under the int8 weight matmul the codes
    laid out for its kernel (``with_int8_matmul_layout``). Float
    weights are returned as they are. A model already in the int8
    matmul's layout serves only that route."""
    if quant is None or quant.weights != "int8":
        return model
    model = model.quantize_weights()
    if quant.weight_matmul == "int8":
        return model.with_int8_matmul_layout()
    if any(n + "@qt" in model.params
           for n in quantized_weight_names(model.spec)):
        raise ValueError("the model's weight codes are in the int8 "
                         "matmul's layout; serve it with "
                         "weight_matmul='int8'")
    return model


def align_cache_config(cache_config, quant: "QuantConfig | None"):
    """``cache_config`` with its page encoding taken from ``quant``: the
    KV mode, the scale dtype, and the weight modes that change the
    activations the KV is computed from (they enter the content-hash
    salt and the swap key). Every engine aligns through here (each of
    a fabric's replicas too), so ``QuantConfig`` alone decides the
    encoding;
    a float pool under a quantized step would scatter the wrong dtype,
    and pages of the int8 matmul must never be served to the
    dequant-first route."""
    want = dict(
        kv_quant=quant.kv if quant is not None else "off",
        scale_dtype=(quant.scale_dtype if quant is not None
                     else cache_config.scale_dtype),
        weight_quant=quant.weights if quant is not None else "off",
        weight_matmul=quant.weight_matmul if quant is not None else "off")
    if any(getattr(cache_config, k) != v for k, v in want.items()):
        cache_config = dataclasses.replace(cache_config, **want)
    return cache_config


def kv_pool_dtype(mode: str) -> torch.dtype:
    """Storage dtype of the quantized K/V pools (1 byte per element)."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"no quantized pool dtype for mode {mode!r}")


def kv_scale_dtype(scale_dtype: str) -> torch.dtype:
    """The scale pools' torch dtype for ``scale_dtype``."""
    return SCALE_DTYPES[scale_dtype]


def kv_scale_shape(pool_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Scale pool shape for a K/V pool ``[L, pages, page, H, D]``: one
    scale per page position per head."""
    return tuple(pool_shape[:-1])


def quantize_kv(x: torch.Tensor, mode: str, scale_dtype: str = "float32"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New K/V values ``x [..., H, D]`` -> ``(codes [..., H, D] (1
    byte), scales [..., H] scale_dtype)``, per-(position, head)
    symmetric absmax over D: each code depends only on its own row of
    ``x``. The codes come from the float32 scale, which is rounded to
    ``scale_dtype`` only afterwards (the JAX order: the codes depend on
    it)."""
    xf = x.to(torch.float32)
    if mode == "int8":
        q, scale = quantize_absmax(xf, axis=-1)
        scale = scale[..., 0]
    elif mode == "fp8":
        amax = xf.abs().amax(dim=-1)
        # a tensor divisor: a true division on the card too
        scale = torch.clamp(amax / torch.full_like(amax, FP8_E4M3_MAX),
                            min=SCALE_EPS)
        q = (xf / scale[..., None]).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"quantize_kv with mode {mode!r}")
    return q, scale.to(kv_scale_dtype(scale_dtype))


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


# ----------------------------------------------------- fenced probing --

_PROBES: Dict[tuple, torch.Tensor] = {}


def _probe_input(mode: str, page_size: int, heads: int, head_dim: int,
                 dev: torch.device) -> torch.Tensor:
    """The probe's seeded page-sized K block on ``dev``, made (and its
    roundtrip run once, untimed: the first launches) at first use."""
    key = (mode, int(page_size), int(heads), int(head_dim), str(dev))
    x = _PROBES.get(key)
    if x is None:
        gen = torch.Generator().manual_seed(0)
        x = _PROBES[key] = torch.randn(
            (int(page_size), int(heads), int(head_dim)),
            generator=gen).to(dev)
        dequantize_kv(*quantize_kv(x, mode))
    return x


def quant_roundtrip_events(mode: str, page_size: int, heads: int,
                           head_dim: int, device):
    """Launch one page-sized quantize -> dequantize roundtrip of a
    seeded K block on the card's current stream between two timing
    events, and return ``(start, end)`` without waiting: the caller
    reads ``start.elapsed_time(end)`` once ``end.query()`` holds. Call
    it outside any graph capture."""
    dev = torch.device(device)
    x = _probe_input(mode, page_size, heads, head_dim, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dequantize_kv(*quantize_kv(x, mode))
    end.record()
    return start, end


def time_quant_roundtrip(mode: str, page_size: int, heads: int,
                         head_dim: int, device=None) -> float:
    """Seconds for one page-sized quantize -> dequantize roundtrip on
    ``device`` (the JAX probe): on the card timed with CUDA events
    around its own launches, waiting for them; on the CPU with the host
    clock. The engine observes the same roundtrip into
    ``pd_quant_dequant_seconds`` on the step profiler's fenced samples
    (through :func:`quant_roundtrip_events` on the card, read at the
    next sample so that it never waits on the stream)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    if dev.type == "cuda":
        start, end = quant_roundtrip_events(mode, page_size, heads,
                                            head_dim, dev)
        end.synchronize()
        return start.elapsed_time(end) / 1000.0
    x = _probe_input(mode, page_size, heads, head_dim, dev)
    t0 = time.perf_counter()
    dequantize_kv(*quantize_kv(x, mode))
    return time.perf_counter() - t0
