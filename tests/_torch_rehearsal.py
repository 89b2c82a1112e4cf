"""What the CPU rehearsals of ``chip_smoke.py`` share
(``tests/test_torch_rehearsal_*.py``), as ``tests/_torch_threads.py`` is
shared by the port's tests.

The smoke runs only on the card. A rehearsal runs its phase functions
on the CPU with each kernel wrapper replaced by the kernel's plain
version (still counting one launch per call), so the phases' control
flow, their launch bookkeeping and their checks are exercised before a
chip run. Here are the stand-ins for what a phase reads of the card
(``_Event``, ``_Profile``, ``cpu_card``), the counting plain kernels
(``plain_kernels``), the fixtures that cut each slice's phases to CPU
sizes (``core_on_cpu``, ``training_on_cpu``, ``compile_on_cpu``,
``hapi_on_cpu``, ``seq_on_cpu``, ``vision_on_cpu``, ``bert_on_cpu``,
``idiom_on_cpu``, ``audio_on_cpu``)
and the helpers more than one rehearsal uses. A rehearsal module imports
the fixtures it requests, and those they request, by name.

Nothing here measures the card: times printed by the phases under a
rehearsal are host times of the plain versions.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402,F401

import collections  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402,F401

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import tensor as ttensor  # noqa: E402
from paddle_tpu_torch.vision.models import resnet18  # noqa: E402
from paddle_tpu_torch.inference.llm import ModelSpec, TorchLM  # noqa: E402
from paddle_tpu_torch.inference.llm.model import init_lm_params  # noqa: E402
from paddle_tpu_torch.inference.llm import model as tmodel  # noqa: E402
from paddle_tpu_torch.kernels import int8 as i8  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def plain_kernels(monkeypatch):
    """Every kernel wrapper runs its plain version and counts a launch;
    ``auto`` resolves to the kernel tier; synchronize is a no-op."""

    def counting(ref, name_of):
        def run(*args, **kw):
            kw.pop("max_q_len", None)
            kw.pop("split_blocks", None)
            split = kw.pop("split_pages", 0)
            out = ref(*args, **kw)
            pa.LAUNCHES[name_of(args, split, kw)] += 1
            return out
        return run

    def ragged_name(a, sp, kw):
        scale = kw.get("k_scale")
        return pa.kernel_name(a[1].dtype, pa.split_active(sp, a[3].shape[1]),
                              None if scale is None else scale.dtype)

    monkeypatch.setattr(pa, "ragged_attention_cuda", counting(
        pa.ragged_attention_ref, ragged_name))
    monkeypatch.setattr(pa, "paged_attention_cuda", counting(
        pa.paged_attention_ref, lambda a, sp, kw: pa.PAGED_KERNEL))
    monkeypatch.setattr(pa, "mixed_attention_cuda", counting(
        pa.mixed_attention_ref, lambda a, sp, kw: pa.MIXED_KERNEL))
    # the int8 matmul's two kernels, where the model calls them
    for mod in (i8, tmodel):
        monkeypatch.setattr(mod, "quantize_rows", counting(
            i8.quantize_rows_ref, lambda a, sp, kw: i8.QUANTIZE_ROWS_KERNEL))
        monkeypatch.setattr(mod, "int8_matmul", counting(
            i8.int8_matmul_ref, lambda a, sp, kw: i8.INT8_MATMUL_KERNEL))
    monkeypatch.setattr(pa, "_resolve_tier",
                        lambda tier, q: "ref" if tier == "ref" else "kernel")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    saved = pa.LAUNCHES.copy()
    yield
    pa.LAUNCHES.clear()                # the phases leave their counts
    pa.LAUNCHES.update(saved)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: every span 1 ms."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0

    def synchronize(self):
        pass


class _Profile:
    """A stand-in for ``torch.profiler.profile`` that records nothing
    (the CPU profiler's per-op records would dominate the rehearsal)."""

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


@pytest.fixture
def cpu_card(monkeypatch):
    """What a serving phase reads of the card, stood in for on the CPU:
    its name, memory statistics, events and the profiler; engines built
    without CUDA graphs, which need the card."""
    monkeypatch.setattr(cs, "card_identity", lambda: "CPU rehearsal")
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "max_memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    make = cs.make_engine

    def eager(*args, **kw):
        kw["cuda_graphs"] = None
        return make(*args, **kw)

    monkeypatch.setattr(cs, "make_engine", eager)


def _narrow_model(max_seq_len):
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=max_seq_len)
    return TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                   device=CPU)


@pytest.fixture
def core_on_cpu(monkeypatch):
    """The core phases at CPU sizes: my_triple's op runs its reference
    and counts a launch, the ResNet phases run resnet18 at 64 x 64,
    batch 2, and the card's memory counters and synchronize are
    no-ops."""
    co = sys.modules["paddle_tpu_torch.utils.custom_op"]

    def run(self, xs):
        outs = self._reference(xs, self.out_specs(xs))
        co.LAUNCHES[self.name] = co.LAUNCHES.get(self.name, 0) + 1
        return outs

    monkeypatch.setattr(co._CudaOp, "run", run)
    monkeypatch.setattr(cs, "TRIPLE_SHAPES", ((4, 8), (64, 96)))
    monkeypatch.setattr(cs, "resnet50", resnet18)
    for name, value in (("RESNET_SIZE", 64), ("RESNET_BATCH", 2),
                        ("RESNET_PARITY_BATCH", 2), ("RESNET_WARMUP", 1),
                        ("RESNET_STEPS", 2), ("RESNET_PLAIN_STEPS", 1),
                        ("RESNET_PARITY_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    saved = tdevice._CURRENT[0]
    paddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved
    co.LAUNCHES.pop("my_triple", None)


# ------------------------------- quantized serving, the rest, the fabric


def _once(fn, reps=20, warmup=3):
    fn()
    return 1.0


CONTRACT_KEYS = {"name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms"}


def _narrow_xl(monkeypatch):
    monkeypatch.setattr(cs, "GPT3_XL", ModelSpec(
        vocab=64, d_model=32, num_layers=2, num_heads=2, head_dim=16,
        max_seq_len=cs.GPT3_XL.max_seq_len))


class _Tap:
    """A stand-in for ``LogitsTap``: rows by (seed, token index)."""

    def __init__(self, rows):
        self.rows = rows

    def row(self, seed, index):
        return self.rows[(seed, index)]


# ------------------------------------- training as users configure it


NARROW_TRAIN = {"vocab_size": 512, "hidden_size": 128,
                "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 256, "max_position_embeddings": 128,
                "loss_chunks": 2}


@pytest.fixture
def training_on_cpu(monkeypatch):
    """The training phases at a CPU size (bench.py's configuration cut
    to d 128, 2 layers, 2 x 128 tokens, 2 steps a call): the flash and
    dropout kernel wrappers run their plain versions and count a launch
    (the phases refuse the plain functions reached any other way), and
    the card's memory counters, caches and synchronize are no-ops."""
    fa, dk, tf = cs.fa, cs.dk, cs.threefry
    monkeypatch.setattr(fa, "LAUNCHES", collections.Counter())
    for kind, name in zip(("fwd", "bwd_dkdv", "bwd_dq"), fa.KERNEL_NAMES):
        def run(*args, _ref=getattr(fa, f"flash_{kind}_ref"), _name=name):
            fa.LAUNCHES[_name] += 1
            return _ref(*args)
        monkeypatch.setattr(fa, f"flash_{kind}_cuda", run)
    monkeypatch.setattr(fa, "_use_kernel", lambda tier, q: tier != "ref")
    ref, bern = dk.dropout_ref, tf.bernoulli

    def kernel(x, key, p, mask_shape=None, upscale=True):
        saved = (dk.dropout_ref, tf.bernoulli)
        dk.dropout_ref, tf.bernoulli = ref, bern
        try:
            out = ref(x, key, p, mask_shape, upscale)
        finally:
            dk.dropout_ref, tf.bernoulli = saved
        dk.LAUNCHES[dk.KERNEL_NAME] += 1
        return out

    monkeypatch.setattr(dk, "dropout_cuda", kernel)
    monkeypatch.setattr(dk, "_apply", lambda x, *a: dk.dropout_cuda(x, *a))
    monkeypatch.setattr(cs, "TRAIN_CFG", {**cs.TRAIN_CFG, **NARROW_TRAIN})
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 128)
    monkeypatch.setattr(cs, "TRAIN_K", 2)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    saved = dk.LAUNCHES.copy()
    yield kernel
    dk.LAUNCHES.clear()
    dk.LAUNCHES.update(saved)


def _small_dropout_shapes(monkeypatch):
    monkeypatch.setattr(cs, "DROPOUT_HIDDEN", (2, 64, 48))
    monkeypatch.setattr(cs, "DROPOUT_ATTN", (2, 3, 64, 64))
    monkeypatch.setattr(cs, "DROPOUT_AXIS", ((2, 3, 16, 8), (2, 3, 1, 1)))
    monkeypatch.setattr(cs, "DROPOUT_PLAIN_SLICE", 4096)
    monkeypatch.setattr(cs, "DROPOUT_KEPT_MIN_DRAWS", 20000)
    monkeypatch.setattr(cs, "DROPOUT_KEPT_TOL", 1e-2)


@pytest.fixture
def compile_on_cpu(training_on_cpu, monkeypatch):
    """The compile and export phases at the training rehearsal's size
    (d 128, 2 layers, 2 x 128 tokens), on the CPU device, with the card's
    name stood in: ``to_static`` runs every signature eagerly there and
    says so, which the phases accept on the CPU only."""
    saved = tdevice._CURRENT[0]
    paddle.set_device("cpu")
    monkeypatch.setattr(cs, "card_identity", lambda: "CPU rehearsal")
    monkeypatch.setattr(cs, "TO_STATIC_REPLAYS", 2)
    monkeypatch.setattr(cs, "TO_STATIC_EAGER_CALLS", 1)
    monkeypatch.setattr(cs, "LOADED_BATCHES", (2, 3))
    monkeypatch.setattr(cs, "STATIC_STEPS", 2)
    monkeypatch.setattr(cs, "EXT_SHAPE", (64, 32))
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture
def hapi_on_cpu(core_on_cpu, cpu_card, monkeypatch):
    """The high-level training phases at CPU sizes: resnet18 at 64 x 64,
    batch 2 for the hapi path (the ResNet-50 counts check runs at its
    real size: one forward at batch 1), two batches of 8 through the
    LeNet ring and of 2 through the ResNet one (``fork`` workers, the
    loader's choice without CUDA), the sequence ops at [4, 16, 8]."""
    for name, value in (("LENET_BATCH", 8), ("LENET_BATCHES", 2),
                        ("WORKER_BATCH", 2), ("WORKER_BATCHES", 2),
                        ("WORKER_WORKERS", 2), ("SEQ_SHAPE", (4, 16, 8)),
                        ("SEQ_FILTERS", 8), ("HAPI_PROFILE_STEPS", 1)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.delenv("PADDLE_TPU_WORKER_START", raising=False)


# ------------------------------------------- the sequence layers and ops

SEQ_NMT = dict(vocab=97, d_model=64, nhead=1, layers=2, ff=128,
               dropout=0.1)
SEQ_LSTM = dict(vocab=50, hidden=16, layers=2, dropout=0.65, init=0.04)


@pytest.fixture
def seq_on_cpu(training_on_cpu, cpu_card, plain_kernels, monkeypatch):
    """The sequence phases at CPU sizes: Transformer-base cut to d 64 (one
    head of 64, so the flash route's eligibility holds), 2 + 2 layers, a
    97-token vocabulary, 2 pairs of 8 + 8 tokens and 4 decode steps; the
    LSTM LM at 2 x 16, 2 x 5 words; the flash and dropout wrappers are
    their counting plain versions (``training_on_cpu``), the int8 ones
    too (``plain_kernels``); ``Tensor.tpu()`` lands on the CPU."""
    for name, value in (("NMT_CFG", SEQ_NMT), ("NMT_BATCH", 2),
                        ("NMT_SRC", 8), ("NMT_TGT", 8), ("NMT_PAD_LEN", 5),
                        ("NMT_WARM", 1), ("NMT_STEPS", 2),
                        ("NMT_REPEAT", 2), ("NMT_DECODE_STEPS", 4),
                        ("LSTM_CFG", SEQ_LSTM), ("LSTM_BATCH", 2),
                        ("LSTM_BPTT", 5), ("LSTM_STEPS", 2),
                        ("LSTM_REPEAT", 2), ("BEAM_STEPS", 3)):
        monkeypatch.setattr(cs, name, value)
    # the op sweep's ``tpu()`` asks for the card: here it is the CPU
    rule = ttensor.to_torch_device
    monkeypatch.setattr(ttensor, "to_torch_device",
                        lambda d: CPU if d == "gpu" else rule(d))
    saved = tdevice._CURRENT[0]
    yield
    tdevice._CURRENT[0] = saved


def _first_built(monkeypatch, name, plant):
    """``cs.<name>`` (a model builder) with ``plant`` applied to the
    first model it builds: the phase's card model, built before its CPU
    twin."""
    make, built = getattr(cs, name), []

    def once(*args, **kw):
        model = make(*args, **kw)
        if not built:
            plant(model)
        built.append(model)
        return model

    monkeypatch.setattr(cs, name, once)


class _OtherMask(torch.nn.Module):
    """Dropout at the same rate under another key: the mask a port that
    drew its keys in another order would give."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training:
            return x
        cs.trng.next_key()
        return paddle.nn.functional.dropout(x, self.p)


def _zero_output(lstm):
    """``lstm`` giving zeros for its output (its states kept)."""
    forward = lstm.forward

    def zeros(x, states=None):
        y, states = forward(x, states)
        return y * 0.0, states

    lstm.forward = zeros


# ------------------------------------ the vision zoo, vision.ops, offload

@pytest.fixture
def vision_on_cpu(training_on_cpu, cpu_card, monkeypatch):
    """The vision, detection, offload and debugging phases at CPU sizes:
    MobileNetV3-Large at batch 4 x 64^2 (2 + 2 steps), two zoo factories
    at 64^2 (batch 2, one timed call), every detection op on small maps
    (SSD300's own maps and priors kept), GPT at the training rehearsal's
    size; device times from one host call each."""
    for name, value in (
            ("RESNET_BATCH", 4), ("RESNET_SIZE", 64), ("RESNET_WARMUP", 2),
            ("RESNET_STEPS", 2), ("VISION_DROPOUT", ((4, 1280), 0.2)),
            ("ZOO", (("squeezenet1_1", {}, 64), ("googlenet", {}, 64))),
            ("ZOO_BATCH", 2), ("ZOO_WARM", 1), ("ZOO_REPS", 1),
            ("FPN_SHAPE", (2, 8, 20, 34)), ("FPN_ROIS", 12),
            ("FPN_IMAGE", (80, 136)), ("FPN_CPU_ROIS", 4),
            ("RFCN_CLASSES", 3), ("RFCN_ROIS", 10), ("RFCN_MAP", (10, 16)),
            ("RFCN_IMAGE", (160, 256)),
            ("DCN_SHAPE", (2, 8, 6, 7)), ("DCN_OUT", 8),
            ("YOLO_BATCH", 2), ("YOLO_CLASSES", 4), ("YOLO_GT", 6),
            ("YOLO_HEADS", ((4, (6, 7, 8), 32), (8, (0, 1, 2), 16))),
            ("RPN_IMAGE", (96, 160)), ("NMS_BOXES", 60), ("NMS_CLASSES", 5)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps=20, warmup=3:
                        _once(fn, reps, warmup))
    saved = tdevice._CURRENT[0]
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture
def bert_on_cpu(vision_on_cpu, monkeypatch):
    """The BERT, incubate and geometric phases at CPU sizes: BERT's base
    config cut to d 128 (two heads of 64: the flash route's head size),
    2 layers and a 512-token vocabulary; 4 x 32 fine-tuning rows (1 + 2
    steps, 1 Lamb and 2 LookAhead steps), inference at 2 x 128; the
    GPT-3 XL stack at the same heads, 2 layers, 2 x 128; a 600-node
    graph."""
    small = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256,
                 max_position_embeddings=128)

    class SmallBert(cs.BertConfig):
        @staticmethod
        def base():
            return cs.BertConfig(**small)

    monkeypatch.setattr(cs, "BertConfig", SmallBert)
    monkeypatch.setattr(cs, "GPT3_XL", ModelSpec(
        vocab=512, d_model=128, num_layers=2, num_heads=2, head_dim=64,
        max_seq_len=128))
    for name, value in (
            ("BERT_BATCH", 4), ("BERT_SEQ", 32), ("BERT_MIN_LEN", 8),
            ("BERT_WARMUP", 1), ("BERT_STEPS", 2), ("BERT_EXTRA_STEPS", 1),
            ("BERT_LOOKAHEAD_K", 2), ("BERT_INFER", (2, 128)),
            ("BERT_INFER_REPS", 1), ("FUSED_SHAPE", (2, 32)),
            ("FMT_SHAPE", (2, 128)), ("FMT_REPS", 1),
            ("ARXIV", (600, 4000, 8)), ("GEO_SEEDS", 16),
            ("GEO_FANOUTS", (5, 3)), ("GEO_REPS", 1),
            ("ASP_BATCH", (2, 32)), ("VITERBI", (4, 16, 11, 4))):
        monkeypatch.setattr(cs, name, value)


@pytest.fixture
def idiom_on_cpu(bert_on_cpu, monkeypatch):
    """The Paddle-idiom phase at CPU size: BERT cut to 2 layers and d 64
    (one head of 64), 4 x 32 rows, 4 hand-loop steps; CUDA events and the
    card's memory counters stood in for (``cpu_card``)."""
    small = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=1, intermediate_size=128,
                 max_position_embeddings=128)

    class TinyBert(cs.BertConfig):
        @staticmethod
        def base():
            return cs.BertConfig(**small)

    monkeypatch.setattr(cs, "BertConfig", TinyBert)
    monkeypatch.setattr(cs, "IDIOM_STEPS", 4)
    monkeypatch.setattr(paddle.device.cuda, "Event", _Event)


@pytest.fixture
def audio_on_cpu(cpu_card, monkeypatch):
    """The audio phase at CPU size: 2 clips of 0.5 s at the PANNs
    settings, one timed batch."""
    for name, value in (("AUDIO_CLIPS", 2), ("AUDIO_SECONDS", 0.5),
                        ("AUDIO_REPS", 1)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    saved = tdevice._CURRENT[0]
    yield
    tdevice._CURRENT[0] = saved


# ---------- the long tail: profiler, cost model, quantization, sparse,
# ---------- distribution, onnx

class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU that times the
    host: ``record()`` reads ``perf_counter``."""

    def __init__(self, **kw):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)

    def synchronize(self):
        pass


@pytest.fixture
def long_tail_on_cpu(training_on_cpu, plain_kernels, monkeypatch, tmp_path):
    """The long tail's phases at CPU sizes: bench.py's GPT cut to 2
    layers of d 64 (one head of 64) at 2 x 128 tokens; resnet18 at 64^2,
    batch 2 (its 20 convolutions); a 2,000-node graph of 8,000 edges and
    16 features; SECOND's stage on a 41 x 64 x 64 grid of 300 voxels;
    the VAE at 32 -> 16 -> 8, batch 16; the distribution sweep at 4,096
    elements. The flash, dropout and int8 wrappers are their counting
    plain versions; CUDA events time the host; the device trace's flash
    kernels are the flash launches made while the profiler records."""
    fa = cs.fa
    recorded = collections.Counter()
    for kind, name in zip(("fwd", "bwd_dkdv", "bwd_dq"), fa.KERNEL_NAMES):
        counted = getattr(fa, f"flash_{kind}_cuda")

        def run(*args, _run=counted, _name=name):
            if sys.modules["paddle_tpu_torch.profiler"]._collecting:
                recorded[_name] += 1
            return _run(*args)
        monkeypatch.setattr(fa, f"flash_{kind}_cuda", run)

    def kernel_counts(path):
        out = dict(recorded)
        recorded.clear()
        out["all_kernels"] = sum(out.values())
        return out

    monkeypatch.setattr(cs, "trace_kernel_counts", kernel_counts)
    monkeypatch.setattr(cs, "TRAIN_CFG", {
        **cs.TRAIN_CFG, "hidden_size": 64, "num_attention_heads": 1,
        "intermediate_size": 128})
    monkeypatch.setattr(cs, "card_identity", lambda: "CPU rehearsal")
    monkeypatch.setattr(cs, "resnet50", resnet18)
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps=20, warmup=3:
                        _once(fn, reps, warmup))
    monkeypatch.setattr(cs, "SCRATCH_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    for name, value in (
            ("RESNET_SIZE", 64), ("QAT_BATCH", 2), ("RESNET_PARITY_BATCH", 2),
            ("RESNET_WARMUP", 1), ("RESNET_STEPS", 2), ("RESNET_CONVS", 20),
            ("QUANT_EVAL", 2), ("PTQ_CALIB", 2), ("QUANT_REPS", 1),
            ("ARXIV", (2000, 8000, 16)), ("GCN_TRAIN", 1000),
            ("GCN_HIDDEN", 32), ("GCN_STEPS", 3), ("GCN_REPS", 1),
            ("SECOND_GRID", (41, 64, 64)), ("SECOND_VOXELS", 300),
            ("SECOND_SAMPLES", 50), ("VAE_DIMS", (32, 16, 8)),
            ("VAE_BATCH", 16), ("VAE_STEPS", 3), ("DIST_N", 4096),
            ("ONNX_BATCH", 2), ("COST_REPEAT", 1)):
        monkeypatch.setattr(cs, name, value)
    saved = tdevice._CURRENT[0]
    paddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved
