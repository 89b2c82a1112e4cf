"""The port stands alone: no JAX, nothing of the JAX package.

- every module of ``paddle_tpu_torch``, ``chip_smoke.py`` and the card
  tools of ``chip_tools/`` is scanned for imports of ``jax`` or
  ``paddle_tpu`` (only ``paddle_tpu_torch`` may be imported);
- importing every module of the port in a fresh interpreter leaves
  ``jax`` and ``paddle_tpu`` out of ``sys.modules``, and so does using
  its top-level Paddle surface (``import paddle_tpu_torch as paddle``,
  ``paddle.to_tensor``, a ``Layer``, a ``cuda_op`` on the CPU);
- the port's copy of the serving-policy defaults equals the JAX
  package's ``shared_policy()`` with no ``PD_*`` environment set (the
  step profiler's sample share, the brownout depth, the journal's,
  the weight-matmul, fabric and SLO knobs included), and its swap-tier
  defaults the JAX cache module's;
- the scan covers the vision zoo, ``vision.ops``, the offload optimizer
  and ``amp.debugging`` (the fresh interpreter uses each), and the
  observability and robustness modules (metrics,
  recorder, export, tracing, chrome trace, step profiler, ledger,
  watchdog; faults, journal, brownout), and the int8 matmul, the
  serving fabric, its observability plane, the SLO alerts and the
  serving bridge, and the training slice's threefry core, random state,
  dropout, clips, schedulers, scaler and autocast;
- ``chip_smoke.py`` exits non-zero and prints no result line without a
  CUDA device, and when it stands alone in a directory.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from paddle_tpu.inference.llm.policy import shared_policy  # noqa: E402
from paddle_tpu_torch.inference.llm import policy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "chip_tools").glob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_covers_observability_and_robustness():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    obs = ROOT / "paddle_tpu_torch" / "observability"
    llm = ROOT / "paddle_tpu_torch" / "inference" / "llm"
    want = ([obs / f"{m}.py" for m in (
        "__init__", "metrics", "recorder", "export", "tracing",
        "chrome_trace", "stepprof", "ledger", "watchdog")]
        + [llm / f"{m}.py" for m in ("faults", "journal", "brownout")])
    for path in want:
        assert str(path.relative_to(ROOT)) in names, path


def test_the_scan_covers_the_training_slice():
    """The modules of training as users configure it: the threefry core
    and random state, the dropout kernel's wrapper, the clips, the
    schedulers, the scaler and autocast."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in ("core/threefry.py", "core/random.py", "kernels/dropout.py",
                "nn/clip.py", "optimizer/lr.py", "amp/grad_scaler.py",
                "amp/auto_cast.py", "jit/to_static.py", "text/gpt.py",
                "inference/llm/threefry.py"):
        assert str((port / rel).relative_to(ROOT)) in names, rel


def test_the_scan_covers_the_vision_slice():
    """The vision zoo and detection ops, the offload optimizer, the
    tensor checker and the static helpers built on ``vision.ops``."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    models = ("alexnet", "vgg", "squeezenet", "mobilenetv1", "mobilenetv2",
              "mobilenetv3", "shufflenetv2", "densenet", "googlenet",
              "inceptionv3", "resnet")
    for rel in (["vision/ops.py", "optimizer/offload.py",
                 "amp/debugging.py", "static/nn.py"]
                + [f"vision/models/{m}.py" for m in models]):
        assert str((port / rel).relative_to(ROOT)) in names, rel


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)\n"
        "paddle.sum(paddle.nn.Linear(2, 3)(x)).backward()\n"
        "assert isinstance(x.grad, paddle.Tensor)\n"
        "op = paddle.utils.cuda_op('iso_triple', '__global__ void k(const '\n"
        "    'float* x, float* o, int64_t n) {}', 'k', lambda x: \n"
        "    paddle.utils.ShapeDtypeStruct(x.shape, x.dtype),\n"
        "    reference=lambda x: x * 3.0)\n"
        "assert op(x.detach()).tolist() == [[3.0, 6.0]]\n"
        "b = paddle.to_tensor([[0.0, 0.0, 2.0, 2.0], [0.1, 0.1, 2.0, 2.0]])\n"
        "keep = paddle.vision.ops.nms(b, 0.5, paddle.to_tensor([0.9, 0.8]))\n"
        "assert keep.tolist() == [0]\n"
        "m = paddle.vision.models.mobilenet_v3_small(scale=0.25,\n"
        "                                            num_classes=4)\n"
        "o = paddle.optimizer.HostOffloadAdamW(parameters=m.parameters())\n"
        "paddle.sum(m(paddle.rand([2, 3, 32, 32]))).backward()\n"
        "o.step()\n"
        "assert int(paddle.amp.debugging.check_numerics(x)[0]) == 0\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('paddle_tpu_torch')]))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().splitlines()[-2:]
    assert int(n_modules) >= 10
    assert bad == "[]"


def test_policy_copy_matches_the_reference(monkeypatch):
    for key in list(os.environ):
        if key.startswith("PD_"):
            monkeypatch.delenv(key)
    ref = shared_policy()
    assert policy.MAX_QUEUE == ref["max_queue"]
    assert policy.DEFAULT_CHUNK_TOKENS == ref["chunk_tokens"]
    assert policy.STEP_TOKEN_BUDGET == ref["step_token_budget"]
    assert policy.DEFAULT_SPEC_TOKENS == ref["spec_tokens"]
    assert policy.ASYNC_DEPTH == ref["async_depth"]
    assert policy.KV_QUANT == ref["kv_quant"]
    assert policy.WEIGHT_QUANT == ref["weight_quant"]
    assert policy.KV_SPLIT_PAGES == ref["kv_split_pages"]
    assert policy.PRIORITY_CLASSES == ref["priority_classes"]
    assert policy.TENANT_MAX_PAGES == ref["tenant_max_pages"]
    assert policy.TENANT_MAX_SLOTS == ref["tenant_max_slots"]
    assert policy.STEPPROF_SAMPLE_PCT == ref["stepprof_sample_pct"]
    assert policy.BROWNOUT_LEVELS == ref["brownout_levels"]
    assert policy.JOURNAL_SYNC_EVERY == ref["journal_sync_every"]
    assert policy.JOURNAL_MAX_BYTES == ref["journal_max_bytes"]
    assert policy.WEIGHT_MATMUL == ref["weight_matmul"]
    assert policy.FABRIC_REPLICAS == ref["fabric_replicas"]
    assert policy.FABRIC_SPILL == ref["fabric_spill"]
    assert policy.FABRIC_ROLES == ref["fabric_roles"]
    assert policy.SLO_TTFT_MS == ref["slo_ttft_ms"]
    assert policy.SLO_ITL_MS == ref["slo_itl_ms"]


def test_swap_defaults_match_the_reference(monkeypatch):
    """The host swap tier's defaults are the JAX cache module's (read
    there from ``PD_SWAP_PAGES``/``PD_COLD_DEMOTE`` at import; with
    neither set, these)."""
    from paddle_tpu.inference.llm import kv_cache as jkv

    monkeypatch.delenv("PD_SWAP_PAGES", raising=False)
    assert policy.SWAP_PAGES_DEFAULT == jkv._swap_pages_default() == 256
    if "PD_COLD_DEMOTE" not in os.environ:
        assert policy.COLD_DEMOTE_DEFAULT == jkv.COLD_DEMOTE_DEFAULT
    assert policy.COLD_DEMOTE_DEFAULT is True


def test_policy_mode_sets_match_the_reference():
    from paddle_tpu.inference.llm import policy as jpolicy

    assert policy.KV_QUANT_MODES == jpolicy.KV_QUANT_MODES
    assert policy.WEIGHT_QUANT_MODES == jpolicy.WEIGHT_QUANT_MODES
    assert policy.WEIGHT_MATMUL_MODES == jpolicy.WEIGHT_MATMUL_MODES
    assert policy.FABRIC_ROLES_MODES == jpolicy.FABRIC_ROLES_MODES


def test_the_scan_covers_quantized_serving_and_the_fabric():
    """The modules of the int8 matmul, the fabric, its observability
    plane, the SLO alerts and the serving bridge are scanned too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    want = [port / "kernels" / "int8.py",
            port / "inference" / "llm" / "fabric.py",
            port / "inference" / "llm" / "quant.py",
            port / "observability" / "fabricobs.py",
            port / "observability" / "alerts.py",
            port / "inference" / "serving.py"]
    for path in want:
        assert str(path.relative_to(ROOT)) in names, path


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_the_scan_covers_the_compile_and_export_slice():
    """dy2static, to_static / save / load, the static recorder and its
    Executor, backward, nn and io, the host C++ extensions and the
    plugin loader are scanned too; the plugin ABI header is the port's
    own copy (byte-equal to the JAX package's, so a plugin built against
    either loads in both)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in ("jit/dy2static/__init__.py", "jit/to_static.py",
                "jit/__init__.py", "static/__init__.py", "static/program.py",
                "static/executor.py", "static/backward.py", "static/nn.py",
                "static/io.py", "utils/cpp_extension.py", "utils/plugin.py",
                "kernels/flash_attention.py", "chip_tools/train_ab.py"):
        path = port / rel if not rel.startswith("chip_tools") else ROOT / rel
        assert str(path.relative_to(ROOT)) in names, rel
    header = port / "utils" / "csrc" / "plugin_abi.h"
    assert header.read_bytes() == (
        ROOT / "paddle_tpu" / "core" / "native" / "csrc" /
        "plugin_abi.h").read_bytes()
    # the JAX header path is nowhere in the port
    for path in PORT_FILES:
        assert "core/native/csrc" not in path.read_text(), path


def test_the_scan_covers_the_high_level_training_slice():
    """``paddle.save`` / ``load`` and the flags, the loss layers, the
    metrics, the native queue tier, the DataLoader, the datasets and
    transforms, LeNet, hapi and its callbacks, and the static tail are
    scanned too; the native queue tier's C++ source is the port's own,
    under ``paddle_tpu_torch/``."""
    from paddle_tpu_torch.core import native

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in ("framework/__init__.py", "framework/io.py",
                "framework/flags.py", "nn/layer/loss.py",
                "metric/__init__.py", "core/native/__init__.py",
                "core/native/queues.py", "io/__init__.py",
                "io/dataloader.py", "vision/datasets/__init__.py",
                "vision/transforms/__init__.py", "vision/models/lenet.py",
                "hapi/__init__.py", "hapi/model.py", "hapi/callbacks.py",
                "callbacks.py", "static/sequence.py", "static/extras.py"):
        assert str((port / rel).relative_to(ROOT)) in names, rel
    src = Path(native.source_path()).resolve()
    assert src.is_file() and port.resolve() in src.parents, src
    text = src.read_text()
    assert "shr_push" in text and "pts_" not in text and "pha_" not in text


def test_the_high_level_surface_loads_no_jax(tmp_path):
    """In a fresh interpreter: ``import paddle_tpu_torch as paddle`` and
    the high-level path on the CPU (FakeData in bfloat16 and float32
    through the DataLoader, inline and over two ``fork`` workers; LeNet
    through ``Model.fit`` / ``evaluate`` / ``predict``; ``summary``,
    ``flops``, ``save`` / ``load``; a sequence op and an EMA) leave
    ``jax``, ``paddle_tpu`` and ``ml_dtypes`` out of ``sys.modules``."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "from paddle_tpu_torch.vision.models import LeNet\n"
        "ds = paddle.vision.datasets.FakeData(num_samples=8, dtype='bfloat16')\n"
        "x, y = next(iter(paddle.io.DataLoader(ds, batch_size=4)))\n"
        "assert str(x.dtype) == 'torch.bfloat16' and y.shape == (4, 1)\n"
        "ds = paddle.vision.datasets.FakeData(num_samples=8)\n"
        "b = list(paddle.io.DataLoader(ds, batch_size=4, num_workers=2))\n"
        "assert len(b) == 2\n"
        "net = LeNet()\n"
        "m = paddle.Model(net).prepare(paddle.optimizer.Adam(\n"
        "    1e-3, parameters=net.parameters()), paddle.nn.CrossEntropyLoss(),\n"
        "    paddle.metric.Accuracy(), jit=True)\n"
        "m.fit(ds, batch_size=4, verbose=0)\n"
        "m.evaluate(ds, batch_size=4, verbose=0)\n"
        "m.predict(ds, batch_size=4, stack_outputs=True)\n"
        "paddle.flops(net, [1, 1, 28, 28])\n"
        f"m.save({str(tmp_path / 'lenet')!r})\n"
        f"m.load({str(tmp_path / 'lenet')!r})\n"
        "paddle.static.sequence_pool(paddle.rand([2, 3]), 'max',\n"
        "                            length=paddle.to_tensor([1, 3]))\n"
        "ema = paddle.static.ExponentialMovingAverage(0.9)\n"
        "ema.update(net.parameters())\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_scan_covers_the_op_surface_and_sequence_slice():
    """The op surface (creation, random, math, logic, reductions,
    manipulation, linear algebra, extras), ``paddle.linalg``, the
    functional tail, every layer family with the RNN and Transformer
    stacks, and ``nn.utils`` are scanned too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in ("ops/creation.py", "ops/random_ops.py", "ops/math.py",
                "ops/logic.py", "ops/reduction.py", "ops/manipulation.py",
                "ops/linalg.py", "ops/extras.py", "linalg.py",
                "nn/functional.py", "nn/utils.py", "nn/layer/activation.py",
                "nn/layer/common.py", "nn/layer/conv.py",
                "nn/layer/norm.py", "nn/layer/pooling.py",
                "nn/layer/rnn.py", "nn/layer/transformer.py",
                "nn/layer/extras.py", "optimizer/optimizer.py"):
        assert str((port / rel).relative_to(ROOT)) in names, rel


def test_the_sequence_layers_load_no_jax():
    """In a fresh interpreter: ``nn.Transformer`` and ``nn.LSTM`` built
    and run forward and backward on the CPU, an incremental decode step
    through ``Cache``, beam search, and a few ops of the surface leave
    ``jax`` and ``paddle_tpu`` out of ``sys.modules``."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "t = paddle.nn.Transformer(32, 2, 1, 1, 64)\n"
        "src, tgt = paddle.rand([2, 5, 32]), paddle.rand([2, 4, 32])\n"
        "mask = paddle.nn.Transformer.generate_square_subsequent_mask(4)\n"
        "t(src, tgt, tgt_mask=mask).sum().backward()\n"
        "t.eval()\n"
        "mem = t.encoder(src)\n"
        "cache = t.decoder.gen_cache(mem)\n"
        "out, cache = t.decoder(tgt[:, :1], mem, None, None, cache)\n"
        "lstm = paddle.nn.LSTM(8, 16, 2, direction='bidirect')\n"
        "y, (h, c) = lstm(paddle.rand([3, 6, 8]))\n"
        "y.sum().backward()\n"
        "cell = paddle.nn.LSTMCell(8, 8)\n"
        "dec = paddle.nn.BeamSearchDecoder(cell, 1, 2, 2,\n"
        "    embedding_fn=paddle.nn.Embedding(10, 8),\n"
        "    output_fn=paddle.nn.Linear(8, 10))\n"
        "ids, _ = paddle.nn.dynamic_decode(\n"
        "    dec, cell.get_initial_states(paddle.zeros([1, 8])), 3)\n"
        "x = paddle.to_tensor(np.eye(3, dtype='float32') * 2)\n"
        "paddle.linalg.svd(x); paddle.histogram(x, 4); paddle.median(x)\n"
        "paddle.nn.functional.interpolate(paddle.rand([1, 2, 4, 4]), [6, 6],\n"
        "                                 mode='bicubic')\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_scan_covers_the_bert_incubate_slice():
    """BERT, the text datasets, ``incubate`` (its fused layers, optimizer
    wrappers, ASP, autodiff, checkpoint and shared-memory tensors),
    ``geometric`` and ``regularizer`` are scanned; in a fresh interpreter
    a tiny BERT step, a fused layer, a LookAhead step, an ASP mask, a
    Jacobian, a message pass and a Viterbi decode leave ``jax`` and
    ``paddle_tpu`` out of ``sys.modules``."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in ("text/bert.py", "text/datasets.py", "regularizer.py",
                "geometric/__init__.py", "incubate/__init__.py",
                "incubate/nn/functional.py", "incubate/nn/layer.py",
                "incubate/optimizer/__init__.py", "incubate/asp/__init__.py",
                "incubate/autograd/__init__.py", "incubate/checkpoint.py",
                "incubate/multiprocessing/reductions.py",
                "incubate/distributed/__init__.py"):
        assert str((port / rel).relative_to(ROOT)) in names, rel
    code = (
        "import sys\n"
        "import paddle_tpu_torch as paddle\n"
        "import paddle_tpu_torch.incubate.multiprocessing\n"
        "from paddle_tpu_torch import incubate, geometric, text\n"
        "paddle.set_device('cpu')\n"
        "m = text.BertForSequenceClassification(text.BertConfig.tiny())\n"
        "opt = incubate.LookAhead(paddle.optimizer.Lamb(\n"
        "    parameters=m.parameters(),\n"
        "    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)), k=1)\n"
        "ids = paddle.randint(0, 256, [2, 8])\n"
        "m(ids).sum().backward(); opt.step()\n"
        "incubate.nn.FusedMultiTransformer(64, 4, 128, num_layers=1)(\n"
        "    paddle.rand([1, 8, 64]))\n"
        "incubate.asp.prune_model(m)\n"
        "incubate.autograd.Jacobian(lambda x: x * x, paddle.rand([3]))\n"
        "geometric.send_u_recv(paddle.rand([4, 2]), paddle.to_tensor(\n"
        "    [0, 1, 2]), paddle.to_tensor([1, 1, 3]), 'max')\n"
        "text.viterbi_decode(paddle.rand([1, 4, 5]), paddle.rand([5, 5]),\n"
        "                    paddle.to_tensor([4]))\n"
        "paddle.regularizer.L1Decay(0.1)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_scan_covers_the_initializer_device_and_audio_slice(tmp_path):
    """The initializers, ``device/``, ``compat``, ``fft``, ``signal``,
    ``audio/``, ``hub``, ``reader``, ``strings`` and ``sysconfig`` are
    scanned; in a fresh interpreter the Paddle idioms of this slice (a
    place, a global initializer, ``set_value``, ``clear_gradients``,
    the log-mel front end, an FFT, a WAV round trip, a local hub) leave
    ``jax`` and ``paddle_tpu`` out of ``sys.modules``."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in ("nn/initializer.py", "device/__init__.py", "compat.py",
                "fft.py", "signal.py", "audio/__init__.py",
                "audio/functional.py", "audio/features.py",
                "audio/backends.py", "audio/datasets.py", "hub.py",
                "reader.py", "strings.py", "sysconfig.py",
                "autograd/__init__.py", "utils/__init__.py"):
        assert str((port / rel).relative_to(ROOT)) in names, rel
    (tmp_path / "hubconf.py").write_text("def one():\n    return 1\n")
    code = (
        "import sys\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device(paddle.CPUPlace())\n"
        "init = paddle.nn.initializer\n"
        "init.set_global_initializer(init.TruncatedNormal(0.0, 0.02))\n"
        "m = paddle.nn.Sequential(paddle.nn.Linear(4, 4))\n"
        "init.set_global_initializer(None)\n"
        "m[0].weight.set_value(paddle.normal(0.0, 0.02, [4, 4]))\n"
        "opt = paddle.optimizer.AdamW(parameters=m.parameters())\n"
        "m(paddle.rand([2, 4])).sum().backward(); opt.step()\n"
        "opt.clear_gradients()\n"
        "x = paddle.rand([1, 4000])\n"
        "paddle.audio.MFCC(sr=16000, n_fft=256, n_mels=20)(x)\n"
        "paddle.fft.rfft(x).cast('complex64')\n"
        f"path = {str(tmp_path / 'a.wav')!r}\n"
        "paddle.audio.save(path, x, 16000); paddle.audio.load(path)\n"
        f"assert paddle.hub.load({str(tmp_path)!r}, 'one') == 1\n"
        "paddle.device.cuda.memory_allocated()\n"
        "list(paddle.batch(lambda: iter(range(3)), 2)())\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


LONG_TAIL = ("sparse/__init__.py", "sparse/nn.py", "distribution/__init__.py",
             "distribution/distribution.py", "distribution/continuous.py",
             "distribution/discrete.py", "distribution/transform.py",
             "distribution/transformed_distribution.py", "distribution/kl.py",
             "quantization/__init__.py", "profiler/__init__.py",
             "onnx/__init__.py", "onnx/_export.py", "onnx/_proto.py",
             "cost_model/__init__.py")


def test_the_scan_covers_the_long_tail_slice():
    """``sparse``, ``distribution``, ``quantization``, ``profiler``,
    ``onnx`` (with its own copy of the protobuf encoder) and
    ``cost_model`` are scanned too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = ROOT / "paddle_tpu_torch"
    for rel in LONG_TAIL:
        assert str((port / rel).relative_to(ROOT)) in names, rel


def test_using_the_long_tail_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "a = paddle.sparse_csr_tensor([0, 1, 2], [1, 0], [2.0, 3.0], [2, 2])\n"
        "y = paddle.sparse.matmul(a, paddle.ones([2, 3]))\n"
        "assert y.numpy().tolist() == [[2.0] * 3, [3.0] * 3]\n"
        "d = paddle.distribution\n"
        "kl = d.kl_divergence(d.Normal(0.0, 1.0), d.Normal(1.0, 2.0))\n"
        "assert float(kl) > 0\n"
        "q = paddle.quantization\n"
        "net = paddle.nn.Sequential(paddle.nn.Linear(4, 3))\n"
        "qn = q.QAT(q.QuantConfig(q.FakeQuanterWithAbsMaxObserver(),\n"
        "    q.FakeQuanterWithAbsMaxObserver())).quantize(net)\n"
        "qn(paddle.ones([2, 4]))\n"
        "i8 = q.PTQ(q.QuantConfig()).convert_int8(net)\n"
        "i8(paddle.ones([2, 4]))\n"
        "prof = paddle.profiler.Profiler(timer_only=True)\n"
        "prof.start()\n"
        "with paddle.profiler.RecordEvent('step'):\n"
        "    pass\n"
        "prof.step()\n"
        "prof.stop()\n"
        "path = paddle.onnx.export(net, sys.argv[1],\n"
        "                          input_spec=[((2, 4), 'float32')])\n"
        "from chip_tools import onnx_eval\n"
        "out, = onnx_eval.run(open(path, 'rb').read(),\n"
        "                     [np.ones((2, 4), 'float32')])\n"
        "assert out.shape == (2, 3)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "m")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
