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
- the scan covers the observability and robustness modules (metrics,
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
