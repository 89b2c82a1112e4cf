"""``paddle.hub``: load models from a directory holding a ``hubconf.py``
(counterpart of ``paddle_tpu/hub.py``).

``list`` / ``help`` / ``load`` find the entry points (the public
callables of ``hubconf.py``) and check its ``dependencies``. Only
``source='local'`` is served: nothing is downloaded, and a remote
source raises with the way to use a local clone instead.
"""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]


def _load_hubconf(repo_dir: str):
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no hubconf.py in {repo_dir}")
    spec = importlib.util.spec_from_file_location(
        f"paddle_tpu_torch_hubconf_{abs(hash(repo_dir))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    deps = getattr(mod, "dependencies", [])
    missing = []
    for d in deps:
        try:
            importlib.import_module(d)
        except ImportError:
            missing.append(d)
    if missing:
        raise RuntimeError(f"hub repo requires missing packages: {missing}")
    return mod


def _resolve(repo_dir: str, source: str):
    if source != "local":
        raise RuntimeError(
            "paddle.hub downloads nothing; clone the repo and use "
            "source='local' with its directory path")
    return _load_hubconf(repo_dir)


def list(repo_dir: str, source: str = "local",  # noqa: A001
         force_reload: bool = False):
    """Entrypoint names exposed by the repo's hubconf.py."""
    mod = _resolve(repo_dir, source)
    return [k for k, v in vars(mod).items()
            if callable(v) and not k.startswith("_")]


def help(repo_dir: str, model: str, source: str = "local",  # noqa: A001
         force_reload: bool = False) -> str:
    mod = _resolve(repo_dir, source)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        names = [k for k, v in vars(mod).items()
                 if callable(v) and not k.startswith("_")]
        raise ValueError(f"no entrypoint {model!r}; available: {names}")
    return fn.__doc__ or ""


def load(repo_dir: str, model: str, source: str = "local",
         force_reload: bool = False, **kwargs):
    mod = _resolve(repo_dir, source)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise ValueError(f"no entrypoint {model!r} in {repo_dir}")
    return fn(**kwargs)
