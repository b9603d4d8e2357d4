"""paddle.hub: the port of ``paddle_tpu/hub.py`` (reference
python/paddle/hapi/hub.py: list/help/load the entry points of a repo's
hubconf.py).

A local directory is the only source: ``source="github"``/``"gitee"`` need
the network and raise. ``load_state_dict_from_url`` reads the cache
(``utils/download.py``) with the port's ``load`` (tensors on the card unless
``map_location="cpu"``).
"""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load", "load_state_dict_from_url"]

_HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {_HUBCONF} found in {repo_dir}")
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["paddle_tpu_torch_hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _resolve(repo_dir, source):
    if source not in ("local", "github", "gitee"):
        raise ValueError(f"unknown source {source!r}: expected 'local', 'github' or 'gitee'")
    if source != "local":
        raise RuntimeError(
            "remote hub sources need network access; clone the repo and use "
            "source='local' (hub.py:_resolve)")
    return repo_dir


def list(repo_dir, source="github", force_reload=False):  # noqa: A001
    """The entry-point names the repo's hubconf exports (hub.py:188)."""
    mod = _load_hubconf(_resolve(repo_dir, source))
    return [name for name, v in vars(mod).items() if callable(v) and not name.startswith("_")]


def _get_entry(repo_dir, model, source):
    entry = getattr(_load_hubconf(_resolve(repo_dir, source)), model, None)
    if entry is None or not callable(entry):
        raise RuntimeError(f"no callable entrypoint {model!r} in hubconf")
    return entry


def help(repo_dir, model, source="github", force_reload=False):  # noqa: A001
    """The entry point's docstring (hub.py:238)."""
    return _get_entry(repo_dir, model, source).__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    """The entry point's model (hub.py:286)."""
    return _get_entry(repo_dir, model, source)(**kwargs)


def load_state_dict_from_url(url, model_dir=None, check_hash=False, file_name=None,
                             map_location=None):
    """The cached state dict downloaded from ``url`` (hub.py:337); only the
    cache is read. ``model_dir``/``file_name`` pick the cache's file as in
    the reference; ``map_location`` is the device of the tensors."""
    import os.path as osp

    from .framework_io import load as _load
    from .utils import download as dl

    root = model_dir or dl.WEIGHTS_HOME
    if file_name:
        path = osp.join(root, file_name)
        if not osp.exists(path):
            raise RuntimeError(
                f"{url} is not cached at {path} and this build has no "
                "network egress; place the file there and retry")
        return _load(path, device=map_location)
    return _load(dl._cached(url, root), device=map_location)
