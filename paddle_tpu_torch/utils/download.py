"""paddle.utils.download: the port of ``paddle_tpu/utils/download.py``
(reference python/paddle/utils/download.py: get_weights_path_from_url and
get_path_from_url over a ~/.cache/paddle cache).

Nothing is downloaded: the cache is the only source, and a file that is not
there raises with the path to place it at.
"""
from __future__ import annotations

import os
import os.path as osp

__all__ = ["get_weights_path_from_url", "get_path_from_url"]

WEIGHTS_HOME = osp.expanduser("~/.cache/paddle/hapi/weights")
DOWNLOAD_HOME = osp.expanduser("~/.cache/paddle/dataset")


def _cached(url, root_dir):
    path = osp.join(root_dir, osp.split(url)[-1])
    if osp.exists(path):
        return path
    raise RuntimeError(
        f"{url} is not in the local cache and this build has no network "
        f"egress; place the file at {path} and retry "
        "(reference download.py would fetch it)")


def get_weights_path_from_url(url, md5sum=None):
    os.makedirs(WEIGHTS_HOME, exist_ok=True)
    return _cached(url, WEIGHTS_HOME)


def get_path_from_url(url, root_dir=None, md5sum=None, check_exist=True,
                      decompress=True, method="get"):
    root_dir = root_dir or DOWNLOAD_HOME
    os.makedirs(root_dir, exist_ok=True)
    return _cached(url, root_dir)
