"""Filesystem shim: local + HDFS (reference paddle/fluid/framework/io/fs.h
localfs_*/hdfs_* via piped shell commands, and
python/paddle/fluid/incubate/fleet/utils/hdfs.py HDFSClient).

LocalFS is a plain implementation; HDFSClient shells out to the ``hadoop``
binary exactly like the reference and raises a clear error when no Hadoop
is installed, so fleet data tooling written against the reference API
ports unchanged. The counterpart of ``paddle_tpu/incubate/fleet/utils``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

__all__ = ["LocalFS", "HDFSClient"]


class LocalFS:
    """reference io/fs.h localfs_* verbs."""

    def ls_dir(self, path: str) -> List[str]:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def is_exist(self, path: str) -> bool:
        return os.path.exists(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def is_file(self, path: str) -> bool:
        return os.path.isfile(path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src: str, dst: str) -> None:
        shutil.move(src, dst)

    def upload(self, local: str, remote: str) -> None:
        shutil.copy(local, remote)

    def download(self, remote: str, local: str) -> None:
        shutil.copy(remote, local)

    def touch(self, path: str) -> None:
        open(path, "a").close()

    def cat(self, path: str) -> str:
        with open(path) as f:
            return f.read()


class HDFSClient:
    """reference incubate/fleet/utils/hdfs.py HDFSClient: every verb shells
    out to ``hadoop fs`` (the reference pipes the same commands through
    io/shell.h)."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None):
        self._hadoop = os.path.join(hadoop_home, "bin", "hadoop") \
            if hadoop_home else "hadoop"
        self._pre = []
        for k, v in (configs or {}).items():
            self._pre += ["-D", f"{k}={v}"]

    def _run(self, *args) -> str:
        cmd = [self._hadoop, "fs"] + self._pre + list(args)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError(
                f"hadoop binary not found ({self._hadoop}) — HDFSClient "
                f"needs a Hadoop installation (reference hdfs.py has the "
                f"same requirement); use LocalFS for local paths")
        if r.returncode != 0:
            raise RuntimeError(f"hadoop fs {' '.join(args)} failed: "
                               f"{r.stderr.strip()[:500]}")
        return r.stdout

    def ls_dir(self, path: str) -> List[str]:
        out = self._run("-ls", path)
        return [line.split()[-1] for line in out.splitlines()
                if line.startswith(("-", "d"))]

    def is_exist(self, path: str) -> bool:
        try:
            self._run("-test", "-e", path)
            return True
        except RuntimeError:
            return False

    def mkdirs(self, path: str) -> None:
        self._run("-mkdir", "-p", path)

    def delete(self, path: str) -> None:
        self._run("-rm", "-r", "-f", path)

    def upload(self, local: str, remote: str) -> None:
        self._run("-put", "-f", local, remote)

    def download(self, remote: str, local: str) -> None:
        self._run("-get", remote, local)
