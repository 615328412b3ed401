"""External-builder pipeline: detect / build / run from an installed
chaincode package to a launched process.

Reference parity: core/container/externalbuilder/externalbuilder.go —
the peer walks its configured builders; the first whose `bin/detect`
accepts the package gets `bin/build`, and the built artifact's
`bin/run` becomes the chaincode's long-running process.  The launch
command is derived from the package itself, never supplied by an
operator.

Layout of an operator builder directory (exactly the reference's):

    <builder>/bin/detect  <pkg_dir> <metadata_dir>     rc 0 = mine
    <builder>/bin/build   <pkg_dir> <metadata_dir> <output_dir>
    <builder>/bin/run     <output_dir> <run_metadata_dir>

A BUILTIN python builder ships in-process so a package whose metadata
declares ``{"type": "python"}`` (or whose label ends in ``.py``) runs
with zero operator configuration: build materializes the code as
``chaincode.py``; run executes it with the current interpreter.  The
chaincode source speaks the shim protocol (extcc.shim_main) via the
FABRIC_TPU_CC_* env the launcher provides.

Build outputs are cached by package id (hash-addressed, like the
installer) so re-install/re-launch never rebuilds.

Counterpart of `fabric_tpu/chaincode/externalbuilder.py`, the same code
on the port's imports.  The builtin python builder runs the package's
source with this interpreter; a port chaincode imports the port's
`shim_main`.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys
from dataclasses import dataclass
from typing import List, Optional

from fabric_tpu_torch.utils import serde

from .lifecycle import package_id

logger = logging.getLogger("fabric_tpu_torch.chaincode.externalbuilder")


@dataclass(frozen=True)
class BuildResult:
    package_id: str
    builder: str
    output_dir: str
    run_argv: List[str]


class ExternalBuilder:
    """One operator-provided builder directory (bin/detect|build|run)."""

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path

    def _bin(self, tool: str) -> str:
        return os.path.join(self.path, "bin", tool)

    def detect(self, pkg_dir: str, meta_dir: str) -> bool:
        exe = self._bin("detect")
        if not os.access(exe, os.X_OK):
            return False
        rc = subprocess.run([exe, pkg_dir, meta_dir],
                            capture_output=True).returncode
        return rc == 0

    def build(self, pkg_dir: str, meta_dir: str, out_dir: str) -> None:
        proc = subprocess.run([self._bin("build"), pkg_dir, meta_dir,
                               out_dir], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"builder {self.name!r} build failed: {proc.stderr[-500:]}")

    def run_argv(self, out_dir: str, run_meta_dir: str) -> List[str]:
        return [self._bin("run"), out_dir, run_meta_dir]


class _PythonBuiltin:
    """Zero-config builder for python-source chaincode packages."""

    name = "python-builtin"

    @staticmethod
    def wants(label: str, metadata: dict) -> bool:
        return (metadata.get("type") == "python"
                or str(label).endswith(".py"))

    @staticmethod
    def build(code: bytes, out_dir: str) -> List[str]:
        path = os.path.join(out_dir, "chaincode.py")
        with open(path, "wb") as f:
            f.write(code)
        return [sys.executable, path]


class BuildPipeline:
    """detect -> build -> run resolution, cached by package id."""

    def __init__(self, build_root: str,
                 builders: Optional[List[ExternalBuilder]] = None):
        self.build_root = build_root
        self.builders = list(builders or [])
        os.makedirs(build_root, exist_ok=True)

    def build(self, pkg: bytes) -> BuildResult:
        """Resolve and build one installed package; idempotent."""
        pid = package_id(pkg)
        d = serde.decode(pkg)
        label, code = d["label"], d["code"]
        metadata = d.get("metadata") or {}
        key = pid.rsplit(":", 1)[1]
        root = os.path.join(self.build_root, key)
        out_dir = os.path.join(root, "release")
        run_meta = os.path.join(root, "run")
        done = os.path.join(root, "BUILDER")
        if os.path.exists(done):
            with open(done) as f:
                builder_name, *argv = f.read().splitlines()
            return BuildResult(pid, builder_name, out_dir, argv)

        pkg_dir = os.path.join(root, "pkg")
        meta_dir = os.path.join(root, "meta")
        for p in (pkg_dir, meta_dir, out_dir, run_meta):
            os.makedirs(p, exist_ok=True)
        with open(os.path.join(pkg_dir, "code"), "wb") as f:
            f.write(code)
        with open(os.path.join(meta_dir, "metadata.json"), "w") as f:
            import json
            json.dump({"label": label,
                       **{k: v for k, v in metadata.items()
                          if isinstance(v, (str, int, bool, float))}}, f)

        builder_name = None
        argv: List[str] = []
        for b in self.builders:
            if b.detect(pkg_dir, meta_dir):
                b.build(pkg_dir, meta_dir, out_dir)
                builder_name = b.name
                argv = b.run_argv(out_dir, run_meta)
                break
        if builder_name is None and _PythonBuiltin.wants(label, metadata):
            argv = _PythonBuiltin.build(code, out_dir)
            builder_name = _PythonBuiltin.name
        if builder_name is None:
            shutil.rmtree(root, ignore_errors=True)
            raise RuntimeError(
                f"no builder detected package {pid!r} (label {label!r})")
        with open(done, "w") as f:
            f.write("\n".join([builder_name, *argv]))
        logger.info("built %s with %s -> %s", pid, builder_name, out_dir)
        return BuildResult(pid, builder_name, out_dir, argv)


def launch_installed(support, pipeline: BuildPipeline, name: str,
                     pkg: bytes) -> BuildResult:
    """Install-package -> running process: build via the pipeline, then
    hand the derived run command to ChaincodeSupport.launch — no
    operator-supplied command line anywhere."""
    res = pipeline.build(pkg)
    support.launch(name, res.run_argv)
    return res
