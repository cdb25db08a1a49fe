"""The port's packaging: every source it builds at run time ships in the
wheel (`pyproject.toml`'s package-data), each port CLI has a
`bist-torch-*` command, and the kernels' build directory lies in the source
tree for a checkout and in a per-user cache directory for an installed
package (`ops/_build.py`)."""

import fnmatch
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bist_tpu_torch.native import loader
from bist_tpu_torch.ops import _build
from torch_threads import two_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
PORT_CLIS = ("generate", "train", "serve", "evaluate", "extract_features",
             "generate_result_video", "train_tgif")


def _project():
    try:
        import tomllib
    except ImportError:  # pragma: no cover - py<3.11
        import tomli as tomllib
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def built_sources():
    """Every file the port compiles at run time: the kernels' .cu sources,
    the headers they include and the native loader's C++ source."""
    return ([_build.SRC_DIR / f"{n}.cu" for n in _build.KERNEL_SOURCES]
            + sorted(_build.SRC_DIR.glob("*.cuh")) + [loader.SRC])


@pytest.mark.parametrize("src", built_sources(), ids=lambda p: p.name)
def test_package_data_ships_every_built_source(src):
    """The source's nearest enclosing package lists a package-data glob that
    matches it."""
    assert src.is_file(), src
    data = _project()["tool"]["setuptools"]["package-data"]
    pkg_dir = src.parent
    while not (pkg_dir / "__init__.py").is_file():
        pkg_dir = pkg_dir.parent
    pkg = ".".join(pkg_dir.relative_to(REPO).parts)
    rel = src.relative_to(pkg_dir).as_posix()
    assert any(fnmatch.fnmatch(rel, g) for g in data.get(pkg, ())), (pkg, rel)


def test_every_port_cli_has_a_bist_torch_command():
    """Seven `bist-torch-*` commands, one per port CLI, each resolving to a
    module with `main`; bist_tpu's own seven commands stay as they are."""
    project = _project()["project"]
    cmds = project["gui-scripts"]
    assert sorted(cmds.values()) == sorted(f"bist_tpu_torch.cli.{m}:main" for m in PORT_CLIS)
    for name, target in cmds.items():
        assert name.startswith("bist-torch-"), name
        mod_name, _, attr = target.partition(":")
        assert callable(getattr(importlib.import_module(mod_name), attr)), name
    assert not set(cmds) & set(project["scripts"])
    assert all(t.startswith("bist_tpu.cli.") for t in project["scripts"].values())


@pytest.mark.parametrize("name", PORT_CLIS)
def test_every_port_cli_runs_as_a_module(name):
    """Each `bist_tpu_torch.cli.<name>` behind a gui-script runs under
    `python -m` (what a gui-script runs: on Linux, where the kernels build,
    it is an ordinary console command): `--help` exits 0 and prints its
    usage."""
    target = _project()["project"]["gui-scripts"][f"bist-torch-{name.replace('_', '-')}"]
    assert target == f"bist_tpu_torch.cli.{name}:main"
    res = subprocess.run([sys.executable, "-m", f"bist_tpu_torch.cli.{name}", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "usage" in res.stdout.lower(), res.stdout[-2000:]


def test_build_dir_in_the_tree_and_in_a_user_cache(monkeypatch, tmp_path):
    assert _build.BUILD_DIR == REPO / "build" / "bist_tpu_torch"
    assert loader.library_path().parent == _build.BUILD_DIR
    installed = tmp_path / "site-packages" / "bist_tpu_torch" / "ops" / "_build.py"
    monkeypatch.setattr(_build, "__file__", str(installed))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir() == tmp_path / "cache" / "bist_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build._build_dir() == tmp_path / "home" / ".cache" / "bist_tpu_torch"
    assert os.path.commonpath([_build._build_dir(), installed]) != str(installed.parents[1])
