"""chip_smoke.py and bench.py refuse to run anywhere but on a GPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import smoke_checks as smoke

ROOT = Path(__file__).resolve().parents[1]


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        smoke.require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke", "bench"])
def test_scripts_refuse_cpu_before_any_result(script, monkeypatch, capsys):
    import importlib

    monkeypatch.setattr(sys, "argv", [f"{script}.py"])
    mod = importlib.import_module(script)
    with pytest.raises(RuntimeError, match="no GPU"):
        mod.main()
    assert "{" not in capsys.readouterr().out


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Copied out of the repo, the script exits non-zero and prints no
    JSON line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
