"""``chip_smoke.py`` rehearsed on the CPU: each phase at tiny widths (the
four-card phase on 4 of the virtual CPU devices), and the refusal to run
anywhere but on a GPU. Also checks that no TPU-only code is left."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = dict(hidden_features=8, depth=2)


def test_phase_dense_ef_tiny(capsys):
    chip_smoke.phase_dense_ef(batch=16, n_ref=8, **TINY)
    assert '"phase": "dense_ef"' in capsys.readouterr().out


def test_phase_md17_train_tiny(capsys):
    chip_smoke.phase_md17_train(n_train=16, n_epochs=3, **TINY)
    assert '"phase": "md17_train"' in capsys.readouterr().out


@pytest.mark.parametrize(
    "n_atoms,periodic,cell_capacity", [(128, False, None), (512, True, 48)]
)
def test_phase_sparse_md_tiny(capsys, n_atoms, periodic, cell_capacity):
    chip_smoke.phase_sparse_md(
        n_atoms=n_atoms, n_steps=4, rebuild_every=2, periodic=periodic,
        cell_capacity=cell_capacity, ref_block=64, **TINY,
    )
    out = capsys.readouterr().out
    assert '"phase": "sparse_md"' in out
    assert ('"build": "cell"' in out) == (cell_capacity is not None)


def test_phase_four_cards_on_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four_cards(batch=8, n_atoms=64, **TINY)
    out = capsys.readouterr().out
    assert out.count('"phase": "sharded_forward"') == 2
    assert '"phase": "dp_step"' in out


def test_phase_gpu_tests_fails_when_they_skip():
    """Off the card the gpu tests skip, and a skipped gpu test fails the
    phase: nothing is passed over."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.phase_gpu_tests()"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0
    assert '"skipped": 5' in proc.stdout, proc.stdout[-2000:]


def test_main_fails_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Run from a directory that holds chip_smoke.py and nothing else of
    the repo: non-zero exit, no ok line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_no_tpu_only_code_left():
    """No Pallas-TPU import, ``xla_tpu`` compiler option or interpreted
    kernel call in the program; ``kernels/`` holds only the functional
    model and its adapter."""
    tpu = re.compile(
        r"pallas\.tpu|pallas import tpu|pltpu|xla_tpu|interpret\s*="
    )
    files = list((REPO / "sake_tpu").rglob("*.py")) + list(REPO.glob("*.py"))
    hits = [
        f"{f.relative_to(REPO)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if tpu.search(line)
    ]
    assert not hits, hits
    kernels = sorted(p.name for p in (REPO / "sake_tpu" / "kernels").glob("*.py"))
    assert kernels == ["__init__.py", "adapter.py", "functional.py"]
