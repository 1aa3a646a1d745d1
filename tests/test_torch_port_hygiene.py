"""apex_tpu_torch stands alone: no JAX, no apex_tpu, no silent CPU run.

- An AST scan of every module of ``apex_tpu_torch`` and of
  ``chip_smoke.py`` finds no import whose top-level module is ``jax``,
  ``jaxlib``, ``flax``, ``optax`` or ``apex_tpu`` (``apex_tpu_torch``
  itself is fine).
- Importing the port in a fresh interpreter loads no JAX module.
- ``Engine(device=None)`` means the GPU, and so do the training
  recipe's default ``--device`` and ``PagedKVCache.create``'s default
  device: without one they raise instead of running on the CPU; and
  ``chip_smoke.py`` exits non-zero with no
  result line, in the checkout without a GPU and alone in an empty
  directory (run in this process).
"""

import ast
import json
import os
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "apex_tpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_files():
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py"))
    assert len(files) >= 13
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_jax_or_apex_tpu_imports():
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in _port_files() for line, mod in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_import_loads_no_jax():
    code = ("import sys, apex_tpu_torch.serving, apex_tpu_torch.models, "
            "apex_tpu_torch.kernels, apex_tpu_torch.amp, "
            "apex_tpu_torch.optimizers, apex_tpu_torch.normalization, "
            "apex_tpu_torch.multi_tensor_apply, apex_tpu_torch.utils, "
            "apex_tpu_torch.examples.lm.main_amp; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would use it")
    from apex_tpu_torch.models import create_lm
    from apex_tpu_torch.serving import Engine

    model = create_lm("tiny", vocab_size=64, max_seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, slots=1, max_len=32, prefill_len=16)


def test_paged_kv_cache_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would use it")
    from apex_tpu_torch.serving import PagedKVCache

    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache.create(layers=1, num_pages=3, heads=2, page_len=4,
                            head_dim=8)


def test_paged_kv_cache_on_the_cpu_when_named():
    from apex_tpu_torch.serving import PagedKVCache

    cache = PagedKVCache.create(layers=2, num_pages=3, heads=2, page_len=4,
                                head_dim=8, dtype=torch.float32,
                                device="cpu")
    assert cache.k.device.type == cache.v.device.type == "cpu"
    assert cache.k.shape == (2, 3, 2, 4, 8) and not cache.k.any()
    assert cache.nbytes() == 2 * 2 * 3 * 2 * 4 * 8 * 4


def test_trainer_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would use it")
    from apex_tpu_torch.examples.lm import main_amp

    argv = ["--size", "tiny", "--vocab-size", "64", "-b", "2",
            "--seq-len", "16", "--iters", "1", "--fused-head"]
    assert main_amp.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        main_amp.main(argv)
    # on the CPU: the fused head, and the default loss (xentropy
    # kernels #11-#12' plain versions) in both FusedAdam layouts and at O1
    out = main_amp.main(argv + ["--device", "cpu"])
    assert len(out["loss_history"]) == 1
    for extra in ([], ["--opt-layout", "flat"], ["--opt-level", "O1"]):
        out = main_amp.main(argv[:-1] + ["--device", "cpu"] + extra)
        assert len(out["loss_history"]) == 1
        assert all(np.isfinite(out["loss_history"]))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_without_a_gpu_prints_no_result(tmp_path, capsys,
                                                  monkeypatch, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        # alone in a directory it stops before it needs the card, so the
        # card is granted here to reach that check
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        runpy.run_path(str(script), run_name="__main__")
    assert exit_.value.code not in (0, None)
    out = capsys.readouterr().out
    for line in out.splitlines():
        if line.startswith("{"):
            assert "ok" not in json.loads(line), line
