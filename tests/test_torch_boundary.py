"""The port's boundary: ``p2p_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the package imports with JAX unavailable,
and its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "p2p_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    # ``p2p_tpu_torch`` starts with ``p2p_tpu``: match the exact name or the
    # ``p2p_tpu.`` prefix only.
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "flax", "p2p_tpu"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_matcher():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("p2p_tpu")
    assert _forbidden("p2p_tpu.models.nn")
    assert not _forbidden("p2p_tpu_torch") and not _forbidden("p2p_tpu_torch.models")
    assert not _forbidden("jaxlike")


def test_no_jax_or_p2p_tpu_imports():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20
    bad = [(str(p.relative_to(ROOT)), name) for p in PORT_FILES
           for name in _imports(p) if _forbidden(name)]
    assert bad == []


def test_imports_with_jax_unavailable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'p2p_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import p2p_tpu_torch, p2p_tpu_torch.cli, p2p_tpu_torch.kernels\n"
            "import p2p_tpu_torch.models.unet, p2p_tpu_torch.models.vae\n"
            "import p2p_tpu_torch.engine.sampler, p2p_tpu_torch.engine.inversion\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    from p2p_tpu_torch.controllers.factory import attention_replace
    from p2p_tpu_torch.engine import sampler
    from p2p_tpu_torch.models.config import TINY
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = HashWordTokenizer(model_max_length=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.random_pipeline(TINY, tok, None)
    pipe = sampler.random_pipeline(TINY, tok, "cpu")
    prompts = ["a cat", "a dog"]
    ctrl = attention_replace(prompts, 2, 0.8, 0.4, tok, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.text2image(pipe, prompts, ctrl, num_steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sampler.text2image(pipe, prompts, ctrl, num_steps=2, device="cuda")
    img, x_t, _ = sampler.text2image(pipe, prompts, ctrl, num_steps=2, device="cpu")
    assert img.shape == (2, 64, 64, 3) and img.device.type == "cpu"


def test_cli_rejects_unsupported_flags():
    from p2p_tpu_torch.cli import main

    base = ["edit", "--source", "a cat", "--target", "a dog", "--device", "cpu"]
    for extra in (["--batch-seeds"], ["--gate", "auto"], ["--schedule", "s.json"],
                  ["--attn-maps", "maps"], ["--checkpoint", "ckpt"]):
        with pytest.raises(SystemExit, match="not supported by p2p_tpu_torch"):
            main(base + extra)
    with pytest.raises(SystemExit):
        main(["generate", "--prompt", "x", "--scheduler", "plms"])


def test_cli_edit_on_cpu(tmp_path):
    from p2p_tpu_torch.cli import main

    assert main(["edit", "--preset", "tiny", "--device", "cpu", "--mode",
                 "replace", "--source", "a cat on a mat", "--target",
                 "a dog on a mat", "--steps", "2", "--kernels", "--quiet",
                 "--out-dir", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["08191_y.jpg",
                                                          "08191_y_hat.jpg"]
