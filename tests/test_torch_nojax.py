"""The port stands alone: no module of palu_tpu_torch (nor chip_smoke)
imports jax, palu_tpu or the JAX tools under tools/, and asking for CUDA
where there is none raises."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "palu_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_imports_without_jax_or_reference_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['palu_tpu'] = None\n"
        "import importlib\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'palu_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_probe_entry_points_are_scanned():
    """The probes subpackage (palu_tpu_torch/tools) and the archived decodes
    (palu_tpu_torch/ops/archive) are among the modules both tests above
    import and scan."""
    mods = _port_modules()
    for name in ("dissect", "stream_probe", "unpack_probe", "gemv_probe", "ab_v2",
                 "mlp_a8_probe"):
        assert f"palu_tpu_torch.tools.{name}" in mods
    for name in ("", ".palu_decode2", ".palu_decode3"):
        assert f"palu_tpu_torch.ops.archive{name}" in mods


def test_parallel_package_is_scanned():
    """The mesh and multi-host modules (palu_tpu_torch/parallel) are among
    the modules the import test loads without JAX and the source scan
    reads."""
    mods = _port_modules()
    for name in ("", ".mesh", ".multihost"):
        assert f"palu_tpu_torch.parallel{name}" in mods


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "palu_tpu", "tools"), \
                    f"{path}: imports {name}"


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from palu_tpu_torch.core.quant import QuantConfig
    from palu_tpu_torch.models.config import ModelConfig
    from palu_tpu_torch.ops.build import require_cuda
    from palu_tpu_torch.runtime.cache import init_cache
    from palu_tpu_torch.runtime.engine import Engine, EngineConfig
    from palu_tpu_torch.runtime.serving import ServingEngine

    ranks = {f"model.layers.0.self_attn.{w}_proj": [8, 8] for w in "kv"}
    cfg = ModelConfig(vocab_size=32, hidden_size=64, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=4,
                      head_group_size=2, head_wise_ranks=ranks)
    qcfg = QuantConfig(bits=3, sym=True, container=4)
    with pytest.raises(RuntimeError):
        require_cuda("cuda")
    with pytest.raises(RuntimeError):
        init_cache(cfg, 1, 16, qcfg)  # default device is cuda
    with pytest.raises(RuntimeError):
        Engine({"layers": []}, cfg, EngineConfig(qcfg=qcfg))
    with pytest.raises(RuntimeError):
        init_cache(cfg, 1, 16, None)  # the unquantized cache too
    with pytest.raises(RuntimeError):
        ServingEngine({"layers": []}, cfg, EngineConfig())


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
