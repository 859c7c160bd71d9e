"""PyTorch port: rules that keep the port apart from the JAX package and keep
it from quietly leaving the card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from xlstm_hved_torch.config import MODEL_ALIASES, MODEL_ZOO, get_config
from xlstm_hved_torch.models import find_model_using_name, resolve_device
from xlstm_hved_torch.ops import gate_cuda

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xlstm_hved_tpu")


# scripts/torch_control_*.py predate the port: the JAX package's controls
# against the upstream PyTorch code, which import the JAX package
PRE_PORT_SCRIPTS = ("torch_control_et.py", "torch_control_recon.py")


def _port_sources():
    files = sorted((REPO / "xlstm_hved_torch").rglob("*.py"))
    scripts = sorted(p for p in (REPO / "scripts").glob("torch_*.py")
                     if p.name not in PRE_PORT_SCRIPTS)
    # tests/_torch_chain.py: chip_smoke.py's phase 15 runs it on the card
    return files + [REPO / "chip_smoke.py", REPO / "scripts" / "mlstm_kernel_timing.py",
                    REPO / "tests" / "_torch_chain.py"] + scripts


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_port_imports_without_jax_installed():
    """Import every port module in a fresh interpreter where jax/flax, the
    JAX package and h5py (absent on the card machine; the HDF5 datasets
    import it when one is opened) cannot be imported."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / "xlstm_hved_torch").rglob("*.py"))
    block = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN + ("h5py",))
    code = f"import sys; {block}; " + "; ".join(f"import {m}" for m in modules)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=300)


def test_config_copy_matches_the_zoo():
    assert "XLSTM_HVED" in MODEL_ZOO and get_config("RA_HVED") == MODEL_ZOO["XLSTM_HVED"]
    cfg = get_config("XLSTM_HVED")
    assert (cfg.skip_return, cfg.mid_vil, cfg.seg_recon_decoder) == (True, True, True)
    assert cfg.dec_f_maps == (4, 8, 16, 32) and cfg.mvae_latents == (1, 2, 4, 8)
    assert all(MODEL_ALIASES[a] in MODEL_ZOO for a in MODEL_ALIASES)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        find_model_using_name("XLSTM_HVED")  # the default device is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    # the gate kernel's wrapper takes CUDA tensors only; the CPU twin is
    # gate_conv's, chosen by the device
    x, w, b = torch.rand(1, 4, 8, 8, 8), torch.rand(1, 4, 7, 7, 7), torch.rand(1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gate_cuda.run_gate_kernel(x, w, b)
