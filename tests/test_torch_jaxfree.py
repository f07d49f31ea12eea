"""The PyTorch port imports neither JAX nor the JAX package.

A subprocess imports the port's main path with ``jax`` and
``simplellminference_tpu`` blocked in ``sys.modules``; an AST scan checks
that no port file (nor chip_smoke.py) names either in an import.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "simplellminference_tpu_torch"
BLOCKED = ("jax", "jaxlib", "simplellminference_tpu")

_PROBE = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None          # any import of these now fails
import simplellminference_tpu_torch
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models import convert, llama, mla
from simplellminference_tpu_torch.ops import cuda_build, sampling
from simplellminference_tpu_torch.ops import ffn_fused, linear, matmul
from simplellminference_tpu_torch.ops import qkv_fused, ref_ops
from simplellminference_tpu_torch.runtime import hf_quant, weights
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention import paged_prefill
from simplellminference_tpu_torch.memory import allocator, paged_kv
from simplellminference_tpu_torch.tokenizer import StreamingDetokenizer
from simplellminference_tpu_torch.tokenizer import ByteTokenizer
from simplellminference_tpu_torch.ops import kv_append
from simplellminference_tpu_torch.ops.attention import flash_decode
from simplellminference_tpu_torch.runtime import generator, kv_cache
from simplellminference_tpu_torch.cli import generate
import chip_smoke
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m.split(".")[0] in ("jax", "jaxlib")
       or m == "simplellminference_tpu"
       or m.startswith("simplellminference_tpu."))]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_file(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in BLOCKED, f"{path.name} imports {mod}"
