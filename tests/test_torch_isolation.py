"""The port stands alone: no file of crdr_tpu_torch/ nor chip_smoke.py imports
JAX, flax, the JAX package, cv2 or PIL (absent where the port runs; the
port reads PNG, JPEG and BMP itself), importing the port leaves them
unloaded, and the PNG decoder builds from standard C++ headers alone."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "crdr_tpu", "PIL", "cv2")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "crdr_tpu_torch")):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_imports(path):
    """Nor cv2 / PIL (FORBIDDEN)."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_png_decoder_needs_only_standard_headers():
    """``runtime/csrc/png.cpp`` includes only standard C++ headers (no
    libpng's ``png.h``, no ``zlib.h``: Python's zlib inflates), so the
    card's machine builds it from the repository's sources alone."""
    std = {"algorithm", "cstdint", "cstdio", "cstdlib", "cstring",
           "stdexcept", "string", "vector"}
    with open(os.path.join(ROOT, "crdr_tpu_torch", "runtime", "csrc",
                           "png.cpp")) as f:
        includes = [line.split()[1].strip("<>\"") for line in f
                    if line.startswith("#include")]
    assert includes and set(includes) <= std, includes


@pytest.mark.parametrize("source", ["webp.cpp", "lzw.cpp"])
def test_body_decoders_need_only_standard_headers(source):
    """The WebP and LZW decoders (``runtime/csrc/``) include only standard
    C++ headers (no libwebp, no libtiff, no PIL), so the card's machine
    builds them from the repository's sources alone."""
    std = {"algorithm", "cstdint", "cstdio", "cstdlib", "cstring",
           "stdexcept", "string", "vector"}
    with open(os.path.join(ROOT, "crdr_tpu_torch", "runtime", "csrc",
                           source)) as f:
        includes = [line.split()[1].strip("<>\"") for line in f
                    if line.startswith("#include")]
    assert includes and set(includes) <= std, includes


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import crdr_tpu_torch.models, crdr_tpu_torch.importers.jax_params\n"
        "import crdr_tpu_torch.ops.charm_uniform, crdr_tpu_torch.runtime\n"
        "import crdr_tpu_torch.ops.lane_decode, crdr_tpu_torch.runtime.lane_rans\n"
        "import crdr_tpu_torch.trainer, crdr_tpu_torch.cli.train\n"
        "import crdr_tpu_torch.serving, crdr_tpu_torch.serving.http_server\n"
        "import crdr_tpu_torch.cli.serve, crdr_tpu_torch.cli.serve_smoke\n"
        "import crdr_tpu_torch.runtime.cache, crdr_tpu_torch.data\n"
        "import crdr_tpu_torch.utils.jpeg, crdr_tpu_torch.utils.img_utils\n"
        "import crdr_tpu_torch.utils.png, crdr_tpu_torch.utils.bmp\n"
        "import crdr_tpu_torch.utils.webp, crdr_tpu_torch.utils.gif\n"
        "import crdr_tpu_torch.utils.pnm, crdr_tpu_torch.utils.tiff\n"
        "import crdr_tpu_torch.cli.compress, crdr_tpu_torch.cli.calc_metrics\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
