"""dgpmp2_tpu_torch stands alone: it ships its own copies of the JAX
package's YAML configurations and native C++ source, held byte-equal to
the originals here (a change to one side shows), and no module of the port
(its examples included), nor ``chip_smoke.py``, nor a tool of the port
(``tools/bench_serve_torch.py``, ``profile_torch_plan.py``,
``time_kernels.py``, ``time_contract.py``) reads a file of ``dgpmp2_tpu/``
or of the repo-root ``csrc/``.  ``tools/make_torch_port_golden.py`` is left
out: it imports both packages by design, to write the JAX goldens the port
is held to.  Docstrings may name a counterpart, and a string naming a TPU
kernel as ``file.py:line`` (the kernels line's ``replaces``) is a name, not
a path that is read."""
import ast
import re
from pathlib import Path

import pytest

from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dgpmp2_tpu_torch"
CONFIGS = sorted(p.name for p in (ROOT / "dgpmp2_tpu" / "configs").glob(
    "*.yaml"))
TOOLS = ("bench_serve_torch.py", "profile_torch_plan.py", "time_kernels.py",
         "time_contract.py")
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + [ROOT / "tools" / name for name in TOOLS])


def test_the_port_ships_every_config_of_the_jax_package():
    assert len(CONFIGS) == 10
    assert config.CONFIG_DIR == PORT / "configs"
    assert sorted(p.name for p in config.CONFIG_DIR.glob("*.yaml")) == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_copy_is_byte_equal_to_the_original(name):
    assert ((config.CONFIG_DIR / name).read_bytes()
            == (ROOT / "dgpmp2_tpu" / "configs" / name).read_bytes())


def test_native_source_copy_is_byte_equal_and_the_one_built():
    assert native.SRC == PORT / "csrc" / "dgpmp2_native.cpp"
    assert native.SRC.read_bytes() == (
        ROOT / "csrc" / "dgpmp2_native.cpp").read_bytes()


def test_package_data_lists_the_copies():
    text = (ROOT / "pyproject.toml").read_text()
    line = next(x for x in text.splitlines()
                if x.startswith("dgpmp2_tpu_torch = "))
    for pattern in ("configs/*.yaml", "csrc/*.cpp", "csrc/*.cu",
                    "csrc/*.cuh"):
        assert f'"{pattern}"' in line


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                out.add(id(body[0].value))
    return out


_INTO_JAX = re.compile(r"(^|[^\w])dgpmp2_tpu/")
_NAMED_LINE = re.compile(r"dgpmp2_tpu/[\w/]+\.py:\d+")


def paths_out_of_the_port(src: str, path: Path) -> list:
    """Each place in the source ``src`` of the file at ``path`` that
    reaches a file of ``dgpmp2_tpu/`` or of the repo-root ``csrc/``: a
    string (not a docstring) naming such a path other than as
    ``file.py:line``, a ``/ "dgpmp2_tpu"`` or ``/ "csrc"`` join other than
    off the port's own directory, a call of ``os.path.join``, ``Path`` or
    ``PurePath`` with a ``"dgpmp2_tpu"`` argument or a ``"csrc"`` one other
    than right after the port's own directory, or ``parents[k]`` of
    ``__file__`` above the package."""
    tree = ast.parse(src)
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and _INTO_JAX.search(_NAMED_LINE.sub("", node.value))):
            found.append((node.lineno, node.value))
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)
                and isinstance(node.right, ast.Constant)
                and node.right.value in ("dgpmp2_tpu", "csrc")
                and not _port_dir(node.left)):
            found.append((node.lineno, ast.unparse(node)))
        if isinstance(node, ast.Call) and _joins_paths(node):
            args = node.args
            for i, a in enumerate(args):
                if not (isinstance(a, ast.Constant)
                        and a.value in ("dgpmp2_tpu", "csrc")):
                    continue
                if a.value == "csrc" and i == 1 and _port_dir(args[0]):
                    continue
                found.append((node.lineno, ast.unparse(node)))
                break
    if path.is_relative_to(PORT):
        for m in re.finditer(r"parents\[(\d+)\]", src):
            if not path.parents[int(m.group(1))].is_relative_to(PORT):
                found.append((src[:m.start()].count("\n") + 1, m.group(0)))
    return found


_JOINS = ("os.path.join", "path.join", "Path", "PurePath", "pathlib.Path",
          "pathlib.PurePath")


def _joins_paths(node: ast.Call) -> bool:
    """``node`` calls ``os.path.join``, ``Path`` or ``PurePath``."""
    return ast.unparse(node.func) in _JOINS


def _port_dir(node) -> bool:
    """``node`` names the port's directory: ``... / "dgpmp2_tpu_torch"``, a
    ``parents[k]`` (checked apart), or a name bound to one of them."""
    if isinstance(node, ast.BinOp):
        return (isinstance(node.right, ast.Constant)
                and node.right.value == "dgpmp2_tpu_torch")
    if isinstance(node, ast.Subscript):
        return ast.unparse(node.value).endswith("parents")
    return isinstance(node, ast.Name) and node.id in ("_PKG_DIR", "PKG_DIR")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_path_of_the_port_into_the_jax_tree_or_the_root_csrc(path):
    assert paths_out_of_the_port(path.read_text(), path) == []


@pytest.mark.parametrize("text,n", [
    ('C = ROOT / "dgpmp2_tpu" / "configs"\n', 1),
    ('S = Path(__file__).resolve().parents[2] / "csrc" / "x.cpp"\n', 1),
    ('F = open("dgpmp2_tpu/configs/robot_2d.yaml")\n', 1),
    ('S = ROOT / "csrc" / "dgpmp2_native.cpp"\n', 1),
    ('"""Reads dgpmp2_tpu/configs/*.yaml."""\n', 0),
    ('R = "dgpmp2_tpu/ops/pallas/btd_solve.py:111"\n', 0),
    ('S = Path(__file__).resolve().parents[1] / "csrc" / "x.cpp"\n', 0),
    ('C = ROOT / "dgpmp2_tpu_torch" / "configs"\n', 0),
    ('CFG = os.path.join(os.path.dirname(__file__), "..", "dgpmp2_tpu", '
     '"configs")\n', 1),
    ('C = Path(ROOT, "dgpmp2_tpu", "configs")\n', 1),
    ('S = os.path.join(ROOT, "csrc", "dgpmp2_native.cpp")\n', 1),
    ('S = os.path.join(PKG_DIR, "csrc", "dgpmp2_native.cpp")\n', 0),
])
def test_the_path_check_catches_each_way_into_the_jax_tree(text, n):
    """The check itself, on a module at ``dgpmp2_tpu_torch/native/``: each
    way back into the JAX tree or the root ``csrc/`` is caught, and a
    docstring, a ``file.py:line`` name or the port's own directory is
    not."""
    found = paths_out_of_the_port(text, PORT / "native" / "probe.py")
    assert len(found) == n, found
