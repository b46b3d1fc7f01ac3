"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's); the reference loads
nothing of the port; a run opens nothing of the JAX side's benchmarks or
scripts."""
import json
import subprocess
import sys
import textwrap

from portbench import run, spec

ROOT = spec.ROOT


def _child(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900, env={"PYTHONPATH": str(ROOT),
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    assert run.forbidden_modules(["dgpmp2_tpu_torch.core.gn", "numpy"]) == []
    assert run.forbidden_modules(["dgpmp2_tpu.core", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "dgpmp2_tpu", "flax", "jax", "jaxlib"]


def test_the_reference_loads_nothing_of_the_port():
    got = _child("""
        import json, sys
        import portbench.reference.compare, portbench.reference.gpmp2
        import portbench.reference.learned
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert "dgpmp2_tpu_torch" not in got
    assert not set(got) & set(run.FORBIDDEN)


def test_a_run_loads_no_jax_and_opens_nothing_of_the_jax_side():
    """Both cells end to end on the CPU, small, with every file the process
    opens recorded."""
    got = _child("""
        import json, os, sys
        opened = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                opened.append(os.path.abspath(os.fsdecode(args[0])))
        sys.addaudithook(hook)
        import torch
        from portbench import run, spec
        for name in ("point2d.b10240", "learned2d.b1024"):
            cell = spec.cell(name, bench=spec.with_pending())
            cell.traffic.update(batch=4, worlds=2, pairs_per_world=2)
            cell.settings.update(warmup_calls=1, check_problems=8,
                                 check_block=8)
            cell.config["optim_params"]["max_iters"] = 3
            run.execute(cell, 1, 0.0, False, torch.device("cpu"))
        print(json.dumps({"modules": sorted({m.split(".")[0]
                                             for m in sys.modules}),
                          "opened": opened}))
    """)
    assert "dgpmp2_tpu_torch" in got["modules"]
    assert not set(got["modules"]) & set(run.FORBIDDEN)
    banned = [ROOT / "benchmarks", ROOT / "bench.py", ROOT / "chip_smoke.py",
              ROOT / "tools", ROOT / "dgpmp2_tpu"]
    for path in got["opened"]:
        for b in banned:
            assert not (path == str(b) or path.startswith(str(b) + "/")), path


def test_no_source_of_the_harness_names_the_jax_side():
    names = ("import jax", "from jax", "dgpmp2_tpu.", "from dgpmp2_tpu ",
             "import dgpmp2_tpu\n", "chip_smoke", "benchmarks/", "bench.py")
    for path in spec.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for n in names:
            assert n not in text, (path, n)
