"""The port stands alone: no file of src/repro_torch/, chip_smoke.py or
tools/port_ab.py imports jax or the JAX package, and the port calls no
library attention.  The only place that may name
scaled_dot_product_attention is chip_smoke.py's timing phase, where it is
the yardstick the kernel is timed against."""
import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _port_files():
    out = []
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_port_has_modules():
    names = {os.path.relpath(p, PORT) for p in _port_files()}
    for want in ("core/fpdt.py", "kernels/flash_attention/kernel.py",
                 "models/serve.py", "launch/serve.py", "convert.py",
                 "core/chunked_loss.py", "optim/adamw.py", "data/pipeline.py",
                 "runtime/placement.py", "runtime/train_loop.py", "launch/train.py",
                 "kernels/build.py", "kernels/linear_scan/ref.py",
                 "kernels/linear_scan/kernel.py", "kernels/linear_scan/ops.py",
                 "models/mamba.py", "models/rglru.py", "configs/recurrentgemma_9b.py",
                 "configs/falcon_mamba_7b.py", "core/parallel.py", "launch/mesh.py",
                 "models/moe.py", "configs/granite_moe_1b_a400m.py"):
        assert want in names
    assert os.path.exists(SMOKE)
    for kernel, src in (("flash_attention", "flash_fwd.cu"), ("flash_attention", "flash_bwd.cu"),
                        ("linear_scan", "linear_scan.cu")):
        assert os.path.exists(os.path.join(PORT, "kernels", kernel, "csrc", src))


def test_no_jax_or_repro_imports():
    """The port, chip_smoke.py, the distributed tests' ranks
    (tests/_torch_dist.py, whose tasks run in spawned processes) and the
    port's timing script (tools/port_ab.py)."""
    bad = {}
    for path in _port_files() + [SMOKE, os.path.join(ROOT, "tests", "_torch_dist.py"),
                                 os.path.join(ROOT, "tools", "port_ab.py")]:
        hit = _imported_roots(path) & FORBIDDEN_ROOTS
        if hit:
            bad[os.path.relpath(path, ROOT)] = sorted(hit)
    assert not bad, f"port files import the JAX side: {bad}"


def test_no_library_attention_in_port():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            text = fh.read()
        for word in ("scaled_dot_product_attention", "flash_attn", "torch.compile", "cudnn"):
            if word in text:
                bad.append((os.path.relpath(path, ROOT), word))
    assert not bad, f"library attention named in the port: {bad}"


def test_smoke_names_sdpa_only_in_its_timing_phase():
    with open(SMOKE) as fh:
        tree = ast.parse(fh.read(), SMOKE)
    owners = []
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) and node.attr == "scaled_dot_product_attention":
                    owners.append(fn.name)
    top_level = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr == "scaled_dot_product_attention"]
    assert len(top_level) == len(owners), "scaled_dot_product_attention named outside a function"
    assert set(owners) <= {"phase_timing"}, owners
