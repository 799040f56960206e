"""scripts/make_demo_assets_torch.py, which imports only the port, makes
the JAX script's demo workspace (scripts/make_demo_assets.py): the same
files, the STL and text files byte for byte, each ``.pt`` loading to the
same arrays bit for bit. The port's script runs with JAX blocked."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from gelslim_depth_tpu_torch.data.pt_io import load_pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "optax", "gelslim_depth_tpu")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def test_port_demo_workspace_equals_jax(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_demo_assets.py"), str(jax_dir)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    script = textwrap.dedent(
        f"""
        import runpy
        import sys

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError(f"{{name}} blocked for this test")
        sys.meta_path.insert(0, Blocker())
        sys.argv = ["make_demo_assets_torch.py", {str(port_dir)!r}]
        runpy.run_path({os.path.join(REPO, "scripts", "make_demo_assets_torch.py")!r}, run_name="__main__")
        assert not any(m.split(".")[0] in {BLOCKED!r} for m in sys.modules)
        """
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]

    files = _tree(jax_dir)
    assert files == _tree(port_dir)
    assert {os.path.splitext(f)[1] for f in files} == {".stl", ".txt", ".pt"} and len(files) == 8
    for name in files:
        got, want = port_dir / name, jax_dir / name
        if name.endswith(".pt"):
            g, w = load_pt(str(got)), load_pt(str(want))
            assert set(g) == set(w), name
            for k in w:
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), (name, k)
            assert np.all(g["tactile_image"].numpy() >= 0)
        else:
            assert got.read_bytes() == want.read_bytes(), name
