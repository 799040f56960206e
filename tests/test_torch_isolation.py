"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and it never runs on the CPU unless asked to."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "optax", "gelslim_depth_tpu")


def test_port_runs_with_jax_blocked(tmp_path):
    script = textwrap.dedent(
        f"""
        import os
        import sys

        class Blocker:
            BLOCKED = {BLOCKED!r}
            def find_spec(self, name, path=None, target=None):
                # exact top-level match: gelslim_depth_tpu_torch must pass
                if name.split(".")[0] in self.BLOCKED:
                    raise ImportError(f"{{name}} blocked for this test")
        sys.meta_path.insert(0, Blocker())

        import numpy as np
        import torch
        from gelslim_depth_tpu_torch import GelslimConfig, Predictor
        from gelslim_depth_tpu_torch.inference import fused_predict_dual
        from gelslim_depth_tpu_torch.models import UNet

        cfg = GelslimConfig(CNN_dimensions=(4, 8), input_tactile_image_size=(8, 11),
                            depth_normalization_parameters=(-1.9, 0.0))
        sd = UNet(cfg.unet_config()).state_dict()
        pred = Predictor(cfg, sd, device="cpu")
        frames = np.full((2, 6, 16, 22), 127.0, np.float32)
        out = pred.predict_dual_frames(frames, frames[0], (16, 22))
        assert out.shape == (2, 2, 16, 22) and torch.isfinite(out).all()
        with torch.no_grad():  # the kernel route, through the kernel's CPU twin
            t = torch.from_numpy(frames)
            out_k = fused_predict_dual(cfg, pred.net, t, t[0], (16, 22), use_kernel=True)
        assert torch.allclose(out, out_k, atol=1e-5)
        out = pred.predict_depth_from_RGB(frames[:, :3], (16, 22))
        assert torch.isfinite(out).all()
        # int8 serving: quantize, serve, save and load back, on the CPU
        rng = np.random.RandomState(0)
        calib = rng.uniform(0, 255, (2, 6, 16, 22)).astype(np.float32)
        qpred = pred.quantize(calib, frames[0], quantize_upconvs=True)
        out = qpred.predict_dual_frames(calib, frames[0], (16, 22))
        assert out.shape == (2, 2, 16, 22) and torch.isfinite(out).all()
        assert qpred.delta_mm >= 0 and qpred.q.has_int8_upconvs
        from gelslim_depth_tpu_torch.inference import QuantizedPredictor
        qpred.save("q")
        again = QuantizedPredictor.from_checkpoint("q", device="cpu", compute_dtype=torch.float32)
        assert torch.equal(again.predict_dual_frames(calib, frames[0], (16, 22)), out)
        # training: bake a synthetic set, fit an epoch, resume for a second
        from gelslim_depth_tpu_torch import Trainer, bake_dataset
        from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
        objs = [make_synthetic_object(rng, n=3, image_size=(16, 22)) for _ in range(2)]
        ds = bake_dataset(preloaded=objs, device="cpu", use_difference_image=True, depth_image_blur_kernel=3,
                          image_normalization_method="0_255_to_0_1", norm_scale=0.9)
        tcfg = GelslimConfig(CNN_dimensions=(4, 8), batch_size=4, weights_name="t")
        tr = Trainer(tcfg, ds, ds, ds, output_dir="run", device="cpu", log_fn=lambda m: None)
        hist = tr.fit(max_epochs=1)
        tr.save_resume_state()
        tr2 = Trainer(tcfg, ds, ds, ds, output_dir="run", device="cpu", log_fn=lambda m: None)
        tr2.load_resume_state()
        hist2 = tr2.fit(max_epochs=2)
        assert hist2["train_loss"][0] == hist["train_loss"][0] and len(hist2["train_loss"]) == 2
        served = Predictor.from_checkpoint("run/weights", device="cpu")
        assert torch.isfinite(served.predict_dual_frames(calib, frames[0], (16, 22))).all()
        # the serving surface: the engine, export, entry and the CLI
        from gelslim_depth_tpu_torch import StreamingEngine, cli
        from gelslim_depth_tpu_torch.entry import entry, flagship_config
        from gelslim_depth_tpu_torch.export import ExportedPredictor, export_predictor
        eng = StreamingEngine(qpred, (16, 22), base_frame=frames[0])
        for f in calib:
            eng.submit(f)
        assert [o.shape for o in eng.drain()] == [(1, 2, 16, 22)] * 2
        export_predictor(qpred, (16, 22), path="q.gsx", batch_sizes=(2,), frame_size=(16, 22))
        assert torch.equal(ExportedPredictor.load("q.gsx")(calib, frames[0]), out)
        assert flagship_config().CNN_dimensions == (64, 128, 256, 512, 1024) and callable(entry)
        # meshgen and the data-prep and train commands
        from gelslim_depth_tpu_torch.cli import generate_depth_cmd, split_cmd, train_cmd, view_cmd
        from gelslim_depth_tpu_torch.data.synthetic import make_mesh_contact_object
        from gelslim_depth_tpu_torch.meshgen import fixtures, native_render, plane_spec, render_depth_batch
        from gelslim_depth_tpu_torch.meshgen import sample_surface_points
        tri = fixtures.heightfield_plate_triangles(fixtures.ridged_height_fn(), grid=(12, 15))
        pts = sample_surface_points(tri, 2000, seed=0)
        depth = render_depth_batch(pts, np.zeros((2, 3), np.float32), np.full(2, 12.0, np.float32),
                                   spec=plane_spec("+y+z"), image_size=(16, 22), mm_per_pixel=1.0, device="cpu")
        assert depth.shape == (2, 2, 16, 22) and depth.min() < 0
        # data parallelism: a one-rank gloo group through a file store, a
        # DP train step, DP serving and the DP renderer on its mesh
        import datetime
        from gelslim_depth_tpu_torch import parallel
        from gelslim_depth_tpu_torch.models.unet import split_state_dict
        from gelslim_depth_tpu_torch.train import create_train_state, make_optimizer
        parallel.initialize("file://" + os.path.abspath("store"), 1, 0, backend="gloo",
                            timeout=datetime.timedelta(seconds=60))
        mesh = parallel.make_mesh(1, device="cpu", backend="gloo")
        p, s = split_state_dict(sd)
        opt = make_optimizer()
        state = parallel.replicate(mesh, create_train_state(cfg.unet_config(), opt, params=p, batch_stats=s))
        x = torch.rand(2, 3, 8, 11)
        state, loss = parallel.make_dp_train_step(cfg.unet_config(), opt, mesh)(state, x, torch.zeros(2, 1, 8, 11))
        assert torch.isfinite(loss)
        dp = parallel.make_dp_fused_predictor(cfg, cfg.unet_config(), mesh, (16, 22))
        out = dp(state.params, state.batch_stats, parallel.shard_batch(mesh, frames), torch.from_numpy(frames[0]))
        assert parallel.gather_rows(mesh, out).shape == (2, 2, 16, 22)
        render = parallel.make_dp_renderer(mesh, spec=plane_spec("+y+z"), image_size=(16, 22), mm_per_pixel=1.0)
        assert render(pts, np.zeros((2, 3), np.float32), np.full(2, 12.0, np.float32)).shape == (2, 2, 16, 22)
        # height-sharded serving on the one rank, a jax.image.resize method, an NHWC step
        sp = parallel.make_spatial_predictor(cfg, cfg.unet_config(), mesh, (16, 22))
        band, base_band = parallel.shard_height(mesh, sp.plan, frames, frames[0])
        got = parallel.gather_height(mesh, sp(state.params, state.batch_stats, band, base_band))
        assert got.shape == (2, 2, 16, 22) and torch.isfinite(got).all() and sp.halo.exchanges == 6
        from gelslim_depth_tpu_torch import ops
        assert ops.resize(torch.rand(1, 3, 16, 22), (8, 11), "bilinear").shape == (1, 3, 8, 11)
        from gelslim_depth_tpu_torch.train import make_train_step
        step = make_train_step(cfg.unet_config(), opt, channels_last=True)
        state, loss = step(state, x.permute(0, 2, 3, 1), torch.zeros(2, 8, 11, 1))
        assert torch.isfinite(loss)
        torch.distributed.destroy_process_group()
        import runpy
        sys.argv = ["gelslim_depth_tpu_torch", "--help"]
        try:
            runpy.run_module("gelslim_depth_tpu_torch", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not any(m.split(".")[0] in Blocker.BLOCKED for m in sys.modules)
        print("NO-JAX-OK")
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, cwd=str(tmp_path),
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": REPO},
        timeout=300,
    )
    assert "NO-JAX-OK" in r.stdout, f"stdout: {r.stdout[-2000:]}\nstderr: {r.stderr[-3000:]}"


def _port_sources():
    pkg = os.path.join(REPO, "gelslim_depth_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    yield from (os.path.join(scripts, f) for f in sorted(os.listdir(scripts)) if f.endswith("_torch.py"))


def test_no_jax_import_in_port_sources():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(path, n) for n in names if n.split(".")[0] in BLOCKED]
    assert not offenders, offenders


def test_no_quiet_cpu_fallback(monkeypatch, tmp_path):
    from gelslim_depth_tpu_torch import GelslimConfig, Predictor
    from gelslim_depth_tpu_torch.models import UNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GelslimConfig(CNN_dimensions=(4, 8), input_tactile_image_size=(8, 11),
                        depth_normalization_parameters=(-1.9, 0.0))
    sd = UNet(cfg.unet_config()).state_dict()
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(cfg, sd, **kw)
    assert Predictor(cfg, sd, device="cpu").device.type == "cpu"

    from gelslim_depth_tpu_torch import Trainer, bake_dataset
    from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object

    objs = [make_synthetic_object(np.random.RandomState(0), n=2, image_size=(16, 22))]
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bake_dataset(preloaded=objs, norm_scale=0.9, **kw)
    ds = bake_dataset(preloaded=objs, norm_scale=0.9, device="cpu")
    assert ds.tactile_image.device.type == "cpu"
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, ds, ds, ds, output_dir=str(tmp_path / "t"), **kw)
    tr = Trainer(cfg, ds, ds, ds, output_dir=str(tmp_path / "t"), device="cpu", log_fn=lambda m: None)
    assert all(v.device.type == "cpu" for v in tr.state.tensors().values())


# command modules under ops/ that drive the kernels through the models;
# nothing in the library imports them
OPS_ENTRY_POINTS = ("kernels/tune_conv_int8.py", "kernels/tune_preprocess.py")


def test_ops_imports_no_higher_layer():
    """The library modules under ``ops/`` import nothing of the layers
    built on them (models, inference, train, parallel), at the top or
    inside a function; read from their source, not imported."""
    root = os.path.join(REPO, "gelslim_depth_tpu_torch", "ops")
    higher = {("gelslim_depth_tpu_torch", layer) for layer in ("models", "inference", "train", "parallel")}
    found, scanned = [], []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, root)
        if rel in OPS_ENTRY_POINTS:
            continue
        scanned.append(rel)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            found += [(rel, n) for n in names if tuple(n.split(".")[:2]) in higher]
    assert all(os.path.exists(os.path.join(root, e)) for e in OPS_ENTRY_POINTS)
    assert {"activation.py", "kernels/conv_epilogue.py", "kernels/conv_int8.py"} <= set(scanned)
    assert found == []
