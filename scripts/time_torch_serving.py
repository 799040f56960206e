"""Host time of one flagship serving call at N=1 dual frame, bfloat16 and
int8, through the ``gelslim_depth_tpu_torch`` package of a given source
tree: ``Predictor.predict_dual_frames`` and the quantized predictor's, each
ending in a synchronize; and the ``StreamingEngine`` at micro-batch 1 on
both. For comparing two trees on one card (the PyTorch port's per-call
host overhead), run it once per tree, in turns:

    python3 scripts/time_torch_serving.py _archive/parent   # parent
    python3 scripts/time_torch_serving.py .                 # change
    python3 scripts/time_torch_serving.py .                 # change
    python3 scripts/time_torch_serving.py _archive/parent   # parent

Prints one JSON line: the tree, the card and its power limit, per path
the median call ms of each round (20 calls after 3 warm-up calls), the
engine's dual frames/s at micro-batch 1 and two dispatch slots (256 host
frames submitted back to back, then drained; 3 rounds), and the host µs a
launch of each kernel's wrapper takes at a small shape (500 launches a
round, none waited for: the per-launch host overhead), where the tree has
the kernel. Needs a CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from gelslim_depth_tpu_torch import GelslimConfig, Predictor, StreamingEngine
    from gelslim_depth_tpu_torch.models.unet import init_unet

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = GelslimConfig(
        CNN_dimensions=(64, 128, 256, 512, 1024), input_tactile_image_size=(160, 213),
        image_normalization_method="0_255_to_0_1", depth_normalization_method="min_max_to_0_-1",
        depth_normalization_parameters=(-1.9180814027786255, 0.0), norm_scale=0.9, use_difference_image=True,
    )
    params, stats = init_unet(cfg.unet_config(), torch.Generator().manual_seed(0))
    pred16 = Predictor(cfg, {**params, **stats}, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.uniform(0, 255, (4, 6, 320, 427)).astype(np.float32)).cuda()
    base = torch.from_numpy(rng.uniform(0, 255, (6, 320, 427)).astype(np.float32)).cuda()
    qpred = pred16.quantize(frames, base)

    def call_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def enqueue_us(fn, calls=500):
        """Host µs a call of fn, which launches work without waiting for it;
        the work is small, so the launch queue never fills."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * host / calls

    from gelslim_depth_tpu_torch.ops.kernels import Epilogue, conv2d_int8, fused_preprocess_dual

    g = torch.Generator(device="cuda").manual_seed(0)
    qx = torch.randint(-127, 128, (1, 8, 8, 64), generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 3, 3, 64), generator=g, device="cuda", dtype=torch.int8)
    vec = torch.rand(64, generator=g, device="cuda")
    ep = Epilogue(bn_mul=vec, bn_add=vec, act="relu", out_dtype=torch.bfloat16,
                  q_scales=(torch.full((1,), 0.05, device="cuda"),), store_float=False)
    small = frames[:1, :, :16, :22].contiguous(), base[:, :16, :22].contiguous()

    def engine_fps(pred):
        host = [f.cpu().numpy() for f in frames]
        eng = StreamingEngine(pred, (320, 427), base_frame=base, max_inflight=256, drop_policy="block",
                              microbatch=1, max_dispatches=2)
        torch.cuda.synchronize()
        for i in range(256):
            eng.submit(host[i % len(host)])
        eng.drain()
        return eng.stats()["throughput_fps"]

    out = {"tree": tree, "card": card, "torch": torch.__version__}
    with torch.inference_mode():
        for tag, pred in (("bf16_N1", pred16), ("int8_N1", qpred)):
            out[tag] = [call_ms(lambda: pred.predict_dual_frames(frames[:1], base, (320, 427))) for _ in range(5)]
    for tag, pred in (("bf16_engine_mb1_fps", pred16), ("int8_engine_mb1_fps", qpred)):
        engine_fps(pred)  # warm-up
        out[tag] = [engine_fps(pred) for _ in range(3)]
    with torch.inference_mode():
        out["conv2d_int8_enqueue_us"] = [
            enqueue_us(lambda: conv2d_int8(qx, w, pad=1, scale=vec, epilogue=ep)) for _ in range(5)]
        out["fused_preprocess_dual_enqueue_us"] = [
            enqueue_us(lambda: fused_preprocess_dual(*small, [1 / 255.0] * 3, [0.0] * 3, out_size=(8, 11)))
            for _ in range(5)]
        try:
            from gelslim_depth_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue
        except ImportError:  # a tree without the kernel
            conv_epilogue = None
        if conv_epilogue is not None:
            y = torch.randn((1, 64, 8, 8), generator=g, device="cuda").to(torch.bfloat16)
            out["conv_epilogue_enqueue_us"] = [
                enqueue_us(lambda: conv_epilogue(y, bn_mul=vec, bn_add=vec, act="relu")) for _ in range(5)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
