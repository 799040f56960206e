"""Which device kernels each cuDNN conv of the flagship U-Net's bf16 eval
forward launches, and what ``inc/conv1`` costs with its 3-channel input
padded to 4 and 8 channels by the caller (the weight zero-padded alike).

    python3 scripts/probe_bf16_convs_torch.py [n_images]

``n_images`` finger images a forward (default 128: 64 dual frames, the
``bf16_batch64`` cell's call). Every conv and transposed conv of one
forward is caught with its exact inputs (channels-last, as the bf16
forward lays them out), then replayed alone: its CUDA-event time a call
over 20 calls and, from a ``torch.profiler`` trace of 3 calls, each device
kernel's launches and microseconds a call. Then ``inc/conv1`` at 3, 4 and
8 input channels, with its largest difference from the 3-channel conv,
and the input's cast with and without the channel pad. Prints the card
and its power limit first. Needs a CUDA device; imports nothing of JAX.
"""

import collections
import os
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gelslim_depth_tpu_torch import GelslimConfig  # noqa: E402
from gelslim_depth_tpu_torch.models import UNet  # noqa: E402


def kernels(fn, reps=3):
    """{kernel name: (launches a call, device us a call)} from a trace."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    count, us = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            count[e.name[:110]] += 1
            us[e.name[:110]] += e.device_time_total
    return {k: (count[k] / reps, us[k] / reps) for k in count}


def event_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def show(fn):
    for k, (n, t) in kernels(fn).items():
        print(f"    {n:.1f} x {t:9.1f} us  {k}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_bf16_convs_torch: needs a CUDA device")
    n_images = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    cfg = GelslimConfig()
    net = UNet(cfg.unet_config()).to(dev).to_compute_dtype(torch.bfloat16)
    x = torch.rand(n_images, 3, *cfg.input_tactile_image_size, device=dev)
    calls = []
    orig = {n: getattr(F, n) for n in ("conv2d", "conv_transpose2d")}

    def spy(name):
        def f(inp, w, *a, **kw):
            calls.append((name, inp, w, a, kw))
            return orig[name](inp, w, *a, **kw)
        return f

    with torch.no_grad():
        net(x)
        F.conv2d, F.conv_transpose2d = spy("conv2d"), spy("conv_transpose2d")
        try:
            net(x)
        finally:
            F.conv2d, F.conv_transpose2d = orig["conv2d"], orig["conv_transpose2d"]
        torch.cuda.synchronize()

        for i, (name, inp, w, a, kw) in enumerate(calls):
            fn = lambda: orig[name](inp, w, *a, **kw)  # noqa: E731
            layout = "channels_last" if inp.is_contiguous(memory_format=torch.channels_last) else "nchw"
            print(f"{i} {name} {tuple(inp.shape)} {tuple(w.shape)} {layout}: {event_ms(fn):.4f} ms", flush=True)
            show(fn)

        name, inp, w, a, kw = calls[0]  # inc/conv1
        ref = F.conv2d(inp, w, padding=1)
        for c in (3, 4, 8):
            xi = torch.zeros(inp.shape[0], c, *inp.shape[2:], device=dev, dtype=inp.dtype)
            xi[:, :3] = inp
            xi = xi.contiguous(memory_format=torch.channels_last)
            wi = torch.zeros(w.shape[0], c, *w.shape[2:], device=dev, dtype=w.dtype)
            wi[:, :3] = w
            wi = wi.contiguous(memory_format=torch.channels_last)
            fn = lambda: F.conv2d(xi, wi, padding=1)  # noqa: E731
            diff = (fn() - ref).abs().max().item()
            print(f"inc/conv1 C={c}: {event_ms(fn):.4f} ms, max |diff| vs C=3 {diff}", flush=True)
            show(fn)
        cast = lambda: x.to(torch.bfloat16, memory_format=torch.channels_last)  # noqa: E731
        print(f"cast C=3: {event_ms(cast):.4f} ms", flush=True)
        print(f"cast+pad C=8: {event_ms(lambda: F.pad(cast(), (0, 0, 0, 0, 0, 5))):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
