"""The depth a tree's program serves in each benchmark cell, hashed: every
pool input of the cell, made from a seed as ``benchmark/run.py`` makes it,
served by the ``gelslim_depth_tpu_torch`` package of the given tree, one
sha256 of the depth bytes a cell and seed. Two trees whose hashes agree
serve the same depth bit for bit. Run it once per tree on one card:

    python3 scripts/served_depth_hash.py _archive/parent 2718281828 1618033988
    python3 scripts/served_depth_hash.py . 2718281828 1618033988

Prints one line a cell and seed: ``depth <cell> seed=<n> sha256=<hex>``,
or ``depth <cell> absent`` where the tree's ``BENCHMARK.json`` has no such
cell. The tree's own ``benchmark/`` makes the inputs: the U-Net cells' as
``benchmark/serving.py::serving_inputs`` does, the transformer cell's
(``dpt_vitl14_batch64``) as ``benchmark/loops/closed_dpt.py::run`` does,
the video cell's (``vda_vitl14_clip64``) as
``benchmark/loops/closed_vda.py::call_inputs`` does, Depth Pro's
(``depth_pro_batch8``) as ``benchmark/loops/closed_depth_pro.py::call_inputs``
does. Needs a CUDA device.
"""

import hashlib
import os
import sys

CELLS = ("int8_batch64", "bf16_batch64", "dpt_vitl14_batch64", "vda_vitl14_clip64", "depth_pro_batch8")


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    seeds = [int(s) for s in sys.argv[2:]] or [2718281828]
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    from benchmark import harness, inputs, serving
    from benchmark.loops import closed_dpt

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def dpt_inputs(cell, seed, device):
        n, pool = cell.traffic["dual_frames_per_call"], cell.traffic["pool"]
        frames, base, _ = inputs.session(inputs.generator(device, seed, inputs.FRAMES), n * pool,
                                         tuple(cell.config["frame_size"]), device)
        sd = closed_dpt.weights(cell.config, inputs.generator(device, seed, inputs.WEIGHTS), device)
        return [frames[i * n:(i + 1) * n].clone() for i in range(pool)], base, None, sd

    def vda_inputs(cell, seed, device):
        from benchmark.loops import closed_vda

        pool_inputs, base, sd = closed_vda.call_inputs(cell, seed, device)
        return pool_inputs, base, None, sd

    def depth_pro_inputs(cell, seed, device):
        from benchmark.loops import closed_depth_pro

        pool_inputs, base, sd = closed_depth_pro.call_inputs(cell, seed, device)
        return pool_inputs, base, None, sd

    makers = {"closed_dpt": dpt_inputs, "closed_vda": vda_inputs, "closed_depth_pro": depth_pro_inputs}
    for name in CELLS:
        try:
            cell = harness.find_cell(name)
        except KeyError:
            print(f"depth {name} absent", flush=True)
            continue
        for seed in seeds:
            make = makers.get(cell.traffic["loop"], serving.serving_inputs)
            pool_inputs, base, calib, sd = make(cell, seed, dev)
            pred = serving.serving_system(cell, sd, calib, base, dev)
            frame = tuple(cell.config["frame_size"])
            h = hashlib.sha256()
            with torch.inference_mode():
                for x in pool_inputs:
                    h.update(pred.predict_dual_frames(x, base, frame).cpu().numpy().tobytes())
            print(f"depth {name} seed={seed} sha256={h.hexdigest()}", flush=True)


if __name__ == "__main__":
    main()
