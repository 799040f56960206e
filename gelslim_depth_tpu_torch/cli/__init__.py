"""Command-line layer of the PyTorch port, one dispatcher over the
reference's entry points and the serving additions:

    python -m gelslim_depth_tpu_torch quantize <weights_name> [gpu] [flags...]  # int8 PTQ
    python -m gelslim_depth_tpu_torch export <weights_name> [gpu] [flags...]    # .gsx artifact
    python -m gelslim_depth_tpu_torch test <weights_name> [gpu] <sub_dir> [objects...]

Not ported yet (the JAX package's ``python -m gelslim_depth_tpu`` runs them):
train, split-data, generate-depth, view.

The positional ``gpu`` argument keeps the reference commands' meaning
(ref train_unet.py:58): 'cpu' runs on the CPU, an ordinal n on cuda:n, and
without it the command runs on cuda.
"""

import os
import re
import sys

COMMANDS = ("quantize", "export", "test")
NOT_PORTED = ("train", "split-data", "generate-depth", "view")


def _version() -> str:
    from importlib.metadata import PackageNotFoundError, version

    try:
        return version("gelslim-depth-tpu")
    except PackageNotFoundError:  # a source tree: read pyproject.toml
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        try:
            with open(os.path.join(root, "pyproject.toml")) as f:
                m = re.search(r'^version\s*=\s*"([^"]+)"', f.read(), re.M)
        except OSError:
            m = None
        return f"{m.group(1)}+source" if m else "0.0.0+source"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] in ("--version", "-V"):
        print(_version())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "quantize":
        from gelslim_depth_tpu_torch.cli.quantize_cmd import run
    elif cmd == "export":
        from gelslim_depth_tpu_torch.cli.export_cmd import run
    elif cmd == "test":
        from gelslim_depth_tpu_torch.cli.test_cmd import run
    elif cmd in NOT_PORTED:
        print(f"command {cmd!r} is not ported to the PyTorch package yet; "
              f"python -m gelslim_depth_tpu {cmd} runs it", file=sys.stderr)
        return 2
    else:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        return 2
    return run(rest) or 0
