"""Command-line layer of the PyTorch port, one dispatcher over the
reference's five entry points and the serving additions:

    python -m gelslim_depth_tpu_torch train <weights_name> [gpu] [flags...]
    python -m gelslim_depth_tpu_torch test <weights_name> [gpu] <sub_dir> [objects...]
    python -m gelslim_depth_tpu_torch split-data [gpu] [flags...]
    python -m gelslim_depth_tpu_torch generate-depth [gpu] [flags...]
    python -m gelslim_depth_tpu_torch view <sub_dir> <data_name> [flags...]
    python -m gelslim_depth_tpu_torch quantize <weights_name> [gpu] [flags...]  # int8 PTQ
    python -m gelslim_depth_tpu_torch export <weights_name> [gpu] [flags...]    # .gsx artifact

The positional ``gpu`` argument keeps the reference commands' meaning
(ref train_unet.py:58): 'cpu' runs on the CPU, an ordinal n on cuda:n, and
without it the command runs on cuda. split-data and view run on the host.
"""

import importlib
import os
import re
import sys

# command -> its module under gelslim_depth_tpu_torch.cli
COMMANDS = {
    "train": "train_cmd", "test": "test_cmd", "split-data": "split_cmd",
    "generate-depth": "generate_depth_cmd", "view": "view_cmd",
    "quantize": "quantize_cmd", "export": "export_cmd",
}


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
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        return 2
    module = importlib.import_module(f"gelslim_depth_tpu_torch.cli.{COMMANDS[cmd]}")
    return module.run(rest) or 0
