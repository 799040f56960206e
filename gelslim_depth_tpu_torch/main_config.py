"""Global data-path config (the reference's one-constant module,
ref gelslim_depth/main_config.py:1), resolved from the environment instead
of an edit-in-place source file: set GELSLIM_DATA_PATH."""

import os

DATA_PATH = os.environ.get("GELSLIM_DATA_PATH", os.path.join(os.getcwd(), "data"))
