import sys

from gelslim_depth_tpu_torch.cli import main

sys.exit(main())
