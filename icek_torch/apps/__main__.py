"""``python -m icek_torch.apps {train,eval,serve} <preset> [flags]``."""

import sys

from icek_torch.apps import main

sys.exit(main())
