"""``python -m icek_torch.apps {train,eval,serve,prep,metrics,quantize} <preset>
[flags]`` and ``python -m icek_torch.apps {validate,port-encoder} [args]``."""

import sys

from icek_torch.apps import main

sys.exit(main())
