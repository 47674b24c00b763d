"""Profile the eval pipeline (encode, context prep, beam decode) under
``torch.profiler``: device time by op class, then the largest individual
ops with their full kernel names (port of ``tools/profile_eval.py``).  The
same caveats as ``profile_train_step``: a map of WHERE the time goes, not a
savings predictor.

Usage: python -m icek_torch.tools.profile_eval [batch] [preset] [beam]
           [trace_dir] [--device cuda|cpu]

The model is the preset's at full width with seeded random weights, bf16 on
the card (f32 on the CPU), over one batch of seeded images.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time
from typing import Callable

from icek_torch.tools.profile_train_step import op_class, summarize, trace, trace_ops


def top_ops(trace_path: str, n: int = 20, out: Callable[[str], None] = print):
    """Print the `n` largest individual ops (summed over their calls) with
    their names; returns [(name, ms, count)] largest first."""
    _, ops = trace_ops(trace_path)
    agg = collections.defaultdict(lambda: [0.0, 0])
    for name, ms in ops:
        agg[name][0] += ms
        agg[name][1] += 1
    rows = sorted(((k, ms, c) for k, (ms, c) in agg.items()), key=lambda r: -r[1])[:n]
    out(f"\ntop {n} individual ops:")
    for name, ms, count in rows:
        out(f"{ms:8.2f} ms x{count:<5} {op_class(name)}\n           {name[:200]}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m icek_torch.tools.profile_eval",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("preset", nargs="?", default="georic")
    p.add_argument("beam", nargs="?", type=int, default=5)
    p.add_argument("trace_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    trace_dir = args.trace_dir or os.path.join(tempfile.gettempdir(),
                                               f"icek_eval_trace_{args.preset}")
    import numpy as np

    from icek_torch import eval_driver
    from icek_torch.tools import _synthetic

    cfg, wm, params, enc = _synthetic.model(args.preset, beam=args.beam,
                                            batch=args.batch)
    ev = eval_driver.Evaluator(cfg, wm, params, enc, batch_size=args.batch,
                               beam_size=args.beam, device=args.device)
    batch = _synthetic.decode_batch(np.random.default_rng(0), args.batch, args.preset)
    ev.decode_batch(batch)                                    # warm-up
    t0 = time.perf_counter()
    ev.decode_batch(batch)                                    # returns on the host
    steady = time.perf_counter() - t0
    print(json.dumps({"preset": args.preset, "batch": args.batch, "beam": args.beam,
                      "pipeline_steady_s": steady,
                      "caps_per_sec": args.batch / steady}))
    path = trace(lambda: ev.decode_batch(batch), trace_dir, 1)
    summarize(path, 1)
    top_ops(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
