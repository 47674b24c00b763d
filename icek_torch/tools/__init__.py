"""Profiling tools (ports of ``tools/profile_train_step.py`` and
``tools/profile_eval.py``), run with ``python -m icek_torch.tools.<name>``."""
